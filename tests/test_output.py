"""Thermo logging, XYZ dumps, checkpoint/resume round trip."""

import io

import pytest

import jax
import jax.numpy as jnp
import numpy as np

from mtp_jax.md.integrators import nhc_init
from mtp_jax.md.output import (
    ThermoLogger,
    XYZDumpWriter,
    load_checkpoint,
    save_checkpoint,
)
from mtp_jax.md.simulation import make_lattice
from mtp_jax.md.state import init_state, thermalize


def _state(rng):
    pos, types, cell = make_lattice("fcc", 4.0, (2, 2, 2))
    st = init_state(pos, types, np.full(len(pos), 58.7), cell, dtype=jnp.float64)
    return thermalize(jax.random.PRNGKey(0), st, 300.0)


def test_thermo_logger(rng):
    st = _state(rng)
    buf = io.StringIO()
    log = ThermoLogger(("step", "temp", "pe", "etotal"), every=1, stream=buf)
    log(st)
    log(st, max_grade=1.5)
    assert len(log.history) == 2
    assert abs(log.column("temp")[0] - 300.0) < 1.0
    out = buf.getvalue().splitlines()
    assert out[0].split() == ["step", "temp", "pe", "etotal"]
    assert len(out) == 3


def test_xyz_dump_roundtrip(tmp_path, rng):
    st = _state(rng)
    p = tmp_path / "traj.xyz"
    with XYZDumpWriter(str(p), species=("Ni",)) as w:
        w.write(st, forces=True, grades=np.arange(st.n_atoms, dtype=float))
        w.write(st)
    lines = p.read_text().splitlines()
    n = st.n_atoms
    assert lines[0] == str(n)
    assert "Lattice=" in lines[1] and "nbh_grade" in lines[1]
    assert lines[2].startswith("Ni ")
    assert len(lines) == 2 * (n + 2)
    # grade column round-trips
    assert float(lines[2 + 5].split()[-1]) == 5.0


def test_checkpoint_roundtrip(tmp_path, rng):
    st = _state(rng)
    aux = nhc_init(jnp.float64)
    f = str(tmp_path / "ckpt.npz")
    save_checkpoint(f, st, aux)
    st2, aux2 = load_checkpoint(f)
    np.testing.assert_array_equal(np.asarray(st2.positions), np.asarray(st.positions))
    np.testing.assert_array_equal(np.asarray(st2.velocities), np.asarray(st.velocities))
    np.testing.assert_array_equal(np.asarray(st2.types), np.asarray(st.types))
    assert int(st2.step) == int(st.step)
    assert aux2.xi.shape == aux.xi.shape


def test_checkpoint_no_aux(tmp_path, rng):
    st = _state(rng)
    f = str(tmp_path / "ckpt2.npz")
    save_checkpoint(f, st)
    st2, aux2 = load_checkpoint(f, dtype=jnp.float32)
    assert aux2 is None
    assert st2.positions.dtype == jnp.float32


def test_cfg_plusstress_roundtrip(rng):
    """PlusStress section round-trips (MLIP training sets carry stress)."""
    from mtp_jax.io.cfg_file import format_cfg, parse_cfgs

    cell = np.diag([10.0, 11.0, 12.0])
    pos = rng.uniform(0, 10, (4, 3))
    types = np.zeros(4, dtype=np.int64)
    stress = rng.normal(size=6)
    txt = format_cfg(cell, pos, types, energy=-3.25, stress=stress)
    cfg = parse_cfgs(txt)[0]
    assert cfg.energy == pytest.approx(-3.25)
    np.testing.assert_allclose(cfg.stress, stress, atol=1e-5)
