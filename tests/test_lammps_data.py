"""LAMMPS data-file reader/writer (io/lammps_data.py).

The reference gets system setup from LAMMPS `read_data` / script commands
(README.md:124-147); this framework owns that entry point, so the format
must round-trip and plug straight into init_state/Simulation.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from mtp_jax.io.lammps_data import (
    LammpsData,
    read_lammps_data,
    write_lammps_data,
)
from mtp_jax.md.simulation import make_lattice


def test_roundtrip_orthorhombic(tmp_path):
    pos, types, cell = make_lattice("fcc", 4.0, (2, 2, 2), type_pattern=(0, 1))
    rng = np.random.default_rng(0)
    pos = pos + rng.normal(0, 0.05, pos.shape)
    masses = np.where(np.asarray(types) == 0, 58.693, 26.98)
    vel = rng.normal(0, 0.1, pos.shape)
    p = tmp_path / "box.data"
    write_lammps_data(p, pos, types, masses, cell, velocities=vel)
    d = read_lammps_data(p)
    np.testing.assert_allclose(d.positions, pos, atol=1e-12)
    np.testing.assert_array_equal(d.types, types)
    np.testing.assert_allclose(d.masses, masses)
    np.testing.assert_allclose(d.cell, cell, atol=1e-12)
    np.testing.assert_allclose(d.velocities, vel, atol=1e-12)
    np.testing.assert_allclose(d.type_masses, [58.693, 26.98])


def test_roundtrip_triclinic(tmp_path):
    cell = np.array([[10.0, 0, 0], [1.5, 9.0, 0], [-0.7, 0.9, 8.0]])
    rng = np.random.default_rng(1)
    frac = rng.uniform(0, 1, (20, 3))
    pos = frac @ cell
    types = np.zeros(20, np.int32)
    masses = np.full(20, 39.0983)
    p = tmp_path / "tri.data"
    write_lammps_data(p, pos, types, masses, cell)
    d = read_lammps_data(p)
    np.testing.assert_allclose(d.cell, cell, atol=1e-12)
    np.testing.assert_allclose(d.positions, pos, atol=1e-12)
    assert d.velocities is None


def test_reader_header_variants(tmp_path):
    """Origin shift, image-flag unwrap, comments, CRLF, reordered ids."""
    text = (
        "LAMMPS data file  # free-form comment\r\n"
        "\r\n"
        "3 atoms\r\n"
        "0 bonds\r\n"
        "2 atom types  # trailing comment\r\n"
        "\r\n"
        "-2.0 8.0 xlo xhi\r\n"
        "1.0 9.0 ylo yhi\r\n"
        "0.0 12.0 zlo zhi\r\n"
        "\r\n"
        "Masses\r\n"
        "\r\n"
        "1 10.0\r\n"
        "2 20.0  # heavy\r\n"
        "\r\n"
        "Atoms # atomic\r\n"
        "\r\n"
        "2 1 0.0 2.0 3.0 1 0 0\r\n"
        "1 2 -1.0 1.5 0.5\r\n"
        "3 1 7.9 8.9 11.9 0 0 -1\r\n"
    )
    p = tmp_path / "v.data"
    p.write_text(text)
    d = read_lammps_data(p)
    # ids reordered to 1,2,3; origin (-2, 1, 0) subtracted; images unwrap
    np.testing.assert_allclose(d.positions[0], [1.0, 0.5, 0.5])
    np.testing.assert_allclose(d.positions[1], [2.0 + 10.0, 1.0, 3.0])
    np.testing.assert_allclose(d.positions[2], [9.9, 7.9, 11.9 - 12.0])
    np.testing.assert_array_equal(d.types, [1, 0, 0])
    np.testing.assert_allclose(d.masses, [20.0, 10.0, 10.0])


@pytest.mark.parametrize(
    "mutate, match",
    [
        (lambda t: t.replace("3 atoms", ""), "missing 'atoms'"),
        (lambda t: t.replace("0.0 12.0 zlo zhi\n", ""), "missing box bounds"),
        (lambda t: t.replace("0 bonds", "2 bonds"), "topology"),
        (lambda t: t.replace("2 1 0.0 2.0 3.0", "2 1 0.0 2.0"), "fields"),
        (lambda t: t + "Bonds\n\n1 1 1 2\n", "not supported"),
        (lambda t: t.replace("1 2 -1.0 1.5 0.5\n", ""), "truncated"),
    ],
)
def test_reader_rejects(tmp_path, mutate, match):
    text = (
        "hdr\n\n3 atoms\n0 bonds\n2 atom types\n\n"
        "-2.0 8.0 xlo xhi\n1.0 9.0 ylo yhi\n0.0 12.0 zlo zhi\n\n"
        "Masses\n\n1 10.0\n2 20.0\n\n"
        "Atoms\n\n2 1 0.0 2.0 3.0\n1 2 -1.0 1.5 0.5\n3 1 7.9 8.9 11.9\n"
    )
    p = tmp_path / "bad.data"
    p.write_text(mutate(text))
    with pytest.raises(ValueError, match=match):
        read_lammps_data(p)


def test_writer_rejects_non_lammps_frame(tmp_path):
    cell = np.array([[10.0, 0.5, 0], [0, 9.0, 0], [0, 0, 8.0]])  # upper tilt
    with pytest.raises(ValueError, match="lower-triangular"):
        write_lammps_data(
            tmp_path / "x.data", np.zeros((1, 3)), [0], [1.0], cell
        )


def test_md_from_data_file(tmp_path):
    """A data file drives the same force evaluation as direct arrays."""
    from mtp_jax.io.basis_gen import make_mtp
    from mtp_jax.md.simulation import Simulation
    from mtp_jax.md.state import init_state
    from mtp_jax.models.mtp import MTPModel
    from mtp_jax.ops.neighbors import grid_shape

    model = MTPModel.from_data(make_mtp(8, species_count=1, seed=0),
                               dtype=jnp.float64)
    pos, types, cell = make_lattice("fcc", 4.0, (3, 3, 3))
    rng = np.random.default_rng(2)
    pos = pos + rng.normal(0, 0.05, pos.shape)
    masses = np.full(len(pos), 58.693)
    p = tmp_path / "fcc.data"
    write_lammps_data(p, pos, types, masses, cell)
    d = read_lammps_data(p)

    sim = Simulation(model, max_neighbors=64, skin=0.5)
    grid = grid_shape(cell, model.cutoff + 0.5)

    def forces(positions):
        st = init_state(positions, types, masses, cell, dtype=jnp.float64)
        return sim.refresh_forces(
            st, sim.rebuild(st, grid=grid, max_neighbors=64)
        )

    st_direct = forces(pos)
    st_file = forces(d.positions)
    np.testing.assert_allclose(
        np.asarray(st_file.forces), np.asarray(st_direct.forces), atol=1e-10
    )
    assert float(st_file.potential_energy) == pytest.approx(
        float(st_direct.potential_energy), abs=1e-10
    )
