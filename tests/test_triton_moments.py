"""The fused Pallas-Triton moments kernel (ops/triton_moments.py) in
interpret mode against the XLA path, and the wrapper's padding and layout.

The kernel compiled for the card is checked by chip_smoke.py; the
`gpu`-marked test here runs it where a GPU is present.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from mtp_jax.io.basis_gen import make_mtp
from mtp_jax.md.simulation import make_lattice
from mtp_jax.models.mtp import MTPModel, gather_displacements, mtp_energy_forces
from mtp_jax.ops import triton_moments as tm
from mtp_jax.ops.moments import energy_and_pair_forces
from mtp_jax.ops.neighbors import build_neighbor_list, grid_shape


def _pairs(species, level=8, max_neighbors=64, reps=(3, 3, 3), dtype=jnp.float32):
    m = make_mtp(level, species_count=species, seed=0)
    model = MTPModel.from_data(m, dtype=dtype)
    kw = {"type_pattern": (0, 1)} if species == 2 else {}
    pos, types, cell = make_lattice("fcc", 4.0, reps, **kw)
    pos = pos + np.random.default_rng(0).normal(0, 0.05, pos.shape)
    p, c = jnp.asarray(pos, dtype), jnp.asarray(cell, dtype)
    t = jnp.asarray(types, jnp.int32)
    nl = build_neighbor_list(
        p, c, model.cutoff, max_neighbors=max_neighbors,
        grid=grid_shape(cell, model.cutoff), with_reverse=True,
    )
    disp = gather_displacements(p, nl.idx, c, jnp.linalg.inv(c))
    mask = (jnp.sum(disp * disp, -1) <= model.cutoff**2) & (
        nl.idx != jnp.arange(len(pos))[:, None]
    )
    return model, p, t, c, nl, disp, mask, t[nl.idx]


@pytest.mark.parametrize("level", [8, 16])
@pytest.mark.parametrize("species", [1, 2])
def test_kernel_matches_xla_vjp(species, level):
    """Site energies and per-pair forces (the vjp through the kernel) equal
    the XLA path's to fp32 round-off."""
    model, _, t, _, _, disp, mask, jt = _pairs(species, level)
    se_ref, pt_ref = energy_and_pair_forces(
        model.schedule, model.coeffs, disp, mask, t, jt
    )
    se, pt = tm.site_energies_and_pair_forces(
        model.schedule, model.coeffs, disp, mask, t, jt, block_n=32,
        interpret=True,
    )
    np.testing.assert_allclose(np.asarray(se), np.asarray(se_ref), atol=2e-6)
    np.testing.assert_allclose(np.asarray(pt), np.asarray(pt_ref), atol=2e-6)


@pytest.mark.parametrize("max_neighbors,block_n", [(48, 32), (64, 64)])
def test_padding_of_atoms_and_slots(max_neighbors, block_n):
    """J = 48 pads to 64 slots and 108 atoms pad to a block multiple; the
    padded slots and atoms contribute nothing."""
    model, _, t, _, _, disp, mask, jt = _pairs(1, max_neighbors=max_neighbors)
    n, j = mask.shape
    jp, n_pad = tm.pair_layout(n, j, block_n)
    assert jp == 64 and n_pad % block_n == 0 and n_pad >= n
    se_ref, pt_ref = energy_and_pair_forces(
        model.schedule, model.coeffs, disp, mask, t, jt
    )
    se, pt = tm.site_energies_and_pair_forces(
        model.schedule, model.coeffs, disp, mask, t, jt, block_n=block_n,
        interpret=True,
    )
    assert se.shape == (n,) and pt.shape == (n, j, 3)
    np.testing.assert_allclose(np.asarray(se), np.asarray(se_ref), atol=2e-6)
    np.testing.assert_allclose(np.asarray(pt), np.asarray(pt_ref), atol=2e-6)


def test_pair_layout():
    assert tm.pair_layout(32000, 64) == (64, 32000)
    assert tm.pair_layout(1000188, 64) == (64, 1000192)
    assert tm.pair_layout(10, 3) == (8, tm.BLOCK_N)
    assert tm.pair_layout(10, 65) == (128, tm.BLOCK_N)


def test_backend_choice(monkeypatch):
    """mtp_energy_forces routes backend="triton" through the kernel, and the
    kernel's forces and virial match backend="xla"."""
    model, p, t, c, nl, _, _, _ = _pairs(2)
    calls = []
    real = tm.site_energies_and_pair_forces

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw, block_n=32, interpret=True)

    monkeypatch.setattr(tm, "site_energies_and_pair_forces", spy)
    args = (model.schedule, model.coeffs, p, t, nl.idx, c, nl.mirror)
    out_k = mtp_energy_forces.__wrapped__(*args, backend="triton")
    assert calls
    out_x = mtp_energy_forces(*args, backend="xla")
    for key, tol in (("forces", 5e-6), ("virial", 5e-5)):
        np.testing.assert_allclose(
            np.asarray(out_k[key]), np.asarray(out_x[key]), atol=tol
        )
    assert float(out_k["energy"]) == pytest.approx(float(out_x["energy"]),
                                                   abs=1e-4)


@pytest.mark.parametrize(
    "platform,dtype,expect",
    [("gpu", jnp.float32, "triton"), ("gpu", jnp.float64, "xla"),
     ("cpu", jnp.float32, "xla")],
)
def test_auto_backend_choice(monkeypatch, platform, dtype, expect):
    """"auto" is the kernel for fp32 on a GPU, else the XLA path; explicit
    names pass through."""
    from mtp_jax.models import mtp

    monkeypatch.setattr(mtp.jax, "default_backend", lambda: platform)
    assert mtp.resolve_backend("auto", dtype) == expect
    assert mtp.resolve_backend("df32", dtype) == "df32"


@pytest.mark.gpu
def test_kernel_compiled_on_gpu(gpu):
    model, _, t, _, _, disp, mask, jt = _pairs(2, level=16)
    se_ref, pt_ref = energy_and_pair_forces(
        model.schedule, model.coeffs, disp, mask, t, jt
    )
    se, pt = tm.site_energies_and_pair_forces(
        model.schedule, model.coeffs, disp, mask, t, jt
    )
    np.testing.assert_allclose(np.asarray(pt), np.asarray(pt_ref), atol=2e-6)
