"""JAX engine vs golden reference parity + autodiff-vs-FD force checks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mtp_jax.models.mtp import MTPModel, mtp_energy, mtp_energy_forces
from mtp_jax.ops.neighbors import build_neighbor_list_bruteforce
from mtp_jax.utils import golden

from conftest import scatter_cluster


def dense_neighbors(pos, cutoff, max_n=24, cell=None):
    """Padded neighbor indices via the brute-force builder."""
    nl = build_neighbor_list_bruteforce(
        jnp.asarray(pos), None if cell is None else jnp.asarray(cell), cutoff,
        max_neighbors=max_n,
    )
    assert not bool(nl.overflow)
    return np.asarray(nl.idx)


@pytest.mark.parametrize("fixture", ["mtp_level8", "mtp_level8_2spec", "mtp_level12"])
def test_parity_cluster(fixture, rng, request):
    m = request.getfixturevalue(fixture)
    n = 14
    pos = scatter_cluster(n, rng)
    types = rng.integers(0, m.species_count, n)
    g = golden.compute(m, pos, types)

    model = MTPModel.from_data(m, dtype=jnp.float64)
    nbr = dense_neighbors(pos, m.max_dist)
    out = mtp_energy_forces(
        model.schedule,
        model.coeffs,
        jnp.asarray(pos),
        jnp.asarray(types, jnp.int32),
        jnp.asarray(nbr),
    )
    assert abs(g["energy"] - float(out["energy"])) < 1e-10
    np.testing.assert_allclose(np.asarray(out["forces"]), g["forces"], atol=1e-11)
    np.testing.assert_allclose(np.asarray(out["virial"]), g["virial"], atol=1e-11)
    np.testing.assert_allclose(
        np.asarray(out["site_energies"]), g["site_energies"], atol=1e-12
    )


def test_parity_periodic(mtp_level8_2spec, rng):
    """Periodic box (> 2*cutoff wide: minimum-image regime)."""
    m = mtp_level8_2spec
    L = 2 * m.max_dist + 1.0
    cell = np.diag([L, L, L * 1.1])
    n = 20
    pos = rng.uniform(0, L, (n, 3))
    # enforce min separation under PBC
    for _ in range(500):
        d = pos[:, None] - pos[None, :]
        d -= np.round(d / L) * L
        dist = np.linalg.norm(d, axis=-1) + np.eye(n) * 100
        if dist.min() > 1.7:
            break
        i, j = divmod(dist.argmin(), n)
        pos[i] += 0.3 * (pos[i] - pos[j]) / dist[i, j]
    types = rng.integers(0, 2, n)

    g = golden.compute(m, pos, types, cell=cell)
    model = MTPModel.from_data(m, dtype=jnp.float64)
    nbr = dense_neighbors(pos, m.max_dist, max_n=24, cell=cell)
    out = mtp_energy_forces(
        model.schedule,
        model.coeffs,
        jnp.asarray(pos),
        jnp.asarray(types, jnp.int32),
        jnp.asarray(nbr),
        cell=jnp.asarray(cell),
    )
    assert abs(g["energy"] - float(out["energy"])) < 1e-10
    np.testing.assert_allclose(np.asarray(out["forces"]), g["forces"], atol=1e-11)
    np.testing.assert_allclose(np.asarray(out["virial"]), g["virial"], atol=1e-10)


def test_forces_match_position_grad(mtp_level8, rng):
    """Forces from the pair-T scatter equal -dE/dx (Newton consistency)."""
    m = mtp_level8
    n = 10
    pos = scatter_cluster(n, rng)
    types = np.zeros(n, dtype=np.int32)
    model = MTPModel.from_data(m, dtype=jnp.float64)
    nbr = jnp.asarray(dense_neighbors(pos, m.max_dist))

    out = mtp_energy_forces(
        model.schedule, model.coeffs, jnp.asarray(pos), jnp.asarray(types), nbr
    )
    gradE = jax.grad(
        lambda p: mtp_energy(model.schedule, model.coeffs, p, jnp.asarray(types), nbr)
    )(jnp.asarray(pos))
    np.testing.assert_allclose(
        np.asarray(out["forces"]), -np.asarray(gradE), atol=1e-11
    )


def test_energy_fp32_accuracy(mtp_level12, rng):
    """fp32 evaluation stays within ~1e-6 eV/atom of the f64 golden engine."""
    m = mtp_level12
    n = 32
    pos = scatter_cluster(n, rng, span=9.0)
    types = np.zeros(n, dtype=np.int32)
    g = golden.compute(m, pos, types)

    model = MTPModel.from_data(m, dtype=jnp.float32)
    nbr = dense_neighbors(pos, m.max_dist, max_n=32)
    out = mtp_energy_forces(
        model.schedule,
        model.coeffs,
        jnp.asarray(pos, jnp.float32),
        jnp.asarray(types),
        jnp.asarray(nbr),
    )
    scale = max(1.0, np.abs(g["site_energies"]).max())
    assert abs(float(out["energy"]) - g["energy"]) / n < 2e-6 * scale
    fscale = max(1.0, np.abs(g["forces"]).max())
    assert np.abs(np.asarray(out["forces"]) - g["forces"]).max() < 1e-4 * fscale
