"""Double-float (f32x2) arithmetic + the df32 accuracy-mode force path.

The df32 backend crosses the <1e-6 force-parity gate from f32 arithmetic
(the fp32 error floor lives in the per-pair backward-DAG arithmetic; only
higher-precision terms can remove it). These
tests validate the arithmetic against f64 and the end-to-end path against
the f64 golden oracle, from identical f32-rounded inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from mtp_jax.models.mtp import MTPModel, mtp_energy_forces
from mtp_jax.ops import df32 as df
from mtp_jax.utils import golden

from conftest import scatter_cluster
from test_model import dense_neighbors


def _rand32(rng, n, scale=1.0):
    return rng.uniform(-scale, scale, n).astype(np.float32)


def test_df_arithmetic_vs_f64(rng):
    a = _rand32(rng, 4096, 100.0)
    b = _rand32(rng, 4096, 100.0)
    # error-free transforms are EXACT
    s, e = df.two_sum(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(
        np.asarray(s, np.float64) + np.asarray(e, np.float64),
        a.astype(np.float64) + b.astype(np.float64),
    )
    p, q = df.two_prod(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(
        np.asarray(p, np.float64) + np.asarray(q, np.float64),
        a.astype(np.float64) * b.astype(np.float64),
    )


def _df_val(x):
    return np.asarray(x[0], np.float64) + np.asarray(x[1], np.float64)


def test_df_ops_accuracy(rng):
    """add/mul/div/sqrt track f64 to ~2^-48 relative (vs f32's 2^-24)."""
    a64 = rng.uniform(0.1, 50.0, 2048)
    b64 = rng.uniform(0.1, 50.0, 2048)
    x = df.two_sum(jnp.asarray(a64, jnp.float32), jnp.asarray((a64 * 1e-4), jnp.float32))
    y = df.two_sum(jnp.asarray(b64, jnp.float32), jnp.asarray((b64 * 1e-4), jnp.float32))
    xv, yv = _df_val(x), _df_val(y)
    tol = 1e-13  # relative; ~2^-43, comfortably past f32
    for got, want in [
        (df.add(x, y), xv + yv),
        (df.sub(x, y), xv - yv),
        (df.mul(x, y), xv * yv),
        (df.div(x, y), xv / yv),
        (df.sqrt(x), np.sqrt(xv)),
    ]:
        err = np.abs(_df_val(got) - want) / np.abs(want)
        assert err.max() < tol, err.max()


def test_df_tree_sum(rng):
    a = rng.uniform(-1, 1, (37, 53)).astype(np.float32)
    got = _df_val(df.tree_sum(df.from_f32(jnp.asarray(a)), axis=1))
    want = a.astype(np.float64).sum(axis=1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("fixture", ["mtp_level8_2spec", "mtp_level12"])
def test_df32_force_parity_cluster(fixture, rng, request):
    """df32 backend matches the f64 oracle ~100x tighter than plain f32."""
    m = request.getfixturevalue(fixture)
    n = 24
    pos = scatter_cluster(n, rng).astype(np.float32)  # f32-rounded inputs
    types = rng.integers(0, m.species_count, n)
    g = golden.compute(m, pos.astype(np.float64), types)
    fscale = np.abs(g["forces"]).max()

    model = MTPModel.from_data(m, dtype=jnp.float32)
    nbr = dense_neighbors(pos, m.max_dist, max_n=32)
    args = (
        model.schedule,
        model.coeffs,
        jnp.asarray(pos, jnp.float32),
        jnp.asarray(types, jnp.int32),
        jnp.asarray(nbr),
    )
    out_df = mtp_energy_forces(*args, backend="df32")
    out_32 = mtp_energy_forces(*args, backend="xla")
    err_df = np.abs(np.asarray(out_df["forces"], np.float64) - g["forces"]).max()
    err_32 = np.abs(np.asarray(out_32["forces"], np.float64) - g["forces"]).max()
    # the df32 terms are ~49-bit; the one rounding to f32 + f32 J-sum leaves
    # ~1e-7 relative (PARITY.md round-4 decomposition). At tiny N the plain
    # f32 error hasn't accumulated much yet, so the ratio criterion is a
    # conservative 5x (measured 7.3x at n=24; ~60x at 4k on device).
    assert err_df < 4e-7 * max(fscale, 1.0), (err_df, err_32, fscale)
    assert err_df < err_32 / 5 or err_32 < 1e-7
    e_err = abs(float(out_df["energy"]) - g["energy"]) / max(abs(g["energy"]), 1.0)
    assert e_err < 1e-6


def test_df32_force_parity_periodic(mtp_level8_2spec, rng):
    """Periodic box: exact df minimum image keeps wrap-boundary pairs tight."""
    m = mtp_level8_2spec
    L = 2 * m.max_dist + 20.0  # bigger box -> bigger f32 min-image rounding
    cell = np.diag([L, L, L * 1.1])
    n = 40
    pos = rng.uniform(0, L, (n, 3))
    for _ in range(800):
        d = pos[:, None] - pos[None, :]
        d -= np.round(d / L) * L
        dist = np.linalg.norm(d, axis=-1) + np.eye(n) * 100
        if dist.min() > 1.8:
            break
        i, j = divmod(dist.argmin(), n)
        pos[i] += 0.3 * (pos[i] - pos[j]) / dist[i, j]
    pos = pos.astype(np.float32)
    cell32 = cell.astype(np.float32)
    types = rng.integers(0, 2, n)

    g = golden.compute(m, pos.astype(np.float64), types, cell=cell32.astype(np.float64))
    fscale = np.abs(g["forces"]).max()
    model = MTPModel.from_data(m, dtype=jnp.float32)
    nbr = dense_neighbors(pos, m.max_dist, max_n=40, cell=cell32)
    out = mtp_energy_forces(
        model.schedule,
        model.coeffs,
        jnp.asarray(pos, jnp.float32),
        jnp.asarray(types, jnp.int32),
        jnp.asarray(nbr),
        cell=jnp.asarray(cell32, jnp.float32),
        backend="df32",
    )
    err = np.abs(np.asarray(out["forces"], np.float64) - g["forces"]).max()
    assert err < 4e-7 * max(fscale, 1.0), (err, fscale)


def test_df32_simulation_wiring(mtp_level8_2spec, rng):
    """Simulation(backend="df32") delivers the accuracy mode end-to-end:
    refresh_forces through the driver (neighbor list, mirror, virial) beats
    the f32 path against the f64 evaluation of the same frozen list."""
    import jax

    from mtp_jax.md.simulation import Simulation, make_lattice
    from mtp_jax.md.state import init_state, thermalize
    from mtp_jax.ops.neighbors import grid_shape

    m = mtp_level8_2spec
    model32 = MTPModel.from_data(m, dtype=jnp.float32)
    pos, types, cell = make_lattice("fcc", 4.0, (3, 3, 3), type_pattern=(0, 1))
    n = len(pos)
    state = thermalize(
        jax.random.PRNGKey(2),
        init_state(pos, types, np.full(n, 58.693), cell, dtype=jnp.float32),
        300.0,
    )
    grid = grid_shape(np.asarray(cell), model32.cutoff + 0.5)

    def forces(backend, model, st):
        sim = Simulation(model, max_neighbors=48, skin=0.5, backend=backend)
        nl = sim.rebuild(st, grid=grid, max_neighbors=48)
        assert not bool(nl.overflow)
        out = sim.refresh_forces(st, nl)
        return np.asarray(out.forces, np.float64), float(out.potential_energy)

    f_df, e_df = forces("df32", model32, state)
    f_32, e_32 = forces("xla", model32, state)
    model64 = MTPModel.from_data(m, dtype=jnp.float64)
    state64 = init_state(
        np.asarray(state.positions, np.float64), types,
        np.full(n, 58.693), np.asarray(state.cell, np.float64),
        dtype=jnp.float64,
    )
    f_64, e_64 = forces("xla", model64, state64)

    err_df = np.abs(f_df - f_64).max()
    err_32 = np.abs(f_32 - f_64).max()
    fscale = np.abs(f_64).max()
    assert err_df < 4e-7 * max(fscale, 1.0), (err_df, err_32)
    assert err_df < err_32 / 5 or err_32 < 1e-7
    assert abs(e_df - e_64) / n < 1e-6
