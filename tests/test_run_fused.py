"""run_fused (single compiled multi-block program) matches the host loop."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mtp_jax.md.simulation import Simulation, make_lattice
from mtp_jax.md.state import init_state, thermalize
from mtp_jax.models.mtp import MTPModel
from mtp_jax.ops.neighbors import grid_shape


def test_run_fused_matches_host_loop(mtp_level8, rng):
    model = MTPModel.from_data(mtp_level8, dtype=jnp.float64)
    pos, types, cell = make_lattice("fcc", 4.0, (3, 3, 3))
    state0 = thermalize(
        jax.random.PRNGKey(0),
        init_state(pos, types, np.full(len(pos), 58.7), cell, dtype=jnp.float64),
        250.0,
    )
    sim = Simulation(model, max_neighbors=48, skin=0.6, steps_per_rebuild=5)
    ref, _ = sim.run(state0, 20, ensemble="nve", dt=0.001)

    grid = grid_shape(cell, model.cutoff + 0.6)
    fused, _, overflow = sim.run_fused(
        state0,
        0,
        grid=grid,
        max_neighbors=48,
        n_blocks=4,
        steps_per_block=5,
        ensemble="nve",
        dt=0.001,
    )
    assert not bool(overflow)
    assert int(fused.step) == 20
    np.testing.assert_allclose(
        np.asarray(fused.positions), np.asarray(ref.positions), atol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(fused.velocities), np.asarray(ref.velocities), atol=1e-10
    )


def test_geometry_overflow_flag(mtp_level8, rng):
    """Shrinking the cell past the static grid's validity trips overflow."""
    from mtp_jax.ops.neighbors import build_neighbor_list, grid_shape

    L = 24.0
    cell = np.diag([L, L, L])
    pos = rng.uniform(0, L, (60, 3))
    grid = grid_shape(cell, 3.0)
    assert min(grid) >= 3
    ok = build_neighbor_list(
        jnp.asarray(pos), jnp.asarray(cell), 3.0, max_neighbors=60, grid=grid
    )
    assert not bool(ok.overflow)
    shrunk = build_neighbor_list(
        jnp.asarray(pos) * 0.5, jnp.asarray(cell) * 0.5, 3.0,
        max_neighbors=60, grid=grid,
    )
    assert bool(shrunk.overflow)
