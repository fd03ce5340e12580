"""FIRE 2.0 minimization (md/minimize.py): the LAMMPS `minimize` workflow.

The reference's users relax structures with LAMMPS `minimize` before MD;
here minimization is a framework driver reusing the Simulation block
machinery, so these tests cover: descent + ftol convergence, independence
of the neighbor padding width, overflow recovery, and the etol stop."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mtp_jax.md.minimize import fire_minimize
from mtp_jax.md.simulation import Simulation, make_lattice
from mtp_jax.md.state import init_state
from mtp_jax.models.mtp import MTPModel


def _rattled(model_data, reps, rattle, seed=0, type_pattern=(0,)):
    model = MTPModel.from_data(model_data, dtype=jnp.float64)
    pos, types, cell = make_lattice(
        "fcc", 4.0, reps, type_pattern=type_pattern
    )
    rng = np.random.default_rng(seed)
    pos = pos + rng.normal(0.0, rattle, pos.shape)
    state = init_state(
        pos, types, np.full(len(pos), 58.7), cell, dtype=jnp.float64
    )
    return model, state


def test_fire_converges_and_descends(mtp_level8):
    model, state = _rattled(mtp_level8, (4, 4, 4), 0.05)
    sim = Simulation(model, max_neighbors=48, skin=0.6, steps_per_rebuild=20)
    state = sim.refresh_forces(
        state, sim.rebuild(state, grid=(3, 3, 3), max_neighbors=48)
    )
    e0 = float(state.potential_energy)
    f0 = float(jnp.sqrt(jnp.max(jnp.sum(state.forces**2, axis=-1))))
    out, res = fire_minimize(sim, state, ftol=1e-4, max_steps=2000)
    assert res.converged and res.stop_reason == "ftol"
    assert res.fmax < 1e-4 < f0
    assert res.potential_energy < e0
    # returned forces are consistent with the returned positions
    chk = sim.refresh_forces(
        out, sim.rebuild(out, grid=(3, 3, 3), max_neighbors=sim.max_neighbors)
    )
    fmax_chk = float(jnp.sqrt(jnp.max(jnp.sum(chk.forces**2, axis=-1))))
    assert abs(fmax_chk - res.fmax) < 1e-10
    assert float(jnp.max(jnp.abs(out.velocities))) == 0.0


def test_fire_overall_descent_per_block(mtp_level8):
    model, state = _rattled(mtp_level8, (4, 4, 4), 0.08, seed=1)
    sim = Simulation(model, max_neighbors=48, skin=0.6, steps_per_rebuild=10)
    energies = []
    fire_minimize(
        sim, state, ftol=1e-3, max_steps=300,
        observer=lambda s: energies.append(float(s.potential_energy)),
    )
    assert len(energies) >= 2
    assert energies[-1] < energies[0]


def test_fire_independent_of_neighbor_padding(mtp_level8_2spec):
    """FIRE is deterministic and padding slots are masked, so a wider
    neighbor list (more self-padded slots per row) gives the same
    minimization trajectory."""
    model, state = _rattled(
        mtp_level8_2spec, (6, 6, 6), 0.04, seed=2, type_pattern=(0, 1)
    )
    kw = dict(skin=0.6, steps_per_rebuild=10)
    sim_a = Simulation(model, max_neighbors=64, **kw)
    sim_b = Simulation(model, max_neighbors=96, **kw)
    out_a, res_a = fire_minimize(sim_a, state, ftol=0.0, max_steps=20)
    out_b, res_b = fire_minimize(sim_b, state, ftol=0.0, max_steps=20)
    np.testing.assert_allclose(
        np.asarray(out_a.positions), np.asarray(out_b.positions), atol=1e-10
    )
    np.testing.assert_allclose(
        res_a.potential_energy, res_b.potential_energy, atol=1e-10
    )
    np.testing.assert_allclose(res_a.fmax, res_b.fmax, atol=1e-10)


def test_fire_overflow_recovery(mtp_level8):
    """A too-small max_neighbors grows (the Simulation.run contract) and the
    minimization still converges."""
    model, state = _rattled(mtp_level8, (4, 4, 4), 0.05)
    sim = Simulation(model, max_neighbors=16, skin=0.6, steps_per_rebuild=20)
    out, res = fire_minimize(sim, state, ftol=1e-3, max_steps=2000)
    assert sim.max_neighbors > 16
    assert res.converged


def test_fire_etol_stop(mtp_level8):
    model, state = _rattled(mtp_level8, (4, 4, 4), 0.05)
    sim = Simulation(model, max_neighbors=48, skin=0.6, steps_per_rebuild=10)
    out, res = fire_minimize(
        sim, state, ftol=0.0, etol=1e-6, max_steps=2000
    )
    assert res.converged and res.stop_reason == "etol"
    assert res.iterations < 2000


def test_fire_simulation_method_delegates(mtp_level8):
    model, state = _rattled(mtp_level8, (4, 4, 4), 0.05)
    sim = Simulation(model, max_neighbors=48, skin=0.6, steps_per_rebuild=20)
    out, res = sim.minimize(state, ftol=1e-3, max_steps=500)
    assert res.converged
