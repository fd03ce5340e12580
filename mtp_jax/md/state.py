"""MD state containers and observables.

The reference delegates the time loop, thermostats, and thermo output to
LAMMPS (SURVEY.md §2.2); here they are first-class framework components.
Units: LAMMPS ``metal`` (A, eV, ps, amu, K, bar).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from mtp_jax.utils import units


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class MDState:
    positions: jax.Array  # (N, 3) A
    velocities: jax.Array  # (N, 3) A/ps
    forces: jax.Array  # (N, 3) eV/A
    masses: jax.Array  # (N,) amu
    types: jax.Array  # (N,) int32
    cell: jax.Array  # (3, 3) row-vector cell
    potential_energy: jax.Array  # () eV
    virial: jax.Array  # (6,) eV (Voigt xx,yy,zz,xy,xz,yz)
    step: jax.Array  # () int32

    @property
    def n_atoms(self) -> int:
        return self.positions.shape[0]


def init_state(positions, types, masses, cell, *, velocities=None, dtype=jnp.float32):
    positions = jnp.asarray(positions, dtype)
    n = positions.shape[0]
    if velocities is None:
        velocities = jnp.zeros((n, 3), dtype)
    return MDState(
        positions=positions,
        velocities=jnp.asarray(velocities, dtype),
        forces=jnp.zeros((n, 3), dtype),
        masses=jnp.asarray(masses, dtype),
        types=jnp.asarray(types, jnp.int32),
        cell=jnp.asarray(cell, dtype),
        potential_energy=jnp.zeros((), dtype),
        virial=jnp.zeros((6,), dtype),
        step=jnp.zeros((), jnp.int32),
    )


def thermalize(key, state: MDState, temperature: float) -> MDState:
    """Draw Maxwell-Boltzmann velocities and remove net momentum
    (the analog of LAMMPS ``velocity all create T seed mom yes``)."""
    n = state.n_atoms
    sigma = jnp.sqrt(units.KB * temperature / (state.masses * units.MVV2E))
    v = jax.random.normal(key, (n, 3), state.velocities.dtype) * sigma[:, None]
    p = jnp.sum(v * state.masses[:, None], axis=0) / jnp.sum(state.masses)
    v = v - p[None, :]
    # rescale to the exact target temperature
    t_now = temperature_of(dataclasses.replace(state, velocities=v))
    v = v * jnp.sqrt(temperature / jnp.maximum(t_now, 1e-30))
    return dataclasses.replace(state, velocities=v)


def kinetic_energy(state: MDState):
    """KE in eV."""
    return 0.5 * units.MVV2E * jnp.sum(
        state.masses[:, None] * state.velocities**2
    )


def temperature_of(state: MDState):
    """Instantaneous temperature [K] (3N degrees of freedom)."""
    n = state.n_atoms
    return 2.0 * kinetic_energy(state) / (3.0 * n * units.KB)


def volume_of(state: MDState):
    return jnp.abs(jnp.linalg.det(state.cell))


def pressure_of(state: MDState):
    """Instantaneous isotropic pressure [bar]: (2 KE + trace(W)) / (3 V)."""
    v = volume_of(state)
    w = state.virial[0] + state.virial[1] + state.virial[2]
    p_eva3 = (2.0 * kinetic_energy(state) + w) / (3.0 * v)
    return p_eva3 * units.EVA3_TO_BAR
