"""Observables for sharded runs: the same output surface as single-chip.

The reference's thermo/dump plumbing is rank-transparent — LAMMPS gathers
per-atom data for dumps and reduces scalars for thermo rows regardless of
the MPI decomposition. Here:

* scalar observables (T, KE, P, E) are computed directly on the sharded
  arrays (XLA inserts the cross-shard reductions; padding slots masked by
  ``real``), no host gather;
* :func:`gather_md_state` performs the id-ordered host gather (the
  MPI_Scan/Send/Recv funnel analog, pair_mtp_extrapolation.cpp:415-474)
  into a plain :class:`MDState`, so every single-chip writer — ThermoLogger,
  XYZDumpWriter, save_checkpoint — works unchanged on multi-chip runs.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from mtp_jax.md.state import MDState
from mtp_jax.parallel.sharded_md import ShardedState
from mtp_jax.utils import units


def sharded_kinetic_energy(sstate: ShardedState):
    """Total kinetic energy [eV] (device scalar; padding slots masked)."""
    v = sstate.velocities
    return 0.5 * units.MVV2E * jnp.sum(
        jnp.where(sstate.real[:, None], sstate.masses[:, None] * v * v, 0.0)
    )


def sharded_temperature(sstate: ShardedState, n_atoms: int):
    """Instantaneous temperature [K] (device scalar)."""
    return (
        2.0 * sharded_kinetic_energy(sstate) / (3.0 * n_atoms * units.KB)
    )


def sharded_pressure(sstate: ShardedState):
    """Scalar pressure [bar] from the replicated virial + sharded KE."""
    vol = jnp.abs(jnp.linalg.det(sstate.cell))
    w_tr = sstate.virial[0] + sstate.virial[1] + sstate.virial[2]
    return (
        (2.0 * sharded_kinetic_energy(sstate) + w_tr)
        / (3.0 * vol)
        * units.EVA3_TO_BAR
    )


def gather_md_state(sstate: ShardedState, n_atoms: int, step: int = 0) -> MDState:
    """Id-ordered host gather of a ShardedState into a plain MDState.

    Valid after migration (ids travel with the atoms). The result feeds any
    single-chip consumer: ThermoLogger, XYZDumpWriter, save_checkpoint, or
    a single-chip Simulation (engine hand-off).

    All arrays come down in ONE batched `jax.device_get` (each separate
    fetch is a full round trip — per-field `ShardedState.gather` calls
    would re-fetch ids/real six times and cost ~18 transfers per frame)."""
    import jax

    ids, real, pos, vel, frc, mas, typ, cell, pe, vir = jax.device_get((
        sstate.ids, sstate.real, sstate.positions, sstate.velocities,
        sstate.forces, sstate.masses, sstate.types, sstate.cell,
        sstate.potential_energy, sstate.virial,
    ))
    m = (ids >= 0) & real
    own = ids[m]

    def order(arr):
        out = np.zeros((n_atoms,) + arr.shape[1:], arr.dtype)
        out[own] = arr[m]
        return out

    dtype = pos.dtype
    return MDState(
        positions=jnp.asarray(order(pos)),
        velocities=jnp.asarray(order(vel)),
        forces=jnp.asarray(order(frc)),
        masses=jnp.asarray(order(mas)),
        types=jnp.asarray(order(typ), jnp.int32),
        cell=jnp.asarray(cell, dtype),
        potential_energy=jnp.asarray(pe, dtype),
        virial=jnp.asarray(vir, dtype),
        step=jnp.asarray(step),
    )
