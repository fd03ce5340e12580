"""FIRE 2.0 energy minimization (the LAMMPS ``minimize`` + ``min_style
fire`` workflow the reference's users run before MD, e.g. to relax a
read-in structure onto the potential's surface).

Design: the same block structure as :class:`Simulation` — one
neighbor rebuild per block, then a jitted ``lax.scan`` of FIRE iterations
against the frozen list (Verlet-skin staleness checked in-scan, capacity
overflow recovered by the host loop exactly like ``Simulation.run``).
Per-iteration adaptive quantities (dt, alpha, uphill counter) are device
scalars in the scan carry, so the whole block is one compiled program with
no host round-trips.

Algorithm: FIRE 2.0 (Guenole et al., Comput. Mater. Sci. 175 (2020)
109584) with semi-implicit Euler integration, the N_delay dt-growth gate,
the half-step position backtrack on uphill power, and a LAMMPS-style
``dmax`` cap on any single atom's per-iteration displacement (min_fire.cpp
semantics; keeps minted/far-from-minimum structures from overshooting).

Convergence (LAMMPS ``minimize etol ftol maxiter maxeval`` analog):
``ftol`` bounds the max per-atom force magnitude [eV/A] (note: LAMMPS's
ftol bounds the global force 2-norm; the per-atom max is the stricter,
size-intensive criterion), ``etol`` the relative energy change across a
block. Either at 0 disables that criterion.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from mtp_jax.md.state import MDState
from mtp_jax.ops.neighbors import check_cell, grid_shape
from mtp_jax.utils import units


class FireAux(NamedTuple):
    """FIRE adaptive state carried across blocks (device scalars)."""

    dt: jax.Array      # current timestep [ps]
    alpha: jax.Array   # velocity-mixing fraction
    n_pos: jax.Array   # consecutive downhill-power iterations


def fire_init(dt0: float, alpha0: float, dtype=jnp.float32) -> FireAux:
    return FireAux(
        dt=jnp.asarray(dt0, dtype),
        alpha=jnp.asarray(alpha0, dtype),
        n_pos=jnp.zeros((), jnp.int32),
    )


@dataclasses.dataclass
class MinimizeResult:
    """Host-side outcome of :func:`fire_minimize`."""

    converged: bool
    iterations: int
    fmax: float               # max per-atom |F| [eV/A]
    potential_energy: float   # [eV]
    stop_reason: str          # "ftol" | "etol" | "maxiter"


def _fire_scan(
    state: MDState,
    aux: FireAux,
    force_fn,
    *,
    n_steps: int,
    ref_positions,
    skin: float,
    dt_max: float,
    dt_min: float,
    alpha0: float,
    n_delay: int,
    f_inc: float,
    f_dec: float,
    f_alpha: float,
    dmax: float,
):
    """`n_steps` FIRE iterations against a frozen neighbor list.

    Incoming ``state.forces`` must be position-consistent. Returns
    (state, aux, stale) — `stale` trips when the two largest displacements
    from the list's reference positions sum past the skin (the exact pair
    criterion; cell is fixed during minimization so no affine term).
    """
    template = state
    eps = jnp.asarray(1e-30, state.positions.dtype)

    def one(carry, _):
        pos, vel, f, pe, vir, dt, alpha, n_pos, stale = carry

        # semi-implicit Euler kick with the current forces
        vel = vel + (dt * units.FTM2A) * f / template.masses[:, None]

        power = jnp.sum(f * vel)
        uphill = power <= 0.0

        # downhill: count; past n_delay grow dt and anneal alpha
        n_pos = jnp.where(uphill, 0, n_pos + 1)
        grow = jnp.logical_and(~uphill, n_pos > n_delay)
        dt = jnp.where(grow, jnp.minimum(dt * f_inc, dt_max), dt)
        alpha = jnp.where(grow, alpha * f_alpha, alpha)

        # uphill: backtrack half the step just taken, freeze, cool dt
        pos = jnp.where(uphill, pos - (0.5 * dt) * vel, pos)
        vel = jnp.where(uphill, 0.0, vel)
        dt = jnp.where(uphill, jnp.maximum(dt * f_dec, dt_min), dt)
        alpha = jnp.where(uphill, alpha0, alpha)

        # velocity mixing toward the force direction (global norms)
        vnorm = jnp.sqrt(jnp.sum(vel * vel))
        fnorm = jnp.sqrt(jnp.sum(f * f))
        vel = (1.0 - alpha) * vel + (alpha * vnorm / jnp.maximum(fnorm, eps)) * f

        # drift, capped so no atom moves further than dmax in one iteration
        step_d = dt * vel
        dmax_atom = jnp.sqrt(jnp.max(jnp.sum(step_d * step_d, axis=-1)))
        scale = jnp.minimum(1.0, dmax / jnp.maximum(dmax_atom, eps))
        pos = pos + scale * step_d

        f, pe, vir = force_fn(pos, template.types, template.cell)

        # Verlet staleness: exact pair criterion (max1 + max2 > skin)
        d = pos - ref_positions
        d2 = jnp.sum(d * d, axis=-1)
        m1 = jnp.max(d2)
        m2 = jnp.max(
            jnp.where(jnp.arange(d2.shape[0]) == jnp.argmax(d2), 0.0, d2)
        )
        stale = stale | (jnp.sqrt(m1) + jnp.sqrt(m2) > skin)

        return (pos, vel, f, pe, vir, dt, alpha, n_pos, stale), None

    carry0 = (
        state.positions,
        state.velocities,
        state.forces,
        state.potential_energy,
        state.virial,
        aux.dt,
        aux.alpha,
        aux.n_pos,
        jnp.zeros((), bool),
    )
    (pos, vel, f, pe, vir, dt, alpha, n_pos, stale), _ = jax.lax.scan(
        one, carry0, None, length=n_steps
    )
    state = dataclasses.replace(
        template,
        positions=pos,
        velocities=vel,
        forces=f,
        potential_energy=pe,
        virial=vir,
        step=template.step + n_steps,
    )
    return state, FireAux(dt=dt, alpha=alpha, n_pos=n_pos), stale


@partial(
    jax.jit,
    static_argnames=(
        "sim", "grid", "max_neighbors", "n_steps", "refresh",
        "dt_max", "dt_min", "alpha0", "n_delay", "f_inc", "f_dec",
        "f_alpha", "dmax",
    ),
)
def _fire_block(
    sim,
    state: MDState,
    aux: FireAux,
    *,
    grid: tuple,
    max_neighbors: int,
    n_steps: int,
    refresh: bool,
    dt_max: float,
    dt_min: float,
    alpha0: float,
    n_delay: int,
    f_inc: float,
    f_dec: float,
    f_alpha: float,
    dmax: float,
):
    """One minimization block: rebuild + `n_steps` FIRE iterations.

    Mirrors ``Simulation.block``/``_scan_with_nl``.
    """
    from mtp_jax.md import integrators as itg

    nl = sim.rebuild(state, grid=grid, max_neighbors=max_neighbors)
    force_fn = sim._force_fn_for(nl, state)
    if refresh:
        state = itg._with_forces(state, force_fn)
    state, aux, stale = _fire_scan(
        state, aux, force_fn, ref_positions=nl.reference_positions,
        n_steps=n_steps, skin=sim.skin, dt_max=dt_max, dt_min=dt_min,
        alpha0=alpha0, n_delay=n_delay, f_inc=f_inc, f_dec=f_dec,
        f_alpha=f_alpha, dmax=dmax,
    )
    fmax = jnp.sqrt(jnp.max(jnp.sum(state.forces * state.forces, axis=-1)))
    return state, aux, nl.overflow, stale, fmax


def fire_minimize(
    sim,
    state: MDState,
    *,
    ftol: float = 1e-3,
    etol: float = 0.0,
    max_steps: int = 2000,
    dt0: float = None,
    dt_max: float = None,
    dt_min: float = 0.0,
    alpha0: float = 0.1,
    n_delay: int = 5,
    f_inc: float = 1.1,
    f_dec: float = 0.5,
    f_alpha: float = 0.99,
    dmax: float = 0.1,
    dt_ref: float = 0.001,
    observer=None,
):
    """Relax ``state`` with FIRE 2.0 using ``sim``'s neighbor/force engine.

    Args:
      sim: a :class:`~mtp_jax.md.simulation.Simulation` (its
        ``max_neighbors``/``skin``/``steps_per_rebuild``/backend govern the
        blocks, with the same overflow-grow / staleness-halve recovery as
        ``Simulation.run``).
      ftol: stop when max per-atom |F| < ftol [eV/A] (0 disables).
      etol: stop when |dE| < etol * |E| across a block (0 disables).
      max_steps: FIRE iteration budget.
      dt0/dt_max/dt_min: initial/max/min FIRE timestep [ps]; defaults
        dt0=dt_ref, dt_max=10*dt_ref (LAMMPS ``timestep``-relative
        defaults).
      dmax: per-iteration cap on any atom's displacement [A].
      observer: optional host callback ``observer(state)`` per block.

    Returns (state, :class:`MinimizeResult`). Velocities in the returned
    state are zeroed (minimization consumes them as internal mixing state).
    """
    if dt0 is None:
        dt0 = dt_ref
    if dt_max is None:
        dt_max = 10.0 * dt_ref
    check_cell(
        np.asarray(jax.device_get(state.cell)), sim.model.cutoff + sim.skin
    )
    dtype = state.positions.dtype
    state = dataclasses.replace(state, velocities=jnp.zeros_like(state.velocities))
    aux = fire_init(dt0, alpha0, dtype)
    fire_kw = dict(
        dt_max=float(dt_max), dt_min=float(dt_min), alpha0=float(alpha0),
        n_delay=int(n_delay), f_inc=float(f_inc), f_dec=float(f_dec),
        f_alpha=float(f_alpha), dmax=float(dmax),
    )
    done = 0
    refresh = True
    prev_e = None
    fmax_h = float("inf")
    reason = "maxiter"
    converged = False
    while done < max_steps:
        k = min(sim.steps_per_rebuild, max_steps - done)
        grid = grid_shape(
            np.asarray(jax.device_get(state.cell)),
            (sim.model.cutoff + sim.skin) * sim.grid_margin,
        )
        new_state, new_aux, overflow, stale, fmax = _fire_block(
            sim, state, aux,
            grid=grid, max_neighbors=sim.max_neighbors, n_steps=k,
            refresh=refresh, **fire_kw,
        )
        if bool(overflow):
            if sim.max_neighbors >= 1024:
                raise RuntimeError(
                    "neighbor overflow persists at max_neighbors="
                    f"{sim.max_neighbors} during minimization: not a "
                    "list-width problem. Check the bin geometry and the "
                    "structure for overlapping atoms."
                )
            sim.max_neighbors = int(sim.max_neighbors * 1.5) + 8
            refresh = True  # block discarded; forces must be recomputed
            continue
        if bool(stale):
            if sim.steps_per_rebuild <= 1:
                raise RuntimeError(
                    "Verlet staleness at steps_per_rebuild=1 during "
                    f"minimization: an atom moved > skin/2 ({sim.skin / 2:.3f}"
                    " A) in one FIRE iteration. Lower dmax/dt_max or "
                    "increase the skin."
                )
            sim.steps_per_rebuild = max(1, sim.steps_per_rebuild // 2)
            refresh = True
            continue
        state, aux = new_state, new_aux
        refresh = False
        done += k
        if observer is not None:
            observer(state)
        fmax_h = float(jax.device_get(fmax))
        e_h = float(jax.device_get(state.potential_energy))
        if ftol > 0.0 and fmax_h < ftol:
            converged, reason = True, "ftol"
            break
        if etol > 0.0 and prev_e is not None and abs(e_h - prev_e) < etol * abs(e_h):
            converged, reason = True, "etol"
            break
        prev_e = e_h
    state = dataclasses.replace(
        state, velocities=jnp.zeros_like(state.velocities)
    )
    result = MinimizeResult(
        converged=converged,
        iterations=done,
        fmax=fmax_h,
        potential_energy=float(jax.device_get(state.potential_energy)),
        stop_reason=reason,
    )
    return state, result
