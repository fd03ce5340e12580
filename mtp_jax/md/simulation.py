"""Simulation driver: couples the MTP model, the neighbor engine, and an
integrator into a jitted `lax.scan` time loop.

Replaces the LAMMPS Verlet driver the reference plugs into (SURVEY.md §2.2).
Structure: a loop over *blocks*; each block rebuilds the neighbor list once,
then runs `steps_per_rebuild` integrator steps with the frozen list (a
Verlet-list cadence with skin). Three drivers:

* `run`        — host loop, per-block overflow check + observer hook.
* `run_async`  — throughput path: rebuild and step-scan dispatched as
                 separate async calls, one host sync at the end.
* `run_fused`  — everything (all blocks) in ONE compiled program.
"""

from __future__ import annotations

import dataclasses
from functools import partial


import jax
import jax.numpy as jnp
import numpy as np

from mtp_jax.md import integrators as itg
from mtp_jax.md.state import MDState
from mtp_jax.models.mtp import MTPModel, _gather_scalar, mtp_energy_forces
from mtp_jax.ops.neighbors import build_neighbor_list, check_cell, grid_shape


@dataclasses.dataclass
class RunFlags:
    """Distinct failure flags of an async run (device bool scalars).

    `overflow` = neighbor/bin capacity or bin-grid geometry
    exceeded — grow `max_neighbors` (or rebuild the grid). `stale` = an
    atom outran the Verlet skin mid-block — shorten `steps_per_rebuild`
    (growing capacity would not help). `bool(flags)` is the OR, so callers
    that only want a pass/fail check keep working.
    """

    overflow: object
    stale: object

    def __bool__(self) -> bool:
        return bool(self.overflow) or bool(self.stale)


@dataclasses.dataclass(eq=False)
class Simulation:
    """Host-side controller for single-chip MD.

    Args:
      model: the MTP model.
      max_neighbors: padded neighbor width J (auto-grown on overflow).
      skin: Verlet skin [A]; neighbor lists are built at cutoff+skin.
      steps_per_rebuild: inner steps per neighbor rebuild.
    """

    model: MTPModel
    max_neighbors: int = 64
    skin: float = 0.5
    steps_per_rebuild: int = 10
    remat: bool = True
    backend: str = "auto"  # see models.mtp.mtp_energy_forces
    # per-step virial tally (LAMMPS vflag analog). Required for NPT/pressure
    # observables; turn off for pure-NVE throughput.
    compute_virial: bool = True
    # bin-grid safety margin: bins are sized >= grid_margin*(cutoff+skin), so
    # an NPT cell can shrink by (grid_margin-1) before the static grid needs
    # recomputing (the geometry-overflow flag trips past that).
    grid_margin: float = 1.0

    def _force_fn_for(self, nl, state, *, ensemble="nve"):
        cv = self.compute_virial or ensemble.startswith("npt")
        return self.force_fn(
            nl.idx, nl.mirror, compute_virial=cv, types=state.types
        )

    def force_fn(self, nbr_idx, nbr_mirror=None, compute_virial=None, types=None):
        sched = self.model.schedule
        coeffs = self.model.coeffs
        cv = self.compute_virial if compute_virial is None else compute_virial
        # precompute everything that depends only on (types, nbr_idx): XLA
        # does not hoist the jtypes gather out of the step scan (see the
        # mtp_energy_forces docstring)
        jtypes = pair_valid = None
        if types is not None:
            jtypes = _gather_scalar(types, nbr_idx)
            n = nbr_idx.shape[0]
            pair_valid = nbr_idx != jnp.arange(n, dtype=nbr_idx.dtype)[:, None]

        def fn(positions, types, cell):
            out = mtp_energy_forces(
                sched,
                coeffs,
                positions,
                types,
                nbr_idx,
                cell,
                nbr_mirror,
                jtypes=jtypes,
                pair_valid=pair_valid,
                remat=self.remat,
                backend=self.backend,
                compute_virial=cv,
            )
            return out["forces"], out["energy"], out["virial"]

        return fn

    # ---- one block: rebuild + K steps, all on device ----

    @partial(
        jax.jit,
        static_argnames=("self", "grid", "max_neighbors"),
    )
    def rebuild(self, state: MDState, *, grid: tuple, max_neighbors: int):
        """Neighbor rebuild as its own dispatch, separate from the step
        scan."""
        return build_neighbor_list(
            state.positions,
            state.cell,
            self.model.cutoff + self.skin,
            max_neighbors=max_neighbors,
            grid=grid,
            with_reverse=True,
        )

    @partial(jax.jit, static_argnames=("self", "ensemble"))
    def refresh_forces(self, state: MDState, nl, *, ensemble: str = "nve"):
        force_fn = self._force_fn_for(nl, state, ensemble=ensemble)
        return itg._with_forces(state, force_fn)

    @partial(
        jax.jit,
        static_argnames=(
            "self",
            "ensemble",
            "n_steps",
            "grid",
            "max_neighbors",
            "refresh",
        ),
    )
    def block(
        self,
        state: MDState,
        aux,
        *,
        grid: tuple,
        max_neighbors: int,
        ensemble: str = "nve",
        n_steps: int = 10,
        dt: float = 0.001,
        temperature: float = 300.0,
        pressure: float = 0.0,
        tdamp: float = 0.1,
        pdamp: float = 1.0,
        refresh: bool = False,
    ):
        nl = build_neighbor_list(
            state.positions,
            state.cell,
            self.model.cutoff + self.skin,
            max_neighbors=max_neighbors,
            grid=grid,
            with_reverse=True,
        )
        # refresh: incoming forces are stale/zero (first block after init or
        # after an overflow retry); recompute. Otherwise the forces carried
        # from the previous block's last step are position-consistent.
        state, aux, stale = self._scan_with_nl(
            state,
            aux,
            nl,
            refresh=refresh,
            ensemble=ensemble,
            n_steps=n_steps,
            dt=dt,
            temperature=temperature,
            pressure=pressure,
            tdamp=tdamp,
            pdamp=pdamp,
        )
        return state, aux, nl.overflow, stale

    def _scan_with_nl(self, state, aux, nl, *, refresh=False, **kw):
        """Run the step scan against a frozen list.
        Returns (state, aux, stale)."""
        force_fn = self._force_fn_for(nl, state, ensemble=kw["ensemble"])
        if refresh:
            state = itg._with_forces(state, force_fn)
        return self._scan_steps(
            state, aux, force_fn,
            ref_positions=nl.reference_positions,
            ref_cell=nl.reference_cell,
            **kw,
        )

    def _scan_steps(
        self,
        state,
        aux,
        force_fn,
        *,
        ensemble,
        n_steps,
        dt,
        temperature,
        pressure,
        tdamp,
        pdamp,
        ref_positions=None,
        ref_cell=None,
    ):
        # types/masses never change during the scan: close over them instead
        # of carrying them, so XLA hoists loop-invariant work (notably the
        # (N, J) jtypes gather) out of the loop
        template = state
        # Verlet-list staleness (LAMMPS `neigh_modify check yes` semantics),
        # OR-accumulated and reported like the overflow flag so long rebuild
        # intervals are safe, not silent. Under a barostat the cell's affine
        # rescaling moves edge atoms ~0.01*L per percent of volume ringing
        # WITHOUT invalidating lists, so the check measures the NON-AFFINE
        # displacement (vs the cell-rescaled reference) and adds a shrink
        # term: a pair just outside cutoff+skin enters the cutoff when
        # 2*max_disp + (1 - s_min)*(cutoff+skin) exceeds the skin.
        cut_skin = self.model.cutoff + self.skin
        if ref_positions is not None and ref_cell is not None:
            inv_ref = jnp.linalg.inv(ref_cell)
            # unrolled products: a (N,3)@(3,3) matmul at default precision
            # may round f32 operands (TF32), an error at coordinate scale
            # that false-trips the staleness flag (same reason
            # minimum_image unrolls)
            ref_frac = jnp.stack(
                [
                    ref_positions[:, 0] * inv_ref[0, a]
                    + ref_positions[:, 1] * inv_ref[1, a]
                    + ref_positions[:, 2] * inv_ref[2, a]
                    for a in range(3)
                ],
                axis=-1,
            )
            ref_widths = 1.0 / jnp.linalg.norm(inv_ref, axis=1)

        def one(carry, _):
            pos, vel, f, cell, pe, vir, step, stale, aux = carry
            state = dataclasses.replace(
                template,
                positions=pos,
                velocities=vel,
                forces=f,
                cell=cell,
                potential_energy=pe,
                virial=vir,
                step=step,
            )
            if ensemble == "nve":
                state = itg.nve_step(state, force_fn, dt)
            elif ensemble == "nvt":
                state, aux = itg.nvt_step(state, aux, force_fn, dt, temperature, tdamp)
            elif ensemble == "npt":
                state, aux = itg.npt_step(
                    state, aux, force_fn, dt, temperature, pressure, tdamp, pdamp
                )
            elif ensemble in ("npt-aniso", "npt-tri"):
                state, aux = itg.npt_aniso_step(
                    state, aux, force_fn, dt, temperature, pressure, tdamp,
                    pdamp, couple="tri" if ensemble == "npt-tri" else "aniso",
                )
            elif ensemble == "langevin":
                state, aux = itg.langevin_step(
                    state, aux, force_fn, dt, temperature, tdamp
                )
            else:
                raise ValueError(f"unknown ensemble {ensemble}")
            if ref_positions is not None and ref_cell is not None:
                scaled_ref = jnp.stack(
                    [
                        ref_frac[:, 0] * state.cell[0, a]
                        + ref_frac[:, 1] * state.cell[1, a]
                        + ref_frac[:, 2] * state.cell[2, a]
                        for a in range(3)
                    ],
                    axis=-1,
                )
                d = state.positions - scaled_ref
                d2 = jnp.sum(d * d, axis=-1)
                # exact pair criterion: a missing pair (i, j) enters the
                # cutoff only if d_i + d_j >= skin for DISTINCT atoms, so
                # the bound is max1 + max2 (two largest), not 2*max1 —
                # the flag trips on the extreme-value TAIL over N atoms,
                # and the second max sits measurably below the first
                m1 = jnp.max(d2)
                m2 = jnp.max(
                    jnp.where(jnp.arange(d2.shape[0]) == jnp.argmax(d2), 0.0, d2)
                )
                widths = 1.0 / jnp.linalg.norm(jnp.linalg.inv(state.cell), axis=1)
                s_min = jnp.min(widths / ref_widths)
                budget = (
                    jnp.sqrt(m1) + jnp.sqrt(m2)
                    + jnp.maximum(0.0, 1.0 - s_min) * cut_skin
                )
                stale = stale | (budget > self.skin)
            out = (
                state.positions,
                state.velocities,
                state.forces,
                state.cell,
                state.potential_energy,
                state.virial,
                state.step,
                stale,
                aux,
            )
            return out, None

        carry0 = (
            state.positions,
            state.velocities,
            state.forces,
            state.cell,
            state.potential_energy,
            state.virial,
            state.step,
            jnp.zeros((), bool),
            aux,
        )
        (pos, vel, f, cell, pe, vir, step, stale, aux), _ = jax.lax.scan(
            one, carry0, None, length=n_steps
        )
        state = dataclasses.replace(
            template,
            positions=pos,
            velocities=vel,
            forces=f,
            cell=cell,
            potential_energy=pe,
            virial=vir,
            step=step,
        )
        return state, aux, stale

    @partial(
        jax.jit,
        static_argnames=("self", "ensemble", "n_steps"),
    )
    def steps(
        self,
        state: MDState,
        aux,
        nl,
        *,
        ensemble: str = "nve",
        n_steps: int = 10,
        dt: float = 0.001,
        temperature: float = 300.0,
        pressure: float = 0.0,
        tdamp: float = 0.1,
        pdamp: float = 1.0,
    ):
        """`n_steps` integrator steps with a frozen neighbor list (no rebuild
        in-graph — pairs with :meth:`rebuild` for the async fast path).

        Returns (state, aux, stale): `stale` is a device bool set if any atom
        moved > skin/2 since the list build (the block's physics can no
        longer be trusted — rebuild more often)."""
        return self._scan_with_nl(
            state,
            aux,
            nl,
            ensemble=ensemble,
            n_steps=n_steps,
            dt=dt,
            temperature=temperature,
            pressure=pressure,
            tdamp=tdamp,
            pdamp=pdamp,
        )

    def run_async(
        self,
        state: MDState,
        n_steps: int,
        *,
        ensemble: str = "nve",
        dt: float = 0.001,
        temperature: float = 300.0,
        pressure: float = 0.0,
        tdamp: float = 0.1,
        pdamp: float = 1.0,
        aux=None,
        return_nl: bool = False,
        refresh: bool = True,
    ):
        """Throughput path: rebuild and step-scan dispatched as separate async
        calls, forces carried across blocks (no redundant refresh), one host
        sync at the end. Constant-cell ensembles only.

        Returns (state, aux, flags) — `flags` is a :class:`RunFlags` of
        device scalars; check after syncing. ``bool(flags)`` is the OR of
        both conditions; `flags.overflow` means capacity/geometry (grow
        `max_neighbors`), `flags.stale` means an atom moved > skin/2 within
        a block (shorten `steps_per_rebuild` — capacity would not help).
        A tripped run is flagged, never silently wrong. NPT is allowed: the
        bin grid is chosen from the initial cell and the builder flags
        `overflow` if the cell shrinks past the grid's validity.
        """
        if aux is None:
            aux = _default_aux(ensemble, state)
        cell_h = np.asarray(jax.device_get(state.cell))
        check_cell(cell_h, self.model.cutoff + self.skin)
        grid = grid_shape(
            cell_h,
            (self.model.cutoff + self.skin) * self.grid_margin,
        )
        kw = dict(
            ensemble=ensemble,
            dt=dt,
            temperature=temperature,
            pressure=pressure,
            tdamp=tdamp,
            pdamp=pdamp,
        )
        overflow = None
        stale_any = jnp.zeros((), bool)
        done = 0
        # refresh=False trusts incoming state.forces to be position-
        # consistent (e.g. refreshed by a fused grade evaluation)
        first = refresh
        nl = None
        while done < n_steps:
            k = min(self.steps_per_rebuild, n_steps - done)
            nl = self.rebuild(state, grid=grid, max_neighbors=self.max_neighbors)
            overflow = nl.overflow if overflow is None else (overflow | nl.overflow)
            if first:
                state = self.refresh_forces(state, nl, ensemble=ensemble)
                first = False
            state, aux, stale = self.steps(state, aux, nl, n_steps=k, **kw)
            stale_any = stale_any | stale
            done += k
        flags = RunFlags(overflow=overflow, stale=stale_any)
        if return_nl:
            # the final block's list: valid for the returned state (within
            # the skin, provided flags are clear) — lets AL grade steps
            # skip their own rebuild (driver.run_with_extrapolation)
            return state, aux, flags, nl
        return state, aux, flags

    # ---- fully on-device run: scan over blocks, no host sync ----

    @partial(
        jax.jit,
        static_argnames=(
            "self",
            "ensemble",
            "n_blocks",
            "steps_per_block",
            "grid",
            "max_neighbors",
        ),
    )
    def run_fused(
        self,
        state: MDState,
        aux,
        *,
        grid: tuple,
        max_neighbors: int,
        n_blocks: int,
        steps_per_block: int,
        ensemble: str = "nve",
        dt: float = 0.001,
        temperature: float = 300.0,
        pressure: float = 0.0,
        tdamp: float = 0.1,
        pdamp: float = 1.0,
    ):
        """`n_blocks` x (neighbor rebuild + steps_per_block steps) as ONE
        compiled program. Overflow flags are OR-reduced and returned at the
        end (caller re-runs with more capacity if set). Under NPT the bin
        grid comes from the initial cell; the builder flags overflow if the
        cell shrinks past the grid's validity."""

        def one_block(carry, _):
            state, aux, ovf = carry
            state, aux, o, stale = self.block(
                state,
                aux,
                grid=grid,
                max_neighbors=max_neighbors,
                ensemble=ensemble,
                n_steps=steps_per_block,
                dt=dt,
                temperature=temperature,
                pressure=pressure,
                tdamp=tdamp,
                pdamp=pdamp,
            )
            return (state, aux, ovf | o | stale), None

        (state, aux, overflow), _ = jax.lax.scan(
            one_block,
            (state, aux, jnp.zeros((), bool)),
            None,
            length=n_blocks,
        )
        return state, aux, overflow

    # ---- host loop with overflow handling ----

    def run(
        self,
        state: MDState,
        n_steps: int,
        *,
        ensemble: str = "nve",
        dt: float = 0.001,
        temperature: float = 300.0,
        pressure: float = 0.0,
        tdamp: float = 0.1,
        pdamp: float = 1.0,
        aux=None,
        observer=None,
        refresh: bool = True,
    ):
        """Run `n_steps`, growing the neighbor capacity on overflow.

        `observer(state)` is called after every block (host-side; use for
        thermo output / dumps / active-learning hooks).

        `refresh=False` trusts the incoming ``state.forces`` to be
        position-consistent (e.g. refreshed by a fused grade evaluation) and
        skips the first block's redundant force recomputation; later blocks
        carry forces from the previous block's last step, which are always
        consistent.
        """
        if aux is None:
            aux = _default_aux(ensemble, state)
        check_cell(
            np.asarray(jax.device_get(state.cell)), self.model.cutoff + self.skin
        )
        done = 0
        while done < n_steps:
            k = min(self.steps_per_rebuild, n_steps - done)
            grid = grid_shape(
                np.asarray(jax.device_get(state.cell)),
                (self.model.cutoff + self.skin) * self.grid_margin,
            )
            new_state, new_aux, overflow, stale = self.block(
                state,
                aux,
                grid=grid,
                max_neighbors=self.max_neighbors,
                ensemble=ensemble,
                n_steps=k,
                dt=dt,
                temperature=temperature,
                pressure=pressure,
                tdamp=tdamp,
                pdamp=pdamp,
                refresh=refresh,
            )
            if bool(overflow):
                if self.max_neighbors >= 1024:
                    # ~7 doublings have not cleared the flag: the overflow
                    # is not list-width capacity (bin density vs the bin
                    # table / compacted fat-row width, geometry, or a
                    # collapsing system) — growing J forever just recompiles
                    # with ever-larger shapes
                    raise RuntimeError(
                        "neighbor overflow persists at max_neighbors="
                        f"{self.max_neighbors}: not a list-width problem. "
                        "Check bin_capacity vs the local density, the grid "
                        "geometry, and the system for collapse/overlap."
                    )
                # discard the block and retry with more capacity
                self.max_neighbors = int(self.max_neighbors * 1.5) + 8
                continue
            if bool(stale):
                if self.steps_per_rebuild <= 1:
                    # rebuilding every step and STILL an atom outran the
                    # skin: the simulation is diverging (or the skin is far
                    # too small). Retrying identically would hang the host
                    # loop forever — fail loudly instead.
                    raise RuntimeError(
                        "Verlet staleness at steps_per_rebuild=1: an atom "
                        f"moved > skin/2 ({self.skin / 2:.3f} A) in a single "
                        f"dt={dt} step. The system is diverging or the skin "
                        "is too small — check dt/forces or increase skin."
                    )
                # an atom outran the Verlet skin mid-block: discard and retry
                # with a shorter rebuild interval (sticky for this run)
                self.steps_per_rebuild = max(1, self.steps_per_rebuild // 2)
                continue
            state, aux = new_state, new_aux
            done += k
            if observer is not None:
                observer(state)
        return state, aux

    def minimize(self, state: MDState, **kw):
        """FIRE 2.0 relaxation (LAMMPS ``minimize`` analog) on this
        simulation's neighbor/force engine — see
        :func:`mtp_jax.md.minimize.fire_minimize` for the knobs."""
        from mtp_jax.md.minimize import fire_minimize

        return fire_minimize(self, state, **kw)


def _default_aux(ensemble, state):
    dtype = state.positions.dtype
    if ensemble == "nvt":
        return itg.nhc_init(dtype)
    if ensemble == "npt":
        return itg.npt_init(dtype)
    if ensemble in ("npt-aniso", "npt-tri"):
        return itg.npt_aniso_init(dtype)
    if ensemble == "langevin":
        return itg.LangevinAux(jax.random.PRNGKey(0))
    return 0


def make_lattice(
    kind: str,
    a: float,
    reps,
    *,
    type_pattern=(0,),
    dtype=np.float64,
):
    """Simple crystal builder (replaces LAMMPS `lattice`/`create_atoms`).

    kind: 'sc' | 'bcc' | 'fcc'. `reps` = (nx, ny, nz) unit cells.
    Returns (positions (N,3), types (N,), cell (3,3)).
    """
    basis = {
        "sc": [(0, 0, 0)],
        "bcc": [(0, 0, 0), (0.5, 0.5, 0.5)],
        "fcc": [(0, 0, 0), (0.5, 0.5, 0), (0.5, 0, 0.5), (0, 0.5, 0.5)],
    }[kind]
    nx, ny, nz = reps
    pts = []
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                for b in basis:
                    pts.append(((i + b[0]) * a, (j + b[1]) * a, (k + b[2]) * a))
    pos = np.asarray(pts, dtype=dtype)
    types = np.array(
        [type_pattern[i % len(type_pattern)] for i in range(len(pos))],
        dtype=np.int32,
    )
    cell = np.diag([nx * a, ny * a, nz * a]).astype(dtype)
    return pos, types, cell
