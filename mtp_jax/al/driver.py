"""Active-learning driver: extrapolation-grade evaluation during MD, with the
reference's two observation styles and two-threshold selection semantics.

* LAMMPS style (reference README.md:60-82): grades computed every N steps on
  request; per-atom grades and the scalar max grade are exposed as observables
  (the analog of `fix pair` / `compute pair`; values are stale between
  evaluations, as documented there).
* MLIP-3 style (reference README.md:84-97): grades every evaluation; if
  max_grade >= select_threshold the configuration is appended to the
  preselected ``.cfg`` stream; if >= break_threshold the stream is flushed and
  the run is terminated (flush-before-break contract,
  pair_mtp_extrapolation.cpp:387-397).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from mtp_jax.al.grades import candidates_and_forces, cfg_grade, nbh_grades
from mtp_jax.io.cfg_file import CfgWriter
from mtp_jax.md.simulation import Simulation
from mtp_jax.md.state import MDState
from mtp_jax.models.mtp import MTPModel
from mtp_jax.ops.neighbors import build_neighbor_list, check_cell, grid_shape


class BreakThresholdExceeded(RuntimeError):
    """Raised when max grade exceeds the break threshold (run terminated)."""

    def __init__(self, max_grade: float):
        super().__init__(
            f"Exceeded Break Threshold: {max_grade:.5f}. Terminating simulation."
        )
        self.max_grade = max_grade


@dataclasses.dataclass(eq=False)
class ExtrapolationMonitor:
    """Evaluates grades for a configuration and applies selection semantics.

    Observables (mirroring extract_peratom/pvector,
    pair_mtp_extrapolation.cpp:624-652): `.max_grade` (scalar) and
    `.nbh_grades` (per-atom array; neighborhood mode only). Stale between
    evaluations by design.
    """

    model: MTPModel
    select_threshold: Optional[float] = None
    break_threshold: Optional[float] = None
    output_path: Optional[str] = None
    max_neighbors: int = 64

    # device-side observables: materialized lazily on access (the LAMMPS
    # contract is stale-between-evals anyway, and each synchronous
    # device->host read stalls the dispatch queue). MLIP-3 style syncs
    # eagerly (thresholds need the value).
    _max_grade_dev: object = 0.0
    _nbh_grades_dev: object = None
    _writer: Optional[CfgWriter] = None

    def __post_init__(self):
        if self.model.inverse_active_set is None:
            raise ValueError(
                "model has no MVS selection state; load a .mtp with an MVS "
                "trailer or build one with mtp_jax.al.maxvol.build_mvs"
            )
        if self.output_path is not None:
            self._writer = CfgWriter(self.output_path)

    @property
    def mlip3_style(self) -> bool:
        return self.select_threshold is not None

    @property
    def max_grade(self) -> float:
        if not isinstance(self._max_grade_dev, float):
            self._max_grade_dev = float(self._max_grade_dev)
        return self._max_grade_dev

    @max_grade.setter
    def max_grade(self, v):
        self._max_grade_dev = v

    @property
    def nbh_grades(self) -> Optional[np.ndarray]:
        if self._nbh_grades_dev is not None and not isinstance(
            self._nbh_grades_dev, np.ndarray
        ):
            self._nbh_grades_dev = np.asarray(self._nbh_grades_dev)
        return self._nbh_grades_dev

    @nbh_grades.setter
    def nbh_grades(self, v):
        self._nbh_grades_dev = v

    def evaluate(self, state: MDState, *, refresh_forces: bool = False, nl=None):
        """Compute grades for the current configuration; apply thresholds.

        The forward pass is SHARED between forces and candidate vectors
        (candidates_and_forces — the reference's grade-step fusion,
        ComputeAlphaBasicRad pair_mtp_extrapolation_kokkos.cpp:780-907).
        With ``refresh_forces=True`` returns ``(grade, state)`` with
        forces/energy refreshed from that same pass, so a driver pays ~one
        evaluation per grade step instead of two.

        `nl`: optional existing :class:`NeighborList` with its mirror,
        built at >= cutoff (e.g. the Simulation's current Verlet list):
        skips the per-eval rebuild. The beyond-cutoff (skin) pairs are
        masked by the candidate path; the caller is responsible for the
        Verlet guarantee (an unflagged simulation block provides it).

        Returns the grade as a DEVICE scalar unless thresholds are set
        (MLIP-3 style syncs eagerly — the break decision needs the value).
        ``float()`` it, or read ``.max_grade``, to materialize; keeping it
        lazy saves a fused AL loop two host round-trips per evaluation.
        """
        out = self._compute(state, nl)
        return self._commit(out, state, refresh_forces=refresh_forces)

    def _compute(self, state: MDState, nl=None) -> dict:
        """PURE device half of :meth:`evaluate`: dispatches the grade
        computation, touches no monitor state, applies no thresholds.
        Drivers dispatch this BEFORE syncing run flags (the device computes
        the grades while the host waits for the flags) and `_commit` only
        the accepted segments."""
        model = self.model
        if nl is None:
            cutoff = model.cutoff
            cell_h = np.asarray(jax.device_get(state.cell))
            check_cell(cell_h, cutoff)
            grid = grid_shape(cell_h, cutoff)
            # a truncated neighbor list would silently UNDERESTIMATE grades —
            # the one failure mode this subsystem exists to prevent — so grow
            # the capacity until the build fits
            while True:
                nl = build_neighbor_list(
                    state.positions,
                    state.cell,
                    cutoff,
                    max_neighbors=self.max_neighbors,
                    grid=grid,
                    with_reverse=True,
                )
                if not bool(nl.overflow):
                    break
                self.max_neighbors = int(self.max_neighbors * 1.5) + 8

        out = candidates_and_forces(
            model.schedule, model.coeffs, state.positions, state.types,
            nl.idx, state.cell, nl.mirror,
        )
        b = out["b"]
        if model.configuration_mode:
            g = cfg_grade(b, model.inverse_active_set, state.n_atoms)
            grades = None
        else:
            grades = nbh_grades(b, model.inverse_active_set)
            g = jnp.max(grades)
        return dict(
            forces=out["forces"], energy=out["energy"], max_grade=g,
            grades=grades, virial=out["virial"],
        )

    def _commit(self, out: dict, state: MDState, *, refresh_forces: bool):
        """Host half of :meth:`evaluate`: store the observables (lazily),
        apply MLIP-3 thresholds (the one host sync), optionally return the
        state with forces/energy refreshed from the shared pass."""
        self.nbh_grades = out["grades"]  # device; materialized on access
        self.max_grade = out["max_grade"]  # device scalar; lazy float()
        g = out["max_grade"]
        if self.mlip3_style:
            # thresholds need the value NOW — this is the one host sync
            g = self.max_grade
            self._apply_thresholds(state)
        if refresh_forces:
            # the virial is refreshed too (LAMMPS fills it on every compute), so a
            # barostatted AL run starts each segment fully consistent
            extra = {}
            if out.get("virial") is not None:
                extra["virial"] = out["virial"]
            new_state = dataclasses.replace(
                state,
                forces=out["forces"],
                potential_energy=out["energy"],
                **extra,
            )
            return g, new_state
        return g

    def _apply_thresholds(self, state: MDState):
        if self._writer is not None and self.max_grade >= self.select_threshold:
            self._writer.write(
                np.asarray(state.cell),
                np.asarray(state.positions),
                np.asarray(state.types),
                grades=None if self.model.configuration_mode else self.nbh_grades,
                max_grade=self.max_grade,
            )
        if (
            self.break_threshold is not None
            and self.max_grade >= self.break_threshold
        ):
            # flush-before-break: no selected configuration may be lost
            if self._writer is not None:
                self._writer.close()
            raise BreakThresholdExceeded(self.max_grade)

    def close(self):
        if self._writer is not None:
            self._writer.close()


@dataclasses.dataclass(eq=False)
class ShardedExtrapolationMonitor:
    """Multi-chip extrapolation monitor: grade collectives over the mesh,
    ordered gather to the host for the preselected stream.

    The mesh analog of the reference's MPI grade pipeline
    (compile_grades MPI_Allreduce + MPI_Scan global ids + rank-0 Send/Recv
    funnel into write_config, pair_mtp_extrapolation.cpp:363-479): `psum`/
    `pmax` over the mesh, then an id-ordered host gather feeds the same
    CfgWriter with the flush-before-break contract.

    Two evaluation paths:

    * **sharded engine** — ``evaluate(sstate, sim=sharded_sim, ctx=ctx)``
      runs the fused candidates evaluation rank-local inside the
      simulation's existing neighbor context (``ShardedSimulation.grade_eval``): no
      second rebuild pipeline, and the shared pass refreshes forces/energy
      (``refresh_forces=True``). This is the reference's design point —
      grades inside the same device pipeline as forces
      (pair_mtp_extrapolation_kokkos.cpp:408-497).
    * **standalone** — ``evaluate(sstate)`` builds its own halo shell +
      neighbor list per call (`make_sharded_grades`); for grading arbitrary
      states outside an MD run. Regrows capacity on overflow.
    """

    model: MTPModel
    mesh: object
    capacity: int
    grid: tuple
    n_atoms: int
    max_neighbors: int = 64
    halo_capacity: Optional[int] = None
    select_threshold: Optional[float] = None
    break_threshold: Optional[float] = None
    output_path: Optional[str] = None

    # device-side observables, materialized lazily on access (same contract
    # and rationale as ExtrapolationMonitor above: stale-between-evals is
    # the LAMMPS semantics, and an eager sync + host gather per eval is
    # exactly the per-eval cost the fused path avoids). The gather
    # snapshot stays consistent because the pending tuple holds the
    # ShardedState REFERENCE from evaluation time — JAX arrays are
    # immutable, so later migration produces a new state object and cannot
    # disturb the snapshot's ids/real/grades pairing.
    _max_grade_dev: object = 0.0
    _nbh_pending: object = None  # (grades_dev, sstate) | np.ndarray | None
    _writer: Optional[CfgWriter] = None
    _grades_fn: object = None

    def __post_init__(self):
        if self.model.inverse_active_set is None:
            raise ValueError("model has no MVS selection state")
        if self.output_path is not None:
            self._writer = CfgWriter(self.output_path)

    @property
    def max_grade(self) -> float:
        if not isinstance(self._max_grade_dev, float):
            self._max_grade_dev = float(self._max_grade_dev)
        return self._max_grade_dev

    @max_grade.setter
    def max_grade(self, v):
        self._max_grade_dev = v

    @property
    def nbh_grades(self) -> Optional[np.ndarray]:
        if isinstance(self._nbh_pending, tuple):
            grades, snap = self._nbh_pending
            self._nbh_pending = snap.gather(grades, self.n_atoms)
        return self._nbh_pending

    @nbh_grades.setter
    def nbh_grades(self, v):
        self._nbh_pending = v

    def _build_fn(self):
        from mtp_jax.parallel.sharded_md import make_sharded_grades

        self._grades_fn = make_sharded_grades(
            self.model,
            self.mesh,
            capacity=self.capacity,
            max_neighbors=self.max_neighbors,
            grid=self.grid,
            halo_capacity=self.halo_capacity,
        )

    @property
    def mlip3_style(self) -> bool:
        return self.select_threshold is not None

    def evaluate(self, sstate, *, sim=None, ctx=None, refresh_forces=False):
        """Grades for a ShardedState; thresholds as in the single-chip
        monitor. With `sim`/`ctx` (a :class:`ShardedSimulation` and the ctx
        from its last `rebuild`) the fused evaluation runs instead of the
        standalone pipeline; ``refresh_forces=True`` then returns
        ``(grade, state)`` with forces/energy refreshed from the shared
        pass."""
        out = self._compute(sstate, sim=sim, ctx=ctx)
        return self._commit(out, sstate, refresh_forces=refresh_forces)

    def _compute(self, sstate, sim=None, ctx=None) -> dict:
        """PURE device half: dispatches the grade computation, touches no
        monitor state, applies no thresholds (drivers dispatch this before
        syncing run flags — the speculative-dispatch pattern)."""
        if sim is not None:
            if ctx is None:
                raise ValueError(
                    "sharded-engine evaluation needs the block ctx from "
                    "sim.rebuild"
                )
            return sim.grade_eval(sstate, ctx)
        if self._grades_fn is None:
            self._build_fn()
        # standalone path regrows on overflow eagerly (wrong grades are the
        # one unacceptable failure mode here)
        while True:
            gmax, grades, flags = self._grades_fn(sstate)
            if not bool(flags):
                break
            self.max_neighbors = int(self.max_neighbors * 1.5) + 8
            self.halo_capacity = self.capacity  # max out the shell too
            self._build_fn()
        return dict(max_grade=gmax, grades=grades, forces=None, energy=None)

    def _commit(self, out: dict, sstate, *, refresh_forces=False):
        """Host half: store observables, apply MLIP-3 thresholds,
        optionally return the state with forces/energy refreshed.

        Observables stay on device (lazy properties) unless thresholds are
        set — MLIP-3 style needs the value for the select/break decision;
        plain monitoring (no thresholds) pays no sync and no host gather.
        The pending snapshot pins THIS sstate so a later migration cannot
        desynchronize ids/real from the grades."""
        g = out["max_grade"]
        self.max_grade = g
        if self.model.configuration_mode:
            self.nbh_grades = None
        else:
            self.nbh_grades = (out["grades"], sstate)
        if self.mlip3_style:
            g = self.max_grade  # eager sync: thresholds need the value
            self._apply_thresholds(sstate)
        if refresh_forces:
            if out.get("forces") is None:
                raise ValueError(
                    "standalone evaluation has no force refresh; pass "
                    "sim/ctx for the fused sharded evaluation"
                )
            extra = {}
            if out.get("virial") is not None:
                extra["virial"] = out["virial"]
            new_state = dataclasses.replace(
                sstate,
                forces=out["forces"],
                potential_energy=out["energy"],
                **extra,
            )
            return g, new_state
        return g

    def _apply_thresholds(self, sstate):
        if self._writer is not None and self.max_grade >= self.select_threshold:
            self._writer.write(
                np.asarray(jax.device_get(sstate.cell)),
                sstate.gather(sstate.positions, self.n_atoms),
                sstate.gather(sstate.types, self.n_atoms),
                grades=self.nbh_grades,
                max_grade=self.max_grade,
            )
        if (
            self.break_threshold is not None
            and self.max_grade >= self.break_threshold
        ):
            if self._writer is not None:
                self._writer.close()
            raise BreakThresholdExceeded(self.max_grade)

    def close(self):
        if self._writer is not None:
            self._writer.close()


def run_with_extrapolation(
    sim: Simulation,
    monitor: ExtrapolationMonitor,
    state: MDState,
    n_steps: int,
    *,
    al_every: int = 1,
    observer=None,
    **run_kwargs,
):
    """MD with periodic grade evaluation (the `fix pair N ... extrapolation 1`
    pattern, reference README.md:70-76).

    Grade-step economics match the reference's on-device AL pipeline
    (ComputeAlphaBasicRad, pair_mtp_extrapolation_kokkos.cpp:780-907):

    * the grade evaluation REUSES the simulation's current Verlet list
      (no per-eval rebuild — the list is valid within the skin whenever the
      preceding block's flags are clear), and
    * SHARES its forward pass with the force refresh
      (candidates_and_forces), so the next MD segment starts from the
      forces the grade step already computed.

    Retries a segment with grown capacity / halved rebuild interval on
    overflow / staleness (the `Simulation.run` contract).

    Returns the final state; raises :class:`BreakThresholdExceeded` in MLIP-3
    style when the break threshold is hit (stream flushed first).
    """
    done = 0
    aux = None
    _, state = monitor.evaluate(state, refresh_forces=True)
    while done < n_steps:
        k = min(al_every, n_steps - done)
        while True:
            new_state, new_aux, flags, nl = sim.run_async(
                state, k, aux=aux, return_nl=True, refresh=False,
                **run_kwargs,
            )
            # speculative grade dispatch BEFORE the flag sync: the device
            # computes the grades while the host waits for the flags. The
            # computation is pure (_compute touches no monitor state, writes
            # no cfg, raises no break), so a tripped segment just discards
            # it and retries.
            pending = monitor._compute(new_state, nl=nl)
            # ONE device->host transfer for both flags
            ovf, stale = jax.device_get((flags.overflow, flags.stale))
            if bool(ovf):
                sim.max_neighbors = int(sim.max_neighbors * 1.5) + 8
                continue
            if bool(stale):
                if sim.steps_per_rebuild <= 1:
                    raise RuntimeError(
                        "Verlet staleness at steps_per_rebuild=1 during AL "
                        "run: system diverging or skin too small"
                    )
                sim.steps_per_rebuild = max(1, sim.steps_per_rebuild // 2)
                continue
            break
        done += k
        _, state = monitor._commit(pending, new_state, refresh_forces=True)
        aux = new_aux
        if observer is not None:
            observer(state, monitor)
    return state


def run_sharded_with_extrapolation(
    sim,
    monitor: ShardedExtrapolationMonitor,
    sstate,
    n_steps: int,
    *,
    al_every: int = 1,
    observer=None,
    **run_kwargs,
):
    """Multi-device MD with periodic grade evaluation on the sharded engine:
    the sharded analog of :func:`run_with_extrapolation`.

    Grade-step economics match the reference's rank-local device AL pipeline
    (pair_mtp_extrapolation_kokkos.cpp:408-497 + the MPI collectives
    …cpp:363-382):

    * the grade evaluation REUSES the segment's last block context
      (``ShardedSimulation.grade_eval``: neighbor lists, halo selections
      and pair constants; no second rebuild pipeline),
    * it SHARES its forward pass with the force refresh, so the next
      segment starts from the forces the grade step computed
      (``refresh=False`` carrying), and
    * the grade dispatch is SPECULATIVE: it is queued before the host
      reads the segment's flags; a tripped segment discards it,
      applies the recovery policy (``ShardedSimulation._recover``), and
      retries.

    `sim.model` must carry the MVS selection state (grade_eval reads
    ``sim.model.inverse_active_set``).

    All ensembles are supported, matching the reference (a LAMMPS pair
    style runs under any fix — `fix npt` + `fix pair ... extrapolation`
    included): the fused grade pass tallies the virial alongside forces
    and energy (LAMMPS fills the virial on every compute), so every
    refresh leaves a fully consistent state for the barostat.

    Returns the final ShardedState; raises :class:`BreakThresholdExceeded`
    in MLIP-3 style when the break threshold is hit (stream flushed first).
    """
    state, ctx, f4 = sim.rebuild(sstate)
    flags0 = jax.device_get(f4)
    if any(bool(f) for f in flags0):
        sim._recover((*flags0, False))
        state, ctx, f4 = sim.rebuild(sstate)
        if any(bool(f) for f in jax.device_get(f4)):
            raise RuntimeError("initial sharded rebuild keeps tripping flags")
    out = monitor._compute(state, sim=sim, ctx=ctx)
    _, state = monitor._commit(out, state, refresh_forces=True)
    done = 0
    while done < n_steps:
        k = min(al_every, n_steps - done)
        while True:
            prev = state
            cur = state
            inner = 0
            segflags = None
            stale_acc = None
            while inner < k:
                b = min(sim.steps_per_rebuild, k - inner)
                cur, ctx, f4 = sim.rebuild(cur)
                cur, stale = sim.steps(cur, ctx, b, refresh=False, **run_kwargs)
                segflags = (
                    f4
                    if segflags is None
                    else tuple(a | b_ for a, b_ in zip(segflags, f4))
                )
                stale_acc = stale if stale_acc is None else (stale_acc | stale)
                inner += b
            # speculative grade dispatch BEFORE the flag sync: the devices
            # compute the grades while the host waits for the flags.
            # _compute is pure (no monitor state, no cfg write, no break),
            # so a tripped segment just discards it.
            pending = monitor._compute(cur, sim=sim, ctx=ctx)
            *flags, cell_h = jax.device_get((*segflags, stale_acc, prev.cell))
            if any(bool(f) for f in flags):
                sim._recover(tuple(flags), cell=cell_h)
                state = prev
                continue
            break
        done += k
        _, state = monitor._commit(pending, cur, refresh_forces=True)
        if observer is not None:
            observer(state, monitor)
    return state
