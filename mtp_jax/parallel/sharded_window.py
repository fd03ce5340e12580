"""Multi-device MD on bin-sorted neighbor lists with rank-local XLA forces.

Each shard runs the single-device force path (`mtp_energy_forces`: the
moments under `jax.vjp`, then the flat mirror gather for Newton's third law)
on its local + ghost view, the design point of the reference, whose Kokkos
kernel pipeline runs unchanged on each MPI rank's local+ghost view
(pair_mtp_kokkos.cpp:287-361).

Structure (two separate dispatches per Verlet block):

* `rebuild`: migrate atoms whose shard changed -> face-shell halo selection
  -> position/type/real exchange (ring ppermute) -> bin-sorted neighbor
  build over the halo-EXTENDED set (ghost rows get neighbor rows too, so
  the mirror permutation sees a symmetric list) -> rebuild-constant pair
  tables (neighbor types, center-masked pair validity).
* `steps`: a `lax.scan` of integrator steps (NVE / NHC-NVT / iso-MTK NPT /
  aniso+triclinic MTK NPT; the tensor-barostat reductions psum over the
  mesh like the scalar ones); each force evaluation is two (H, 3)
  ppermutes per mesh axis (ghost positions in, ghost force contributions
  out) around :func:`mtp_energy_forces`.

Decomposition: 1-D slabs on a 1-axis mesh, or 2-D bricks on a 2-axis mesh
(the LAMMPS brick analog, lifting the slab device cap of
box_width/(cutoff+skin)). The 2-D halo runs as two stages: axis-0 face
shells first, then axis-1 face shells of the axis-0-EXTENDED set, so corner
ghosts ride the second hop; the force give-back reverses both hops (a
stage-1 return may add into a stage-0 ghost row, which then forwards to the
diagonal owner). Migration re-homes diagonal movers in two per-axis hops
inside one rebuild.

Ghost centers are masked out of the compute (`center_ok`): a ghost's
neighborhood is incomplete (the halo is one cutoff+skin deep), so its site
energy and pair derivatives are not computable locally; its owner computes
them and receives the mirrored contributions instead. Cross-shard Newton
give-back (LAMMPS reverse comm, pair_mtp.cpp:248-254) is then just the
ghost-row slice of the force array: masked ghost rows accumulate exactly
-sum_j t_{j->ghost} from own-centered pairs, which ppermutes back to the
owner and adds on.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from mtp_jax.al.grades import candidates_and_forces, nbh_grades
from mtp_jax.md import integrators as itg
from mtp_jax.models.mtp import (
    MTPModel,
    _gather_rows3,
    _gather_scalar,
    mtp_energy_forces,
)
from mtp_jax.ops.neighbors import build_sorted_neighbor_list, grid_shape
from mtp_jax.parallel.sharded_md import (
    ShardedState,
    _exchange,
    _halo_select,
    _migrate,
)
from mtp_jax.utils import units


class ShardedRunFlags(NamedTuple):
    """Replicated device-bool flags of a sharded run."""

    neighbor_overflow: jax.Array  # list/bin capacity or geometry
    halo_overflow: jax.Array  # face-shell selection exceeded halo capacity
    migrate_overflow: jax.Array  # migration buffers / free slots exceeded
    escape: jax.Array  # an atom jumped past the adjacent slab in one block
    stale: jax.Array  # an atom outran the Verlet skin mid-block

    def any(self):
        return (
            self.neighbor_overflow
            | self.halo_overflow
            | self.migrate_overflow
            | self.escape
            | self.stale
        )


@dataclasses.dataclass(eq=False)
class ShardedSimulation:
    """Host-side controller for multi-device MD.

    The per-atom arrays of :class:`ShardedState` are (nd*capacity, ...),
    sharded along the mesh axis. Both drivers are a host loop of (rebuild
    dispatch, steps dispatch) per Verlet block: `run_async` mirrors
    `Simulation.run_async` (no per-block sync; flags accumulate on device,
    check once at the end — the throughput path), `run` mirrors
    `Simulation.run` (one flag sync per block, tripped blocks discarded
    and retried after growing the relevant capacity).
    """

    model: MTPModel
    mesh: object
    capacity: int
    max_neighbors: int
    grid: tuple
    skin: float = 0.5
    steps_per_rebuild: int = 10
    # int: stage-0 shell capacity; tuple: per-stage; None: maximal defaults
    # (each stage's shell is a subset of its source rows, so the defaults
    # are always sufficient but memory-hungry on 2-D meshes)
    halo_capacity: Optional[object] = None
    migrate_capacity: Optional[int] = None
    slab_axis: int = 0  # cell vector of mesh axis 0
    slab_axis2: int = 1  # cell vector of mesh axis 1 (2-D brick meshes)
    compute_virial: bool = False

    def __post_init__(self):
        mesh = self.mesh
        self.axes = tuple(mesh.axis_names)
        self.sizes = tuple(mesh.devices.shape)
        self.nd = mesh.devices.size
        if len(self.axes) == 1:
            self.slab_axes = (self.slab_axis,)
        elif len(self.axes) == 2:
            # 2-D brick decomposition (LAMMPS brick analog): halo exchange
            # runs as two stages — x-face shells first, then y-face shells
            # of the x-EXTENDED set (corner ghosts ride the second hop, and
            # the force give-back reverses both hops)
            if self.slab_axis2 == self.slab_axis:
                raise ValueError("slab_axis2 must differ from slab_axis")
            self.slab_axes = (self.slab_axis, self.slab_axis2)
        else:
            raise ValueError("mesh must have 1 or 2 axes")
        self.w_cut = self.model.cutoff + self.skin
        self._reconfigure()

    def _reconfigure(self):
        """Re-derive capacity-dependent geometry and drop compiled programs.

        Called from ``__post_init__`` and again by :meth:`run`'s recovery
        policy after growing `max_neighbors` / `halo_capacity` /
        `migrate_capacity` (shapes change, so every cached jitted program is
        invalid)."""
        C = self.capacity
        self.E = (
            self.migrate_capacity
            if self.migrate_capacity is not None
            else max(8, C // 8)
        )
        # one comm stage per mesh axis: stage k ships the face shells of
        # the stage-(k-1)-extended set along mesh axis k
        hc = self.halo_capacity
        self.stages = []
        src = C
        for k, (ax, nk) in enumerate(zip(self.axes, self.sizes)):
            if nk <= 1:
                hk = 0
            elif hc is None:
                hk = src  # maximal: the shell is a subset of the source
            elif isinstance(hc, tuple):
                hk = hc[k]
            else:
                hk = hc if k == 0 else src
            self.stages.append(dict(
                axis=ax, nd=nk, H=hk, slab_axis=self.slab_axes[k],
                base=src,
                perm_fwd=[(i, (i + 1) % nk) for i in range(nk)],
                perm_bwd=[(i, (i - 1) % nk) for i in range(nk)],
            ))
            src += 2 * hk
        self.H = self.stages[0]["H"]
        self.NE = src
        ncells = int(np.prod(self.grid))
        # each shard's extended set is a SUBSET of the global atom set per
        # bin (ghosts are other shards' atoms at their original coords), so
        # the single-chip uniform-density cap applies; overflow is flagged
        self.bin_cap = max(1, int(np.ceil(2.2 * self.nd * C / ncells))) + 12
        self._rebuild_fn = None
        self._steps_cache = {}
        self._grade_fn = None

    # ------------------------------------------------------ comm helpers
    # (per-stage wrappers of the sharded_md primitives; a 1-axis mesh has
    # one stage and reduces exactly to the previous slab behavior)

    def _exchange_multi(self, x, sels, fill):
        for st, (sr, vr, sl, vl) in zip(self.stages, sels):
            x = _exchange(
                x, sr, vr, sl, vl, fill, H=st["H"], axis=st["axis"],
                nd=st["nd"], perm_fwd=st["perm_fwd"], perm_bwd=st["perm_bwd"],
            )
        return x

    def _giveback_multi(self, f_ext, sels):
        """Reverse the halo hops: ghost-row force contributions return to
        their owners stage by stage (a stage-1 return may add into a
        stage-0 ghost row — the two-hop corner give-back)."""
        for st, (sr, vr, sl, vl) in reversed(list(zip(self.stages, sels))):
            base, h = st["base"], st["H"]
            low = f_ext[:base]
            if st["nd"] > 1 and h > 0:
                back_r = jax.lax.ppermute(
                    f_ext[base : base + h], st["axis"], st["perm_bwd"]
                )
                back_l = jax.lax.ppermute(
                    f_ext[base + h : base + 2 * h], st["axis"], st["perm_fwd"]
                )
                low = low.at[sr].add(jnp.where(vr[:, None], back_r, 0.0))
                low = low.at[sl].add(jnp.where(vl[:, None], back_l, 0.0))
            f_ext = low
        return f_ext

    def _sels_from_ctx(self, ctx):
        return [
            (ctx[f"sel_r{k}"], ctx[f"val_r{k}"],
             ctx[f"sel_l{k}"], ctx[f"val_l{k}"])
            for k in range(len(self.stages))
        ]

    # ------------------------------------------------------------ rebuild

    def _make_rebuild(self):
        C, NE = self.capacity, self.NE
        grid, w_cut = self.grid, self.w_cut
        bin_cap = self.bin_cap
        axes = self.axes
        stages = self.stages

        def rebuild_shard(pos, vel, f, types, masses, real, ids, cell):
            inv_cell = jnp.linalg.inv(cell)
            mig_ovf = escape = jnp.zeros((), bool)
            # migrate along each mesh axis in turn (a diagonal/corner mover
            # re-homes in two hops within this one rebuild)
            for st in stages:
                (pos, vel, f, types, masses, real, ids), (mo, esc) = _migrate(
                    pos, vel, f, types, masses, real, ids, inv_cell,
                    E=self.E, slab_axis=st["slab_axis"], axis=st["axis"],
                    nd=st["nd"], perm_fwd=st["perm_fwd"],
                    perm_bwd=st["perm_bwd"],
                )
                mig_ovf = mig_ovf | mo
                escape = escape | esc
            # staged halo selection: stage k selects face shells of the
            # stage-(k-1)-extended set (corner ghosts ride stage 1)
            sels = []
            halo_ovf = jnp.zeros((), bool)
            cur_pos, cur_real = pos, real
            for st in stages:
                kw = dict(
                    H=st["H"], axis=st["axis"], nd=st["nd"],
                    perm_fwd=st["perm_fwd"], perm_bwd=st["perm_bwd"],
                )
                sr, vr, sl, vl, ho = _halo_select(
                    cur_pos, cur_real, inv_cell,
                    w_cut=w_cut, slab_axis=st["slab_axis"], **kw,
                )
                halo_ovf = halo_ovf | ho
                sels.append((sr, vr, sl, vl))
                cur_pos = _exchange(
                    cur_pos, sr, vr, sl, vl, jnp.asarray(0.0, pos.dtype), **kw
                )
                cur_real = _exchange(cur_real, sr, vr, sl, vl, False, **kw)
            ext_pos, ext_real = cur_pos, cur_real
            ext_types = self._exchange_multi(
                types, sels, jnp.asarray(0, types.dtype)
            )
            swl = build_sorted_neighbor_list(
                ext_pos, cell, w_cut,
                max_neighbors=self.max_neighbors, grid=grid,
                real=ext_real, bin_capacity=bin_cap,
            )
            # rebuild-constant pair tables in sorted space; only own real
            # rows are centers (ghost neighborhoods are incomplete)
            own_mask = (jnp.arange(NE) < C) & ext_real
            center_ok = own_mask[swl.order]
            types_s = ext_types[swl.order]
            rows = jnp.arange(NE, dtype=swl.idx.dtype)
            ctx = dict(
                order=swl.order, inv_order=swl.inv_order, idx=swl.idx,
                mirror=swl.mirror, types_s=types_s, center_ok=center_ok,
                jtypes=_gather_scalar(types_s, swl.idx).astype(types_s.dtype),
                pair_valid=(swl.idx != rows[:, None]) & center_ok[:, None],
            )
            for k, (sr, vr, sl, vl) in enumerate(sels):
                ctx[f"sel_r{k}"] = sr
                ctx[f"val_r{k}"] = vr
                ctx[f"sel_l{k}"] = sl
                ctx[f"val_l{k}"] = vl
            flags = (
                jax.lax.pmax(swl.overflow, axes),
                jax.lax.pmax(halo_ovf, axes),
                jax.lax.pmax(mig_ovf, axes),
                jax.lax.pmax(escape, axes),
            )
            return (pos, vel, f, types, masses, real, ids), ctx, flags

        axis_p = P(self.axes)
        ctx_specs = {k: axis_p for k in self._ctx_keys()}
        sharded = jax.shard_map(
            rebuild_shard,
            mesh=self.mesh,
            in_specs=(axis_p,) * 7 + (P(),),
            out_specs=(
                (axis_p,) * 7,
                ctx_specs,
                (P(), P(), P(), P()),
            ),
            check_vma=False,
        )
        return jax.jit(sharded)

    def rebuild(self, state: ShardedState):
        """Migration + halo selection + neighbor build as one
        dispatch. Returns (state, ctx, flags4)."""
        if self._rebuild_fn is None:
            self._rebuild_fn = self._make_rebuild()
        (pos, vel, f, types, masses, real, ids), ctx, flags = self._rebuild_fn(
            state.positions, state.velocities, state.forces, state.types,
            state.masses, state.real, state.ids, state.cell,
        )
        state = dataclasses.replace(
            state, positions=pos, velocities=vel, forces=f, types=types,
            masses=masses, real=real, ids=ids,
        )
        return state, ctx, flags

    # -------------------------------------------------------------- steps

    def _make_steps(self, key):
        (ensemble, n_steps, dt, temperature, pressure, tdamp, pdamp,
         refresh) = key
        axes = self.axes
        aniso = ensemble in ("npt-aniso", "npt-tri")
        couple = "tri" if ensemble == "npt-tri" else "aniso"
        cv = self.compute_virial or ensemble == "npt" or aniso
        cut_skin = self.w_cut
        skin = self.skin
        half = 0.5 * dt * units.FTM2A

        def steps_shard(pos, vel, f, masses, real, cell, thermo, pe_in, vir_in, ctx):
            dtype = pos.dtype
            sels = self._sels_from_ctx(ctx)

            def force_eval(pos, cell):
                ext_pos = self._exchange_multi(pos, sels, jnp.asarray(0.0, dtype))
                out = self._local_forces(ext_pos, cell, ctx, cv)
                # ghost rows hold -sum_j t_{j->ghost}: ship back to the
                # owner stage by stage and ADD (the cross-shard Newton
                # give-back; LAMMPS reverse comm analog)
                fo = self._giveback_multi(out["forces"], sels)
                pe = jax.lax.psum(out["energy"], axes)
                vir = jax.lax.psum(out["virial"], axes)
                return fo, pe, vir

            mass_col = masses[:, None]
            n_total = jax.lax.psum(jnp.sum(real), axes)
            ndof = 3.0 * n_total
            kt = units.KB * temperature
            q1 = ndof * kt * tdamp**2
            q2 = kt * tdamp**2
            p_ext = pressure / units.EVA3_TO_BAR
            w_b, qb1, qb2 = itg._npt_masses(ndof, kt, tdamp, pdamp)
            # aniso/tri MTK: the barostat momentum is a symmetric tensor
            # (Voigt-6 in thermo[8:14]); n_modes thermostatted modes
            n_modes = 6 if couple == "tri" else 3
            qb1_a = n_modes * qb1

            def ke2_of(vel):
                return jax.lax.psum(
                    jnp.sum(
                        jnp.where(real[:, None], mass_col * vel * vel, 0.0)
                    )
                    * units.MVV2E,
                    axes,
                )

            def nhc_half(vel, xi, eta):
                scale, xi, eta = itg._nhc_chain_half(
                    ke2_of(vel), ndof, xi, eta, dt, kt, q1=q1, q2=q2
                )
                return vel * scale, xi, eta

            def baro_chain_half(bv, bxi, beta):
                scale, bxi, beta = itg._nhc_chain_half(
                    w_b * bv**2, 1.0, bxi, beta, dt, kt, q1=qb1, q2=qb2
                )
                return bv * scale, bxi, beta

            def omega_dot_half(vel, vir, cell, bv):
                return itg.mtk_iso_omega_half(
                    bv,
                    vol=jnp.abs(jnp.linalg.det(cell)),
                    w_tr=vir[0] + vir[1] + vir[2],
                    ke2=ke2_of(vel),
                    dt=dt, ndof=ndof, p_ext=p_ext, w_b=w_b,
                )

            # ---- aniso/tri MTK pieces (tensor barostat, Voigt-6 state):
            # the SAME mtk_* functions as integrators.npt_aniso_step with
            # the two reductions (KE tensor, KE) psum'd over shards
            def baro_chain_half_a(bv6, bxi, beta):
                sumsq = jnp.sum(bv6[:3] * bv6[:3]) + 2.0 * jnp.sum(
                    bv6[3:] * bv6[3:]
                )
                scale, bxi, beta = itg._nhc_chain_half(
                    w_b * sumsq, n_modes, bxi, beta, dt, kt, q1=qb1_a, q2=qb2
                )
                return bv6 * scale, bxi, beta

            def omega_dot_half_a(vel, vir, cell, bv6):
                bv = itg.mtk_aniso_omega_half(
                    itg._voigt_to_tensor(bv6),
                    mvv=jax.lax.psum(
                        itg.mtk_ke_tensor(vel, mass_col, real), axes
                    ),
                    vir6=vir,
                    vol=jnp.abs(jnp.linalg.det(cell)),
                    ke2=ke2_of(vel),
                    dt=dt, ndof=ndof, p_ext=p_ext, w_b=w_b, couple=couple,
                )
                return itg._tensor_to_voigt(bv)

            def v_press_half_a(vel, bv6):
                alpha = itg.mtk_aniso_vscale(
                    itg._voigt_to_tensor(bv6), dt, ndof
                )
                return itg._xm3(vel, alpha)

            # Verlet-staleness reference (non-affine displacement + shrink
            # term, same criterion as Simulation._scan_steps)
            ref_pos, ref_cell = pos, cell
            inv_ref = jnp.linalg.inv(ref_cell)
            ref_frac = jnp.stack(
                [
                    ref_pos[:, 0] * inv_ref[0, a]
                    + ref_pos[:, 1] * inv_ref[1, a]
                    + ref_pos[:, 2] * inv_ref[2, a]
                    for a in range(3)
                ],
                axis=-1,
            )
            ref_widths = 1.0 / jnp.linalg.norm(inv_ref, axis=1)

            def staleness(pos, cell, stale):
                scaled_ref = jnp.stack(
                    [
                        ref_frac[:, 0] * cell[0, a]
                        + ref_frac[:, 1] * cell[1, a]
                        + ref_frac[:, 2] * cell[2, a]
                        for a in range(3)
                    ],
                    axis=-1,
                )
                d = pos - scaled_ref
                d2 = jnp.where(real, jnp.sum(d * d, axis=-1), 0.0)
                # exact pair criterion (max1 + max2 over distinct atoms, as
                # in the single-chip scan), with the top-2 combined across
                # shards: the global second max is the pmax of each shard's
                # runner-up candidate, or max1 itself if two shards tie at
                # the global max
                m1 = jnp.max(d2)
                m2 = jnp.max(
                    jnp.where(jnp.arange(d2.shape[0]) == jnp.argmax(d2), 0.0, d2)
                )
                g1 = jax.lax.pmax(m1, axes)
                ties = jax.lax.psum((m1 == g1).astype(jnp.int32), axes)
                cand = jnp.where(m1 == g1, m2, m1)
                g2 = jnp.where(ties > 1, g1, jax.lax.pmax(cand, axes))
                widths = 1.0 / jnp.linalg.norm(jnp.linalg.inv(cell), axis=1)
                s_min = jnp.min(widths / ref_widths)
                budget = (
                    jnp.sqrt(g1) + jnp.sqrt(g2)
                    + jnp.maximum(0.0, 1.0 - s_min) * cut_skin
                )
                return stale | (budget > skin)

            if refresh:
                f0, pe0, vir0 = force_eval(pos, cell)
            else:
                # carried forces/pe/virial from the previous block's last
                # step are position-consistent (the new list contains every
                # in-cutoff pair the old one did) — no redundant refresh
                f0, pe0, vir0 = f, pe_in, vir_in

            def one(carry, _):
                pos, vel, f, cell, pe, vir, th, stale = carry
                xi, eta = th[:2], th[2:4]
                bxi, beta, bv = th[4:6], th[6:8], th[8]
                bv6 = th[8:14]
                if ensemble in ("nvt", "npt") or aniso:
                    vel, xi, eta = nhc_half(vel, xi, eta)
                if ensemble == "npt":
                    bv, bxi, beta = baro_chain_half(bv, bxi, beta)
                    bv = omega_dot_half(vel, vir, cell, bv)
                    alpha = itg.mtk_iso_vscale(bv, dt, ndof)
                    vel = vel * alpha
                if aniso:
                    bv6, bxi, beta = baro_chain_half_a(bv6, bxi, beta)
                    bv6 = omega_dot_half_a(vel, vir, cell, bv6)
                    vel = v_press_half_a(vel, bv6)
                vel = vel + half * f / mass_col
                if ensemble == "npt":
                    # exact MTK position map (shared mtk_iso_maps)
                    s, d = itg.mtk_iso_maps(bv, dt)
                    pos = pos * s + dt * vel * d
                    cell = cell * s
                elif aniso:
                    # matrix analog of the exact iso map (mtk_aniso_maps)
                    e_full, d_mat = itg.mtk_aniso_maps(
                        itg._voigt_to_tensor(bv6), dt
                    )
                    pos = itg._xm3(pos, e_full) + dt * itg._xm3(vel, d_mat)
                    cell = itg._mm3(cell, e_full)
                else:
                    pos = pos + dt * vel
                f, pe, vir = force_eval(pos, cell)
                vel = vel + half * f / mass_col
                if ensemble == "npt":
                    vel = vel * alpha
                    bv = omega_dot_half(vel, vir, cell, bv)
                    bv, bxi, beta = baro_chain_half(bv, bxi, beta)
                if aniso:
                    vel = v_press_half_a(vel, bv6)
                    bv6 = omega_dot_half_a(vel, vir, cell, bv6)
                    bv6, bxi, beta = baro_chain_half_a(bv6, bxi, beta)
                if ensemble in ("nvt", "npt") or aniso:
                    vel, xi, eta = nhc_half(vel, xi, eta)
                stale = staleness(pos, cell, stale)
                if aniso:
                    th = jnp.concatenate([xi, eta, bxi, beta, bv6])
                else:
                    th = jnp.concatenate([xi, eta, bxi, beta, bv[None], th[9:]])
                return (pos, vel, f, cell, pe, vir, th, stale), None

            carry0 = (
                pos, vel, f0, cell, pe0, vir0, thermo, jnp.zeros((), bool)
            )
            (pos, vel, f, cell, pe, vir, thermo, stale), _ = jax.lax.scan(
                one, carry0, None, length=n_steps
            )
            return pos, vel, f, cell, pe, vir, thermo, jax.lax.pmax(stale, axes)

        axis_p = P(self.axes)
        ctx_specs = {k: axis_p for k in self._ctx_keys()}
        sharded = jax.shard_map(
            steps_shard,
            mesh=self.mesh,
            in_specs=(
                axis_p, axis_p, axis_p, axis_p, axis_p, P(), P(), P(), P(),
                ctx_specs,
            ),
            out_specs=(
                axis_p, axis_p, axis_p, P(), P(), P(), P(), P(),
            ),
            check_vma=False,
        )
        return jax.jit(sharded)

    def _ctx_keys(self):
        keys = [
            "order", "inv_order", "idx", "mirror", "types_s", "center_ok",
            "jtypes", "pair_valid",
        ]
        for k in range(len(self.stages)):
            keys += [f"sel_r{k}", f"val_r{k}", f"sel_l{k}", f"val_l{k}"]
        return keys

    def _local_forces(self, ext_pos, cell, ctx, compute_virial):
        """Rank-local energy/forces/virial on the halo-extended set: the
        single-device force path in sorted space, with ghost centers masked
        (their rows still collect the give-back of own-centered pairs).
        Returns forces in extended-set order."""
        sched, coeffs = self.model.schedule, self.model.coeffs
        out = mtp_energy_forces(
            sched, coeffs, _gather_rows3(ext_pos, ctx["order"]),
            ctx["types_s"], ctx["idx"], cell, ctx["mirror"],
            jtypes=ctx["jtypes"], pair_valid=ctx["pair_valid"],
            compute_virial=compute_virial,
        )
        return dict(
            forces=_gather_rows3(out["forces"], ctx["inv_order"]),
            energy=jnp.sum(
                jnp.where(ctx["center_ok"], out["site_energies"], 0.0)
            ),
            virial=out["virial"],
        )

    def steps(
        self, state: ShardedState, ctx, n_steps, *,
        ensemble="nve", dt=0.001, temperature=300.0, pressure=0.0,
        tdamp=0.1, pdamp=1.0, refresh=False,
    ):
        """`n_steps` integrator steps with the frozen block context, as one
        dispatch. Returns (state, stale)."""
        key = (
            ensemble, int(n_steps), float(dt), float(temperature),
            float(pressure), float(tdamp), float(pdamp), bool(refresh),
        )
        fn = self._steps_cache.get(key)
        if fn is None:
            fn = self._steps_cache[key] = self._make_steps(key)
        pos, vel, f, cell, pe, vir, thermo, stale = fn(
            state.positions, state.velocities, state.forces, state.masses,
            state.real, state.cell, state.thermo, state.potential_energy,
            state.virial, ctx,
        )
        state = dataclasses.replace(
            state, positions=pos, velocities=vel, forces=f, cell=cell,
            potential_energy=pe, virial=vir, thermo=thermo,
        )
        return state, stale

    # ---------------------------------------------------------- grade eval

    def _make_grade_eval(self):
        C = self.capacity
        model = self.model
        sched, coeffs = model.schedule, model.coeffs
        inv_a = model.inverse_active_set
        cfg_mode = model.configuration_mode
        axes = self.axes

        def grade_shard(pos, real, cell, ctx):
            dtype = pos.dtype
            sels = self._sels_from_ctx(ctx)
            ext_pos = self._exchange_multi(pos, sels, jnp.asarray(0.0, dtype))

            # ONE shared forward pass: forces, energy, virial and candidate
            # vectors, rank-local on the halo-extended set (the
            # ComputeAlphaBasicRad economics,
            # pair_mtp_extrapolation_kokkos.cpp:408-497, inside the same
            # device pipeline as the MD forces)
            own_s = ctx["center_ok"]
            out = candidates_and_forces(
                sched, coeffs, _gather_rows3(ext_pos, ctx["order"]),
                ctx["types_s"], ctx["idx"], cell, ctx["mirror"],
                row_valid=own_s,
            )
            # forces with the cross-shard Newton give-back, identical to the
            # step path's force_eval, so refreshed forces are exact
            f_ext = _gather_rows3(out["forces"], ctx["inv_order"])
            fo = self._giveback_multi(f_ext, sels)
            # ghost centers are masked (row_valid), so site energies are
            # nonzero on own rows only; the virial's own-centered half-shares
            # complete under the psum, exactly like the step path
            pe = jax.lax.psum(out["energy"], axes)
            vir = jax.lax.psum(out["virial"], axes)
            b = out["b"]

            # grade collectives (MPI_Allreduce SUM/MAX,
            # pair_mtp_extrapolation.cpp:363-382)
            if cfg_mode:
                bsum = jax.lax.psum(jnp.sum(b, axis=0), axes)
                n_total = jax.lax.psum(jnp.sum(real), axes)
                g = jnp.max(jnp.abs(jnp.matmul(
                    inv_a.astype(dtype), bsum,
                    precision=jax.lax.Precision.HIGHEST,
                ))) / jnp.maximum(n_total, 1)
                grades_own = jnp.zeros((C,), dtype)
            else:
                grades = jnp.where(own_s, nbh_grades(b, inv_a), 0.0)
                grades_own = _gather_scalar(grades, ctx["inv_order"])[:C]
                g = jax.lax.pmax(jnp.max(grades_own), axes)
            return fo, pe, vir, g, grades_own

        axis_p = P(self.axes)
        ctx_specs = {k: axis_p for k in self._ctx_keys()}
        sharded = jax.shard_map(
            grade_shard,
            mesh=self.mesh,
            in_specs=(axis_p, axis_p, P(), ctx_specs),
            out_specs=(axis_p, P(), P(), P(), axis_p),
            check_vma=False,
        )
        return jax.jit(sharded)

    def grade_eval(self, state: ShardedState, ctx):
        """Extrapolation grades + refreshed forces/energy as ONE dispatch,
        reusing the block's neighbor context (`ctx` from :meth:`rebuild`):
        no second rebuild pipeline. The rank-local candidates evaluation
        runs on the halo-extended set exactly like the step path's force
        evaluation; grades reduce with pmax/psum over the mesh.

        Valid whenever the block's Verlet guarantee holds (an unflagged
        segment provides it). Returns dict(forces (nd*C, 3) sharded, energy
        and virial (replicated), max_grade (replicated device scalar),
        grades ((nd*C,) sharded own-slot grades; zeros in configuration
        mode)).
        """
        if self.model.inverse_active_set is None:
            raise ValueError(
                "model has no MVS selection state; load a .mtp with an MVS "
                "trailer or build one with mtp_jax.al.maxvol.build_mvs"
            )
        if self._grade_fn is None:
            self._grade_fn = self._make_grade_eval()
        fo, pe, vir, g, grades = self._grade_fn(
            state.positions, state.real, state.cell, ctx
        )
        return dict(
            forces=fo, energy=pe, virial=vir, max_grade=g, grades=grades
        )

    # ---------------------------------------------------------------- run

    def run_async(
        self, state: ShardedState, n_steps, *,
        ensemble="nve", dt=0.001, temperature=300.0, pressure=0.0,
        tdamp=0.1, pdamp=1.0, refresh=True,
    ):
        """Throughput path: (rebuild, steps) per Verlet block with NO host
        sync; flags accumulated on device and returned as
        :class:`ShardedRunFlags` (check after a final sync;
        ``bool(flags.any())`` syncs). A tripped run is flagged, never
        silently wrong — use :meth:`run` for automatic recovery."""
        flags = None
        stale_any = jnp.zeros((), bool)
        done = 0
        first = refresh
        while done < n_steps:
            k = min(self.steps_per_rebuild, n_steps - done)
            state, ctx, f4 = self.rebuild(state)
            flags = (
                f4
                if flags is None
                else tuple(a | b for a, b in zip(flags, f4))
            )
            state, stale = self.steps(
                state, ctx, k, ensemble=ensemble, dt=dt,
                temperature=temperature, pressure=pressure, tdamp=tdamp,
                pdamp=pdamp, refresh=first,
            )
            first = False
            stale_any = stale_any | stale
            done += k
        if flags is None:
            flags = (jnp.zeros((), bool),) * 4
        return state, ShardedRunFlags(*flags, stale_any)

    def _recover(self, flags: tuple, cell=None) -> str:
        """Apply the recovery policy for a tripped block (the single-chip
        `Simulation.run` contract, md/simulation.py:750-771, extended to the
        sharded flag set). Returns a short description of the action; raises
        when no recovery can help."""
        nbr, halo, mig, esc, stale = (bool(f) for f in flags)
        if nbr and cell is not None:
            # the neighbor flag also covers bin GEOMETRY: under NPT the box
            # shrinks and a static grid's width/bins drops below the cutoff
            # (the single-chip driver re-derives the grid from the live cell
            # every block, md/simulation.py:744-747). Re-grid FIRST — growing
            # max_neighbors cannot fix geometry and recompiles ever-larger
            # programs for nothing.
            ng = grid_shape(np.asarray(cell), self.w_cut)
            if ng != tuple(self.grid):
                self.grid = ng
                self._reconfigure()
                return f"grid -> {ng} (cell changed)"
        if nbr:
            if self.max_neighbors >= 1024:
                # growing J has not cleared the flag across ~7 doublings:
                # the overflow is not neighbor-count capacity (likely bin
                # density vs bin_capacity, or a geometry violation) and no
                # amount of J can fix it — retrying forever would just
                # recompile with ever-larger shapes
                raise RuntimeError(
                    "neighbor overflow persists at max_neighbors="
                    f"{self.max_neighbors}: not a list-width problem. Check "
                    "bin_capacity vs the local density, the grid geometry, "
                    "and the system for collapse/overlap."
                )
            self.max_neighbors = int(self.max_neighbors * 1.5) + 8
            self._reconfigure()
            return f"max_neighbors -> {self.max_neighbors}"
        if halo:
            if self.halo_capacity is None:
                # already maximal (each stage's shell is a subset of its
                # source rows): the flag is _halo_select's geometric check —
                # a slab/brick thinner than 2*(cutoff+skin) — which no
                # capacity can fix
                raise RuntimeError(
                    "halo overflow with maximal halo capacity: a domain is "
                    "thinner than 2*(cutoff+skin). Use fewer chips along "
                    "that axis (max chips ~ box_width/(cutoff+skin))."
                )
            # maximal defaults: each stage's shell is a subset of its
            # source rows, so halo_capacity=None always suffices
            self.halo_capacity = None
            self._reconfigure()
            return f"halo_capacity -> max ({[st['H'] for st in self.stages]})"
        if mig:
            if self.E >= self.capacity:
                # migration buffers already cover every local slot: the
                # overflow is free-slot exhaustion — a shard's population
                # exceeds its fixed per-shard capacity
                raise RuntimeError(
                    "migration overflow with maximal buffers: a shard's "
                    "population exceeds its capacity "
                    f"({self.capacity}). Repartition with more headroom."
                )
            self.migrate_capacity = min(
                self.capacity, 2 * self.E + 8
            )
            self._reconfigure()
            return f"migrate_capacity -> {self.migrate_capacity}"
        # escape (an atom crossed two slab boundaries in one block) and
        # staleness both shrink with the block length
        kind = "escape" if esc else "staleness"
        if self.steps_per_rebuild <= 1:
            raise RuntimeError(
                f"{kind} at steps_per_rebuild=1: an atom moved too far in a "
                "single step. The system is diverging, the skin is too "
                "small, or the slabs are too thin — check dt/forces or "
                "increase skin/capacity."
            )
        self.steps_per_rebuild = max(1, self.steps_per_rebuild // 2)
        return f"steps_per_rebuild -> {self.steps_per_rebuild}"

    def run(
        self, state: ShardedState, n_steps, *,
        ensemble="nve", dt=0.001, temperature=300.0, pressure=0.0,
        tdamp=0.1, pdamp=1.0, refresh=True, observer=None,
    ):
        """Run `n_steps` with automatic recovery: one flag sync per Verlet
        block; a tripped block is DISCARDED and retried after growing the
        relevant capacity / halving the rebuild interval (the
        `Simulation.run` contract; LAMMPS would error out on neighbor
        overflow — here capacities are dynamic, so grow-and-retry replaces
        error-and-edit-the-script). Returns (state, flags) with all-clear
        flags; raises when recovery is impossible (diverging system at
        steps_per_rebuild=1).

        `observer(state)` runs after every committed block (host-side:
        thermo/dumps/AL hooks)."""
        done = 0
        first = refresh
        while done < n_steps:
            k = min(self.steps_per_rebuild, n_steps - done)
            prev = state
            new_state, ctx, f4 = self.rebuild(state)
            new_state, stale = self.steps(
                new_state, ctx, k, ensemble=ensemble, dt=dt,
                temperature=temperature, pressure=pressure, tdamp=tdamp,
                pdamp=pdamp, refresh=first,
            )
            # ONE device->host transfer for all five flags + the cell (the
            # cell rides along so geometry recovery can re-derive the grid)
            *flags, cell_h = jax.device_get((*f4, stale, prev.cell))
            if any(bool(f) for f in flags):
                self._recover(tuple(flags), cell=cell_h)
                state = prev  # discard the tripped block
                continue
            state = new_state
            first = False
            done += k
            if observer is not None:
                observer(state)
        zero = jnp.zeros((), bool)
        return state, ShardedRunFlags(zero, zero, zero, zero, zero)
