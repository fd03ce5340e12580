"""Multi-device MD: shard_map over a 1-D device mesh with ring halo exchange.

Device-mesh replacement for the reference's LAMMPS/MPI layer (SURVEY.md §2.3):

* spatial data parallelism -> atoms sharded along the mesh axis (slabs);
* LAMMPS atom exchange at reneighbor -> device-side migration: slab leavers
  are compacted into fixed-size buffers, ring-`ppermute`d to the adjacent
  shard, and merged into its padding slots (with escape/overflow flags);
* per-step ghost-position forward comm -> boundary-shell-only halos: only
  atoms within cutoff+skin of a slab face are shipped, two `ppermute`s of
  (H, 3) per step instead of whole slabs;
* Newton force give-back (LAMMPS reverse comm, pair_mtp.cpp:248-254 across
  ranks) -> mirror-permutation GATHERS: the halo-extended neighbor list is
  symmetric, so t_ji for shard-local pairs is a gather; contributions to
  ghosts are gathered per ghost row, summed, and ppermuted back to the owner
  (an (H, 3) message) — no large scatter anywhere;
* `MPI_Allreduce` of energies/grades -> `psum`/`pmax` over the mesh axis.

Model parameters are closed over (replicated), the analog of the reference's
`MPI_Bcast` of the model (pair_mtp.cpp:572-652).

Layout inside a shard: extended array ``[own (C) | from-left (H) | from-right
(H)]``; requires slab width >= cutoff + skin so adjacent slabs contain all
neighbors (and >= 2*(cutoff+skin) on a 2-device mesh, else the same atom
would be shipped to both faces of the single neighbor — flagged at runtime).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mtp_jax.models.mtp import MTPModel
from mtp_jax.ops.moments import site_energies
from mtp_jax.ops.neighbors import build_neighbor_list, mirror_permutation
from mtp_jax.parallel.domain import SlabPartition
from mtp_jax.utils import units


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "atoms") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise RuntimeError(
                f"need {n_devices} devices, have {len(devs)} "
                f"({devs[0].platform}); for CPU testing set "
                "jax.config.update('jax_platforms','cpu') and "
                "XLA_FLAGS=--xla_force_host_platform_device_count=N"
            )
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis_name,))


def make_mesh_2d(shape: tuple, axis_names: tuple = ("bx", "by")) -> Mesh:
    """(n0, n1) device mesh for 2-D brick decomposition (LAMMPS-brick
    analog; lifts the 1-D slab chip cap of box_width/(cutoff+skin))."""
    n0, n1 = shape
    devs = jax.devices()
    if len(devs) < n0 * n1:
        raise RuntimeError(
            f"need {n0 * n1} devices, have {len(devs)} ({devs[0].platform})"
        )
    return Mesh(np.array(devs[: n0 * n1]).reshape(n0, n1), axis_names)


class ShardFlags(NamedTuple):
    """Replicated error/overflow flags of a sharded block (all () bool)."""

    neighbor_overflow: jax.Array  # neighbor list / bin capacity exceeded
    halo_overflow: jax.Array  # face-shell selection exceeded halo capacity,
    # or (nd==2) an atom fell in both face shells
    migrate_overflow: jax.Array  # migration buffer / free slots exceeded
    escape: jax.Array  # an atom jumped PAST the adjacent slab in one block

    def any(self):
        return (
            self.neighbor_overflow
            | self.halo_overflow
            | self.migrate_overflow
            | self.escape
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ShardedState:
    """Per-atom arrays are (n_shards*capacity, ...), sharded on axis 0."""

    positions: jax.Array
    velocities: jax.Array
    forces: jax.Array
    types: jax.Array
    masses: jax.Array
    real: jax.Array
    ids: jax.Array  # int32 original atom index per slot (-1 = padding);
    # migrates with the atom, so host gathers stay valid after re-homing
    cell: jax.Array  # replicated
    potential_energy: jax.Array  # replicated scalar
    virial: jax.Array  # replicated (6,)
    # replicated integrator aux (9,): particle NHC [xi1, xi2, eta1, eta2],
    # barostat NHC [bxi1, bxi2, beta1, beta2], barostat strain rate [eps_dot]
    # (NVE uses none, NVT the first 4, NPT all 9)
    thermo: jax.Array

    @classmethod
    def from_partition(cls, part: SlabPartition, cell, mesh: Mesh, dtype=jnp.float32):
        # 1-D mesh: shard over the single axis; 2-D brick mesh: shard the
        # brick-major atom axis over BOTH mesh axes
        sh = NamedSharding(mesh, P(tuple(mesh.axis_names)))
        rep = NamedSharding(mesh, P())
        put = lambda a, s: jax.device_put(jnp.asarray(a), s)
        return cls(
            positions=put(jnp.asarray(part.positions, dtype), sh),
            velocities=put(jnp.asarray(part.velocities, dtype), sh),
            forces=put(jnp.zeros_like(jnp.asarray(part.positions, dtype)), sh),
            types=put(part.types, sh),
            masses=put(jnp.asarray(part.masses, dtype), sh),
            real=put(part.real, sh),
            ids=put(part.original_index.astype(np.int32), sh),
            cell=put(jnp.asarray(cell, dtype), rep),
            potential_energy=put(jnp.zeros((), dtype), rep),
            virial=put(jnp.zeros((6,), dtype), rep),
            # [xi(2) | eta(2) | baro_xi(2) | baro_eta(2) | baro_v: scalar
            # at [8] (iso MTK) or Voigt-6 at [8:14] (aniso/tri MTK)]
            thermo=put(jnp.zeros((14,), dtype), rep),
        )

    def gather(self, arr_sharded, n_atoms: int) -> np.ndarray:
        """Per-atom array back to original atom order (valid after migration,
        unlike SlabPartition.gather — ids travel with the atoms)."""
        ids = np.asarray(jax.device_get(self.ids))
        real = np.asarray(jax.device_get(self.real))
        arr = np.asarray(jax.device_get(arr_sharded))
        out = np.zeros((n_atoms,) + arr.shape[1:], arr.dtype)
        m = (ids >= 0) & real
        out[ids[m]] = arr[m]
        return out


def _compact(mask, k):
    """Indices of up to k True entries of a 1-D mask, compacted to the front.

    Returns (take (k,) int32, valid (k,) bool, overflow ()): a static-shape
    top_k compaction (cf. the neighbor builder's row compaction).
    """
    m = mask.shape[0]
    score = jnp.where(mask, m - lax.iota(jnp.int32, m), 0)
    vals, take = lax.top_k(score, min(k, m))
    if k > m:  # degenerate: more slots than rows
        take = jnp.pad(take, (0, k - m))
        vals = jnp.pad(vals, (0, k - m))
    valid = vals > 0
    overflow = jnp.sum(mask) > k
    return take.astype(jnp.int32), valid, overflow


def _frac_along(pos, inv_cell, slab_axis):
    """Wrapped fractional coordinate along the slab axis."""
    f = (
        pos[:, 0] * inv_cell[0, slab_axis]
        + pos[:, 1] * inv_cell[1, slab_axis]
        + pos[:, 2] * inv_cell[2, slab_axis]
    )
    return f - jnp.floor(f)


def _migrate(
    pos, vel, f, types, masses, real, ids, inv_cell,
    *, axis, nd, E, slab_axis, perm_fwd, perm_bwd,
):
    """Re-home atoms whose slab changed (LAMMPS exchange analog).

    Leavers are compacted into fixed (E,)-slot buffers, ring-ppermuted to
    the adjacent shard, and merged into free slots. Forces migrate with the
    atom so a caller that carries forces across blocks stays consistent.
    Returns ((pos, vel, f, types, masses, real, ids), (mig_ovf, escape)).
    """
    zero = jnp.zeros((), bool)
    if nd == 1:
        return (pos, vel, f, types, masses, real, ids), (zero, zero)
    s = lax.axis_index(axis)
    fa = _frac_along(pos, inv_cell, slab_axis)
    dest = jnp.clip((fa * nd).astype(jnp.int32), 0, nd - 1)
    dest = jnp.where(real, dest, s)
    stay = dest == s
    if nd == 2:
        go_r = real & ~stay
        go_l = jnp.zeros_like(go_r)
        escape = zero
    else:
        right = (s + 1) % nd
        left = (s - 1) % nd
        go_r = real & (dest == right)
        go_l = real & (dest == left)
        escape = jnp.any(real & ~stay & ~go_r & ~go_l)

    def pack(go):
        take, valid, ovf = _compact(go, E)
        pf = jnp.concatenate(
            [pos[take], vel[take], f[take], masses[take][:, None]], axis=1
        )
        pi = jnp.stack([types[take], ids[take]], axis=1)
        return pf, pi, valid, ovf

    pf_r, pi_r, val_r, ovf_r = pack(go_r)
    pf_l, pi_l, val_l, ovf_l = pack(go_l)
    # arriving-from-left = left neighbor's rightward buffer, and v.v.
    in_pf = [jax.lax.ppermute(pf_r, axis, perm_fwd)]
    in_pi = [jax.lax.ppermute(pi_r, axis, perm_fwd)]
    in_val = [jax.lax.ppermute(val_r, axis, perm_fwd)]
    if nd > 2:
        in_pf.append(jax.lax.ppermute(pf_l, axis, perm_bwd))
        in_pi.append(jax.lax.ppermute(pi_l, axis, perm_bwd))
        in_val.append(jax.lax.ppermute(val_l, axis, perm_bwd))
    inc_pf = jnp.concatenate(in_pf, axis=0)
    inc_pi = jnp.concatenate(in_pi, axis=0)
    inc_val = jnp.concatenate(in_val, axis=0)
    k_in = inc_val.shape[0]

    gone = go_r | go_l
    real = real & ~gone
    ids = jnp.where(gone, -1, ids)  # stale ids would corrupt gathers
    # compact incoming to the front, then place into free slots
    tk, valid_in, _ = _compact(inc_val, k_in)
    inc_pf = inc_pf[tk]
    inc_pi = inc_pi[tk]
    free_take, free_valid, _ = _compact(~real, k_in)
    cap_ovf = jnp.any(valid_in & ~free_valid)
    sel = valid_in & free_valid
    dst = free_take
    pos = pos.at[dst].set(jnp.where(sel[:, None], inc_pf[:, 0:3], pos[dst]))
    vel = vel.at[dst].set(jnp.where(sel[:, None], inc_pf[:, 3:6], vel[dst]))
    f = f.at[dst].set(jnp.where(sel[:, None], inc_pf[:, 6:9], f[dst]))
    masses = masses.at[dst].set(jnp.where(sel, inc_pf[:, 9], masses[dst]))
    types = types.at[dst].set(jnp.where(sel, inc_pi[:, 0], types[dst]))
    ids = ids.at[dst].set(jnp.where(sel, inc_pi[:, 1], ids[dst]))
    real = real.at[dst].set(real[dst] | sel)
    mig_ovf = ovf_r | ovf_l | cap_ovf
    return (pos, vel, f, types, masses, real, ids), (mig_ovf, escape)


def _halo_select(
    pos, real, inv_cell, *, axis, nd, H, w_cut, slab_axis,
    perm_fwd=None, perm_bwd=None,
):
    """Face-shell membership (fixed for a block): atoms within `w_cut` of
    each slab face, compacted into H send slots. Returns
    (sel_r, val_r, sel_l, val_l, halo_ovf). (perm_* accepted for caller
    symmetry with the other comm helpers; selection itself is local.)"""
    zero = jnp.zeros((), bool)
    if nd == 1:
        dummy = jnp.zeros((H,), jnp.int32)
        dummyv = jnp.zeros((H,), bool)
        return (dummy, dummyv, dummy, dummyv, zero)
    widths = 1.0 / jnp.linalg.norm(inv_cell, axis=1)
    w_frac = w_cut / widths[slab_axis]
    s = lax.axis_index(axis)
    fa = _frac_along(pos, inv_cell, slab_axis)
    hi = (s + 1.0) / nd
    lo = s / nd
    near_r = real & (hi - fa < w_frac)
    near_l = real & (fa - lo < w_frac)
    sel_r, val_r, ovf_r = _compact(near_r, H)
    sel_l, val_l, ovf_l = _compact(near_l, H)
    halo_ovf = ovf_r | ovf_l
    if nd == 2:
        # both faces ship to the SAME device: an atom in both shells
        # would be double-counted there
        halo_ovf = halo_ovf | jnp.any(near_r & near_l)
    return sel_r, val_r, sel_l, val_l, halo_ovf


def _exchange(own, sel_r, val_r, sel_l, val_l, fill, *, axis, nd, H, perm_fwd, perm_bwd):
    """own (C, ...) -> extended (C+2H, ...): [own, from-left, from-right].

    Invalid send slots carry `fill` (excluded from pairs via ext_real).
    """
    if nd == 1:
        pad_shape = (2 * H,) + own.shape[1:]
        return jnp.concatenate(
            [own, jnp.full(pad_shape, fill, own.dtype)], axis=0
        )
    vr = val_r.reshape((H,) + (1,) * (own.ndim - 1))
    vl = val_l.reshape((H,) + (1,) * (own.ndim - 1))
    send_r = jnp.where(vr, own[sel_r], fill)
    send_l = jnp.where(vl, own[sel_l], fill)
    from_left = jax.lax.ppermute(send_r, axis, perm_fwd)
    from_right = jax.lax.ppermute(send_l, axis, perm_bwd)
    return jnp.concatenate([own, from_left, from_right], axis=0)


def make_sharded_md_block(
    model: MTPModel,
    mesh: Mesh,
    *,
    capacity: int,
    max_neighbors: int,
    grid: tuple,
    skin: float = 0.5,
    n_steps: int = 10,
    dt: float = 0.001,
    ensemble: str = "nve",
    temperature: float = 300.0,
    tdamp: float = 0.1,
    halo_capacity: Optional[int] = None,
    migrate_capacity: Optional[int] = None,
    remat: bool = True,
    slab_axis: int = 0,
):
    """Build a jitted multi-chip MD block: atom migration + halo selection +
    neighbor rebuild + `n_steps` integrator steps (NVE or NHC-NVT).

    Returns ``block(state: ShardedState) -> (ShardedState, ShardFlags)``.
    """
    if ensemble not in ("nve", "nvt"):
        raise ValueError(f"sharded block supports nve/nvt, got {ensemble}")
    axis = mesh.axis_names[0]
    nd = mesh.devices.size
    C = capacity
    J = max_neighbors
    H = halo_capacity if halo_capacity is not None else C
    E = migrate_capacity if migrate_capacity is not None else max(8, C // 8)
    sched = model.schedule
    coeffs = model.coeffs
    cutoff = model.cutoff
    w_cut = cutoff + skin
    perm_fwd = [(i, (i + 1) % nd) for i in range(nd)]  # send right
    perm_bwd = [(i, (i - 1) % nd) for i in range(nd)]  # send left
    ncells = int(np.prod(grid))
    bin_cap = max(1, int(np.ceil(4.0 * nd * C / ncells))) + 8
    NE = C + 2 * H  # extended rows: [own | from-left | from-right]

    comm_kw = dict(axis=axis, nd=nd, perm_fwd=perm_fwd, perm_bwd=perm_bwd)

    def migrate(pos, vel, f, types, masses, real, ids, inv_cell):
        return _migrate(
            pos, vel, f, types, masses, real, ids, inv_cell,
            E=E, slab_axis=slab_axis, **comm_kw,
        )

    def halo_select(pos, real, inv_cell):
        return _halo_select(
            pos, real, inv_cell, H=H, w_cut=w_cut, slab_axis=slab_axis,
            **comm_kw,
        )

    def exchange(own, sel_r, val_r, sel_l, val_l, fill):
        return _exchange(own, sel_r, val_r, sel_l, val_l, fill, H=H, **comm_kw)

    def pair_forces(ext_pos, idx, mirror, mask, itypes, jtypes, cell, inv_cell):
        """Site energies + per-pair T for the C+2H-row extended set's OWN
        rows; Newton give-back stays gather-only (mirror permutation)."""
        from mtp_jax.models.mtp import _gather_rows3, minimum_image

        disp = _gather_rows3(ext_pos, idx) - ext_pos[:C, None, :]
        disp = minimum_image(disp, cell, inv_cell)
        d2 = jnp.sum(disp * disp, axis=-1)
        mask = mask & (d2 <= cutoff**2)

        fn = site_energies
        if remat:
            fn = jax.checkpoint(fn, static_argnums=(0,))
        site_e, vjp = jax.vjp(
            lambda d: fn(sched, coeffs, d, mask, itypes, jtypes), disp
        )
        (pair_t,) = vjp(jnp.ones_like(site_e))
        pair_t = pair_t * mask[..., None].astype(pair_t.dtype)

        flat = pair_t.reshape(-1, 3)
        own_pairs = C * J
        # own-pair mirrors: valid when the mirrored pair is an own pair too
        mir_own = mirror[:own_pairs]
        valid_own = (mir_own < own_pairs)[:, None].astype(flat.dtype)
        t_ji = (_gather_rows3(flat, mir_own) * valid_own).reshape(C, J, 3)
        forces = jnp.sum(pair_t - t_ji, axis=1)

        # give-back: my contributions to ghosts, gathered per ghost row
        if nd > 1:
            mir_g = mirror[own_pairs:]
            valid_g = (mir_g < own_pairs)[:, None].astype(flat.dtype)
            t_g = (_gather_rows3(flat, mir_g) * valid_g).reshape(2 * H, J, 3)
            gb = jnp.sum(t_g, axis=1)  # (2H, 3) force to subtract at owner
        else:
            gb = None
        return site_e, pair_t, disp, mask, forces, gb

    def giveback(forces, gb, sel_r, val_r, sel_l, val_l):
        """Route ghost contributions back to their owners and subtract."""
        if gb is None:
            return forces
        # ghost block [0:H] came from my LEFT neighbor's sel_r -> send back
        # along perm_bwd; block [H:2H] from right's sel_l -> perm_fwd
        back_r = jax.lax.ppermute(gb[:H], axis, perm_bwd)
        back_l = jax.lax.ppermute(gb[H:], axis, perm_fwd)
        forces = forces.at[sel_r].add(
            jnp.where(val_r[:, None], -back_r, 0.0)
        )
        forces = forces.at[sel_l].add(
            jnp.where(val_l[:, None], -back_l, 0.0)
        )
        return forces

    def block_shard(pos, vel, f, types, masses, real, ids, cell, thermo):
        inv_cell = jnp.linalg.inv(cell)
        (pos, vel, f, types, masses, real, ids), (mig_ovf, escape) = migrate(
            pos, vel, f, types, masses, real, ids, inv_cell
        )
        sel_r, val_r, sel_l, val_l, halo_ovf = halo_select(pos, real, inv_cell)

        def exch(x, fill):
            return exchange(x, sel_r, val_r, sel_l, val_l, fill)

        ext_pos0 = exch(pos, jnp.asarray(0.0, pos.dtype))
        ext_types = exch(types, jnp.asarray(0, types.dtype))
        ext_real = exch(real, False)
        nl = build_neighbor_list(
            ext_pos0,
            cell,
            w_cut,
            max_neighbors=J,
            grid=grid,
            real=ext_real,
            bin_capacity=bin_cap,
            with_reverse=True,
        )
        idx_own = nl.idx[:C]
        self_pair = idx_own == jnp.arange(C, dtype=nl.idx.dtype)[:, None]
        from mtp_jax.models.mtp import _gather_scalar

        pair_real = (
            ~self_pair
            & _gather_scalar(ext_real, idx_own)
            & real[:, None]
        )
        itypes = types
        jtypes = _gather_scalar(ext_types, idx_own)

        mass_col = masses[:, None]
        half = 0.5 * dt * units.FTM2A
        n_total = jax.lax.psum(jnp.sum(real), axis)
        ndof = 3.0 * n_total
        kt = units.KB * temperature

        def force_eval(pos):
            ext_pos = exch(pos, jnp.asarray(0.0, pos.dtype))
            site_e, pair_t, disp, mask, forces, gb = pair_forces(
                ext_pos, idx_own, nl.mirror, pair_real, itypes, jtypes,
                cell, inv_cell,
            )
            forces = giveback(forces, gb, sel_r, val_r, sel_l, val_l)
            site_e = jnp.where(real, site_e, 0.0)
            pe = jax.lax.psum(jnp.sum(site_e), axis)
            r = jnp.where(mask[..., None], disp, 0.0)
            # HIGHEST: a default-precision f32 einsum may round its operands
            # (TF32); the virial drives the (sharded) barostat
            wv = -jnp.einsum(
                "nja,njb->ab", pair_t, r, precision=jax.lax.Precision.HIGHEST
            )
            wv = 0.5 * (wv + wv.T)
            vir = jax.lax.psum(
                jnp.stack(
                    [wv[0, 0], wv[1, 1], wv[2, 2], wv[0, 1], wv[0, 2], wv[1, 2]]
                ),
                axis,
            )
            return forces, pe, vir

        # refresh forces for the new neighbor list (incoming f may be stale)
        f, pe0, vir0 = force_eval(pos)

        def ke2_of(vel):
            return jax.lax.psum(
                jnp.sum(
                    jnp.where(real[:, None], masses[:, None] * vel * vel, 0.0)
                )
                * units.MVV2E,
                axis,
            )

        def nhc_half(vel, xi, eta):
            from mtp_jax.md.integrators import _nhc_chain_half

            scale, xi, eta = _nhc_chain_half(
                ke2_of(vel), ndof, xi, eta, dt, kt,
                q1=ndof * kt * tdamp**2, q2=kt * tdamp**2,
            )
            return vel * scale, xi, eta

        def one(carry, _):
            pos, vel, f, xi, eta = carry
            if ensemble == "nvt":
                vel, xi, eta = nhc_half(vel, xi, eta)
            vel = vel + half * f / mass_col
            pos = pos + dt * vel
            f, pe, vir = force_eval(pos)
            vel = vel + half * f / mass_col
            if ensemble == "nvt":
                vel, xi, eta = nhc_half(vel, xi, eta)
            return (pos, vel, f, xi, eta), (pe, vir)

        xi0, eta0 = thermo[:2], thermo[2:4]
        xi, eta = xi0, eta0
        if n_steps > 0:
            (pos, vel, f, xi, eta), (pes, virs) = jax.lax.scan(
                one, (pos, vel, f, xi0, eta0), None, length=n_steps
            )
            pe, vir = pes[-1], virs[-1]
        else:
            pe, vir = pe0, vir0
        thermo = jnp.concatenate([xi, eta, thermo[4:]])
        nbr_ovf = jax.lax.pmax(nl.overflow, axis)
        flags = (
            nbr_ovf,
            jax.lax.pmax(halo_ovf, axis),
            jax.lax.pmax(mig_ovf, axis),
            jax.lax.pmax(escape, axis),
        )
        return pos, vel, f, types, masses, real, ids, pe, vir, thermo, flags

    sharded = jax.shard_map(
        block_shard,
        mesh=mesh,
        in_specs=(
            P(axis), P(axis), P(axis), P(axis), P(axis), P(axis), P(axis),
            P(), P(),
        ),
        out_specs=(
            P(axis), P(axis), P(axis), P(axis), P(axis), P(axis), P(axis),
            P(), P(), P(), (P(), P(), P(), P()),
        ),
        check_vma=False,
    )

    @jax.jit
    def block(state: ShardedState):
        pos, vel, f, types, masses, real, ids, pe, vir, thermo, flags = sharded(
            state.positions,
            state.velocities,
            state.forces,
            state.types,
            state.masses,
            state.real,
            state.ids,
            state.cell,
            state.thermo,
        )
        return (
            dataclasses.replace(
                state,
                positions=pos,
                velocities=vel,
                forces=f,
                types=types,
                masses=masses,
                real=real,
                ids=ids,
                potential_energy=pe,
                virial=vir,
                thermo=thermo,
            ),
            ShardFlags(*flags),
        )

    return block


def make_sharded_grades(
    model: MTPModel,
    mesh: Mesh,
    *,
    capacity: int,
    max_neighbors: int,
    grid: tuple,
    halo_capacity: Optional[int] = None,
    slab_axis: int = 0,
):
    """Multi-chip extrapolation grades: per-shard candidate vectors with
    boundary-shell halo exchange, then the reference's grade collectives as
    mesh reductions — `psum` of summed candidate vectors in configuration
    mode / `pmax` of per-atom grades in neighborhood mode
    (MPI_Allreduce SUM/MAX, pair_mtp_extrapolation.cpp:363-382).

    Returns grades_fn(state: ShardedState) -> (max_grade, per_atom_grades,
    flags) with per-atom grades sharded like the atoms (zero on padding
    slots; zeros in configuration mode).
    """
    if model.inverse_active_set is None:
        raise ValueError("model has no MVS selection state")
    axis = mesh.axis_names[0]
    nd = mesh.devices.size
    C = capacity
    H = halo_capacity if halo_capacity is not None else C
    sched = model.schedule
    coeffs = model.coeffs
    cutoff = model.cutoff
    inv_a = model.inverse_active_set
    cfg_mode = model.configuration_mode
    perm_fwd = [(i, (i + 1) % nd) for i in range(nd)]
    perm_bwd = [(i, (i - 1) % nd) for i in range(nd)]
    ncells = int(np.prod(grid))
    bin_cap = max(1, int(np.ceil(4.0 * nd * C / ncells))) + 8

    def shard_fn(pos, types, real, cell):
        from mtp_jax.models.mtp import _gather_scalar, minimum_image
        from mtp_jax.ops.moments import basic_moments, contract_dag, readout

        inv_cell = jnp.linalg.inv(cell)

        # boundary-shell halo selection (grades need only own neighborhoods)
        if nd == 1:
            ext_pos = pos
            ext_types = types
            ext_real = real
            halo_ovf = jnp.zeros((), bool)
        else:
            widths = 1.0 / jnp.linalg.norm(inv_cell, axis=1)
            w_frac = cutoff / widths[slab_axis]
            s = lax.axis_index(axis)
            f = (
                pos[:, 0] * inv_cell[0, slab_axis]
                + pos[:, 1] * inv_cell[1, slab_axis]
                + pos[:, 2] * inv_cell[2, slab_axis]
            )
            fa = f - jnp.floor(f)
            near_r = real & ((s + 1.0) / nd - fa < w_frac)
            near_l = real & (fa - s / nd < w_frac)
            sel_r, val_r, ovf_r = _compact(near_r, H)
            sel_l, val_l, ovf_l = _compact(near_l, H)
            halo_ovf = ovf_r | ovf_l
            if nd == 2:
                halo_ovf = halo_ovf | jnp.any(near_r & near_l)

            def exch(x, fill):
                ndim = x.ndim
                vr = val_r.reshape((H,) + (1,) * (ndim - 1))
                vl = val_l.reshape((H,) + (1,) * (ndim - 1))
                send_r = jnp.where(vr, x[sel_r], fill)
                send_l = jnp.where(vl, x[sel_l], fill)
                return jnp.concatenate(
                    [
                        x,
                        jax.lax.ppermute(send_r, axis, perm_fwd),
                        jax.lax.ppermute(send_l, axis, perm_bwd),
                    ],
                    axis=0,
                )

            ext_pos = exch(pos, jnp.asarray(0.0, pos.dtype))
            ext_types = exch(types, jnp.asarray(0, types.dtype))
            ext_real = exch(real, False)

        nl = build_neighbor_list(
            ext_pos, cell, cutoff,
            max_neighbors=max_neighbors, grid=grid,
            centers=C, real=ext_real, bin_capacity=bin_cap,
        )
        from mtp_jax.models.mtp import _gather_rows3

        disp = _gather_rows3(ext_pos, nl.idx) - ext_pos[:C, None, :]
        disp = minimum_image(disp, cell, inv_cell)
        d2 = jnp.sum(disp * disp, axis=-1)
        self_pair = nl.idx == jnp.arange(C, dtype=nl.idx.dtype)[:, None]
        mask = (
            (d2 <= cutoff**2) & (~self_pair)
            & _gather_scalar(ext_real, nl.idx) & real[:, None]
        )
        itypes = types
        jtypes = _gather_scalar(ext_types, nl.idx)

        mb, aux = basic_moments(sched, coeffs, disp, mask, itypes, jtypes)
        dtype = mb.dtype

        def site_e_of(mbv):
            e, _ = readout(sched, coeffs, contract_dag(sched, mbv), itypes)
            return jnp.sum(jnp.where(real, e, 0.0))

        gamma = jax.grad(site_e_of)(mb)
        _, basis_members = readout(sched, coeffs, contract_dag(sched, mb), itypes)

        S = sched.species_count
        MU = sched.radial_funcs_count
        RB = sched.radial_basis_size
        w = jnp.where(mask, jnp.asarray(1.0, dtype), 0.0)
        jt_onehot = jax.nn.one_hot(jtypes, S, dtype=dtype) * w[..., None]
        mu_onehot = jnp.asarray(np.eye(MU)[sched.basic[:, 0]], dtype)
        gU = jnp.einsum("nk,njk,km->njm", gamma, aux["U"], mu_onehot, precision=jax.lax.Precision.HIGHEST)
        rad = jnp.einsum("njm,njs,njr->nsmr", gU, jt_onehot, aux["cheb"], precision=jax.lax.Precision.HIGHEST)
        it_onehot = jax.nn.one_hot(itypes, S, dtype=dtype) * real[:, None].astype(dtype)
        b = jnp.concatenate(
            [
                jnp.einsum("nt,nsmr->ntsmr", it_onehot, rad, precision=jax.lax.Precision.HIGHEST).reshape(
                    C, S * S * MU * RB
                ),
                it_onehot,
                basis_members * real[:, None].astype(dtype),
            ],
            axis=1,
        )

        flags = jax.lax.pmax(nl.overflow, axis) | jax.lax.pmax(halo_ovf, axis)
        if cfg_mode:
            bsum = jax.lax.psum(jnp.sum(b, axis=0), axis)
            natoms = jax.lax.psum(jnp.sum(real), axis)
            g = jnp.max(jnp.abs(jnp.matmul(
                inv_a.astype(dtype), bsum,
                precision=jax.lax.Precision.HIGHEST,
            ))) / jnp.maximum(natoms, 1)
            return g, jnp.zeros((C,), dtype), flags
        # HIGHEST: see al/grades.nbh_grades
        grades = jnp.max(jnp.abs(jnp.matmul(
            b, inv_a.astype(dtype).T, precision=jax.lax.Precision.HIGHEST,
        )), axis=-1)
        grades = jnp.where(real, grades, 0.0)
        gmax = jax.lax.pmax(jnp.max(grades), axis)
        return gmax, grades, flags

    sharded = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P()),
        out_specs=(P(), P(axis), P()),
        check_vma=False,
    )

    @jax.jit
    def grades_fn(state: ShardedState):
        return sharded(state.positions, state.types, state.real, state.cell)

    return grades_fn


def compute_sharded_forces(
    model: MTPModel, mesh: Mesh, *, capacity, max_neighbors, grid, skin=0.0, **kw
):
    """One-shot sharded force/energy evaluation (for tests and AL hooks)."""
    blk = make_sharded_md_block(
        model,
        mesh,
        capacity=capacity,
        max_neighbors=max_neighbors,
        grid=grid,
        skin=skin,
        n_steps=0,
        dt=0.0,
        **kw,
    )

    def fn(state: ShardedState):
        out, flags = blk(state)
        return out, flags

    return fn
