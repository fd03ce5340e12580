"""Neighbor-list construction with static shapes (jit-friendly).

The reference delegates neighbor lists to LAMMPS (full lists requested at
pair_mtp.cpp:318; rectangular (chunk, max_neighs) padding assumed at
pair_mtp_kokkos.cpp:277-282). Here the neighbor engine is a first-class
component: a periodic cell (bin) list built entirely from sort/segment
primitives so it runs under `jit` with fixed shapes.

Representation: padded index array `idx (N, max_neighbors) int32` where
padding entries equal the row's own atom index (self-pairs are masked by the
compute path). Overflow (more candidates than fit) is reported in a flag, the
device-side version of LAMMPS's "neighbor list overflow" error: callers
re-build with a larger capacity.

Requires every perpendicular cell width >= 2*cutoff (minimum-image regime);
`check_cell` validates this on the host.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class NeighborList:
    idx: jax.Array  # (N, max_neighbors) int32, padded with self-index
    overflow: jax.Array  # () bool — capacity exceeded somewhere
    reference_positions: jax.Array  # positions at build time (for skin check)
    reference_cell: jax.Array | None = None  # cell at build time (NPT skin check)
    # (N*max_neighbors,) flat mirror permutation: mirror[p] = flat storage
    # position of the mirrored pair (j -> i) of flat pair p = (i -> j). Lets
    # Newton force give-back be a gather instead of a scatter. Requires idx
    # rows sorted ascending (see mirror_permutation). Optional; None unless
    # requested.
    mirror: jax.Array | None = None


def mirror_permutation(idx):
    """Flat mirror permutation of a row-sorted symmetric neighbor list.

    Pairs are stored row-major, so with each row of `idx` sorted ascending
    the storage order IS the (src, dst) lexicographic order. The k-th pair
    in (dst, src) order is then exactly the mirror of the k-th pair in
    storage, so `argsort(dst * N + src)` maps storage position -> mirror's
    storage position in one O(NJ log NJ) device sort.

    Padding entries (dst == src == row) mirror among themselves (equal keys,
    equal multiplicity on both sides), and must be masked by the caller as
    always. Requires list symmetry: every real pair (i, j) present implies
    (j, i) present — true for full lists without overflow.
    """
    n, j = idx.shape
    src = jax.lax.broadcasted_iota(jnp.int32, (n, j), 0).reshape(-1)
    dst = idx.reshape(-1)
    if n <= 46340:  # n^2 < 2^31: the composite key fits int32
        return jnp.argsort(dst * n + src).astype(jnp.int32)
    # larger systems: a composite int32 key overflows, and int64 is not
    # available with x64 disabled: lexicographic two-key sort instead
    pos = jnp.arange(n * j, dtype=jnp.int32)
    _, _, perm = jax.lax.sort((dst, src, pos), num_keys=2)
    return perm


def perpendicular_widths(cell: np.ndarray) -> np.ndarray:
    """Perpendicular widths of a (row-vector) cell matrix."""
    inv = np.linalg.inv(np.asarray(cell, dtype=np.float64))
    return 1.0 / np.linalg.norm(inv, axis=1)


def check_cell(cell, cutoff: float) -> None:
    w = perpendicular_widths(cell)
    if (w < 2.0 * cutoff).any():
        raise ValueError(
            f"cell widths {w} must be >= 2*cutoff ({2 * cutoff}) for the "
            "minimum-image neighbor engine; replicate the cell first"
        )


def grid_shape(cell, cutoff: float) -> tuple:
    """Static bin-grid shape: as many bins as fit with width >= cutoff."""
    w = perpendicular_widths(cell)
    return tuple(int(max(1, np.floor(wi / cutoff))) for wi in w)


def _frac_unrolled(positions, inv_cell):
    """positions @ inv_cell, unrolled per component.

    A matrix product at default precision may round f32 operands (TF32
    keeps ~10 mantissa bits): positions of a 252 A box would bin with up
    to ~0.1 A error, enough to shift an atom one bin on a commensurate grid
    and silently drop true neighbors from the 3x3x3 stencil. The unrolled
    form is exact f32 elementwise arithmetic (see
    models/mtp.minimum_image)."""
    return jnp.stack(
        [
            positions[:, 0] * inv_cell[0, a]
            + positions[:, 1] * inv_cell[1, a]
            + positions[:, 2] * inv_cell[2, a]
            for a in range(3)
        ],
        axis=1,
    )


@partial(
    jax.jit,
    static_argnames=(
        "max_neighbors",
        "grid",
        "include_self_image",
        "centers",
        "bin_capacity",
        "row_block",
        "with_reverse",
    ),
)
def build_neighbor_list(
    positions,
    cell,
    cutoff,
    *,
    max_neighbors: int,
    grid: tuple,
    include_self_image: bool = False,
    centers: int | None = None,
    real=None,
    bin_capacity: int | None = None,
    row_block: int | None = None,
    with_reverse: bool = False,
):
    """Periodic cell-list neighbor build.

    Args:
      positions: (N, 3); may be unwrapped (wrapped internally).
      cell: (3, 3) row-vector cell matrix.
      cutoff: neighbor cutoff (typically model cutoff + Verlet skin).
      max_neighbors: static output width J.
      grid: static bin grid (from :func:`grid_shape`); each dim >= 1. When a
        dim is < 3 bins, all bins along it are candidates (correct, slower).
      centers: build lists only for the first `centers` rows (halo-extended
        sets: own atoms first, ghosts after). Default: all rows.
      real: optional (N,) bool; False rows (slab padding) are excluded both as
        centers and as neighbors.

    Returns :class:`NeighborList` with idx of shape (centers or N, J).
    """
    n = positions.shape[0]
    gx, gy, gz = grid
    ncells = gx * gy * gz
    inv_cell = jnp.linalg.inv(cell)
    frac = _frac_unrolled(positions, inv_cell)
    frac = frac - jnp.floor(frac)  # wrap to [0,1)

    # the bin grid is static but the cell is runtime (NPT changes volume):
    # flag if any binned dimension's width has shrunk below the cutoff
    # (dims with <3 bins use an all-bins stencil, so no constraint there)
    widths = 1.0 / jnp.linalg.norm(inv_cell, axis=1)
    checked = jnp.asarray([g >= 3 for g in grid])
    # relative epsilon: grid_shape picks g = floor(w/cutoff), so w/g == cutoff
    # exactly for commensurate boxes (252 A / 45 bins at cutoff 5.6) and f32
    # rounding must not trip the flag; 1e-6 relative (~6e-6 A) is far below
    # any physical displacement scale
    geom_overflow = jnp.any(
        checked
        & (widths / jnp.asarray(grid, widths.dtype) < cutoff * (1.0 - 1e-6))
    )

    dims = jnp.asarray(grid)
    bin3 = jnp.clip((frac * dims).astype(jnp.int32), 0, dims - 1)
    bin_id = (bin3[:, 0] * gy + bin3[:, 1]) * gz + bin3[:, 2]
    if real is not None:
        # padding rows (e.g. invalid halo send slots, all at one fill
        # position) go to a trash bin so they can't overflow a real bin
        bin_id = jnp.where(real, bin_id, ncells)

    # sort atoms by bin; ranks within bin give a collision-free cell table
    order = jnp.argsort(bin_id)
    sorted_bin = bin_id[order]
    # capacity: atoms per bin, padded (uniform-density estimate; callers with
    # concentrated occupancy — e.g. halo-extended slabs — pass bin_capacity).
    # Overflow is flagged, so a tight estimate is safe.
    # 2.2x mean + 12 covers thermal density fluctuations AND perfect-lattice
    # commensurability clustering (a 63^3 fcc lattice on a 45^3 grid packs
    # 2x2x2 cells = 32 atoms into some bins vs a 2x-mean cap of 30)
    cap = bin_capacity or max(1, int(np.ceil(2.2 * n / ncells)) + 12)
    nbins = ncells + (1 if real is not None else 0)
    counts = jnp.zeros((nbins,), jnp.int32).at[sorted_bin].add(1)
    cell_overflow = jnp.max(counts[:ncells]) > cap
    start = jnp.cumsum(counts) - counts
    rank = jnp.arange(n, dtype=jnp.int32) - start[sorted_bin]
    # trash-bin rows overflow their cap harmlessly: clipped writes collide
    # inside the trash row, which the stencil never reads
    table = jnp.full((nbins, cap), -1, dtype=jnp.int32)
    table = table.at[sorted_bin, jnp.clip(rank, 0, cap - 1)].set(
        order.astype(jnp.int32)
    )
    nc = n if centers is None else centers

    # candidate bins: 3x3x3 stencil around each atom's bin (with wrap).
    # When a dimension has <3 bins use all of them exactly once.
    def offs(g):
        return np.arange(g) if g < 3 else np.array([-1, 0, 1])

    # Fat-row tables: when the grid supports a true 3x3 (y, z) stencil,
    # pre-concatenate each bin's 9-bin (y, z) neighborhood (periodic rolls
    # at build time) so every atom gathers 3 fat rows (x-1, x, x+1) instead
    # of 27 thin ones: 9x fewer gathered rows.
    use_fat = gy >= 3 and gz >= 3 and not include_self_image
    if use_fat:
        def fatten(t):
            c = t.shape[1]
            tz = t.reshape(gx * gy, gz, c)
            t3 = jnp.concatenate(
                [jnp.roll(tz, 1, axis=1), tz, jnp.roll(tz, -1, axis=1)],
                axis=2,
            )
            t3 = t3.reshape(gx, gy, gz, 3 * c)
            t9 = jnp.concatenate(
                [jnp.roll(t3, 1, axis=1), t3, jnp.roll(t3, -1, axis=1)],
                axis=3,
            )
            return t9.reshape(ncells, 9 * c)

        # Compact the fat rows: each bin's 9-bin (y, z) neighborhood carries
        # 9x the per-bin cap of padding, but its TRUE occupancy concentrates
        # to ~9x the mean (the commensurate-clustering worst case measured
        # max9 = 122 vs mean9 = 99 at every bench config — clustering in one
        # bin is compensated by its neighbors). A single-operand ascending
        # row sort (invalid -> INT_MAX) moves the valid ids to the front,
        # and the compacted width W2 halves every downstream per-atom cost:
        # candidate gather, d2 filter and the top_k compaction.
        # True 9-bin occupancy > W2 raises the overflow flag.
        big = jnp.int32(2**31 - 1)
        table9_raw = fatten(table[:ncells])
        # Width contract: `cap` bounds the occupied-region mean occupancy
        # via cap >= 2.2*mean_occ + 8 — true for the uniform default above
        # (2.2*mean + 12) and for every concentrated-occupancy caller
        # (halo-extended shard sets populate ~1/nd of this grid, so
        # n/ncells would undersize W2 by the shard count; their
        # bin_capacity formulas encode the occupied density instead). The
        # cap-implied bound also covers moderate single-chip inhomogeneity
        # (vacuum slabs/surfaces): by the time a local density exceeds it,
        # the per-bin table overflows first and raises the same flag.
        mean_est = (cap - 8) / 2.2
        W2 = int(min(9 * cap, -(-int(np.ceil(9 * mean_est * 1.45 + 24)) // 8) * 8))
        if W2 < 9 * cap:
            tablec = jax.lax.sort(
                jnp.where(table9_raw >= 0, table9_raw, big), dimension=1
            )[:, :W2]
            validc = tablec != big
            table9 = jnp.where(validc, tablec, -1)
            # exact 9-bin occupancy from the per-bin counts (periodic rolls)
            cz = counts[:ncells].reshape(gx * gy, gz)
            c3 = jnp.roll(cz, 1, axis=1) + cz + jnp.roll(cz, -1, axis=1)
            c3 = c3.reshape(gx, gy, gz)
            c9 = jnp.roll(c3, 1, axis=1) + c3 + jnp.roll(c3, -1, axis=1)
            cell_overflow = cell_overflow | (jnp.max(c9) > W2)
        else:
            table9 = table9_raw
            validc = table9 >= 0
        # positions in fat-row layout by GATHER over the compacted ids
        # (8-wide padded rows, as models/mtp._gather_rows3)
        p8 = jnp.pad(positions, ((0, 0), (0, 5)))
        ptab9 = (
            p8[jnp.where(validc, table9, 0).reshape(-1)]
            .reshape(ncells, table9.shape[1], 8)[..., :3]
        )
        stencil_x = np.asarray(offs(gx), dtype=np.int32)  # (Kx,)
    else:
        # positions arranged in bin-table layout: candidate coordinates are
        # then fetched as whole bins (chunky row gathers) instead of K*cap
        # scattered element gathers per atom
        ptab = jnp.zeros((nbins, cap, 3), positions.dtype)
        ptab = ptab.at[sorted_bin, jnp.clip(rank, 0, cap - 1)].set(
            positions[order]
        )

    stencil = np.array(
        [(ox, oy, oz) for ox in offs(gx) for oy in offs(gy) for oz in offs(gz)],
        dtype=np.int32,
    )  # (K, 3)

    # the candidate width and atom count bound the packed-key trick below
    w_cand = (
        len(stencil_x) * table9.shape[1] if use_fat else len(stencil) * cap
    )
    can_pack = n < 2**20 and w_cand < 2**11

    def row_phase(args):
        """Distance-filter + compact for a block of center rows.

        Memory scales with block * K*cap; the block loop (lax.map) bounds the
        working set, the analog of the reference's chunk loop
        (pair_mtp_kokkos.cpp:287-361)."""
        cbin3, cpos, crow = args
        b = cbin3.shape[0]
        if use_fat:
            nbx = (cbin3[:, None, 0] + stencil_x[None, :]) % gx  # (b, Kx)
            nb_id = (nbx * gy + cbin3[:, None, 1]) * gz + cbin3[:, None, 2]
            cand = table9[nb_id].reshape(b, -1)  # (b, Kx*9*cap)
            cand_pos = ptab9[nb_id].reshape(b, -1, 3)
        else:
            nb3 = (cbin3[:, None, :] + stencil[None, :, :]) % dims  # (b, K, 3)
            nb_id = (nb3[..., 0] * gy + nb3[..., 1]) * gz + nb3[..., 2]
            cand = table[nb_id].reshape(b, -1)  # (b, K*cap)
            cand_pos = ptab[nb_id].reshape(b, -1, 3)  # chunky row gather
        cand_valid = cand >= 0
        cand_safe = jnp.where(cand_valid, cand, 0)
        # minimum image UNROLLED per component (see
        # models/mtp.minimum_image): elementwise, fuses into one pass
        dc = [cand_pos[..., a] - cpos[:, a][:, None] for a in range(3)]
        fr = [
            dc[0] * inv_cell[0, a] + dc[1] * inv_cell[1, a] + dc[2] * inv_cell[2, a]
            for a in range(3)
        ]
        fr = [fa - jnp.round(fa) for fa in fr]
        d2 = jnp.zeros_like(fr[0])
        for a in range(3):
            da = fr[0] * cell[0, a] + fr[1] * cell[1, a] + fr[2] * cell[2, a]
            d2 = d2 + da * da
        self_row = cand_safe == crow[:, None]
        keep = cand_valid & (d2 <= cutoff * cutoff) & (~self_row)
        if include_self_image:
            # count self periodic images too (only correct for tiny cells;
            # min-image regime excludes them)
            keep = keep | (
                cand_valid & (d2 <= cutoff * cutoff) & self_row & (d2 > 1e-12)
            )
        if real is not None:
            # candidates are real BY CONSTRUCTION: non-real rows are
            # trash-binned and the stencil never reads the trash row, so
            # only the (cheap, (b,)) center mask is needed, not a
            # real[cand] gather over every candidate.
            keep = keep & real[crow][:, None]

        # compact kept candidates to the front by top_k over a score that
        # decreases with column. The candidate VALUE rides in the key's low
        # bits when it fits (n < 2^20, W < 2^11), which saves the (rows x J)
        # take_along_axis scalar gather.
        w = keep.shape[1]
        # compacted fat rows can be narrower than J (sparse systems with a
        # wide max_neighbors): clamp k and self-pad the missing columns
        k = min(max_neighbors, w)
        col = jax.lax.broadcasted_iota(jnp.int32, keep.shape, 1)
        if can_pack:
            packed = jnp.where(keep, ((w - col) << 20) | cand_safe, 0)
            vals, _ = jax.lax.top_k(packed, k)
            row_keep = vals > 0
            row_idx = vals & ((1 << 20) - 1)
        else:
            score = jnp.where(keep, w - col, 0)
            vals, take = jax.lax.top_k(score, k)
            row_keep = vals > 0
            row_idx = jnp.take_along_axis(cand_safe, take, axis=1)
        idx = jnp.where(row_keep, row_idx, crow[:, None])
        if k < max_neighbors:
            idx = jnp.concatenate(
                [idx, jnp.broadcast_to(crow[:, None], (b, max_neighbors - k))],
                axis=1,
            )
        return idx.astype(jnp.int32), jnp.max(jnp.sum(keep, axis=1))

    crow_all = jnp.arange(nc, dtype=jnp.int32)
    if row_block is None and nc > 16384:
        row_block = 8192  # bound the candidate working set on large systems
    if row_block is None or row_block >= nc:
        idx, max_cnt = row_phase((bin3[:nc], positions[:nc], crow_all))
    else:
        nb = -(-nc // row_block)
        pad = nb * row_block - nc
        pbin3 = jnp.pad(bin3[:nc], ((0, pad), (0, 0)))
        ppos = jnp.pad(positions[:nc], ((0, pad), (0, 0)))
        prow = jnp.pad(crow_all, (0, pad))  # pad rows alias row 0; sliced off
        idx_b, cnt_b = jax.lax.map(
            row_phase,
            (
                pbin3.reshape(nb, row_block, 3),
                ppos.reshape(nb, row_block, 3),
                prow.reshape(nb, row_block),
            ),
        )
        idx = idx_b.reshape(nb * row_block, max_neighbors)[:nc]
        max_cnt = jnp.max(cnt_b)

    nbr_overflow = max_cnt > max_neighbors
    mirror = None
    if with_reverse and centers is None:
        idx = jnp.sort(idx, axis=1)  # row-sorted storage = (src, dst) order
        mirror = mirror_permutation(idx)
    return NeighborList(
        idx=idx,
        overflow=cell_overflow | nbr_overflow | geom_overflow,
        reference_positions=positions,
        reference_cell=cell,
        mirror=mirror,
    )


def build_neighbor_list_bruteforce(positions, cell, cutoff, *, max_neighbors: int):
    """O(N^2) all-pairs build (tests / small systems)."""
    n = positions.shape[0]
    disp = positions[None, :, :] - positions[:, None, :]
    if cell is not None:
        from mtp_jax.models.mtp import minimum_image

        disp = minimum_image(disp, cell, jnp.linalg.inv(cell))
    d2 = jnp.sum(disp * disp, axis=-1)
    eye = jnp.eye(n, dtype=bool)
    keep = (d2 <= cutoff * cutoff) & (~eye)
    sort_key = jnp.where(keep, 0, 1).astype(jnp.int32)
    take = jnp.argsort(sort_key, axis=1, stable=True)[:, :max_neighbors]
    row_keep = jnp.take_along_axis(keep, take, axis=1)
    self_col = jnp.arange(n, dtype=jnp.int32)[:, None]
    idx = jnp.where(row_keep, take.astype(jnp.int32), self_col)
    overflow = jnp.max(jnp.sum(keep, axis=1)) > max_neighbors
    return NeighborList(
        idx=idx, overflow=overflow, reference_positions=positions,
        reference_cell=cell,
    )


def needs_rebuild(nl: NeighborList, positions, cell, skin: float):
    """Verlet criterion: any atom moved more than skin/2 since build."""
    disp = positions - nl.reference_positions
    if cell is not None:
        from mtp_jax.models.mtp import minimum_image

        disp = minimum_image(disp, cell, jnp.linalg.inv(cell))
    return jnp.max(jnp.sum(disp * disp, axis=-1)) > (0.5 * skin) ** 2


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SortedNeighborList:
    """Neighbor list over bin-sorted atoms (the sharded engine's layout).

    Index arrays live in *sorted* space (row k = atom order[k]); callers
    keep per-atom state in their own order and permute positions in and
    forces out around the force evaluation.
    """

    order: jax.Array  # (N,) int32: sorted row -> user atom
    inv_order: jax.Array  # (N,) int32: user atom -> sorted row
    idx: jax.Array  # (N, J) int32 sorted-space list, rows ascending, pads = own row
    mirror: jax.Array  # (N*J,) flat mirror permutation
    overflow: jax.Array  # () bool: capacity or geometry exceeded
    reference_positions: jax.Array  # user-order positions at build time
    reference_cell: jax.Array  # cell at build time (NPT skin check)


def build_sorted_neighbor_list(
    positions,
    cell,
    cutoff,
    *,
    max_neighbors: int,
    grid: tuple,
    real=None,
    bin_capacity: int | None = None,
):
    """Cell-list build over bin-sorted atoms.

    `real`/`bin_capacity`: as in :func:`build_neighbor_list`: non-real rows
    (halo padding slots in the sharded path) sort to the end (trash bin)
    and are excluded as centers and neighbors.
    """
    gx, gy, gz = grid
    inv_cell = jnp.linalg.inv(cell)
    frac = _frac_unrolled(positions, inv_cell)
    frac = frac - jnp.floor(frac)
    dims = jnp.asarray(grid)
    bin3 = jnp.clip((frac * dims).astype(jnp.int32), 0, dims - 1)
    bin_id = (bin3[:, 0] * gy + bin3[:, 1]) * gz + bin3[:, 2]
    if real is not None:
        bin_id = jnp.where(real, bin_id, gx * gy * gz)  # trash: sort last
    order = jnp.argsort(bin_id).astype(jnp.int32)
    inv_order = jnp.argsort(order).astype(jnp.int32)

    nl = build_neighbor_list(
        positions[order], cell, cutoff, max_neighbors=max_neighbors,
        grid=grid, with_reverse=True,
        real=None if real is None else real[order],
        bin_capacity=bin_capacity,
    )
    return SortedNeighborList(
        order=order,
        inv_order=inv_order,
        idx=nl.idx,
        mirror=nl.mirror,
        overflow=nl.overflow,
        reference_positions=positions,
        reference_cell=cell,
    )
