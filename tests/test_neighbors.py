"""Cell-list neighbor engine vs brute force."""

import jax.numpy as jnp
import numpy as np
import pytest

from mtp_jax.ops.neighbors import (
    build_neighbor_list,
    build_neighbor_list_bruteforce,
    check_cell,
    grid_shape,
    needs_rebuild,
)


def neighbor_sets(idx):
    """Convert padded idx (self-padded) to a list of sets."""
    out = []
    for i, row in enumerate(np.asarray(idx)):
        out.append(set(int(j) for j in row if j != i))
    return out


@pytest.mark.parametrize("n,L", [(40, 12.0), (100, 14.0)])
def test_cell_list_matches_bruteforce(n, L, rng):
    cell = np.diag([L, L * 1.05, L * 0.95])
    pos = rng.uniform(0, L, (n, 3))
    cutoff = 3.5
    check_cell(cell, cutoff)
    g = grid_shape(cell, cutoff)
    nl = build_neighbor_list(
        jnp.asarray(pos), jnp.asarray(cell), cutoff, max_neighbors=48, grid=g
    )
    bf = build_neighbor_list_bruteforce(
        jnp.asarray(pos), jnp.asarray(cell), cutoff, max_neighbors=48
    )
    assert not bool(nl.overflow)
    assert not bool(bf.overflow)
    assert neighbor_sets(nl.idx) == neighbor_sets(bf.idx)


def test_triclinic_cell(rng):
    cell = np.array([[12.0, 0, 0], [2.0, 12.0, 0], [1.0, -1.5, 12.0]])
    pos = rng.uniform(0, 12.0, (60, 3))
    cutoff = 3.0
    check_cell(cell, cutoff)
    g = grid_shape(cell, cutoff)
    nl = build_neighbor_list(
        jnp.asarray(pos), jnp.asarray(cell), cutoff, max_neighbors=48, grid=g
    )
    bf = build_neighbor_list_bruteforce(
        jnp.asarray(pos), jnp.asarray(cell), cutoff, max_neighbors=48
    )
    assert neighbor_sets(nl.idx) == neighbor_sets(bf.idx)


def test_unwrapped_positions(rng):
    """Builder must wrap out-of-box positions itself."""
    L = 12.0
    cell = np.diag([L, L, L])
    pos = rng.uniform(0, L, (50, 3))
    shifted = pos + np.array([3 * L, -2 * L, L])
    g = grid_shape(cell, 3.0)
    nl0 = build_neighbor_list(
        jnp.asarray(pos), jnp.asarray(cell), 3.0, max_neighbors=40, grid=g
    )
    nl1 = build_neighbor_list(
        jnp.asarray(shifted), jnp.asarray(cell), 3.0, max_neighbors=40, grid=g
    )
    assert neighbor_sets(nl0.idx) == neighbor_sets(nl1.idx)


def test_overflow_flag(rng):
    L = 12.0
    cell = np.diag([L, L, L])
    pos = rng.uniform(0, L, (80, 3))
    g = grid_shape(cell, 4.0)
    nl = build_neighbor_list(
        jnp.asarray(pos), jnp.asarray(cell), 4.0, max_neighbors=2, grid=g
    )
    assert bool(nl.overflow)


def test_check_cell_rejects_small():
    with pytest.raises(ValueError):
        check_cell(np.diag([5.0, 20.0, 20.0]), 3.0)


def test_needs_rebuild(rng):
    L = 12.0
    cell = jnp.asarray(np.diag([L, L, L]))
    pos = jnp.asarray(rng.uniform(0, L, (20, 3)))
    g = grid_shape(np.asarray(cell), 3.0)
    nl = build_neighbor_list(pos, cell, 3.0, max_neighbors=40, grid=g)
    assert not bool(needs_rebuild(nl, pos, cell, skin=1.0))
    moved = pos.at[0, 0].add(0.6)
    assert bool(needs_rebuild(nl, moved, cell, skin=1.0))
    assert not bool(needs_rebuild(nl, moved, cell, skin=1.3))


def test_mirror_permutation_large_n():
    """n > 46340: the composite int32 key would overflow (and int64 is
    unavailable with x64 off), so mirror_permutation switches to a two-key
    lexicographic sort — verify it still maps every pair to its reverse."""
    from mtp_jax.ops.neighbors import mirror_permutation

    n, j = 50176, 4
    rows = np.arange(n, dtype=np.int32)[:, None]
    offs = np.array([-2, -1, 1, 2], dtype=np.int32)[None, :]
    idx = np.sort((rows + offs) % n, axis=1)  # symmetric ring lattice
    mirror = np.asarray(mirror_permutation(jnp.asarray(idx)))
    src = np.repeat(np.arange(n, dtype=np.int64), j)
    dst = idx.reshape(-1).astype(np.int64)
    # mirrored pair of flat p=(i->j) must be (j->i)
    assert (src[mirror] == dst).all() and (dst[mirror] == src).all()


def test_fat_row_compaction_parity_and_overflow(rng):
    """The compacted fat-row path (W2 < 9*cap) must match brute force at
    uniform density, and flag when a cluster's true 9-bin occupancy
    exceeds the compacted width instead of silently dropping neighbors."""
    L = 24.0
    cell = np.diag([L, L, L])
    g = grid_shape(cell, 4.0)

    pos = rng.uniform(0, L, (800, 3))
    nl = build_neighbor_list(
        jnp.asarray(pos), jnp.asarray(cell), 4.0, max_neighbors=96, grid=g
    )
    bf = build_neighbor_list_bruteforce(
        jnp.asarray(pos), jnp.asarray(cell), 4.0, max_neighbors=96
    )
    assert not bool(nl.overflow)
    assert neighbor_sets(nl.idx) == neighbor_sets(bf.idx)

    # 300 atoms crammed into a 4 A ball: 9-bin occupancy >> W2. J wider
    # than the compacted candidate width also exercises the self-pad fill.
    clustered = np.concatenate(
        [rng.uniform(9, 13, (300, 3)), rng.uniform(0, L, (60, 3))]
    )
    nl2 = build_neighbor_list(
        jnp.asarray(clustered), jnp.asarray(cell), 4.0,
        max_neighbors=320, grid=g,
    )
    assert bool(nl2.overflow)


def test_fat_row_compaction_concentrated_occupancy(rng):
    """Halo-extended shard sets populate only a slice of the full-box grid:
    the compacted width must be sized from the OCCUPIED-region density
    (encoded by bin_capacity), not the global n/ncells mean — otherwise a
    dense slice in a mostly-empty grid permanently trips the overflow flag."""
    L = 40.0
    cell = np.diag([L, L, L])
    cutoff = 4.0
    g = grid_shape(cell, cutoff)  # 10^3 bins, most of them empty

    # 900 atoms confined to a 2-bin-thick slab (x in [0, 8)): the occupied
    # bins hold ~4.5 atoms each while n/ncells says 0.9 — a global-mean W2
    # sits decisively below the true 9-bin occupancy (~60)
    pos = np.concatenate(
        [rng.uniform(0, 8.0, (900, 1)), rng.uniform(0, L, (900, 2))], axis=1
    )
    n_real = 900
    n_pad = 960  # padded capacity rows, parked at a fill position
    pos_ext = np.concatenate([pos, np.full((n_pad - n_real, 3), 1.0)])
    real = np.arange(n_pad) < n_real

    # the caller-formula capacity for the occupied density (as the sharded
    # engines compute it: 2.2 * global mean + 12 over the occupied region)
    occupied_mean = n_real / (2 * 10 * 10)  # atoms per occupied bin
    bin_cap = max(1, int(np.ceil(2.2 * occupied_mean))) + 12

    nl = build_neighbor_list(
        jnp.asarray(pos_ext), jnp.asarray(cell), cutoff,
        max_neighbors=64, grid=g, real=jnp.asarray(real),
        bin_capacity=bin_cap,
    )
    assert not bool(nl.overflow)

    bf = build_neighbor_list_bruteforce(
        jnp.asarray(pos), jnp.asarray(cell), cutoff, max_neighbors=64
    )
    got = neighbor_sets(nl.idx[:n_real])
    want = neighbor_sets(bf.idx)
    assert got == want
