"""Spatial domain decomposition: slab partitioning for a 1-D device mesh.

The reference inherits spatial decomposition + ghost atoms from LAMMPS MPI
(SURVEY.md §2.2/§2.3). Device-mesh version: the box is cut into equal-width
slabs along one cell vector, one slab per device along the mesh axis; each
slab is padded to a common atom capacity (static shapes). Ghost positions are
exchanged with ring `ppermute` every step (see `parallel/sharded_md.py`).

Constraint (asserted): slab perpendicular width >= cutoff + skin, so all
neighbors of an atom live in its own or adjacent slabs.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SlabPartition:
    """Host-side partition result. Arrays are (n_shards * capacity, ...) laid
    out shard-major so sharding along axis 0 gives each device its slab."""

    positions: np.ndarray
    velocities: np.ndarray
    types: np.ndarray
    masses: np.ndarray
    real: np.ndarray  # bool, False = padding slot
    capacity: int
    n_shards: int
    axis: int  # which cell vector the cut is along
    original_index: np.ndarray  # (n_shards*capacity,) -> index into input (or -1)

    def gather(self, arr_sharded: np.ndarray, n_atoms: int) -> np.ndarray:
        """Undo the partition permutation for a per-atom array."""
        out = np.zeros((n_atoms,) + arr_sharded.shape[1:], arr_sharded.dtype)
        m = self.original_index >= 0
        out[self.original_index[m]] = arr_sharded[m]
        return out


def partition_bricks(
    positions,
    velocities,
    types,
    masses,
    cell,
    shape: tuple,
    *,
    cutoff: float,
    axes: tuple = (0, 1),
    capacity: int | None = None,
    pad_multiple: int = 8,
) -> SlabPartition:
    """2-D brick decomposition: sort atoms into an (n0, n1) grid of bricks
    along two cell vectors (the LAMMPS brick-decomposition analog for a 2-D
    device mesh). Bricks are flattened brick-major (i0 * n1 + i1), matching
    `Mesh(devices.reshape(n0, n1), ...)` device order.

    Per-axis width guards as in :func:`partition_slabs` (>= cutoff; >= 2x
    cutoff when that axis has exactly 2 shards)."""
    n0, n1 = shape
    if n1 == 1:
        return partition_slabs(
            positions, velocities, types, masses, cell, n0,
            cutoff=cutoff, axis=axes[0], capacity=capacity,
            pad_multiple=pad_multiple,
        )
    positions = np.asarray(positions)
    cell = np.asarray(cell, dtype=np.float64)
    inv = np.linalg.inv(cell)
    frac = positions @ inv
    frac -= np.floor(frac)
    widths = 1.0 / np.linalg.norm(inv, axis=1)
    for ax, nk in zip(axes, shape):
        w = widths[ax] / nk
        min_w = 2.0 * cutoff if nk == 2 else cutoff
        if nk > 1 and w < min_w:
            raise ValueError(
                f"brick width {w:.2f} A along axis {ax} < required "
                f"{min_w:.2f} A: max shards along it is "
                f"{int(widths[ax] / cutoff)}"
            )
    i0 = np.minimum((frac[:, axes[0]] * n0).astype(np.int64), n0 - 1)
    i1 = np.minimum((frac[:, axes[1]] * n1).astype(np.int64), n1 - 1)
    brick = i0 * n1 + i1
    n_shards = n0 * n1
    counts = np.bincount(brick, minlength=n_shards)
    if capacity is None:
        capacity = int(
            np.ceil((counts.max() * 1.1 + 4) / pad_multiple) * pad_multiple
        )
    elif counts.max() > capacity:
        raise ValueError(
            f"brick overflow: max count {counts.max()} > capacity {capacity}"
        )
    n = len(positions)
    total = n_shards * capacity
    pos_out = np.zeros((total, 3), positions.dtype)
    vel_out = np.zeros((total, 3), positions.dtype)
    typ_out = np.zeros((total,), np.int32)
    mas_out = np.ones((total,), positions.dtype)
    real = np.zeros((total,), bool)
    orig = np.full((total,), -1, np.int64)
    order = np.argsort(brick, kind="stable")
    offsets = np.concatenate([[0], np.cumsum(counts)])
    for s in range(n_shards):
        sel = order[offsets[s] : offsets[s + 1]]
        dst = np.arange(len(sel)) + s * capacity
        pos_out[dst] = positions[sel]
        vel_out[dst] = np.asarray(velocities)[sel]
        typ_out[dst] = np.asarray(types)[sel]
        mas_out[dst] = np.asarray(masses)[sel]
        real[dst] = True
        orig[dst] = sel
    return SlabPartition(
        positions=pos_out,
        velocities=vel_out,
        types=typ_out,
        masses=mas_out,
        real=real,
        capacity=capacity,
        n_shards=n_shards,
        axis=axes[0],
        original_index=orig,
    )


def partition_slabs(
    positions,
    velocities,
    types,
    masses,
    cell,
    n_shards: int,
    *,
    cutoff: float,
    axis: int = 0,
    capacity: int | None = None,
    pad_multiple: int = 8,
) -> SlabPartition:
    """Sort atoms into x-slabs (fractional coordinate along `axis`)."""
    positions = np.asarray(positions)
    cell = np.asarray(cell, dtype=np.float64)
    inv = np.linalg.inv(cell)
    frac = positions @ inv
    frac -= np.floor(frac)

    widths = 1.0 / np.linalg.norm(inv, axis=1)
    slab_w = widths[axis] / n_shards
    # hard cap of 1-D slab decomposition: every neighbor must live in the
    # own or ADJACENT slab, so n_shards <= box_width / cutoff. On exactly
    # two shards both faces ship to the SAME device, so an atom must never
    # sit in both face shells: slab width >= 2*cutoff there.
    min_w = 2.0 * cutoff if n_shards == 2 else cutoff
    if slab_w < min_w:
        raise ValueError(
            f"slab width {slab_w:.2f} A < required {min_w:.2f} A "
            f"({'2x cutoff on a 2-shard mesh' if n_shards == 2 else 'cutoff'}"
            f"): max shards for this box along axis {axis} is "
            f"{int(widths[axis] / cutoff)} (1-D slab decomposition limit)"
        )

    slab = np.minimum((frac[:, axis] * n_shards).astype(np.int64), n_shards - 1)
    counts = np.bincount(slab, minlength=n_shards)
    if capacity is None:
        # ~10% headroom: migration needs free slots for atoms drifting in
        capacity = int(
            np.ceil((counts.max() * 1.1 + 4) / pad_multiple) * pad_multiple
        )
    elif counts.max() > capacity:
        raise ValueError(f"slab overflow: max count {counts.max()} > capacity {capacity}")

    n = len(positions)
    total = n_shards * capacity
    pos_out = np.zeros((total, 3), positions.dtype)
    vel_out = np.zeros((total, 3), positions.dtype)
    typ_out = np.zeros((total,), np.int32)
    mas_out = np.ones((total,), positions.dtype)
    real = np.zeros((total,), bool)
    orig = np.full((total,), -1, np.int64)

    order = np.argsort(slab, kind="stable")
    offsets = np.concatenate([[0], np.cumsum(counts)])
    for s in range(n_shards):
        sel = order[offsets[s] : offsets[s + 1]]
        dst = np.arange(len(sel)) + s * capacity
        pos_out[dst] = positions[sel]
        vel_out[dst] = np.asarray(velocities)[sel]
        typ_out[dst] = np.asarray(types)[sel]
        mas_out[dst] = np.asarray(masses)[sel]
        real[dst] = True
        orig[dst] = sel

    return SlabPartition(
        positions=pos_out,
        velocities=vel_out,
        types=typ_out,
        masses=mas_out,
        real=real,
        capacity=capacity,
        n_shards=n_shards,
        axis=axis,
        original_index=orig,
    )
