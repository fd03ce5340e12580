"""The MTP model: parameters + schedule + batched energy/force evaluation.

Splits the reference's monolithic pair style into three pieces:

* :class:`MTPCoeffs` — the differentiable coefficient pytree (radial, species,
  linear), the arrays `PairMTP::read_file` loads (pair_mtp.cpp:441-569).
* :class:`MTPSchedule` (ops/moments.py) — the static contraction program
  (alpha tables), a trace-time constant.
* :func:`mtp_energy_forces` — energy, forces, virial over a padded neighbor
  representation; the analog of `PairMTP::compute` (pair_mtp.cpp:72-280) but
  batched over all atoms and differentiated by XLA.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from mtp_jax.io.mtp_file import MTPData
from mtp_jax.ops.moments import (
    MTPSchedule,
    site_energies,
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class MTPCoeffs:
    """Differentiable MTP coefficients (a JAX pytree)."""

    radial_coeffs: jax.Array  # (S, S, MU, RB)
    species_coeffs: jax.Array  # (S,)
    moment_coeffs: jax.Array  # (n_scalar,)


@dataclasses.dataclass(frozen=True)
class MTPModel:
    """Bundle of schedule (static) + coefficients (pytree) + AL state."""

    schedule: MTPSchedule
    coeffs: MTPCoeffs
    inverse_active_set: Optional[jax.Array] = None  # (P, P)
    active_set: Optional[np.ndarray] = None
    configuration_mode: bool = False

    @property
    def cutoff(self) -> float:
        return self.schedule.max_dist

    @classmethod
    def from_data(cls, m: MTPData, dtype=jnp.float32) -> "MTPModel":
        sched = MTPSchedule.from_tables(
            species_count=m.species_count,
            radial_basis_size=m.radial_basis_size,
            radial_funcs_count=m.radial_funcs_count,
            min_dist=m.min_dist,
            max_dist=m.max_dist,
            scaling=m.scaling,
            alpha_moments_count=m.alpha_moments_count,
            alpha_index_basic=m.alpha_index_basic,
            alpha_index_times=m.alpha_index_times,
            alpha_moment_mapping=m.alpha_moment_mapping,
        )
        coeffs = MTPCoeffs(
            radial_coeffs=jnp.asarray(m.radial_coeffs, dtype=dtype),
            species_coeffs=jnp.asarray(m.species_coeffs, dtype=dtype),
            moment_coeffs=jnp.asarray(m.moment_coeffs, dtype=dtype),
        )
        inv = act = None
        cfg = False
        if m.mvs is not None:
            inv = jnp.asarray(m.mvs.inverse_active_set, dtype=dtype)
            act = m.mvs.active_set
            cfg = m.mvs.configuration_mode
        return cls(
            schedule=sched,
            coeffs=coeffs,
            inverse_active_set=inv,
            active_set=act,
            configuration_mode=cfg,
        )

    @classmethod
    def load(cls, path: str, dtype=jnp.float32) -> "MTPModel":
        from mtp_jax.io.mtp_file import load_mtp

        return cls.from_data(load_mtp(path), dtype=dtype)


def minimum_image(disp, cell, inv_cell):
    """Wrap displacement vectors to the nearest periodic image.

    Valid when the cell is at least twice the cutoff in every perpendicular
    width (the usual MD constraint; the reference inherits it from LAMMPS's
    domain decomposition).

    The 3x3 products are unrolled into per-component elementwise ops, so
    coordinates never pass through a matrix unit (no TF32 rounding) and the
    whole map fuses into one elementwise pass.
    """
    d = [disp[..., 0], disp[..., 1], disp[..., 2]]
    f = [
        d[0] * inv_cell[0, a] + d[1] * inv_cell[1, a] + d[2] * inv_cell[2, a]
        for a in range(3)
    ]
    f = [fa - jnp.round(fa) for fa in f]
    out = [
        f[0] * cell[0, a] + f[1] * cell[1, a] + f[2] * cell[2, a]
        for a in range(3)
    ]
    return jnp.stack(out, axis=-1)


def _gather_scalar(arr, idx):
    """Gather scalars by index through 8-wide padded rows (see
    :func:`_gather_rows3`)."""
    a8 = jnp.pad(arr[:, None], ((0, 0), (0, 7)))
    return a8[idx][..., 0]


def _gather_rows3(arr3, idx):
    """Gather (..., 3) rows by flat index, padded to 8 lanes first.

    The pad + slice is fused around the gather. Whether the padded row
    (32 B to carry 12 B) helps the GPU's gather is unmeasured: it is a
    layout lever kept for the benchmark to decide.
    """
    a8 = jnp.pad(arr3, ((0, 0), (0, 5)))
    return a8[idx][..., :3]


def gather_displacements(positions, nbr_idx, cell=None, inv_cell=None):
    """disp[i, jj] = x[nbr_idx[i, jj]] - x[i], minimum-imaged if periodic."""
    disp = _gather_rows3(positions, nbr_idx) - positions[:, None, :]
    if cell is not None:
        disp = minimum_image(disp, cell, inv_cell)
    return disp


def gather_displacements_df(positions, nbr_idx, cell=None, inv_cell=None):
    """Exact double-float displacements: (hi, lo) with hi+lo == x_j - x_i
    minus the integer image shift, exactly, given f32 inputs.

    The raw subtraction uses the error-free two_sum; the image SHIFT decision
    is made in f32 (an integer choice, robust far from the wrap boundary —
    the same minimum-image validity constraint as `minimum_image`), and the
    shift correction -s @ cell is applied with exact two_prod accumulation.
    This removes minimum-image f32 rounding (~ulp(box) ~ 1.5e-5 A at 252 A)
    as an input perturbation to the df32 accuracy path — at bench scale that
    rounding alone would exceed the <1e-6 force gate.
    """
    from mtp_jax.ops import df32 as df

    xj = _gather_rows3(positions, nbr_idx)
    xi = positions[:, None, :]
    hi, lo = df.two_sum(xj, -xi)
    if cell is None:
        return hi, lo
    d = [hi[..., 0], hi[..., 1], hi[..., 2]]
    s = [
        jnp.round(
            d[0] * inv_cell[0, a] + d[1] * inv_cell[1, a] + d[2] * inv_cell[2, a]
        )
        for a in range(3)
    ]
    out_hi, out_lo = [], []
    for a in range(3):
        acc = (hi[..., a], lo[..., a])
        for k in range(3):
            acc = df.add(acc, df.neg(df.prod_ff(s[k], cell[k, a])))
        out_hi.append(acc[0])
        out_lo.append(acc[1])
    return jnp.stack(out_hi, axis=-1), jnp.stack(out_lo, axis=-1)


@partial(
    jax.jit,
    static_argnames=("sched", "remat", "compute_vatom", "backend", "compute_virial"),
)
def mtp_energy_forces(
    sched: MTPSchedule,
    coeffs: MTPCoeffs,
    positions,
    types,
    nbr_idx,
    cell=None,
    nbr_mirror=None,
    *,
    jtypes=None,
    pair_valid=None,
    remat: bool = True,
    compute_vatom: bool = False,
    backend: str = "auto",
    compute_virial: bool = True,
):
    """Energy, forces, virial for one configuration.

    Args:
      positions: (N, 3).
      types: (N,) int32, 0-indexed species.
      nbr_idx: (N, J) int32 padded neighbor indices; padding entries must
        equal the row's own atom index (self-pairs are masked out).
      cell: optional (3, 3) row-vector cell for periodic boundaries.
      jtypes/pair_valid: optional precomputed (N, J) neighbor types and
        center/neighbor validity mask. These depend only on (types,
        nbr_idx), which are fixed for a whole neighbor-list block, and XLA
        does not hoist the (N, J) jtypes gather out of a `lax.scan`, so
        callers stepping in a scan precompute them outside the loop
        (Simulation does). A `pair_valid` row that is all False excludes
        that atom as a center (the sharded engine's ghost rows) while its
        row still receives the Newton give-back of the pairs that point at
        it.
      backend: "auto" (see :func:`resolve_backend`), "triton" (the fused
        moments kernel for NVIDIA GPUs, ops/triton_moments.py; fp32 only),
        "xla" (plain JAX differentiated by XLA: the reference path, any
        dtype, any platform) or "df32", the double-float accuracy mode
        (ops/moments_df.py): the reference's all-double accuracy class
        (pair_mtp.cpp) evaluated with f32 arithmetic, for validation and
        reference-grade single points.

    Returns dict: energy (scalar), site_energies (N,), forces (N,3),
    virial (6,) in Voigt order (xx,yy,zz,xy,xz,yz), and optionally
    vatom (N,6).
    """
    n = positions.shape[0]
    inv_cell = jnp.linalg.inv(cell) if cell is not None else None
    disp_lo = None
    backend = resolve_backend(backend, positions.dtype)
    if backend == "df32":
        disp, disp_lo = gather_displacements_df(positions, nbr_idx, cell, inv_cell)
    else:
        disp = gather_displacements(positions, nbr_idx, cell, inv_cell)
    d2 = jnp.sum(disp * disp, axis=-1)
    if pair_valid is None:
        pair_valid = nbr_idx != jnp.arange(n, dtype=nbr_idx.dtype)[:, None]
    mask = (d2 <= sched.max_dist**2) & pair_valid

    itypes = types
    if jtypes is None:
        jtypes = _gather_scalar(types, nbr_idx)

    if backend == "df32":
        # reference-accuracy-class (all-double, pair_mtp.cpp) evaluation:
        # the whole chain in double-float arithmetic
        from mtp_jax.ops.moments_df import energy_and_pair_forces_df

        site_e, pair_t = energy_and_pair_forces_df(
            sched, coeffs, disp, mask, itypes, jtypes, disp_lo=disp_lo
        )
    elif backend == "triton":
        from mtp_jax.ops.triton_moments import site_energies_and_pair_forces

        site_e, pair_t = site_energies_and_pair_forces(
            sched, coeffs, disp, mask, itypes, jtypes
        )
    elif backend == "xla":
        fn = site_energies
        if remat:
            fn = jax.checkpoint(fn, static_argnums=(0,))
        site_e, vjp = jax.vjp(
            lambda d: fn(sched, coeffs, d, mask, itypes, jtypes), disp
        )
        (pair_t,) = vjp(jnp.ones_like(site_e))
        pair_t = pair_t * mask[..., None].astype(pair_t.dtype)
    else:
        raise ValueError(f"unknown backend {backend!r}")

    forces = newton_forces(pair_t, nbr_idx, nbr_mirror)
    out = dict(
        energy=jnp.sum(site_e),
        site_energies=site_e,
        forces=forces,
    )
    if compute_virial or compute_vatom:
        # virial tally (pair_mtp.cpp:257-266): W -= sym(T (x) r). Optional,
        # like LAMMPS's vflag: NVE inner steps don't need per-step pressure.
        r = jnp.where(mask[..., None], disp, 0.0)
        vatom = _virial_tally(pair_t, r)
        out["virial"] = jnp.sum(vatom, axis=0)
        if compute_vatom:
            out["vatom"] = vatom
    else:
        out["virial"] = jnp.zeros((6,), dtype=forces.dtype)
    return out


def resolve_backend(backend: str, dtype) -> str:
    """The force path "auto" stands for: the fused kernel for fp32 on a
    GPU (measured 16x the XLA path end to end at 32k and 1M atoms on an
    H100, PERF.md), else the XLA path."""
    if backend != "auto":
        return backend
    if jax.default_backend() == "gpu" and jnp.dtype(dtype) == jnp.float32:
        return "triton"
    return "xla"


def newton_forces(pair_t, nbr_idx, nbr_mirror=None):
    """Per-atom forces from per-pair forces (Newton's third law,
    pair_mtp.cpp:248-254): +T to the center, -T to each neighbor.

    With the flat mirror permutation the give-back is a gather of the
    mirrored pair's T (full lists are symmetric); without it, a scatter-add.
    The gathered t_ji needs no mask of its own: masked pairs carry T = 0,
    padding slots mirror among themselves, and the distance mask is bitwise
    symmetric (the minimum-image displacement is exactly antisymmetric). A
    row excluded as a center therefore still collects -T from every valid
    pair that points at it.
    """
    if nbr_mirror is not None:
        flat = pair_t.reshape(-1, 3)
        t_ji = _gather_rows3(flat, nbr_mirror).reshape(pair_t.shape)
        return jnp.sum(pair_t - t_ji, axis=1)
    forces = jnp.sum(pair_t, axis=1)
    return forces.at[nbr_idx.reshape(-1)].add(-pair_t.reshape(-1, 3))


def _virial_tally(pair_t, r):
    """Per-atom virial tally (N, 6) in Voigt order (xx,yy,zz,xy,xz,yz)."""
    vxx = -jnp.sum(pair_t[..., 0] * r[..., 0], axis=1)
    vyy = -jnp.sum(pair_t[..., 1] * r[..., 1], axis=1)
    vzz = -jnp.sum(pair_t[..., 2] * r[..., 2], axis=1)
    vxy = -0.5 * jnp.sum(
        pair_t[..., 0] * r[..., 1] + pair_t[..., 1] * r[..., 0], axis=1
    )
    vxz = -0.5 * jnp.sum(
        pair_t[..., 0] * r[..., 2] + pair_t[..., 2] * r[..., 0], axis=1
    )
    vyz = -0.5 * jnp.sum(
        pair_t[..., 1] * r[..., 2] + pair_t[..., 2] * r[..., 1], axis=1
    )
    return jnp.stack([vxx, vyy, vzz, vxy, vxz, vyz], axis=-1)


def mtp_energy(sched, coeffs, positions, types, nbr_idx, cell=None):
    """Total potential energy only (no force computation)."""
    n = positions.shape[0]
    inv_cell = jnp.linalg.inv(cell) if cell is not None else None
    disp = gather_displacements(positions, nbr_idx, cell, inv_cell)
    d2 = jnp.sum(disp * disp, axis=-1)
    self_pair = nbr_idx == jnp.arange(n, dtype=nbr_idx.dtype)[:, None]
    mask = (d2 <= sched.max_dist**2) & (~self_pair)
    return jnp.sum(
        site_energies(sched, coeffs, disp, mask, types, types[nbr_idx])
    )
