"""The MTP hot path: per-neighborhood moment construction, DAG contraction,
linear energy readout — batched over all atoms with static shapes.

This replaces the reference's six-kernel GPU pipeline
(pair_mtp_kokkos.cpp:404-670) with a single traced function XLA can fuse.
Design notes (written for an accelerator, not a translation):

* Basic moments are computed with *unit-vector* powers: because the rank-nu
  normalization divides by d^nu (pair_mtp.cpp:162-172), the coordinate powers
  r^a / d^nu are exactly (r/d)^a. One divide replaces the reference's separate
  dist_powers / coord_powers tables.
* Forces come from `jax.grad` of the site-energy sum w.r.t. the displacement
  array — replacing ~150 lines of hand-written backprop + Jacobian plumbing
  (pair_mtp.cpp:154-254). The per-pair gradient dE/d(disp_ij) is the same
  `temp_force` the reference scatters (pair_mtp.cpp:236-254).
* The contraction DAG (`alpha_index_times`, pair_mtp.cpp:196-201) has static
  indices known at trace time. We partition it into dependency *waves* once at
  load time (generalizing the reference's 3-wave split,
  pair_mtps_kokkos.cpp:179-200) and execute each wave as
  gather -> multiply -> scatter-add with fully static index arrays.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from mtp_jax.ops.chebyshev import chebyshev_basis


@dataclasses.dataclass(frozen=True)
class MTPSchedule:
    """Static (trace-time constant) MTP contraction schedule.

    Hashable so functions carrying it can be `jax.jit` static arguments; the
    hash covers the table contents.
    """

    species_count: int
    radial_basis_size: int
    radial_funcs_count: int
    min_dist: float
    max_dist: float
    scaling: float
    alpha_moments_count: int
    alpha_index_basic: tuple  # of (mu, ax, ay, az)
    alpha_index_times: tuple  # of (a0, a1, mult, a3)
    alpha_moment_mapping: tuple

    @classmethod
    def from_tables(
        cls,
        *,
        species_count,
        radial_basis_size,
        radial_funcs_count,
        min_dist,
        max_dist,
        scaling,
        alpha_moments_count,
        alpha_index_basic,
        alpha_index_times,
        alpha_moment_mapping,
    ):
        return cls(
            species_count=int(species_count),
            radial_basis_size=int(radial_basis_size),
            radial_funcs_count=int(radial_funcs_count),
            min_dist=float(min_dist),
            max_dist=float(max_dist),
            scaling=float(scaling),
            alpha_moments_count=int(alpha_moments_count),
            alpha_index_basic=tuple(map(tuple, np.asarray(alpha_index_basic).tolist())),
            alpha_index_times=tuple(map(tuple, np.asarray(alpha_index_times).tolist())),
            alpha_moment_mapping=tuple(np.asarray(alpha_moment_mapping).tolist()),
        )

    # ---- derived static tables (cached as numpy) ----
    @property
    def basic(self) -> np.ndarray:
        return np.asarray(self.alpha_index_basic, dtype=np.int32).reshape(-1, 4)

    @property
    def times(self) -> np.ndarray:
        return np.asarray(self.alpha_index_times, dtype=np.int32).reshape(-1, 4)

    @property
    def mapping(self) -> np.ndarray:
        return np.asarray(self.alpha_moment_mapping, dtype=np.int32)

    @property
    def basic_count(self) -> int:
        return len(self.alpha_index_basic)

    @property
    def max_rank(self) -> int:
        return int(self.basic[:, 1:].sum(axis=1).max()) if self.basic_count else 0

    def waves(self):
        """Partition the product DAG into dependency waves.

        Node depth: basics are 0; node a3's depth is 1 + max input depth over
        all rows writing it (fixpoint). All rows writing a node execute in
        wave depth-1; consumers read strictly later. For MLIP-template tables
        this yields <=3 waves (cf. pair_mtps_kokkos.cpp:179-200); arbitrary
        valid tables give more.
        """
        t = self.times
        M = self.alpha_moments_count
        depth = np.zeros(M, dtype=np.int64)
        changed = True
        while changed:
            changed = False
            nd = np.maximum(depth[t[:, 0]], depth[t[:, 1]]) + 1
            for (a0, a1, _, a3), d in zip(t, nd):
                if d > depth[a3]:
                    depth[a3] = d
                    changed = True
        row_wave = depth[t[:, 3]] - 1
        n_waves = int(depth.max()) if len(t) else 0
        return [t[row_wave == w] for w in range(n_waves)]


def _radial_part(sched: MTPSchedule, coeffs, dist, itypes, jtypes, dtype):
    """f_mu(d) for every pair: contraction of per-pair-type radial coefficients
    with the Chebyshev basis (pair_mtp.cpp:139-151).

    Returns (cheb (N,J,RB), f (N,J,MU)).
    """
    cheb = chebyshev_basis(
        dist, sched.radial_basis_size, sched.min_dist, sched.max_dist, sched.scaling
    ).astype(dtype)
    # (S,S,MU,RB) gathered at (N,J) pair types -> (N,J,MU,RB)
    c = coeffs.radial_coeffs.astype(dtype)[itypes[:, None], jtypes]
    # HIGHEST: a default-precision f32 einsum may round its operands (TF32
    # on the GPU), an error far above the force gate
    f = jnp.einsum(
        "njmr,njr->njm", c, cheb, precision=jax.lax.Precision.HIGHEST
    )
    return cheb, f


def basic_moments(sched: MTPSchedule, coeffs, disp, mask, itypes, jtypes, dtype=None):
    """Basic moments m_k = sum_j f_{mu_k}(d_j) * (r/d)^{alpha_k}  for all atoms.

    Args:
      disp: (N, J, 3) displacement vectors r_ij = x_j - x_i (padded entries
        arbitrary; masked out).
      mask: (N, J) bool, True for real neighbors within the outer cutoff.
      itypes: (N,) central types; jtypes: (N, J) neighbor types (0-indexed).

    Returns (m_basic (N, B), aux dict with intermediates for active learning).
    """
    dtype = dtype or disp.dtype
    basic = sched.basic
    d2 = jnp.sum(disp * disp, axis=-1)
    safe = jnp.where(mask, d2, jnp.asarray(1.0, d2.dtype))
    dist = jnp.sqrt(safe)
    cheb, f = _radial_part(sched, coeffs, dist, itypes, jtypes, dtype)

    # unit-vector powers up to the max tensor rank
    u = disp / dist[..., None]
    max_rank = sched.max_rank
    upow = [jnp.ones_like(u)]
    for _ in range(max_rank):
        upow.append(upow[-1] * u)
    upow = jnp.stack(upow, axis=-2)  # (N, J, max_rank+1, 3)

    ax, ay, az = basic[:, 1], basic[:, 2], basic[:, 3]
    U = upow[..., ax, 0] * upow[..., ay, 1] * upow[..., az, 2]  # (N, J, B)
    F = f[..., basic[:, 0]]  # (N, J, B)
    w = jnp.where(mask, jnp.asarray(1.0, dtype), jnp.asarray(0.0, dtype))
    m_basic = jnp.einsum(
        "njb,nj->nb", F * U, w, precision=jax.lax.Precision.HIGHEST
    )
    aux = dict(cheb=cheb, U=U, dist=dist, mask=mask)
    return m_basic, aux


def contract_dag(sched: MTPSchedule, m_basic):
    """Run the product DAG: moments (N, M) from basic moments (N, B).

    Executes the static wave schedule; scatter-adds use `.at[].add` with
    trace-time-constant indices (duplicates accumulate, matching
    pair_mtp.cpp:196-201).
    """
    N = m_basic.shape[0]
    M = sched.alpha_moments_count
    m = jnp.zeros((N, M), dtype=m_basic.dtype)
    m = m.at[:, : sched.basic_count].set(m_basic)
    for wave in sched.waves():
        a0, a1, mult, a3 = (wave[:, k] for k in range(4))
        contrib = m[:, a0] * m[:, a1] * jnp.asarray(mult, m.dtype)
        m = m.at[:, a3].add(contrib)
    return m


def readout(sched: MTPSchedule, coeffs, moments, itypes):
    """Site energies: species constant + linear combination of scalar moments
    (pair_mtp.cpp:204-212)."""
    dtype = moments.dtype
    basis_members = moments[:, sched.mapping]  # (N, S)
    # HIGHEST: a rounded (TF32) readout biases every site energy, far above
    # the <1e-6 eV/atom gate
    e = jnp.matmul(
        basis_members,
        coeffs.moment_coeffs.astype(dtype),
        precision=jax.lax.Precision.HIGHEST,
    )
    return e + coeffs.species_coeffs.astype(dtype)[itypes], basis_members


def site_energies(sched: MTPSchedule, coeffs, disp, mask, itypes, jtypes, dtype=None):
    """Per-atom MTP energies as a pure function of displacements."""
    with jax.named_scope("mtp_basic_moments"):
        m_basic, _ = basic_moments(sched, coeffs, disp, mask, itypes, jtypes, dtype)
    with jax.named_scope("mtp_contract_dag"):
        moments = contract_dag(sched, m_basic)
    with jax.named_scope("mtp_readout"):
        e, _ = readout(sched, coeffs, moments, itypes)
    return e


@partial(jax.jit, static_argnames=("sched", "remat"))
def energy_and_pair_forces(sched, coeffs, disp, mask, itypes, jtypes, remat=True):
    """Total energy, per-atom energies, and per-pair force vectors.

    Returns (site_E (N,), pair_T (N,J,3)) where pair_T = dE_total/d(disp_ij)
    is the reference's `temp_force` (pair_mtp.cpp:241-246): the contribution
    of pair (i,j) adds +T to atom i and -T to atom j.
    """
    fn = site_energies
    if remat:
        fn = jax.checkpoint(fn, static_argnums=(0,))

    site_e, vjp = jax.vjp(lambda d: fn(sched, coeffs, d, mask, itypes, jtypes), disp)
    (pair_t,) = vjp(jnp.ones_like(site_e))
    pair_t = pair_t * mask[..., None].astype(pair_t.dtype)
    return site_e, pair_t
