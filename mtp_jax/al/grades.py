"""MaxVol extrapolation grades (active learning), batched as matrix products.

The reference computes, per atom, the candidate vector b_i = dE_i/dtheta over
all model coefficients (radial block via a `radial_jacobian` accumulated in
the forward pass, species one-hot, scalar-basis members; reference
pair_mtp_extrapolation.cpp:193-252, 322-329) and then a per-atom team matvec
against the inverse active set (pair_mtp_extrapolation_kokkos.cpp:1156-1166).

Batched formulation:
* gamma_i = dE_i/d(basic moments) comes from one `jax.vjp` through the
  contraction DAG + readout (replacing the hand-written reverse pass).
* The radial Jacobian is an einsum over the same Chebyshev values and
  unit-vector powers the forward pass produces.
* All atoms' candidate vectors form a matrix B (N, P); grades are
  max|B @ invA^T|: one large matmul instead of per-atom matvecs.

Coefficient-vector layout (must match the MVS active-set files,
pair_mtp_extrapolation.cpp:533): [radial (S,S,MU,RB) row-major | species (S) |
scalar-basis (m_scal)].
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from mtp_jax.models.mtp import gather_displacements
from mtp_jax.ops.moments import (
    MTPSchedule,
    basic_moments,
    contract_dag,
    readout,
)


@partial(jax.jit, static_argnames=("sched",))
def candidate_vectors(sched: MTPSchedule, coeffs, positions, types, nbr_idx, cell=None):
    """Per-atom candidate vectors B (N, P) = dE_i/dtheta.

    Also returns site energies so an AL step does not need a second forward
    pass.
    """
    n = positions.shape[0]
    inv_cell = jnp.linalg.inv(cell) if cell is not None else None
    disp = gather_displacements(positions, nbr_idx, cell, inv_cell)
    d2 = jnp.sum(disp * disp, axis=-1)
    self_pair = nbr_idx == jnp.arange(n, dtype=nbr_idx.dtype)[:, None]
    mask = (d2 <= sched.max_dist**2) & (~self_pair)
    itypes = types
    jtypes = types[nbr_idx]

    m_basic, aux = basic_moments(sched, coeffs, disp, mask, itypes, jtypes)
    dtype = m_basic.dtype

    def site_e_of(mb):
        e, _ = readout(sched, coeffs, contract_dag(sched, mb), itypes)
        return jnp.sum(e)

    site_e, gamma = jax.value_and_grad(site_e_of)(m_basic)  # gamma (N, B)
    _, basis_members = readout(sched, coeffs, contract_dag(sched, m_basic), itypes)

    S = sched.species_count
    MU = sched.radial_funcs_count
    RB = sched.radial_basis_size
    B = sched.basic_count

    # radial jacobian contracted with gamma:
    #   rad[n, s, mu, ri] = sum_k gamma[n,k] * sum_j [tj=s] cheb[n,j,ri] U[n,j,k]
    # (reference pair_mtp_extrapolation.cpp:193-198 + 322-329, fused)
    w = jnp.where(mask, jnp.asarray(1.0, dtype), jnp.asarray(0.0, dtype))
    jt_onehot = jax.nn.one_hot(jtypes, S, dtype=dtype) * w[..., None]  # (N,J,S)
    # group gamma*U by the basic row's radial index mu via a static one-hot
    import numpy as np

    mu_onehot = jnp.asarray(
        np.eye(MU, dtype=np.float64)[sched.basic[:, 0]], dtype=dtype
    )  # (B, MU)
    gU = jnp.einsum("nk,njk,km->njm", gamma, aux["U"], mu_onehot, precision=jax.lax.Precision.HIGHEST)  # (N,J,MU)
    rad = jnp.einsum("njm,njs,njr->nsmr", gU, jt_onehot, aux["cheb"], precision=jax.lax.Precision.HIGHEST)  # (N,S,MU,RB)

    # scatter into the (itype, jtype) block: b_rad[n, ti, s, mu, ri]
    it_onehot = jax.nn.one_hot(itypes, S, dtype=dtype)  # (N,S)
    b_rad = jnp.einsum("nt,nsmr->ntsmr", it_onehot, rad, precision=jax.lax.Precision.HIGHEST).reshape(n, S * S * MU * RB)

    b = jnp.concatenate([b_rad, it_onehot, basis_members], axis=1)  # (N, P)
    return b, site_e


@partial(jax.jit, static_argnames=("sched",))
def candidates_and_forces(
    sched: MTPSchedule, coeffs, positions, types, nbr_idx, cell=None,
    nbr_mirror=None, row_valid=None,
):
    """Fused grade-step evaluation: ONE shared forward pass yields both the
    MD forces and the per-atom candidate vectors.

    The reference fuses the radial Jacobian into the alpha-basic kernel on
    grade steps so active learning costs ~one pass instead of two
    (ComputeAlphaBasicRad, pair_mtp_extrapolation_kokkos.cpp:780-907). Here
    the shared intermediates are the basic moments + Chebyshev/unit-vector
    tables: gamma = dE/d(moments) drives BOTH the force backward pass
    (chain rule through the moments) and the radial block of the candidate
    vectors.

    `row_valid`: optional (N,) bool: False rows (the sharded engine's ghost
    and padding rows) are excluded as centers; their site energies,
    candidate vectors, and own pair forces are zeroed, while their force
    rows still collect the give-back of valid pairs that point at them.

    Returns dict(b, site_energies, energy, forces, virial) — the virial is
    tallied too (LAMMPS semantics: compute() fills the virial whenever
    vflag is set, pair_mtp.cpp:257-266), so a barostatted AL run's force
    refresh leaves a fully consistent state.
    """
    from mtp_jax.models.mtp import _virial_tally, newton_forces

    n = positions.shape[0]
    inv_cell = jnp.linalg.inv(cell) if cell is not None else None
    disp = gather_displacements(positions, nbr_idx, cell, inv_cell)
    d2 = jnp.sum(disp * disp, axis=-1)
    self_pair = nbr_idx == jnp.arange(n, dtype=nbr_idx.dtype)[:, None]
    mask = (d2 <= sched.max_dist**2) & (~self_pair)
    if row_valid is None:
        row_valid = jnp.ones((n,), bool)
    mask = mask & row_valid[:, None]
    rows = (disp, mask, types, types[nbr_idx], row_valid)

    if n <= CHUNK_ROWS:
        b, site_e, pair_t = _candidate_rows(sched, coeffs, *rows)
    else:
        # bounded working set: the (rows, J, B) tables of one chunk at a
        # time (the reference's chunk loop, pair_mtp_kokkos.cpp:287-361)
        nb = -(-n // CHUNK_ROWS)
        pad = nb * CHUNK_ROWS - n

        def blocks(a):
            a = jnp.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1))
            return a.reshape((nb, CHUNK_ROWS) + a.shape[1:])

        out = jax.lax.map(
            lambda r: _candidate_rows(sched, coeffs, *r),
            tuple(blocks(a) for a in rows),
        )
        b, site_e, pair_t = (
            a.reshape((nb * CHUNK_ROWS,) + a.shape[2:])[:n] for a in out
        )
    forces = newton_forces(pair_t, nbr_idx, nbr_mirror)
    r = jnp.where(mask[..., None], disp, 0.0)
    virial = jnp.sum(_virial_tally(pair_t, r), axis=0)

    return dict(
        b=b,
        site_energies=site_e,
        energy=jnp.sum(site_e),
        forces=forces,
        virial=virial,
    )


# rows per chunk of the grade-step evaluation: the (rows, J, B) tables of
# a level-16 potential at J = 64 take ~1 GB per table at this size (the
# reference's documented chunk size, README.md:52-53)
CHUNK_ROWS = 32768


def _candidate_rows(sched, coeffs, disp, mask, itypes, jtypes, row_valid):
    """Candidate vectors, site energies and masked per-pair forces of a
    block of rows (rows are independent given their displacements)."""
    import numpy as np

    # shared forward: moments once, with the aux tables
    (m_basic, aux), vjp_mb = jax.vjp(
        lambda d: basic_moments(sched, coeffs, d, mask, itypes, jtypes), disp
    )

    def site_e_of(mb):
        e, _ = readout(sched, coeffs, contract_dag(sched, mb), itypes)
        return jnp.sum(e)

    gamma = jax.grad(site_e_of)(m_basic)  # (N, B) = dE/d(basic moments)
    site_e, basis_members = readout(
        sched, coeffs, contract_dag(sched, m_basic), itypes
    )

    # forces: chain gamma through the moments' dependence on displacements
    (pair_t,) = vjp_mb((gamma, jax.tree_util.tree_map(jnp.zeros_like, aux)))
    pair_t = pair_t * mask[..., None].astype(pair_t.dtype)

    # candidate vectors from the SAME gamma + aux tables
    n = disp.shape[0]
    dtype = m_basic.dtype
    S = sched.species_count
    MU = sched.radial_funcs_count
    RB = sched.radial_basis_size
    HI = jax.lax.Precision.HIGHEST
    w = jnp.where(mask, jnp.asarray(1.0, dtype), jnp.asarray(0.0, dtype))
    jt_onehot = jax.nn.one_hot(jtypes, S, dtype=dtype) * w[..., None]
    mu_onehot = jnp.asarray(np.eye(MU, dtype=np.float64)[sched.basic[:, 0]], dtype)
    gU = jnp.einsum("nk,njk,km->njm", gamma, aux["U"], mu_onehot, precision=HI)
    rad = jnp.einsum("njm,njs,njr->nsmr", gU, jt_onehot, aux["cheb"], precision=HI)
    rv = row_valid.astype(dtype)[:, None]
    it_onehot = jax.nn.one_hot(itypes, S, dtype=dtype) * rv  # zeroes the species AND radial blocks
    basis_members = basis_members * rv
    site_e = jnp.where(row_valid, site_e, 0.0)
    b_rad = jnp.einsum("nt,nsmr->ntsmr", it_onehot, rad, precision=HI).reshape(n, S * S * MU * RB)
    b = jnp.concatenate([b_rad, it_onehot, basis_members], axis=1)
    return b, site_e, pair_t


@jax.jit
def nbh_grades(b, inverse_active_set):
    """Neighborhood-mode grades: gamma_i = max_l |(invA @ b_i)_l|.

    One (N,P)x(P,P) matmul for the whole configuration (the batched
    replacement for pair_mtp_extrapolation_kokkos.cpp:1108-1172)."""
    # HIGHEST: a default-precision f32 matmul may round its operands (TF32
    # on the GPU), an error of O(1e-2) on candidate columns of scale ~30,
    # against O(1) grade thresholds
    g = jnp.abs(jnp.matmul(
        b, inverse_active_set.astype(b.dtype).T,
        precision=jax.lax.Precision.HIGHEST,
    ))
    return jnp.max(g, axis=-1)


@jax.jit
def cfg_grade(b, inverse_active_set, n_atoms):
    """Configuration-mode grade: sum candidate vectors over atoms, one matvec,
    normalize by atom count (pair_mtp_extrapolation.cpp:363-377)."""
    bsum = jnp.sum(b, axis=0)
    g = jnp.max(jnp.abs(jnp.matmul(
        inverse_active_set.astype(b.dtype), bsum,
        precision=jax.lax.Precision.HIGHEST,
    )))
    return g / jnp.maximum(n_atoms, 1)
