"""Double-float (f32x2) MTP evaluation: reference-grade energies AND forces
from f32 arithmetic.

The fp32 production path's force error lives in the per-pair backward-DAG
arithmetic itself: compensated *summation* buys nothing; only higher-
precision *terms* can cross the <1e-6 reference-parity gate (the reference,
pair_mtp.cpp, is all-double). This module evaluates the full MTP chain —
Chebyshev recurrence (mtp_rb_chevbyshev_basis.cpp:29-54 semantics), radial
contraction, unit-vector moment construction (pair_mtp.cpp:139-201), product
DAG, linear readout (pair_mtp.cpp:204-212), and a hand-written reverse pass
emitting per-pair forces (the reference's `temp_force`, pair_mtp.cpp:236-254)
— entirely in (hi, lo) double-float arithmetic (ops/df32.py), then rounds
once to f32.

Design notes:
* autodiff cannot be reused here: `jax.vjp` of the f32 path computes the
  *backward itself* in f32, which is exactly where the error lives. The
  reverse pass is hand-derived in df ops.
* df addition is not componentwise, so the DAG's duplicate-target
  scatter-adds (`.at[].add`) are replaced by statically-split sub-batches
  with unique targets per batch: gather -> df add -> exact set. The split is
  computed once at trace time from the static alpha tables (<=46 sub-batches
  at level 16).
* All J/B/RB reductions are pairwise trees (df32.tree_sum), keeping every
  partial in df.
* Atom-chunked via lax.map so the (n, J, B) df intermediates stay bounded;
  throughput is secondary — this is the accuracy mode, not the MD hot path.

CPU-compile caveat: jax 0.9.0's new MLIR CPU fusion emitters take tens of
minutes of LLVM time on this module's long error-free-transform chains
(measured >18 min for a level-8 graph; 5 s with the legacy emitters). When
compiling the df32 path for CPU (tests, offline validation), set
``XLA_FLAGS=--xla_cpu_use_fusion_emitters=false`` before importing jax —
tests/conftest.py does. The flag is CPU-only.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from mtp_jax.ops import df32 as df


def _barrier(*trees):
    """`optimization_barrier` between pipeline stages.

    The df arithmetic builds extremely LONG sequential dependency chains of
    tiny add/sub ops (every error-free transform is ~6 serial ops); XLA's
    CPU fusion/simplification passes go superlinear on such chains — a
    level-8 module (5.6k HLO ops) measured >10 min to compile on one CPU
    core without barriers. Cutting the graph at stage boundaries bounds
    every pass's working set; the df values flowing through are tiny
    ((chunk, M) pairs), so the lost fusion is noise at runtime. The barrier
    is also a semantics GUARANTEE the df recipes want: no algebraic rewrite
    can ever look across stages.
    """
    out = jax.lax.optimization_barrier(trees)
    return out if len(trees) > 1 else out[0]


def _unique_batches(idx):
    """Split static index array into sub-batches with unique values each.

    Returns a list of (row_positions, targets) numpy pairs; sequential
    gather/df-add/set over the batches implements an exact df scatter-add.
    """
    idx = np.asarray(idx)
    remaining = list(range(len(idx)))
    batches = []
    while remaining:
        seen, cur, rest = set(), [], []
        for r in remaining:
            t = int(idx[r])
            if t in seen:
                rest.append(r)
            else:
                seen.add(t)
                cur.append(r)
        cur = np.asarray(cur, dtype=np.int64)
        batches.append((cur, idx[cur]))
        remaining = rest
    return batches


def _df_scatter_add_cols(m, idx, contrib):
    """m[:, idx] += contrib for a df (n, M) array, duplicate-safe.

    idx is a static numpy array; contrib a df (n, len(idx)) pair.
    """
    m_hi, m_lo = m
    for rows, targets in _unique_batches(idx):
        cur = (m_hi[:, targets], m_lo[:, targets])
        new = df.add(cur, (contrib[0][:, rows], contrib[1][:, rows]))
        m_hi = m_hi.at[:, targets].set(new[0])
        m_lo = m_lo.at[:, targets].set(new[1])
    return m_hi, m_lo


def _chebyshev_df(sched, dist):
    """Radial basis values and derivatives in df, stacked on a new last axis.

    Same recurrences as the f64 oracle (utils/golden.py:21-41).
    """
    lo, hi, s = sched.min_dist, sched.max_dist, sched.scaling
    inv_w = 1.0 / (hi - lo)
    mult = 2.0 * inv_w
    shape = dist[0].shape

    def c(v):
        hi_, lo_ = df.const(v)
        return jnp.broadcast_to(hi_, shape), jnp.broadcast_to(lo_, shape)

    # ksi = (2 d - (lo+hi)) / (hi-lo), computed as (2d - (lo+hi)) * inv_w in
    # df; env = (d - hi)^2
    ksi = df.mul(df.add(df.mul_f(dist, jnp.float32(2.0)), c(-(lo + hi))), c(inv_w))
    dmh = df.add(dist, c(-hi))
    env = df.mul(dmh, dmh)
    vals = [df.mul(env, c(s)), None]
    vals[1] = df.mul(ksi, vals[0])
    ders = [df.mul(dmh, c(2.0 * s)), None]
    ders[1] = df.add(df.mul(env, c(s * mult)), df.mul(ksi, ders[0]))
    for i in range(2, sched.radial_basis_size):
        two_ksi = df.mul_f(ksi, jnp.float32(2.0))
        vals.append(df.sub(df.mul(two_ksi, vals[i - 1]), vals[i - 2]))
        ders.append(
            df.sub(
                df.mul_f(
                    df.add(df.mul(vals[i - 1], c(mult)), df.mul(ksi, ders[i - 1])),
                    jnp.float32(2.0),
                ),
                ders[i - 2],
            )
        )
        vals[i], ders[i] = _barrier(vals[i], ders[i])

    def stack(xs):
        return (
            jnp.stack([x[0] for x in xs], axis=-1),
            jnp.stack([x[1] for x in xs], axis=-1),
        )

    return stack(vals), stack(ders)


def _gather_last(x, idx):
    """Componentwise static-index gather on a df array's last axis."""
    return x[0][..., idx], x[1][..., idx]


def _chunk_eval(sched, coeffs, disp_hi, disp_lo, mask, itypes, jtypes):
    """site energies (f32) + per-pair forces (f32) for one atom chunk, df."""
    basic = sched.basic
    ax, ay, az = basic[:, 1], basic[:, 2], basic[:, 3]
    mu = basic[:, 0]
    axm = np.maximum(ax - 1, 0)
    aym = np.maximum(ay - 1, 0)
    azm = np.maximum(az - 1, 0)
    f32 = jnp.float32
    zero = jnp.zeros_like
    disp = (disp_hi, disp_lo)

    # --- distances ---
    def comp(c):
        return disp_hi[..., c], disp_lo[..., c]

    p0 = df.mul(comp(0), comp(0))
    p1 = df.mul(comp(1), comp(1))
    p2 = df.mul(comp(2), comp(2))
    d2 = df.add(df.add(p0, p1), p2)
    one = (jnp.ones_like(d2[0]), zero(d2[0]))
    d2 = df.where(mask, d2, one)
    dist = df.sqrt(d2)
    inv_dist = df.div(one, dist)

    # --- radial part ---
    vals, ders = _chebyshev_df(sched, dist)  # (n, J, RB) df each
    rc = coeffs.radial_coeffs.astype(f32)[itypes[:, None], jtypes]  # (n,J,MU,RB)
    f_mu = df.tree_sum(df.mul_f((vals[0][..., None, :], vals[1][..., None, :]), rc), axis=-1)
    fder_mu = df.tree_sum(df.mul_f((ders[0][..., None, :], ders[1][..., None, :]), rc), axis=-1)
    f_mu, fder_mu = _barrier(f_mu, fder_mu)

    # --- unit-vector powers ---
    u = df.div(disp, (dist[0][..., None], dist[1][..., None]))
    upow = [(jnp.ones_like(disp_hi), zero(disp_hi))]
    for _ in range(sched.max_rank):
        upow.append(df.mul(upow[-1], u))
    upow = (
        jnp.stack([p[0] for p in upow], axis=-2),
        jnp.stack([p[1] for p in upow], axis=-2),
    )  # (n, J, R+1, 3)

    def upow_at(pw, comp):
        return upow[0][..., pw, comp], upow[1][..., pw, comp]

    Ux, Uy, Uz = upow_at(ax, 0), upow_at(ay, 1), upow_at(az, 2)
    U = df.mul(df.mul(Ux, Uy), Uz)  # (n, J, B)
    F = _gather_last(f_mu, mu)
    Fder = _gather_last(fder_mu, mu)

    FU = df.mul(F, U)
    zb = (zero(FU[0]), zero(FU[1]))
    FU = df.where(mask[..., None], FU, zb)
    m_basic = _barrier(df.tree_sum(FU, axis=1))  # (n, B)

    # --- DAG contraction ---
    n = disp_hi.shape[0]
    M = sched.alpha_moments_count
    m = (jnp.zeros((n, M), f32), jnp.zeros((n, M), f32))
    m = (
        m[0].at[:, : sched.basic_count].set(m_basic[0]),
        m[1].at[:, : sched.basic_count].set(m_basic[1]),
    )
    waves = sched.waves()
    for wave in waves:
        a0, a1, mlt, a3 = (wave[:, k] for k in range(4))
        contrib = df.mul_f(
            df.mul((m[0][:, a0], m[1][:, a0]), (m[0][:, a1], m[1][:, a1])),
            jnp.asarray(mlt, f32),
        )
        m = _barrier(_df_scatter_add_cols(m, a3, contrib))

    # --- readout ---
    mapping = sched.mapping
    bm = (m[0][:, mapping], m[1][:, mapping])
    mc = coeffs.moment_coeffs.astype(f32)
    site_e = df.tree_sum(df.mul_f(bm, mc), axis=1)
    site_e = _barrier(df.add_f(site_e, coeffs.species_coeffs.astype(f32)[itypes]))

    # --- reverse pass: g = dE_total/dm ---
    g = (jnp.zeros((n, M), f32), jnp.zeros((n, M), f32))
    g = _df_scatter_add_cols(
        g,
        mapping,
        (
            jnp.broadcast_to(mc, (n, len(mapping))),
            jnp.zeros((n, len(mapping)), f32),
        ),
    )
    for wave in reversed(waves):
        a0, a1, mlt, a3 = (wave[:, k] for k in range(4))
        t = df.mul_f((g[0][:, a3], g[1][:, a3]), jnp.asarray(mlt, f32))
        g = _df_scatter_add_cols(g, a0, df.mul(t, (m[0][:, a1], m[1][:, a1])))
        g = _barrier(_df_scatter_add_cols(g, a1, df.mul(t, (m[0][:, a0], m[1][:, a0]))))
    gb = (g[0][:, None, : sched.basic_count], g[1][:, None, : sched.basic_count])

    # --- per-pair force terms ---
    # E_pair = sum_b g_b f_b(d) U_b(u); dE/ddisp = Q u + (P - (P.u) u) / d
    # with Q = sum_b g_b f'_b U_b and P = sum_b g_b f_b dU/du.
    W = df.mul(gb, F)  # (n, J, B)
    Q = df.tree_sum(df.mul(df.mul(gb, Fder), U), axis=-1)  # (n, J)

    def p_comp(pw_own, own_exp, other1, other2, comp):
        base = df.mul(df.mul(upow_at(pw_own, comp), other1), other2)
        return df.tree_sum(
            df.mul(W, df.mul_f(base, jnp.asarray(own_exp, f32))), axis=-1
        )

    Px = _barrier(p_comp(axm, ax, Uy, Uz, 0))
    Py = _barrier(p_comp(aym, ay, Ux, Uz, 1))
    Pz = _barrier(p_comp(azm, az, Ux, Uy, 2))
    P = (
        jnp.stack([Px[0], Py[0], Pz[0]], axis=-1),
        jnp.stack([Px[1], Py[1], Pz[1]], axis=-1),
    )  # (n, J, 3)
    Pu = df.tree_sum(df.mul(P, u), axis=-1)  # (n, J)

    def ex(x):  # expand (n, J) df to (n, J, 1)
        return x[0][..., None], x[1][..., None]

    T = df.add(
        df.mul(u, ex(Q)),
        df.mul(df.sub(P, df.mul(u, ex(Pu))), ex(inv_dist)),
    )
    T = df.where(mask[..., None], T, (zero(T[0]), zero(T[1])))
    return df.to_f32(site_e), df.to_f32(T)


@partial(jax.jit, static_argnames=("sched", "chunk"))
def energy_and_pair_forces_df(
    sched, coeffs, disp, mask, itypes, jtypes, disp_lo=None, chunk=256
):
    """df32 analog of ops.moments.energy_and_pair_forces.

    Returns (site_E (N,), pair_T (N, J, 3)) as f32, with both computed in
    double-float internally — per-pair force terms carry ~49-bit accuracy,
    rounded once to f32 (PARITY.md's decomposition shows that suffices for
    ~1e-7 force parity; the J-sum in f32 is then harmless).

    `disp_lo` optionally carries the low words of exact df displacements
    (models.mtp.gather_displacements_df) so minimum-image rounding does not
    re-enter as an input perturbation at large boxes.
    """
    N = disp.shape[0]
    disp = disp.astype(jnp.float32)
    if disp_lo is None:
        disp_lo = jnp.zeros_like(disp)
    pad = (-N) % chunk
    if pad:
        disp = jnp.pad(disp, ((0, pad), (0, 0), (0, 0)))
        disp_lo = jnp.pad(disp_lo, ((0, pad), (0, 0), (0, 0)))
        mask = jnp.pad(mask, ((0, pad), (0, 0)))
        itypes = jnp.pad(itypes, (0, pad))
        jtypes = jnp.pad(jtypes, ((0, pad), (0, 0)))
    nc = disp.shape[0] // chunk

    def body(args):
        return _chunk_eval(sched, coeffs, *args)

    shaped = lambda x: x.reshape((nc, chunk) + x.shape[1:])  # noqa: E731
    site_e, pair_t = jax.lax.map(
        body,
        (shaped(disp), shaped(disp_lo), shaped(mask), shaped(itypes), shaped(jtypes)),
    )
    site_e = site_e.reshape(-1)[:N]
    pair_t = pair_t.reshape((-1,) + pair_t.shape[2:])[:N]
    return site_e, pair_t
