"""Fused MTP moments, contraction DAG, readout and their backward in one
Pallas kernel for NVIDIA GPUs (the Triton route).

One program handles a block of atoms, one atom per thread. It loops over the
J neighbor slots accumulating the B basic moments in registers, runs the
static contraction DAG and the readout, runs the DAG backward, and loops
over J again to emit dE/du and dE/df_mu per pair: the (N, J, B) tables that
the XLA path writes to device memory never exist. The per-pair prologue
(distance, unit vector u, radial functions f_mu) and its backward stay in
XLA under `jax.vjp`, so the kernel has no gradient rule of its own: it is
the middle of one vjp. Arithmetic is elementwise fp32, with no matrix unit
and so no TF32.

Layouts: per-pair inputs and outputs are (J_pad, N_pad) arrays, one per
vector component or radial function, so that row j of a block is the
contiguous slot-j values of BLOCK_N atoms. J_pad is a power of two (Triton
block shapes); padded slots and atoms carry u = f = 0.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from mtp_jax.ops.moments import _radial_part

BLOCK_N = 128  # atoms per program: one per thread at NUM_WARPS = 4
NUM_WARPS = 4


def _kernel_body(sched, bj, ux_ref, uy_ref, uz_ref, *refs):
    MU = sched.radial_funcs_count
    f_refs = refs[:MU]
    xi_ref = refs[MU]
    e_ref = refs[MU + 1]
    gux_ref, guy_ref, guz_ref = refs[MU + 2: MU + 5]
    gf_refs = refs[MU + 5: MU + 5 + MU]

    basic = sched.basic
    B = sched.basic_count
    mu_b = basic[:, 0].tolist()
    ax = basic[:, 1].tolist()
    ay = basic[:, 2].tolist()
    az = basic[:, 3].tolist()
    rx, ry, rz = max(ax), max(ay), max(az)

    def powers(v, r):
        p = [None, v]
        for _ in range(r - 1):
            p.append(p[-1] * v)
        return p

    def monomial(px, py, pz, a, b, c):
        t = None
        for p, k in ((px, a), (py, b), (pz, c)):
            if k:
                t = p[k] if t is None else t * p[k]
        return t

    def load_row(ref, j):
        return ref[j, :]

    def fwd(j, acc):
        ux, uy, uz = load_row(ux_ref, j), load_row(uy_ref, j), load_row(uz_ref, j)
        f = [load_row(r, j) for r in f_refs]
        px, py, pz = powers(ux, rx), powers(uy, ry), powers(uz, rz)
        out = []
        for b in range(B):
            m = monomial(px, py, pz, ax[b], ay[b], az[b])
            t = f[mu_b[b]] if m is None else f[mu_b[b]] * m
            out.append(acc[b] + t)
        return tuple(out)

    bn = ux_ref.shape[1]
    zero = jnp.zeros((bn,), jnp.float32)
    mb = jax.lax.fori_loop(0, bj, fwd, tuple(zero for _ in range(B)))

    # contraction DAG (static, wave order) and readout
    M = sched.alpha_moments_count
    m = list(mb) + [None] * (M - B)
    waves = sched.waves()
    for wave in waves:
        for a0, a1, mult, a3 in wave.tolist():
            t = m[a0] * m[a1] * float(mult)
            m[a3] = t if m[a3] is None else m[a3] + t
    mapping = sched.mapping.tolist()
    xi = [xi_ref[k] for k in range(len(mapping))]
    e = None
    for k, idx in enumerate(mapping):
        t = m[idx] * xi[k]
        e = t if e is None else e + t
    e_ref[...] = e

    # reverse DAG
    g = [None] * M
    for k, idx in enumerate(mapping):
        g[idx] = xi[k] + zero if g[idx] is None else g[idx] + xi[k]
    for wave in reversed(waves):
        for a0, a1, mult, a3 in reversed(wave.tolist()):
            if g[a3] is None:
                continue
            ga = g[a3] * float(mult)
            t0, t1 = ga * m[a1], ga * m[a0]
            g[a0] = t0 if g[a0] is None else g[a0] + t0
            g[a1] = t1 if g[a1] is None else g[a1] + t1
    gb = [zero if g[b] is None else g[b] for b in range(B)]

    def bwd(j, carry):
        ux, uy, uz = load_row(ux_ref, j), load_row(uy_ref, j), load_row(uz_ref, j)
        f = [load_row(r, j) for r in f_refs]
        px, py, pz = powers(ux, rx), powers(uy, ry), powers(uz, rz)
        one = jnp.ones_like(ux)
        gf = [None] * MU
        gx = gy = gz = zero
        for b in range(B):
            a, bb, c = ax[b], ay[b], az[b]
            mono = monomial(px, py, pz, a, bb, c)
            mono = one if mono is None else mono
            t = gb[b] * mono
            mu = mu_b[b]
            gf[mu] = t if gf[mu] is None else gf[mu] + t
            w = gb[b] * f[mu]
            if a:
                d = monomial(px, py, pz, a - 1, bb, c)
                d = one if d is None else d
                gx = gx + w * (a * d)
            if bb:
                d = monomial(px, py, pz, a, bb - 1, c)
                d = one if d is None else d
                gy = gy + w * (bb * d)
            if c:
                d = monomial(px, py, pz, a, bb, c - 1)
                d = one if d is None else d
                gz = gz + w * (c * d)
        for ref, v in ((gux_ref, gx), (guy_ref, gy), (guz_ref, gz)):
            ref[j, :] = v
        for mu in range(MU):
            gf_refs[mu][j, :] = zero if gf[mu] is None else gf[mu]
        return carry

    jax.lax.fori_loop(0, bj, bwd, 0)


def moments_kernel(sched, u, f, xi, *, block_n=BLOCK_N, interpret=False):
    """Site energies (without the species constant), dE/du and dE/df.

    u: 3 arrays (J_pad, N_pad); f: MU arrays (J_pad, N_pad); xi: the
    (n_scalar,) moment coefficients. N_pad must be a multiple of block_n
    and J_pad a power of two. Returns (e (N_pad,), [3 x (J_pad, N_pad)],
    [MU x (J_pad, N_pad)])."""
    jp, n = u[0].shape
    MU = sched.radial_funcs_count
    spec = pl.BlockSpec((jp, block_n), lambda i: (0, i))
    xi_spec = pl.BlockSpec(xi.shape, lambda i: (0,))
    e_spec = pl.BlockSpec((block_n,), lambda i: (i,))
    out_shape = (
        [jax.ShapeDtypeStruct((n,), jnp.float32)]
        + [jax.ShapeDtypeStruct((jp, n), jnp.float32)] * (3 + MU)
    )
    call = pl.pallas_call(
        functools.partial(_kernel_body, sched, jp),
        out_shape=out_shape,
        grid=(n // block_n,),
        in_specs=[spec] * (3 + MU) + [xi_spec],
        out_specs=[e_spec] + [spec] * (3 + MU),
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="mtp_moments_fused",
    )
    outs = call(*u, *f, xi)
    return outs[0], outs[1:4], outs[4:]


def pair_layout(n, j, block_n=BLOCK_N):
    """(J_pad, N_pad) of the kernel's per-pair arrays for an (N, J) list."""
    return max(8, 1 << (j - 1).bit_length()), -(-n // block_n) * block_n


def site_energies_and_pair_forces(sched, coeffs, disp, mask, itypes, jtypes,
                                  *, block_n=BLOCK_N, interpret=False):
    """Site energies (N,) and masked per-pair forces dE/d(disp) (N, J, 3):
    the contract of the XLA path in models.mtp.mtp_energy_forces."""
    if disp.dtype != jnp.float32:
        raise ValueError(f"the fused kernel computes in float32, got {disp.dtype}")
    n, j, _ = disp.shape
    jp, n_pad = pair_layout(n, j, block_n)
    maskf = mask.astype(jnp.float32)

    def prologue(d):
        d2 = jnp.sum(d * d, axis=-1)
        dist = jnp.sqrt(jnp.where(mask, d2, 1.0))
        u = d / dist[..., None] * maskf[..., None]
        _, fr = _radial_part(sched, coeffs, dist, itypes, jtypes, jnp.float32)
        fr = fr * maskf[..., None]
        def lay(a):  # (N, J) -> (Jp, N_pad)
            return jnp.pad(a.T, ((0, jp - j), (0, n_pad - n)))
        return ([lay(u[..., c]) for c in range(3)],
                [lay(fr[..., k]) for k in range(sched.radial_funcs_count)])

    (u, f), vjp = jax.vjp(prologue, disp)
    xi = coeffs.moment_coeffs.astype(jnp.float32)
    e, gu, gf = moments_kernel(sched, u, f, xi, block_n=block_n,
                               interpret=interpret)
    (pair_t,) = vjp((list(gu), list(gf)))
    site_e = e[:n] + coeffs.species_coeffs.astype(jnp.float32)[itypes]
    return site_e, pair_t * maskf[..., None]
