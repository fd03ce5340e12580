"""Double-float (f32x2) arithmetic: ~49-bit-mantissa values as (hi, lo) pairs
of f32 arrays: f64-class accuracy from f32 operations.

A df value x is represented by two f32 arrays with x = hi + lo and
|lo| <= ulp(hi)/2 (normalized). Error-free transformations (two_sum, Dekker
two_prod) follow the classic double-double recipes (Dekker 1971; Hida/Li/
Bailey QD library), specialized to f32: the Dekker split constant is
2^12 + 1 = 4097.

Why this exists: the fp32 production force path has an error floor that
lives in the per-pair backward-DAG arithmetic itself, not in the J-sum, so
compensated *summation* cannot reach the <1e-6 reference-parity gate; only
higher-precision *terms* can. This module powers the opt-in df32
evaluation path (ops/moments_df.py), giving reference-grade forces from f32
arithmetic at a multiple of the fp32 cost. The reference computes
everything in f64 (pair_mtp.cpp throughout). Whether native f64 on the GPU
makes this path unnecessary is an open measurement.

IEEE notes: every op below relies only on correctly-rounded f32 +,-,* (IEEE
round-to-nearest); no FMA is required. XLA does not algebraically simplify
floating-point expressions (no fast-math), so the cancellation patterns
survive compilation, validated against f64 in tests/test_df32.py and on
the device by chip_smoke.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

_SPLIT = 4097.0  # 2^12 + 1 for binary32 (Dekker)


def two_sum(a, b):
    """Error-free a + b for arbitrary f32 a, b: returns (s, e), s + e == a + b."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """Error-free a + b assuming |a| >= |b| (or a == 0)."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a):
    t = _SPLIT * a
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free a * b: returns (p, e) with p + e == a*b exactly."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


# ---- df values are (hi, lo) tuples of equal-shape f32 arrays ----


def const(c, dtype=jnp.float32):
    """A python/f64 scalar as a df constant (hi = round(c), lo = residual).

    The split happens in numpy (not jnp) so it works under jit tracing.
    """
    np_dtype = np.dtype(dtype.dtype if hasattr(dtype, "dtype") else dtype)
    c = float(c)
    hi = np.asarray(c, np_dtype)
    lo = np.asarray(c - float(hi), np_dtype)
    return jnp.asarray(hi), jnp.asarray(lo)


def from_f32(a):
    return a, jnp.zeros_like(a)


def to_f32(x):
    return x[0] + x[1]


def neg(x):
    return -x[0], -x[1]


def add(x, y):
    """Accurate df + df (QD ieee_add)."""
    s, e = two_sum(x[0], y[0])
    t, f = two_sum(x[1], y[1])
    e = e + t
    s, e = quick_two_sum(s, e)
    e = e + f
    return quick_two_sum(s, e)


def add_f(x, a):
    """df + f32 (a exact in f32)."""
    s, e = two_sum(x[0], a)
    e = e + x[1]
    return quick_two_sum(s, e)


def sub(x, y):
    return add(x, neg(y))


def mul(x, y):
    """df * df."""
    p, e = two_prod(x[0], y[0])
    e = e + (x[0] * y[1] + x[1] * y[0])
    return quick_two_sum(p, e)


def mul_f(x, a):
    """df * f32 (a exact in f32)."""
    p, e = two_prod(x[0], a)
    e = e + x[1] * a
    return quick_two_sum(p, e)


def prod_ff(a, b):
    """Exact f32 * f32 as a df value."""
    return two_prod(a, b)


def div(x, y):
    """df / df via two Newton correction terms."""
    q1 = x[0] / y[0]
    r = sub(x, mul_f(y, q1))
    q2 = r[0] / y[0]
    r = sub(r, mul_f(y, q2))
    q3 = r[0] / y[0]
    s, e = quick_two_sum(q1, q2)
    return quick_two_sum(s, e + q3)


def sqrt(x):
    """df sqrt (x >= 0): f32 seed + one df Newton correction."""
    a = jnp.sqrt(x[0])
    r = sub(x, prod_ff(a, a))
    e = (r[0] + r[1]) / (2.0 * a)
    return quick_two_sum(a, e)


def where(m, x, y):
    return jnp.where(m, x[0], y[0]), jnp.where(m, x[1], y[1])


def tree_sum(x, axis):
    """Sum a df array over `axis` by pairwise (tree) df adds.

    Tree reduction keeps every partial in df, so the result carries the full
    ~49-bit accuracy of the terms (a scatter/segment reduction cannot do df
    adds; this is the vectorizable alternative).
    """
    hi = jnp.moveaxis(x[0], axis, 0)
    lo = jnp.moveaxis(x[1], axis, 0)
    n = hi.shape[0]
    while n > 1:
        half = n // 2
        a = (hi[:half], lo[:half])
        b = (hi[half : 2 * half], lo[half : 2 * half])
        s = add(a, b)
        if n % 2:
            hi = jnp.concatenate([s[0], hi[2 * half :]], axis=0)
            lo = jnp.concatenate([s[1], lo[2 * half :]], axis=0)
            n = half + 1
        else:
            hi, lo = s
            n = half
    return hi[0], lo[0]
