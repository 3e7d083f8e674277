"""Double-word float32 ("df32") arithmetic: float32-word extended
precision, the f32 analogue of the reference's extended-precision story
(Double64 converging to tol=1e-28, the reference's readme.md:81-99).

The classic double-single technique (Dekker 1971; Thall 2006 on GPUs)
represents a value as an unevaluated sum hi + lo of two float32s, giving
~2^-48 ≈ 3.6e-15 effective relative precision from pure f32 elementwise
ops.  Error-free transforms:

  * two_sum (Knuth, branch-free, 6 flops): s + err == a + b exactly;
  * two_prod (Dekker split, no FMA needed): p + err == a * b exactly —
    each f32 splits into two 12-bit-mantissa halves whose pairwise
    products are exact in f32.

On top of these, df_add / df_mul / df_dot / df_axpy give the vector
kernels Gram-Schmidt orthogonalization needs.  Everything is elementwise
or tree-structured work that vectorizes over (m, n) operands — no
matrix units (they cannot carry the compensation), so df32
orthogonalization costs ~10x the flops of plain f32; for the solver this
work is a tiny slice of wall-clock next to the SpMV.

Measured (tests/test_df32.py, docs/precision.md): df32 dot reaches
~1e-11 relative error where plain f32-HIGHEST sits at ~3e-6, and a
20-step df32 CGS2 holds ||V V^T - I|| at the f64 level.

CAUTION: error-free transforms die under value-unsafe compiler rewrites
((a + b) - a -> b).  XLA is IEEE-strict on these patterns on the CPU
(verified by test_two_sum_exactness, which fails loudly if a compiler
version regresses this); chip_smoke.py's `extended` phase checks the
same transforms compiled for the GPU.

MAGNITUDE LIMIT: two_prod's Dekker split multiplies by 2^12 + 1, which
overflows f32 for |a| > ~8.3e34 (2^127 / 2^12); _pin clamps the overflow
so the error word is quietly wrong rather than inf.  Operands must stay
below ~1e34 in magnitude for the extended precision to be meaningful —
comfortably true for the normalized Krylov bases and Hessenberg entries
this module serves (everything is O(||A||)).  Pre-scale first if you
feed it data near the f32 overflow threshold.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

__all__ = [
    "two_sum",
    "two_prod",
    "df_add",
    "df_sub",
    "df_mul",
    "df_scale",
    "df_sum",
    "df_dot",
    "df_project_coeffs",
    "df_axpy_update",
    "df_inv",
    "df_norm",
]

_SPLIT = 4097.0  # 2^12 + 1 for the 24-bit f32 mantissa

# Error-free transforms rely on each product/sum being IEEE-rounded
# SEPARATELY; inside a fused jitted program the XLA:CPU (LLVM) emitter
# applies FMA CONTRACTION — `s - a*b` becomes fma(-a, b, s), skipping the
# product's rounding — which silently breaks any EFT whose subtraction
# consumes a product (measured: jit(df_mul) degrades from 3e-15 to 5e-8
# while the same ops run eagerly are exact; lax.optimization_barrier is
# DELETED by the CPU pipeline and does not help; LLVM's NVPTX backend
# contracts a*b + c by default too).  `_pin` (a full-range lax.clamp)
# survives every optimization
# pass we tested and blocks the contraction by hiding the producer: it
# pins every EFT intermediate to its rounded value.  Cost: two selects
# per pin — noise next to the solver's matvecs.  test_two_sum_exactness
# and test_df32_cgs2_orthogonality fail loudly if a compiler change
# defeats this.
def _pin(x):
    m = jnp.asarray(jnp.finfo(jnp.result_type(x)).max, jnp.result_type(x))
    return lax.clamp(-m, x, m)


_ob = _pin


def two_sum(a, b):
    """Error-free sum: (s, e) with s = fl(a+b) and s + e == a + b."""
    a, b = _ob(a), _ob(b)  # pinned inputs: an input product would
    s = _ob(a + b)          # otherwise contract into the cancellations
    bp = _ob(s - a)
    t1 = _ob(s - bp)
    e = _ob(a - t1) + _ob(b - bp)
    return s, e


def _quick_two_sum(a, b):
    """Error-free sum assuming |a| >= |b| (3 flops)."""
    a, b = _ob(a), _ob(b)
    s = _ob(a + b)
    t = _ob(s - a)
    e = b - t
    return s, e


def two_prod(a, b):
    """Error-free product: (p, e) with p = fl(a*b) and p + e == a * b."""
    a, b = _ob(a), _ob(b)
    p = _ob(a * b)
    ac = _ob(_SPLIT * a)
    ta = _ob(ac - a)
    ahi = _ob(ac - ta)
    alo = _ob(a - ahi)
    bc = _ob(_SPLIT * b)
    tb = _ob(bc - b)
    bhi = _ob(bc - tb)
    blo = _ob(b - bhi)
    e1 = _ob(ahi * bhi - p)
    e2 = _ob(e1 + ahi * blo)
    e3 = _ob(e2 + alo * bhi)
    e = e3 + alo * blo
    return p, e


def df_add(xh, xl, yh, yl):
    """(xh, xl) + (yh, yl), accurate double-word add (Knuth add2)."""
    sh, se = two_sum(xh, yh)
    te = xl + yl + se
    return _quick_two_sum(sh, te)


def df_sub(xh, xl, yh, yl):
    return df_add(xh, xl, -yh, -yl)


def df_mul(xh, xl, yh, yl):
    """(xh, xl) * (yh, yl) to double-word accuracy."""
    ph, pe = two_prod(xh, yh)
    pe = pe + (xh * yl + xl * yh)
    return _quick_two_sum(ph, pe)


def df_scale(xh, xl, c):
    """(xh, xl) * scalar-or-array c (c a plain f32)."""
    ph, pe = two_prod(xh, c)
    pe = pe + xl * c
    return _quick_two_sum(ph, pe)


def df_sum(xh, xl, axis=-1):
    """Double-word sum-reduction along `axis` by pairwise (tree) df_add:
    log2(n) vectorized rounds, error O(n log n * eps^2)."""
    xh = jnp.moveaxis(xh, axis, -1)
    xl = jnp.moveaxis(xl, axis, -1)
    n = xh.shape[-1]
    pow2 = 1 << max(0, (n - 1)).bit_length()
    if pow2 != n:
        pad = [(0, 0)] * (xh.ndim - 1) + [(0, pow2 - n)]
        xh = jnp.pad(xh, pad)
        xl = jnp.pad(xl, pad)
    while xh.shape[-1] > 1:
        half = xh.shape[-1] // 2
        xh, xl = df_add(
            xh[..., :half], xl[..., :half], xh[..., half:], xl[..., half:]
        )
    return xh[..., 0], xl[..., 0]


def df_dot(x, y, axis=-1):
    """Compensated dot of plain-f32 arrays along `axis`: exact per-element
    products (two_prod) then a double-word tree reduction.  Relative error
    ~1e-11 where f32-HIGHEST gives ~1e-6 (ill-conditioned sums)."""
    p, e = two_prod(x, y)
    return df_sum(p, e, axis=axis)


def df_project_coeffs(V, wh, wl):
    """Gram-Schmidt coefficients h = V @ w for a double-word w against a
    plain-f32 basis V (m, n): exact products against both words, one tree
    reduction.  Returns (hh, hl) of shape (m,)."""
    ph, pe = two_prod(V, wh[None, :])
    pe = pe + V * wl[None, :]
    return df_sum(ph, pe, axis=-1)


def df_axpy_update(wh, wl, hh, hl, V):
    """w <- w - sum_j h_j V[j] in double-word: each (h_j * V[j]) formed to
    double-word accuracy and subtracted with df_add.  V is plain f32."""

    def body(carry, hV):
        wh, wl = carry
        (hh_j, hl_j), Vj = hV
        th, tl = df_scale(
            jnp.broadcast_to(hh_j, Vj.shape),
            jnp.broadcast_to(hl_j, Vj.shape),
            Vj,
        )
        return df_sub(wh, wl, th, tl), None

    (wh, wl), _ = lax.scan(body, (wh, wl), ((hh, hl), V))
    return wh, wl


def df_project_coeffs_df(Vh, Vl, wh, wl):
    """Gram-Schmidt coefficients h = V @ w with BOTH the basis V (m, n)
    and w held double-word — required when the basis itself must stay
    orthonormal beyond f32 storage rounding."""
    ph, pe = df_mul(Vh, Vl, wh[None, :], wl[None, :])
    return df_sum(ph, pe, axis=-1)


def df_axpy_update_df(wh, wl, hh, hl, Vh, Vl):
    """w <- w - sum_j h_j V[j] with a double-word basis."""

    def body(carry, hV):
        wh, wl = carry
        (hh_j, hl_j), Vjh, Vjl = hV
        th, tl = df_mul(
            jnp.broadcast_to(hh_j, Vjh.shape),
            jnp.broadcast_to(hl_j, Vjh.shape),
            Vjh,
            Vjl,
        )
        return df_sub(wh, wl, th, tl), None

    (wh, wl), _ = lax.scan(body, (wh, wl), ((hh, hl), Vh, Vl))
    return wh, wl


def df_inv(xh, xl):
    """Double-word reciprocal 1 / (xh, xl): f32 seed + one Newton step
    r <- r + r * (1 - x * r) carried in double-word."""
    r = 1.0 / xh
    ph, pe = df_mul(xh, xl, r, jnp.zeros_like(r))
    # residual 1 - x*r (tiny, double-word)
    dh, dl = df_add(jnp.ones_like(r), jnp.zeros_like(r), -ph, -pe)
    ch, ce = df_scale(dh, dl, r)
    return df_add(r, jnp.zeros_like(r), ch, ce)


def df_norm(xh, xl):
    """Double-word 2-norm of a double-word vector: sqrt of the df dot.
    Exactly zero input returns (0, 0) — NOT NaN — so breakdown tests
    downstream (df_expansion's DGKS) see a true zero."""
    ph, pe = df_mul(xh, xl, xh, xl)
    sh, sl = df_sum(ph, pe)
    # One Newton step refines sqrt(sh) to double-word accuracy:
    # r = sqrt(s); r' = r + (s - r^2) / (2r).
    r = jnp.sqrt(sh)
    r2h, r2e = two_prod(r, r)
    dh, dl = df_add(sh, sl, -r2h, -r2e)
    corr = jnp.where(r > 0, (dh + dl) / (2.0 * jnp.where(r > 0, r, 1.0)), 0.0)
    return _quick_two_sum(r, corr)
