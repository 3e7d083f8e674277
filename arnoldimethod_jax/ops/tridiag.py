"""Parallel tridiagonal solver: pivoted LU on host, log-depth device solves.

Shift-invert Arnoldi needs x = (A - sigma*I)^{-1} v once per Krylov step.
For tridiagonal A the factorization is O(n) host work done once (LAPACK
dgttrf-style partial pivoting), and each solve is two banded-triangular
substitutions.  A sequential substitution is a worst case for a
data-parallel device — n dependent scalar steps — so both substitutions here are reformulated as
first-/second-order *affine recurrences* and evaluated in log2(n) depth
with `lax.associative_scan` over affine-map composition: the parallel
cyclic-reduction idea, expressed the XLA way (fixed shapes, no dynamic
control flow, elementwise work over n).

Behavioral reference: the shift-invert recipe of the reference docs
(/root/reference/docs/src/index.md:234-303, `factorize(A - sigma*B)` +
`ldiv!`) and its benchmark configuration bench/partial_schur.jl:37-52.

Numerics: the factorization uses partial pivoting, so it is backward
stable for any nonsingular tridiagonal (growth factor <= 2).  With row
swaps the forward substitution is no longer a pure prefix product of the
subdiagonal; the swap at step i folds into the recurrence as

    t_{i+1} = a_i * t_i + c_i,   a_i = swap_i ? 1 : -l_i,
                                 c_i = swap_i ? -l_i*b_{i+1} : b_{i+1},
    y_i     = swap_i ? b_{i+1} : t_i

where t_i is the working value at row i when elimination step i begins.
The backward substitution with U's two superdiagonals is the second-order
recurrence x_i = (y_i - u1_i*x_{i+1} - u2_i*x_{i+2}) / d_i, scanned as
2x2-matrix affine maps.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["factor_tridiagonal", "tridiag_lu_solve", "TridiagFactorization"]

# An f32 contraction with no precision given may run in TF32 on the GPU
# (~3 decimal digits); the 2x2 affine-map
# compositions are exactly the accuracy-critical arithmetic of the solve,
# so every einsum requests full-precision accumulation (same rule as the
# orthogonalization kernels, ops/expansion.py).
_PREC = lax.Precision.HIGHEST


class TridiagFactorization:
    """Host-computed P(A) = L U factors, padded to fixed length n:
    l (n: L subdiagonal, entry n-1 unused), swap (n bool, entry n-1 False),
    d0 (n: U diagonal), du1 (n: first superdiagonal, last entry 0),
    du2 (n: second superdiagonal, last two entries 0)."""

    def __init__(self, l, swap, d0, du1, du2):
        self.l = l
        self.swap = swap
        self.d0 = d0
        self.du1 = du1
        self.du2 = du2

    def astype(self, dtype):
        return TridiagFactorization(
            self.l.astype(dtype),
            self.swap,
            self.d0.astype(dtype),
            self.du1.astype(dtype),
            self.du2.astype(dtype),
        )

    def arrays(self):
        return self.l, self.swap, self.d0, self.du1, self.du2


def factor_tridiagonal(dl, d, du):
    """LU with partial pivoting of the tridiagonal (dl, d, du) — LAPACK
    dgttrf recurrence.  dl/du have length n-1, d length n.  Host numpy,
    float64/complex128 regardless of input dtype (the one-time O(n) cost
    is irrelevant; full-precision factors are then cast to the solve
    dtype).  Raises on an exactly singular pivot (sigma hit an
    eigenvalue)."""
    d = np.asarray(d)
    work = np.promote_types(d.dtype, np.float64)
    n = d.shape[0]
    if np.asarray(dl).shape[0] != n - 1 or np.asarray(du).shape[0] != n - 1:
        raise ValueError("dl/du must have length n-1")
    d0 = d.astype(work).copy()
    l = np.zeros(n, dtype=work)
    du1 = np.zeros(n, dtype=work)
    du1[: n - 1] = du
    du2 = np.zeros(n, dtype=work)
    sub = np.asarray(dl, dtype=work).copy()
    swap = np.zeros(n, dtype=bool)

    for i in range(n - 1):
        if abs(d0[i]) >= abs(sub[i]):
            if d0[i] == 0:
                raise np.linalg.LinAlgError(
                    f"exactly singular pivot at row {i}: the shift is an "
                    "eigenvalue of A (or A is singular)"
                )
            fact = sub[i] / d0[i]
            l[i] = fact
            d0[i + 1] = d0[i + 1] - fact * du1[i]
        else:
            swap[i] = True
            fact = d0[i] / sub[i]
            l[i] = fact
            d0[i] = sub[i]
            temp = du1[i]
            du1[i] = d0[i + 1]
            d0[i + 1] = temp - fact * d0[i + 1]
            if i < n - 2:
                du2[i] = du1[i + 1]
                du1[i + 1] = -fact * du1[i + 1]
    if d0[n - 1] == 0:
        raise np.linalg.LinAlgError(
            "exactly singular pivot at the last row: the shift is an "
            "eigenvalue of A (or A is singular)"
        )
    return TridiagFactorization(l, swap, d0, du1, du2)


def _affine1_combine(a, b):
    """Compose scalar affine maps elementwise: b after a."""
    aa, ca = a
    ab, cb = b
    return ab * aa, ab * ca + cb


def _affine2_combine(a, b):
    """Compose 2x2 affine maps elementwise.  In a reverse associative
    scan the accumulator `a` holds the *higher-index* suffix (the maps
    applied first, nearest the base), and `b` the new lower-index
    element — so `b` is applied after `a`: v -> Mb (Ma v + ga) + gb."""
    Ma, ga = a
    Mb, gb = b
    return (
        jnp.einsum("nij,njk->nik", Mb, Ma, precision=_PREC),
        jnp.einsum("nij,nj->ni", Mb, ga, precision=_PREC) + gb,
    )


@jax.jit
def tridiag_lu_solve(l, swap, d0, du1, du2, b):
    """x = U^{-1} L^{-1} P b, both substitutions as log-depth scans."""
    n = b.shape[0]
    if n == 1:  # 1x1 system: no recurrences at all
        return b / d0
    one = jnp.ones((), dtype=b.dtype)

    # Forward: t_{i+1} = a_i t_i + c_i for i in [0, n-1), t_0 = b_0.
    bsh = jnp.concatenate([b[1:], b[-1:]])  # b_{i+1}; last entry unused
    a = jnp.where(swap[:-1], one, -l[:-1])
    c = jnp.where(swap[:-1], -l[:-1] * bsh[:-1], bsh[:-1])
    A, C = lax.associative_scan(_affine1_combine, (a, c))
    t = jnp.concatenate([b[:1], A * b[0] + C])
    y = jnp.where(swap, bsh, t)

    # Backward: x_i = (y_i - du1_i x_{i+1} - du2_i x_{i+2}) / d0_i.
    # Base pair v_{n-2} = (x_{n-2}, x_{n-1}); elements i in [0, n-2) map
    # v_{i+1} -> v_i; a reverse scan composes the suffix maps.
    yd = y / d0
    xn1 = yd[n - 1]
    xn2 = yd[n - 2] - (du1[n - 2] / d0[n - 2]) * xn1
    base = jnp.stack([xn2, xn1])
    if n == 2:  # the base pair is the whole solution
        return base

    m = n - 2
    r1 = -du1[:m] / d0[:m]
    r2 = -du2[:m] / d0[:m]
    zero = jnp.zeros_like(r1)
    M = jnp.stack(
        [
            jnp.stack([r1, r2], axis=-1),
            jnp.stack([jnp.full_like(r1, one), zero], axis=-1),
        ],
        axis=-2,
    )  # (m, 2, 2)
    g = jnp.stack([yd[:m], zero], axis=-1)  # (m, 2)
    S, h = lax.associative_scan(_affine2_combine, (M, g), reverse=True)
    head = jnp.einsum("nij,j->ni", S, base, precision=_PREC) + h  # v_i for i in [0, n-2)
    return jnp.concatenate([head[:, 0], base])
