"""On-device dense restart kernels: the L2/L1 layers of the solver as
jit-traceable, fixed-shape JAX code (real dtype).

The host dense layer (schur.py / swaps.py / restore.py / eig.py — and its
C++ twin) is the behavioral reference; this module re-expresses the same
mathematics with masked full-width row/column updates and `lax` control
flow so the *entire* Krylov-Schur restart — Francis QR, eigenvalue /
residual extraction, locking decisions, Sylvester-swap partitioning,
Hessenberg restoration, and the truncation basis change — runs inside one
compiled device program (see fused.py).  That removes the per-restart
host<->device round trip.

Everything here is REAL arithmetic: conjugate-pair bookkeeping uses
explicit (re, im) pairs of the real Schur form's 2x2 blocks.  Every
matrix-vector product pins HIGHEST precision (no TF32 on the GPU).
Shapes are fixed at (m+1, m) / (m, m); window
boundaries are traced scalars applied through index masks.

Behavioral reference: ArnoldiMethod.jl src/schurfact.jl, schursort.jl,
restore_hessenberg.jl, eigvals.jl, eigenvector_uppertriangular.jl (via the
numpy twins in this package, which are tested against the reference's own
oracles).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

__all__ = [
    "givens_jax",
    "local_schur_jax",
    "eigenvalues_jax",
    "residuals_jax",
    "swap_jax",
    "rotate_right_jax",
    "partition_three_way_jax",
    "sort_schur_jax",
    "restore_arnoldi_jax",
    "order_key_jax",
]

_PREC = lax.Precision.HIGHEST


# --- L1: Givens rotations with masked ranged application -------------------


def givens_jax(f, g):
    """Real plane rotation (c, s, r): [c s; -s c] @ [f; g] = [r; 0]
    (dlartg semantics, matching rotations.givens for real inputs)."""
    fa = jnp.abs(f)
    ga = jnp.abs(g)
    scale = jnp.maximum(fa, ga)
    scale_s = jnp.where(scale == 0, 1, scale)
    fs = f / scale_s
    gs = g / scale_s
    d = jnp.sqrt(fs * fs + gs * gs)
    d_s = jnp.where(d == 0, 1, d)
    sgn_f = jnp.where(f < 0, -1.0, 1.0).astype(f.dtype)
    c = jnp.abs(fs) / d_s
    s = sgn_f * gs / d_s
    r = sgn_f * d * scale
    gz = g == 0
    fz = f == 0
    sgn_g = jnp.where(g < 0, -1.0, 1.0).astype(f.dtype)
    c = jnp.where(gz, 1.0, jnp.where(fz, 0.0, c))
    s = jnp.where(gz, 0.0, jnp.where(fz, sgn_g, s))
    r = jnp.where(gz, f, jnp.where(fz, ga, r))
    return c, s, r


# Each helper reads its 2-3 row/column slab with ONE dynamic_slice and
# writes it back with ONE dynamic_update_slice: inside the sequential QR /
# swap loops the wall-clock is per-op dispatch overhead, not bytes, so
# halving the op count per rotation roughly halves the dense-phase time.


def _lmul2(c, s, A, i, j0, j1):
    """A[i:i+2, j0:j1] = G @ A[i:i+2, j0:j1] (masked full rows)."""
    cols = jnp.arange(A.shape[1])
    mask = (cols >= j0) & (cols < j1)
    i = jnp.asarray(i, jnp.int32)
    z = jnp.int32(0)
    blk = lax.dynamic_slice(A, (i, z), (2, A.shape[1]))
    a1, a2 = blk[0], blk[1]
    new = jnp.stack(
        [
            jnp.where(mask, c * a1 + s * a2, a1),
            jnp.where(mask, -s * a1 + c * a2, a2),
        ]
    )
    return lax.dynamic_update_slice(A, new, (i, z))


def _rmul2(A, c, s, i, r0, r1):
    """A[r0:r1, i:i+2] = A[r0:r1, i:i+2] @ G^T (masked full columns)."""
    rows = jnp.arange(A.shape[0])
    mask = (rows >= r0) & (rows < r1)
    i = jnp.asarray(i, jnp.int32)
    z = jnp.int32(0)
    blk = lax.dynamic_slice(A, (z, i), (A.shape[0], 2))
    a1, a2 = blk[:, 0], blk[:, 1]
    new = jnp.stack(
        [
            jnp.where(mask, a1 * c + a2 * s, a1),
            jnp.where(mask, -a1 * s + a2 * c, a2),
        ],
        axis=1,
    )
    return lax.dynamic_update_slice(A, new, (z, i))


def _lmul3(c1, s1, c2, s2, A, i, j0, j1):
    """3-row rotation G2@G1 on rows i..i+2 (G1 on i+1,i+2; G2 on i,i+1)."""
    cols = jnp.arange(A.shape[1])
    mask = (cols >= j0) & (cols < j1)
    i = jnp.asarray(i, jnp.int32)
    z = jnp.int32(0)
    blk = lax.dynamic_slice(A, (i, z), (3, A.shape[1]))
    a1, a2, a3 = blk[0], blk[1], blk[2]
    b2 = c1 * a2 + s1 * a3
    b3 = -s1 * a2 + c1 * a3
    new = jnp.stack(
        [
            jnp.where(mask, c2 * a1 + s2 * b2, a1),
            jnp.where(mask, -s2 * a1 + c2 * b2, a2),
            jnp.where(mask, b3, a3),
        ]
    )
    return lax.dynamic_update_slice(A, new, (i, z))


def _rmul3(A, c1, s1, c2, s2, i, r0, r1):
    rows = jnp.arange(A.shape[0])
    mask = (rows >= r0) & (rows < r1)
    i = jnp.asarray(i, jnp.int32)
    z = jnp.int32(0)
    blk = lax.dynamic_slice(A, (z, i), (A.shape[0], 3))
    a1, a2, a3 = blk[:, 0], blk[:, 1], blk[:, 2]
    b2 = a2 * c1 + a3 * s1
    b3 = -a2 * s1 + a3 * c1
    new = jnp.stack(
        [
            jnp.where(mask, a1 * c2 + b2 * s2, a1),
            jnp.where(mask, -a1 * s2 + b2 * c2, a2),
            jnp.where(mask, b3, a3),
        ],
        axis=1,
    )
    return lax.dynamic_update_slice(A, new, (z, i))


# --- L2: Francis QR (real quasi-Schur) --------------------------------------


def _upper_triangular_2x2(h11, h12, h21, h22):
    """(is_real, c, s) for the trailing real 2x2 block — dlanv2-style
    scaled discriminant + perfect-shift rotation (schur.py twin)."""
    trivially_pair = (h21 == 0) | (
        (h11 == h22) & (jnp.sign(h12) != jnp.sign(h21))
    )
    trivially_real = h12 == 0

    p = (h11 - h22) / 2
    bcmax = jnp.maximum(jnp.abs(h12), jnp.abs(h21))
    bcmis = jnp.minimum(jnp.abs(h12), jnp.abs(h21)) * jnp.sign(h12) * jnp.sign(h21)
    scale = jnp.maximum(jnp.abs(p), bcmax)
    scale_s = jnp.where(scale == 0, 1, scale)
    z = (p / scale_s) * p + (bcmax / scale_s) * bcmis
    neg = z < 0

    h11ml = p + jnp.copysign(jnp.sqrt(scale) * jnp.sqrt(jnp.maximum(z, 0)), p)
    nrm = jnp.hypot(h21, h11ml)
    nrm_s = jnp.where(nrm == 0, 1, nrm)
    c = h11ml / nrm_s
    s = h21 / nrm_s

    is_real = jnp.where(trivially_pair, False, jnp.where(trivially_real, True, ~neg))
    c = jnp.where(trivially_pair | neg, 1.0, jnp.where(trivially_real, 0.0, c))
    s = jnp.where(trivially_pair | neg, 0.0, jnp.where(trivially_real, 1.0, s))
    return is_real, c, s


def _use_single_shift(h11, h12, h21, h22):
    """(is_single, mu): single Wilkinson shift iff the trailing block has
    real eigenvalues, pre-scaled by the block 1-norm (schur.py twin)."""
    scale = jnp.abs(h11) + jnp.abs(h12) + jnp.abs(h21) + jnp.abs(h22)
    scale_s = jnp.where(scale == 0, 1, scale)
    a11, a12 = h11 / scale_s, h12 / scale_s
    a21, a22 = h21 / scale_s, h22 / scale_s
    t = (a11 + a22) / 2
    d = (a11 - t) * (a22 - t) - a12 * a21
    is_single = d <= 0
    sq = jnp.sqrt(jnp.abs(d))
    lam1 = t + sq
    lam2 = t - sq
    lam = jnp.where(jnp.abs(a22 - lam1) < jnp.abs(a22 - lam2), lam1, lam2)
    return is_single, lam * scale


def _rot3(p1, p2, p3):
    c1, s1, n1 = givens_jax(p2, p3)
    c2, s2, n2 = givens_jax(p1, n1)
    return c1, s1, c2, s2, n2


def _single_shift_sweep(H, Q, frm, to, mu, mrows):
    """One single-shift bulge chase on window frm..to (inclusive)."""
    n = H.shape[1]

    c, s, _ = givens_jax(H[frm, frm] - mu, H[frm + 1, frm])
    H = _lmul2(c, s, H, frm, frm, n)
    H = _rmul2(H, c, s, frm, 0, jnp.minimum(frm + 3, mrows))
    Q = _rmul2(Q, c, s, frm, 0, Q.shape[0])

    def body(i, HQ):
        H, Q = HQ
        c, s, nrm = givens_jax(H[i, i - 1], H[i + 1, i - 1])
        H = H.at[i, i - 1].set(nrm).at[i + 1, i - 1].set(0)
        H = _lmul2(c, s, H, i, i, n)
        H = _rmul2(H, c, s, i, 0, jnp.minimum(i + 3, mrows))
        Q = _rmul2(Q, c, s, i, 0, Q.shape[0])
        return H, Q

    return lax.fori_loop(frm + 1, to, body, (H, Q))


def _double_shift_sweep(H, Q, frm, to, trace, det, mrows):
    """Francis double-shift 3x3 bulge chase on window frm..to (inclusive)."""
    n = H.shape[1]

    h11 = H[frm, frm]
    h21 = H[frm + 1, frm]
    h12 = H[frm, frm + 1]
    h22 = H[frm + 1, frm + 1]
    h32 = H[frm + 2, frm + 1]
    p1 = h11 * h11 + h12 * h21 - trace * h11 + det
    p2 = h21 * (h11 + h22 - trace)
    p3 = h32 * h21

    c1, s1, c2, s2, _ = _rot3(p1, p2, p3)
    H = _lmul3(c1, s1, c2, s2, H, frm, frm, n)
    H = _rmul3(H, c1, s1, c2, s2, frm, 0, jnp.minimum(frm + 4, mrows))
    Q = _rmul3(Q, c1, s1, c2, s2, frm, 0, Q.shape[0])

    def body(i, HQ):
        H, Q = HQ
        c1, s1, c2, s2, nrm = _rot3(H[i, i - 1], H[i + 1, i - 1], H[i + 2, i - 1])
        H = (
            H.at[i, i - 1].set(nrm)
            .at[i + 1, i - 1].set(0)
            .at[i + 2, i - 1].set(0)
        )
        H = _lmul3(c1, s1, c2, s2, H, i, i, n)
        H = _rmul3(H, c1, s1, c2, s2, i, 0, jnp.minimum(i + 4, mrows))
        Q = _rmul3(Q, c1, s1, c2, s2, i, 0, Q.shape[0])
        return H, Q

    H, Q = lax.fori_loop(frm + 1, to - 1, body, (H, Q))

    c, s, nrm = givens_jax(H[to - 1, to - 2], H[to, to - 2])
    H = H.at[to - 1, to - 2].set(nrm).at[to, to - 2].set(0)
    H = _lmul2(c, s, H, to - 1, to - 1, n)
    H = _rmul2(H, c, s, to - 1, 0, jnp.minimum(to + 1, mrows))
    Q = _rmul2(Q, c, s, to - 1, 0, Q.shape[0])
    return H, Q


def local_schur_jax(H, Q, lo, hi, eps=None, maxiter=None):
    """Real quasi-Schur factorization of the diagonal window [lo, hi) of
    the Hessenberg H ((m+1, m) or (m, m); rotations never touch rows >= m),
    accumulating into Q ((m, m)).  Returns (H, Q, ok).

    Twin of schur.py:_local_schur_real; `ok` is False on non-convergence
    (the host path raises; device code returns the flag)."""
    m = H.shape[1]
    mrows = m  # rotations act on the square m x m part only
    if eps is None:
        eps = float(jnp.finfo(H.dtype).eps)
    if maxiter is None:
        maxiter = 100 * m
    idx = jnp.arange(m - 1)

    def deflate1(H, Q, frm, to):
        return H, Q, to - 1

    def block2(H, Q, frm, to):
        c11, c12 = H[to - 1, to - 1], H[to - 1, to]
        c21, c22 = H[to, to - 1], H[to, to]
        is_real, c, s = _upper_triangular_2x2(c11, c12, c21, c22)

        def rotate(HQ):
            H, Q = HQ
            H2 = _lmul2(c, s, H, frm, frm, m)
            H2 = _rmul2(H2, c, s, frm, 0, to + 1)
            Q2 = _rmul2(Q, c, s, frm, 0, Q.shape[0])
            H2 = H2.at[to, to - 1].set(0)
            return H2, Q2

        H, Q = lax.cond(is_real, rotate, lambda HQ: HQ, (H, Q))
        return H, Q, to - 2

    def shifted_sweep(H, Q, frm, to):
        c11, c12 = H[to - 1, to - 1], H[to - 1, to]
        c21, c22 = H[to, to - 1], H[to, to]
        is_single, mu = _use_single_shift(c11, c12, c21, c22)

        def single(args):
            H, Q = args
            return _single_shift_sweep(H, Q, frm, to, mu, mrows)

        def double(args):
            H, Q = args
            return _double_shift_sweep(
                H, Q, frm, to, c11 + c22, c11 * c22 - c12 * c21, mrows
            )

        H, Q = lax.cond(is_single, single, double, (H, Q))
        return H, Q, to

    def body(state):
        H, Q, to, it = state
        absd = jnp.abs(jnp.diagonal(H[:m, :m]))
        sub = jnp.abs(H[jnp.arange(1, m), jnp.arange(m - 1)])
        small = sub <= eps * (absd[:-1] + absd[1:])
        cand = small & (idx >= lo) & (idx < to)
        mx = jnp.max(jnp.where(cand, idx, -1))
        frm = jnp.where(mx >= 0, mx + 1, lo)
        # Flush the deflated subdiagonal entry (no-op when nothing found:
        # write its own value back).
        H = H.at[frm, frm - 1].set(
            jnp.where(mx >= 0, 0.0, H[frm, frm - 1])
        )
        case = jnp.where(frm == to, 0, jnp.where(frm + 1 == to, 1, 2))
        H, Q, to = lax.switch(case, [deflate1, block2, shifted_sweep], H, Q, frm, to)
        return H, Q, to, it + 1

    def cond(state):
        H, Q, to, it = state
        return (to > lo) & (it < maxiter)

    H, Q, to, it = lax.while_loop(cond, body, (H, Q, hi - 1, jnp.int32(0)))
    return H, Q, to <= lo


# --- Eigenvalues of the quasi-triangular form (split-complex) ---------------


def block_starts_jax(H, lo, hi, eps=None):
    """Boolean (m,) vector: True at diagonal positions that *start* a block
    within [lo, hi) — 1x1 everywhere except at conjugate-pair 2x2 blocks,
    detected by a non-negligible subdiagonal (eig.py:copy_eigenvalues scan,
    sequentialized with an exclusive scan so pair members don't chain)."""
    m = H.shape[1]
    if eps is None:
        eps = float(jnp.finfo(H.dtype).eps)
    absd = jnp.abs(jnp.diagonal(H[:m, :m]))
    sub = jnp.abs(H[jnp.arange(1, m), jnp.arange(m - 1)])
    coupled = jnp.concatenate(
        [sub > eps * (absd[:-1] + absd[1:]), jnp.zeros(1, bool)]
    )  # (m,): position i couples to i+1

    def scan_body(in_pair, c):
        start_of_pair = c & ~in_pair
        return start_of_pair, ~in_pair  # next in_pair, this-is-a-block-start

    _, starts = lax.scan(scan_body, jnp.asarray(False), coupled)
    return starts


def eigenvalues_jax(H, eps=None):
    """(lam_re, lam_im, starts): eigenvalues of the quasi-triangular m x m
    part of H read off its diagonal blocks, split-complex.  For a 2x2 block
    at (i, i+1): lam[i] = x + iy, lam[i+1] = x - iy (eig.py twin).  A block
    whose discriminant turns out non-negative contributes the real roots
    x +- sqrt(disc) (mirrors copy_eigenvalues' complex sqrt of a positive
    number)."""
    m = H.shape[1]
    if eps is None:
        eps = float(jnp.finfo(H.dtype).eps)
    absd = jnp.abs(jnp.diagonal(H[:m, :m]))
    subv = H[jnp.arange(1, m), jnp.arange(m - 1)]
    coupled = jnp.concatenate(
        [jnp.abs(subv) > eps * (absd[:-1] + absd[1:]), jnp.zeros(1, bool)]
    )

    def scan_body(in_pair, c):
        return c & ~in_pair, ~in_pair

    _, starts = lax.scan(scan_body, jnp.asarray(False), coupled)

    d = jnp.diagonal(H[:m, :m])
    sup = jnp.concatenate([H[jnp.arange(m - 1), jnp.arange(1, m)], jnp.zeros(1, H.dtype)])
    sub = jnp.concatenate([subv, jnp.zeros(1, H.dtype)])
    d_next = jnp.concatenate([d[1:], jnp.zeros(1, H.dtype)])

    # As-pair-start quantities for every i (garbage where not a pair start).
    x = (d + d_next) / 2
    det = d * d_next - sup * sub
    disc = x * x - det
    y = jnp.sqrt(jnp.maximum(-disc, 0.0))
    rr = jnp.sqrt(jnp.maximum(disc, 0.0))  # real-root offset when disc >= 0

    is_pair_start = starts & coupled
    is_pair_second = jnp.concatenate([jnp.zeros(1, bool), is_pair_start[:-1]])

    x_prev = jnp.concatenate([jnp.zeros(1, H.dtype), x[:-1]])
    y_prev = jnp.concatenate([jnp.zeros(1, H.dtype), y[:-1]])
    rr_prev = jnp.concatenate([jnp.zeros(1, H.dtype), rr[:-1]])

    lam_re = jnp.where(
        is_pair_start,
        x + rr,
        jnp.where(is_pair_second, x_prev - rr_prev, d),
    )
    lam_im = jnp.where(is_pair_start, y, jnp.where(is_pair_second, -y_prev, 0.0))
    return lam_re, lam_im, starts


# --- Ritz residuals via split-complex eigenvector backsubstitution ----------


def _cdiv(ar, ai, br, bi):
    """Split-complex division a / b (Smith's algorithm for stability)."""
    use_r = jnp.abs(br) >= jnp.abs(bi)
    # branch 1: |br| >= |bi|
    br_s = jnp.where(br == 0, 1, br)
    r1 = bi / br_s
    den1 = br + bi * r1
    den1 = jnp.where(den1 == 0, 1, den1)
    cr1 = (ar + ai * r1) / den1
    ci1 = (ai - ar * r1) / den1
    # branch 2: |bi| > |br|
    bi_s = jnp.where(bi == 0, 1, bi)
    r2 = br / bi_s
    den2 = bi + br * r2
    den2 = jnp.where(den2 == 0, 1, den2)
    cr2 = (ar * r2 + ai) / den2
    ci2 = (ai * r2 - ar) / den2
    return jnp.where(use_r, cr1, cr2), jnp.where(use_r, ci1, ci2)


def residuals_jax(H, Q, h_last, lo, hi, eps=None):
    """rs[i] = |Q[m-1, :] @ y_i| * |h_last| for every Ritz position i in
    [lo, hi): y_i the unit-norm eigenvector of the quasi-triangular H block
    containing diagonal index i, by shifted backward substitution in
    split-complex arithmetic (driver._copy_residuals twin)."""
    m = H.shape[1]
    if eps is None:
        eps = float(jnp.finfo(H.dtype).eps)
    R = H[:m, :]
    qrow = Q[m - 1, :]
    cols = jnp.arange(m)

    def one_residual(i):
        # Mirror collect_eigen exactly: bump j to the pair's second column
        # on a *nonzero* (not eps-small) subdiagonal, then detect the pair
        # from R[j, j-1] and take lam = (tr + sqrt(tr^2 - 4 det))/2 — the
        # positive-imaginary root, or the +sqrt real root if the block's
        # discriminant is non-negative.
        is_pair_first = (i < m - 1) & (H[jnp.minimum(i + 1, m - 1), i] != 0)
        j = jnp.where(is_pair_first, i + 1, i)
        pair = (j > 0) & (R[j, jnp.maximum(j - 1, 0)] != 0)

        jm1 = jnp.maximum(j - 1, 0)
        b11, b12 = R[jm1, jm1], R[jm1, j]
        b21, b22 = R[j, jm1], R[j, j]
        tr2 = (b11 + b22) / 2
        disc = tr2 * tr2 - (b11 * b22 - b21 * b12)
        lam_pair_re = tr2 + jnp.sqrt(jnp.maximum(disc, 0.0))
        lam_pair_im = jnp.sqrt(jnp.maximum(-disc, 0.0))
        lr = jnp.where(pair, lam_pair_re, R[j, j])
        li = jnp.where(pair, lam_pair_im, 0.0)

        # Seed x over columns [0, j] and the backward elimination:
        #   pair: x[j-1] = -r12/(r11-lam), x[j] = 1,
        #         x[:j-1] = -R[:j-1, j-1]*x[j-1] - R[:j-1, j], solve to k=j-1
        #   real: x[j] = 1, x[:j] = -R[:j, j], solve to k=j
        r11 = R[jnp.maximum(j - 1, 0), jnp.maximum(j - 1, 0)]
        r12 = R[jnp.maximum(j - 1, 0), j]
        xj1_re, xj1_im = _cdiv(-r12, jnp.zeros_like(r12), r11 - lr, -li)

        colj = R[:, j]
        colj1 = R[:, jnp.maximum(j - 1, 0)]
        x_re = jnp.where(
            cols == j,
            1.0,
            jnp.where(
                pair,
                jnp.where(
                    cols == j - 1,
                    xj1_re,
                    -colj1 * xj1_re - colj,
                ),
                -colj,
            ),
        )
        x_im = jnp.where(
            pair,
            jnp.where(cols == j, 0.0, jnp.where(cols == j - 1, xj1_im, -colj1 * xj1_im)),
            jnp.zeros_like(colj),
        )
        x_re = jnp.where(cols > j, 0.0, x_re)
        x_im = jnp.where(cols > j, 0.0, x_im)
        kend = jnp.where(pair, j - 1, j)  # number of leading entries to solve

        # Backward substitution (R[:k,:k] - lam I) y = x, k = kend, walking
        # k down by 1 or 2 (2x2 blocks solved directly).
        def bs_cond(state):
            k = state[0]
            return k > 0

        def bs_body(state):
            k, x_re, x_im = state
            is22 = (k > 1) & (jnp.abs(R[k - 1, jnp.maximum(k - 2, 0)]) > 0)

            def solve22(x_re, x_im):
                i2 = jnp.maximum(k - 2, 0)
                r11 = R[i2, i2] - lr
                r12 = R[i2, k - 1]
                r21 = R[k - 1, i2]
                r22 = R[k - 1, k - 1] - lr
                # complex: diag entries have -li imaginary part
                # det = r11*r22 - r21*r12 (complex)
                det_re = r11 * r22 - li * li - r21 * r12
                det_im = -li * (r11 + r22)
                b1r, b1i = x_re[i2], x_im[i2]
                b2r, b2i = x_re[k - 1], x_im[k - 1]
                # a1 = (r22c*b1 - r12*b2) / det ; r22c = r22 - i*li
                n1r = r22 * b1r + li * b1i - r12 * b2r
                n1i = r22 * b1i - li * b1r - r12 * b2i
                n2r = -r21 * b1r + r11 * b2r + li * b2i
                n2i = -r21 * b1i + r11 * b2i - li * b2r
                a1r, a1i = _cdiv(n1r, n1i, det_re, det_im)
                a2r, a2i = _cdiv(n2r, n2i, det_re, det_im)
                mask = cols < i2
                colA = R[:, i2]
                colB = R[:, k - 1]
                x_re2 = jnp.where(mask, x_re - (colA * a1r + colB * a2r), x_re)
                x_im2 = jnp.where(mask, x_im - (colA * a1i + colB * a2i), x_im)
                x_re2 = x_re2.at[i2].set(a1r).at[k - 1].set(a2r)
                x_im2 = x_im2.at[i2].set(a1i).at[k - 1].set(a2i)
                return x_re2, x_im2, k - 2

            def solve11(x_re, x_im):
                sr = R[k - 1, k - 1] - lr
                si = -li
                zero_pivot = (sr == 0) & (si == 0)
                vr, vi = _cdiv(x_re[k - 1], x_im[k - 1], sr, si)
                vr = jnp.where(zero_pivot, 0.0, vr)
                vi = jnp.where(zero_pivot, 0.0, vi)
                mask = cols < k - 1
                colA = R[:, k - 1]
                x_re2 = jnp.where(mask, x_re - colA * vr, x_re)
                x_im2 = jnp.where(mask, x_im - colA * vi, x_im)
                x_re2 = x_re2.at[k - 1].set(vr)
                x_im2 = x_im2.at[k - 1].set(vi)
                return x_re2, x_im2, k - 1

            x_re, x_im, k = lax.cond(
                is22,
                lambda xs: solve22(*xs),
                lambda xs: solve11(*xs),
                (x_re, x_im),
            )
            return k, x_re, x_im

        _, x_re, x_im = lax.while_loop(bs_cond, bs_body, (kend, x_re, x_im))

        nrm = jnp.sqrt(jnp.sum(x_re * x_re + x_im * x_im))
        nrm = jnp.where(nrm == 0, 1, nrm)
        tr = jnp.sum(qrow * x_re) / nrm
        ti = jnp.sum(qrow * x_im) / nrm
        return jnp.sqrt(tr * tr + ti * ti) * jnp.abs(h_last)

    idx = jnp.arange(m)
    rs = jax.vmap(one_residual)(idx)
    return jnp.where((idx >= lo) & (idx < hi), rs, 0.0)


# --- Sylvester swaps and Schur reordering (sylvester.py / swaps.py twins) ---


def _solve_complete_pivot_jax(M, b):
    """Complete-pivoting Gaussian elimination for a static tiny N (2 or 4).
    Returns (x, singular); x is garbage when singular (sylvester.py twin)."""
    N = M.shape[0]
    rows = jnp.arange(N)

    def swap_rows(A, k, i):
        rk, ri = A[k], A[i]
        return A.at[k].set(ri).at[i].set(rk)

    def swap_cols(A, k, j):
        ck, cj = A[:, k], A[:, j]
        return A.at[:, k].set(cj).at[:, j].set(ck)

    def swap_elems(v, k, i):
        vk, vi = v[k], v[i]
        return v.at[k].set(vi).at[i].set(vk)

    def body(k, state):
        M, x, colperm, singular = state
        live = (rows[:, None] >= k) & (rows[None, :] >= k)
        vals = jnp.where(live, jnp.abs(M), -1.0)
        flat = jnp.argmax(vals)
        i, j = flat // N, flat % N
        M = swap_rows(M, k, i)
        x = swap_elems(x, k, i)
        M = swap_cols(M, k, j)
        colperm = swap_elems(colperm, k, j)
        pivot = M[k, k]
        singular = singular | (pivot == 0)
        piv_s = jnp.where(pivot == 0, 1.0, pivot)
        fac = jnp.where(rows > k, M[:, k] / piv_s, 0.0)
        M = M - jnp.where(
            (rows[:, None] > k) & (rows[None, :] > k),
            jnp.outer(fac, M[k]),
            0.0,
        )
        M = M.at[:, k].set(jnp.where(rows > k, fac, M[:, k]))
        x = x - jnp.where(rows > k, fac * x[k], 0.0)
        return M, x, colperm, singular

    state = (M, b, jnp.arange(N), jnp.asarray(False))
    M, x, colperm, singular = lax.fori_loop(0, N - 1, body, state)
    singular = singular | (M[N - 1, N - 1] == 0)

    def back(t, x):
        i = N - 1 - t
        s = jnp.sum(jnp.where(rows > i, M[i] * x, 0.0))
        piv = M[i, i]
        piv_s = jnp.where(piv == 0, 1.0, piv)
        return x.at[i].set((x[i] - s) / piv_s)

    x = lax.fori_loop(0, N, back, x)
    out = jnp.zeros_like(x).at[colperm].set(x)
    return out, singular


def _sylv_jax(A, B, C):
    """Solve A X - X B = C for static block sizes p, q in {1, 2}
    (sylvester.py twin: Kronecker recast + complete-pivot elimination)."""
    p, q = C.shape
    M = jnp.kron(jnp.eye(q, dtype=A.dtype), A) - jnp.kron(
        B.T, jnp.eye(p, dtype=A.dtype)
    )
    x, singular = _solve_complete_pivot_jax(M, C.reshape(p * q, order="F"))
    return x.reshape((p, q), order="F"), singular


def _dynslice(R, i, j, p, q):
    return lax.dynamic_slice(R, (i, j), (p, q))


def swap11_jax(H, Q, i):
    """Exchange adjacent 1x1 blocks at i, i+1 — closed-form rotation
    (swaps.py:swap11 twin); operates on the m x m part of H."""
    m = H.shape[1]
    r11 = H[i, i]
    r12 = H[i, i + 1]
    r22 = H[i + 1, i + 1]
    c, s, _ = givens_jax(r12, r22 - r11)
    H = _lmul2(c, s, H, i, i + 2, m)
    H = _rmul2(H, c, s, i, 0, i)
    H = H.at[i, i].set(r22).at[i + 1, i + 1].set(r11)
    Q = _rmul2(Q, c, s, i, 0, Q.shape[0])
    return H, Q


def swap12_jax(H, Q, i):
    m = H.shape[1]
    A = _dynslice(H, i, i, 1, 1)
    B = _dynslice(H, i + 1, i + 1, 2, 2)
    C = _dynslice(H, i, i + 1, 1, 2)
    X, singular = _sylv_jax(A, B, C)

    def do(HQ):
        H, Q = HQ
        c1, s1, _ = givens_jax(-X[0, 0], jnp.ones((), H.dtype))
        x22 = -s1 * -X[0, 1]
        c2, s2, _ = givens_jax(x22, jnp.ones((), H.dtype))
        H = _lmul2(c1, s1, H, i, i, m)
        H = _rmul2(H, c1, s1, i, 0, i + 3)
        H = _lmul2(c2, s2, H, i + 1, i, m)
        H = _rmul2(H, c2, s2, i + 1, 0, i + 3)
        H = H.at[i + 2, i].set(0).at[i + 2, i + 1].set(0)
        Q = _rmul2(Q, c1, s1, i, 0, Q.shape[0])
        Q = _rmul2(Q, c2, s2, i + 1, 0, Q.shape[0])
        return H, Q

    return lax.cond(singular, lambda HQ: HQ, do, (H, Q))


def swap21_jax(H, Q, i):
    m = H.shape[1]
    A = _dynslice(H, i, i, 2, 2)
    B = _dynslice(H, i + 2, i + 2, 1, 1)
    C = _dynslice(H, i, i + 2, 2, 1)
    X, singular = _sylv_jax(A, B, C)

    def do(HQ):
        H, Q = HQ
        c1, s1, n1 = givens_jax(-X[1, 0], jnp.ones((), H.dtype))
        c2, s2, _ = givens_jax(-X[0, 0], n1)
        H = _lmul3(c1, s1, c2, s2, H, i, i, m)
        H = _rmul3(H, c1, s1, c2, s2, i, 0, i + 3)
        H = H.at[i + 1, i].set(0).at[i + 2, i].set(0)
        Q = _rmul3(Q, c1, s1, c2, s2, i, 0, Q.shape[0])
        return H, Q

    return lax.cond(singular, lambda HQ: HQ, do, (H, Q))


def swap22_jax(H, Q, i):
    m = H.shape[1]
    A = _dynslice(H, i, i, 2, 2)
    B = _dynslice(H, i + 2, i + 2, 2, 2)
    C = _dynslice(H, i, i + 2, 2, 2)
    X, singular = _sylv_jax(A, B, C)

    def do(HQ):
        H, Q = HQ
        one = jnp.ones((), H.dtype)
        c1, s1, n1 = givens_jax(-X[1, 0], one)
        c2, s2, _ = givens_jax(-X[0, 0], n1)
        x22 = c1 * -X[1, 1]
        x32 = -s1 * -X[1, 1]
        x22 = -s2 * -X[0, 1] + c2 * x22
        c3, s3, n3 = givens_jax(x32, one)
        c4, s4, _ = givens_jax(x22, n3)

        H = _lmul3(c1, s1, c2, s2, H, i, i, m)
        H = _rmul3(H, c1, s1, c2, s2, i, 0, i + 4)
        H = _lmul3(c3, s3, c4, s4, H, i + 1, i, m)
        H = _rmul3(H, c3, s3, c4, s4, i + 1, 0, i + 4)
        H = (
            H.at[i + 2, i].set(0)
            .at[i + 3, i].set(0)
            .at[i + 2, i + 1].set(0)
            .at[i + 3, i + 1].set(0)
        )
        Q = _rmul3(Q, c1, s1, c2, s2, i, 0, Q.shape[0])
        Q = _rmul3(Q, c3, s3, c4, s4, i + 1, 0, Q.shape[0])
        return H, Q

    return lax.cond(singular, lambda HQ: HQ, do, (H, Q))


def _is_start_11(H, i):
    m = H.shape[1]
    return (i == m - 1) | (H[jnp.minimum(i + 1, m - 1), i] == 0)


def _is_end_11(H, i):
    return (i == 0) | (H[i, jnp.maximum(i - 1, 0)] == 0)


def swap_jax(H, Q, i, curr_is_11, next_is_11):
    """Swap the two consecutive blocks starting at i (swaps.py:swap twin)."""
    case = jnp.where(curr_is_11, 0, 2) + jnp.where(next_is_11, 0, 1)
    return lax.switch(
        case, [swap11_jax, swap12_jax, swap21_jax, swap22_jax], H, Q, i
    )


def rotate_right_jax(H, Q, frm, to):
    """Move the block at `to` in front of `frm` by successive swaps
    (swaps.py:rotate_right twin)."""

    def cond(state):
        return state[2] > frm

    def body(state):
        H, Q, i = state
        curr_11 = _is_start_11(H, i)
        prev_11 = _is_end_11(H, i - 1)
        j = jnp.where(prev_11, i - 1, i - 2)
        H, Q = swap_jax(H, Q, j, prev_11, curr_11)
        return H, Q, j

    H, Q, _ = lax.while_loop(cond, body, (H, Q, to))
    return H, Q


def partition_three_way_jax(H, Q, groups):
    """Partition the Schur blocks into [locked | retained | purged] by
    rotating group-1/2 blocks forward (driver._partition_three_way twin).
    `groups` is indexed by original diagonal position."""
    m = H.shape[1]

    def cond(state):
        return state[2] < m

    def body(state):
        H, Q, hi, mi, lo = state
        group = groups[jnp.minimum(hi, m - 1)]
        bs = jnp.where(_is_start_11(H, hi), 1, 2)

        def purged(H, Q, hi, mi, lo):
            return H, Q, hi + bs, mi, lo

        def retained(H, Q, hi, mi, lo):
            H, Q = rotate_right_jax(H, Q, mi, hi)
            return H, Q, hi + bs, mi + bs, lo

        def locked(H, Q, hi, mi, lo):
            H, Q = rotate_right_jax(H, Q, lo, hi)
            return H, Q, hi + bs, mi + bs, lo + bs

        case = jnp.clip(group - 1, 0, 2)  # 1 -> locked, 2 -> retained, 3 -> purged
        return lax.switch(case, [locked, retained, purged], H, Q, hi, mi, lo)

    z = jnp.int32(0)
    H, Q, _, _, _ = lax.while_loop(cond, body, (H, Q, z, z, z))
    return H, Q


def order_key_jax(which_name, lam_re, lam_im):
    """Sort key vector for a target (targets.get_order twin, split-complex;
    `which_name` is a static string)."""
    if which_name == "LM":
        return -jnp.hypot(lam_re, lam_im)
    if which_name == "LR":
        return -lam_re
    if which_name == "SR":
        return lam_re
    if which_name == "LI":
        return -lam_im
    if which_name == "SI":
        return lam_im
    raise ValueError(f"unknown target {which_name!r}")


def _block_eig_key(H, i, which_name):
    """Order key of the eigenvalue of the block starting at i
    (eig.py:eigenvalue twin: +imag root for 2x2 blocks)."""
    m = H.shape[1]
    pair = ~_is_start_11(H, i)
    i1 = jnp.minimum(i + 1, m - 1)
    b11, b12 = H[i, i], H[i, i1]
    b21, b22 = H[i1, i], H[i1, i1]
    x = (b11 + b22) / 2
    disc = x * x - (b11 * b22 - b12 * b21)
    re_pair = x + jnp.sqrt(jnp.maximum(disc, 0.0))
    im_pair = jnp.sqrt(jnp.maximum(-disc, 0.0))
    lr = jnp.where(pair, re_pair, H[i, i])
    li = jnp.where(pair, im_pair, 0.0)
    return order_key_jax(which_name, lr, li)


def sort_schur_jax(H, Q, count, which_name):
    """Insertion sort of the leading `count` Schur blocks into the target
    order via direct swaps (driver._sort_schur twin).  `which_name` is a
    static string."""

    def outer_cond(state):
        return state[2] < count

    def outer_body(state):
        H, Q, nxt = state
        curr0 = nxt
        curr_size0 = jnp.where(_is_start_11(H, curr0), 1, 2)
        key_curr = _block_eig_key(H, curr0, which_name)

        def inner_cond(st):
            H, Q, curr = st
            prev_size = jnp.where(_is_end_11(H, jnp.maximum(curr - 1, 0)), 1, 2)
            prev = curr - prev_size
            key_prev = _block_eig_key(H, jnp.maximum(prev, 0), which_name)
            return (curr > 0) & (key_curr < key_prev)

        def inner_body(st):
            H, Q, curr = st
            prev_size = jnp.where(_is_end_11(H, jnp.maximum(curr - 1, 0)), 1, 2)
            prev = curr - prev_size
            curr_size = jnp.where(_is_start_11(H, curr), 1, 2)
            H, Q = swap_jax(H, Q, prev, prev_size == 1, curr_size == 1)
            return H, Q, prev

        H, Q, _ = lax.while_loop(inner_cond, inner_body, (H, Q, curr0))
        return H, Q, nxt + curr_size0

    H, Q, _ = lax.while_loop(outer_cond, outer_body, (H, Q, jnp.int32(0)))
    return H, Q


# --- Hessenberg restoration after truncation (restore.py twin) --------------


def restore_arnoldi_jax(H, Q, lo, hi):
    """Zero Q's last row over [lo, hi-1) with Givens rotations, absorb the
    residual coupling into H[hi, hi-1], then restore the Hessenberg form of
    the window with a backward Householder sweep (restore.py twin).
    No-op when the active window has <= 1 column."""
    m = H.shape[1]
    last = Q.shape[0] - 1
    cols = jnp.arange(m)
    rows_h = jnp.arange(H.shape[0])
    trivial = lo >= hi - 1

    def full(H, Q):
        # Pass 1: Givens zero-out of Q[last, lo:hi-1].
        def g_body(i, state):
            H, Q, nrm = state
            c, s, nrm2 = givens_jax(Q[last, i + 1], nrm)
            # Rotation2(c, -s, i) in the reference's convention.
            H = _rmul2(H, c, -s, i, 0, jnp.minimum(i + 3, hi))
            H = _lmul2(c, -s, H, i, 0, hi)
            Q = _rmul2(Q, c, -s, i, 0, Q.shape[0])
            return H, Q, nrm2

        H, Q, _ = lax.fori_loop(lo, hi - 1, g_body, (H, Q, Q[last, lo]))

        H = H.at[hi, hi - 1].set(Q[last, hi - 1] * H[m, m - 1])

        # Pass 2: backward Householder sweep, length = hi-1-lo .. 2.
        # The reflector at `length` is built from row `row = lo+length`'s
        # leading segment [lo, lo+length); it acts on rows/columns
        # [lo, lo+length) with weights v (entries [lo, lastc)) and 1 at
        # lastc = lo+length-1 (restore.py:_refl_lmul/_refl_rmul).
        def h_body(t, state):
            H, Q = state
            length = (hi - 1 - lo) - t
            row = lo + length
            lastc = row - 1

            vmask = (cols >= lo) & (cols < lastc)
            alpha = H[row, lastc]
            xnrm2 = jnp.sum(jnp.where(vmask, H[row] * H[row], 0.0))
            zero_refl = xnrm2 == 0
            beta = -jnp.copysign(
                jnp.hypot(jnp.abs(alpha), jnp.sqrt(xnrm2)), alpha
            )
            beta_s = jnp.where(beta == 0, 1.0, beta)
            tau = jnp.where(zero_refl, 0.0, (beta - alpha) / beta_s)
            denom = alpha - beta
            denom = jnp.where(denom == 0, 1.0, denom)
            v = jnp.where(vmask, H[row] / denom, 0.0)
            vaug = v + jnp.where(cols == lastc, 1.0, 0.0)  # (m,)
            vaug_rows = jnp.concatenate(
                [vaug, jnp.zeros(H.shape[0] - m, vaug.dtype)]
            )  # (m+1,): same offsets as row indices

            # Column-space application to H rows [0, row).
            d = jnp.where(
                rows_h < row, tau * jnp.matmul(H, vaug, precision=_PREC), 0.0
            )
            H = H - jnp.outer(d, vaug)
            # Explicit pivot-row writes (kept at alpha for a trivial
            # reflector, mirroring reflector()'s early return).
            beta_w = jnp.where(zero_refl, alpha, beta)
            H = H.at[row].set(
                jnp.where(vmask, 0.0, jnp.where(cols == lastc, beta_w, H[row]))
            )
            # Row-space application to H rows [lo, row), columns [lo, hi).
            colsel = (cols >= lo) & (cols < hi)
            d2 = jnp.where(
                colsel,
                tau * jnp.matmul(vaug_rows, H, precision=_PREC),
                0.0,
            )
            H = H - jnp.outer(vaug_rows, d2)
            # Column-space application to Q (all rows).
            dq = tau * jnp.matmul(Q, vaug, precision=_PREC)
            Q = Q - jnp.outer(dq, vaug)
            return H, Q

        nsweeps = jnp.maximum(hi - 1 - lo - 1, 0)

        def h_loop(t, state):
            return lax.cond(t < nsweeps, lambda s: h_body(t, s), lambda s: s, state)

        H, Q = lax.fori_loop(0, m, h_loop, (H, Q))
        return H, Q

    return lax.cond(trivial, lambda H, Q: (H, Q), full, H, Q)
