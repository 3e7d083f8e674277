"""Split-complex Arnoldi expansion: complex matrices carried in real words.

Selected by partial_schur(..., split_complex=True); complex matrices
otherwise run natively in complex64/complex128.  The n-sized device work
carries the Krylov basis as a REAL pair (V_re, V_im), exactly the move
ops/df_expansion.py makes for the hi/lo double-word pair.  The
(maxdim+1)-sized dense restart layer stays on host in complex128, where
the full generic machinery (single-shift QR, complex swaps, complex
eigenvectors) already exists.

The operator contract is `matvec_sc(xr, xi) -> (yr, yi)`; with
A = Ar + i*Ai that is

    yr = Ar xr - Ai xi,    yi = Ar xi + Ai xr

(SplitComplexDenseOperator in models.operators; matrix-free users
implement it directly).  All projections conjugate the basis:
h = V^H w  =>  hr = Vr.wr + Vi.wi,  hi = Vr.wi - Vi.wr, contracted at
HIGHEST precision like every Gram-Schmidt product in ops/expansion.py.

Everything mirrors ops/expansion.py step for step (same DGKS eta, same
breakdown handling; behavioral reference ArnoldiMethod.jl
src/expansion.jl) — only the arithmetic is split into (re, im) words.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from .expansion import ETA, _PREC

__all__ = [
    "sc_expand_range",
    "sc_truncate_and_expand",
    "sc_apply_basis_change",
    "sc_set_initial_vector",
    "sc_set_random_vector",
]


def _sc_norm(wr, wi):
    return jnp.sqrt(
        jnp.vdot(wr, wr, precision=_PREC) + jnp.vdot(wi, wi, precision=_PREC)
    )


def _sc_masked_project(Vr, Vi, wr, wi, mask):
    """h = V^H w over masked rows, and the projection update w -= V^T h
    (rows convention: w' = w - sum_j h_j V_j)."""
    hr = jnp.where(
        mask,
        jnp.matmul(Vr, wr, precision=_PREC)
        + jnp.matmul(Vi, wi, precision=_PREC),
        0.0,
    )
    hi = jnp.where(
        mask,
        jnp.matmul(Vr, wi, precision=_PREC)
        - jnp.matmul(Vi, wr, precision=_PREC),
        0.0,
    )
    wr = wr - (
        jnp.matmul(hr, Vr, precision=_PREC)
        - jnp.matmul(hi, Vi, precision=_PREC)
    )
    wi = wi - (
        jnp.matmul(hr, Vi, precision=_PREC)
        + jnp.matmul(hi, Vr, precision=_PREC)
    )
    return (hr, hi), (wr, wi)


def _sc_dgks(Vr, Vi, wr, wi, mask):
    """Two-stage DGKS (ops/expansion.py::_dgks_orthogonalize twin)."""
    rnorm = _sc_norm(wr, wi)
    (hr, hi), (wr, wi) = _sc_masked_project(Vr, Vi, wr, wi, mask)
    wnorm = _sc_norm(wr, wi)

    def second_pass(args):
        wr, wi, hr, hi, wnorm = args
        (cr, ci), (w2r, w2i) = _sc_masked_project(Vr, Vi, wr, wi, mask)
        return w2r, w2i, hr + cr, hi + ci, _sc_norm(w2r, w2i), wnorm

    def no_second_pass(args):
        wr, wi, hr, hi, wnorm = args
        return wr, wi, hr, hi, wnorm, rnorm

    return lax.cond(
        wnorm < ETA * rnorm, second_pass, no_second_pass,
        (wr, wi, hr, hi, wnorm),
    )


def _sc_random_unit(key, n, dtype, Vr, Vi, mask):
    kr, ki = jax.random.split(key)
    zr = jax.random.normal(kr, (n,), dtype=dtype)
    zi = jax.random.normal(ki, (n,), dtype=dtype)
    _, (zr, zi) = _sc_masked_project(Vr, Vi, zr, zi, mask)
    _, (zr, zi) = _sc_masked_project(Vr, Vi, zr, zi, mask)
    nrm = _sc_norm(zr, zi)
    return zr / nrm, zi / nrm


def sc_expand_range_impl(op, Vr, Vi, Hr, Hi, j0, j1, key):
    """Extend A V[:j].T = V[:j+1].T H[:j+1, :j] in split-complex
    arithmetic, writing basis rows j0+1 .. j1 and H columns [j0, j1)."""
    m1, n = Vr.shape
    rows = jnp.arange(m1)

    def body(j, carry):
        Vr, Vi, Hr, Hi = carry
        wr, wi = op.matvec_sc(Vr[j], Vi[j])
        mask = rows <= j
        wr, wi, hr, hi, wnorm, refnorm = _sc_dgks(Vr, Vi, wr, wi, mask)
        breakdown = wnorm <= ETA * refnorm

        def keep(Vr, Vi, Hr, Hi):
            Hcr = jnp.where(rows == j + 1, wnorm, hr)
            Hci = jnp.where(rows == j + 1, 0.0, hi)
            return (
                Vr.at[j + 1].set(wr / wnorm),
                Vi.at[j + 1].set(wi / wnorm),
                Hr.at[:, j].set(Hcr),
                Hi.at[:, j].set(Hci),
            )

        def handle_breakdown(Vr, Vi, Hr, Hi):
            Hr = Hr.at[:, j].set(hr)  # H[j+1, j] stays zero: deflation
            Hi = Hi.at[:, j].set(hi)

            def reinit(VV):
                Vr, Vi = VV
                zr, zi = _sc_random_unit(
                    jax.random.fold_in(key, j), n, Vr.dtype, Vr, Vi, mask
                )
                return Vr.at[j + 1].set(zr), Vi.at[j + 1].set(zi)

            Vr, Vi = lax.cond(
                j + 1 < n,
                reinit,
                lambda VV: (VV[0].at[j + 1].set(wr),
                            VV[1].at[j + 1].set(wi)),
                (Vr, Vi),
            )
            return Vr, Vi, Hr, Hi

        return lax.cond(breakdown, handle_breakdown, keep, Vr, Vi, Hr, Hi)

    return lax.fori_loop(j0, j1, body, (Vr, Vi, Hr, Hi))


sc_expand_range = jax.jit(sc_expand_range_impl, donate_argnums=(1, 2, 3, 4))


def _sc_basis_change_impl(Vr, Vi, Qr, Qi):
    """V <- Qbig^T V with complex Qbig = Qr + i*Qi (no conjugate — this
    is the right-multiplication basis change, run.jl:363-365)."""
    nVr = (
        jnp.matmul(Qr.T, Vr, precision=_PREC)
        - jnp.matmul(Qi.T, Vi, precision=_PREC)
    )
    nVi = (
        jnp.matmul(Qr.T, Vi, precision=_PREC)
        + jnp.matmul(Qi.T, Vr, precision=_PREC)
    )
    return nVr, nVi


sc_apply_basis_change = jax.jit(_sc_basis_change_impl, donate_argnums=(0, 1))


@partial(jax.jit, donate_argnums=(1, 2, 3, 4))
def sc_truncate_and_expand(op, Vr, Vi, Hr, Hi, Qr, Qi, j0, j1, key):
    """One fused device step per restart (split-complex twin of
    ops/expansion.py::truncate_and_expand)."""
    Vr, Vi = _sc_basis_change_impl(Vr, Vi, Qr, Qi)
    return sc_expand_range_impl(op, Vr, Vi, Hr, Hi, j0, j1, key)


@partial(jax.jit, donate_argnums=(0, 1))
def sc_set_initial_vector(Vr, Vi, vr, vi):
    vr = vr.astype(Vr.dtype)
    vi = vi.astype(Vi.dtype)
    nrm = _sc_norm(vr, vi)
    return Vr.at[0].set(vr / nrm), Vi.at[0].set(vi / nrm)


@partial(jax.jit, donate_argnums=(0, 1))
def sc_set_random_vector(Vr, Vi, j, key):
    """Fresh random unit vector orthogonal to rows [0, j) — warm-start
    reinitialization (partialschur! with initialize=true)."""
    m1, n = Vr.shape
    mask = jnp.arange(m1) < j
    zr, zi = _sc_random_unit(key, n, Vr.dtype, Vr, Vi, mask)
    return Vr.at[j].set(zr), Vi.at[j].set(zi)
