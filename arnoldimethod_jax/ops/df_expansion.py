"""Extended-precision Arnoldi expansion: the n-sized device work carried
in DOUBLE-WORD arithmetic (ops/df32.py), with the Krylov basis stored as
an unevaluated (V_hi, V_lo) pair.

This is the double-word analogue of the reference's Double64 capability
(readme.md:81-99): with float32 words the effective working precision is
~2^-48 ≈ 3.6e-15, so the solver's convergence criterion can honor
tolerances down to ~1e-12 from float32 arithmetic alone.
The (maxdim+1)-sized dense restart work stays on host in float64 —
comfortably below the double-word f32 noise floor, so it does not limit
the end-to-end residual.

Everything mirrors ops/expansion.py step for step (same DGKS eta, same
breakdown handling — behavioral reference ArnoldiMethod.jl
src/expansion.jl); only the arithmetic is double-word and the operator
is applied through `matvec_df(xh, xl) -> (yh, yl)` (DiaOperator
implements it; any operator can).  H coefficient columns are returned as
a (Hh, Hl) pair whose f64 sum the host driver treats as authoritative.

Cost: ~10-20x the flops of the plain-f32 expansion, all elementwise /
tree-reduction work (matrix units cannot carry the compensation), plus
2x the basis memory traffic.  For latency-bound small-to-medium problems
this is noise; for bandwidth-bound giants use the plain path (or native
float64) unless you need the digits.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from . import df32
from .expansion import ETA


def _df_masked_project(Vh, Vl, wh, wl, mask):
    """h = V^T w (double-word, masked rows) and the projection update."""
    hh, hl = df32.df_project_coeffs_df(Vh, Vl, wh, wl)
    hh = jnp.where(mask, hh, 0)
    hl = jnp.where(mask, hl, 0)
    wh, wl = df32.df_axpy_update_df(wh, wl, hh, hl, Vh, Vl)
    return (hh, hl), (wh, wl)


def _df_dgks(Vh, Vl, wh, wl, mask):
    """Two-stage DGKS in double-word; returns (w, h, wnorm_hi, refnorm_hi)
    — the breakdown test compares hi words (eta is 0.707, not 1e-15)."""
    rnorm = df32.df_norm(wh, wl)[0]
    (hh, hl), (wh, wl) = _df_masked_project(Vh, Vl, wh, wl, mask)
    wnorm = df32.df_norm(wh, wl)[0]

    def second_pass(args):
        wh, wl, hh, hl, wnorm = args
        (ch, cl), (w2h, w2l) = _df_masked_project(Vh, Vl, wh, wl, mask)
        hh, hl = df32.df_add(hh, hl, ch, cl)
        return w2h, w2l, hh, hl, df32.df_norm(w2h, w2l)[0], wnorm

    def no_second_pass(args):
        wh, wl, hh, hl, wnorm = args
        return wh, wl, hh, hl, wnorm, rnorm

    return lax.cond(
        wnorm < ETA * rnorm, second_pass, no_second_pass,
        (wh, wl, hh, hl, wnorm),
    )


def _df_normalize(wh, wl):
    nh, nl = df32.df_norm(wh, wl)
    ih, il = df32.df_inv(nh, nl)
    sh, sl = df32.df_mul(wh, wl, ih, il)
    return (sh, sl), (nh, nl)


def _df_random_unit(key, n, dtype, Vh, Vl, mask):
    v = jax.random.normal(key, (n,), dtype=dtype)
    zh, zl = v, jnp.zeros_like(v)
    _, (zh, zl) = _df_masked_project(Vh, Vl, zh, zl, mask)
    _, (zh, zl) = _df_masked_project(Vh, Vl, zh, zl, mask)
    (zh, zl), _ = _df_normalize(zh, zl)
    return zh, zl


def _matvec_df(op, xh, xl):
    if hasattr(op, "matvec_df"):
        return op.matvec_df(xh, xl)
    # Fallback: two plain matvecs — the SpMV rounding then floors the
    # achievable residual at ~eps_word * ||A||; operators wanting full
    # double-word accuracy must implement matvec_df.
    yh = op.matvec(xh)
    yl = op.matvec(xl)
    return df32.df_add(yh, jnp.zeros_like(yh), yl, jnp.zeros_like(yl))


def df_expand_range_impl(op, Vh, Vl, Hh, Hl, j0, j1, key):
    """Extend A V[:j].T = V[:j+1].T H[:j+1, :j] in double-word arithmetic,
    writing basis rows j0+1 .. j1 and H columns [j0, j1)."""
    m1, n = Vh.shape
    rows = jnp.arange(m1)

    def body(j, carry):
        Vh, Vl, Hh, Hl = carry
        wh, wl = _matvec_df(op, Vh[j], Vl[j])
        mask = rows <= j
        wh, wl, hh, hl, wnorm, refnorm = _df_dgks(Vh, Vl, wh, wl, mask)
        breakdown = wnorm <= ETA * refnorm

        def keep(Vh, Vl, Hh, Hl):
            (sh, sl), (nh, nl) = _df_normalize(wh, wl)
            Hcolh = jnp.where(rows == j + 1, nh, hh)
            Hcoll = jnp.where(rows == j + 1, nl, hl)
            return (
                Vh.at[j + 1].set(sh),
                Vl.at[j + 1].set(sl),
                Hh.at[:, j].set(Hcolh),
                Hl.at[:, j].set(Hcoll),
            )

        def handle_breakdown(Vh, Vl, Hh, Hl):
            Hh = Hh.at[:, j].set(hh)  # H[j+1, j] stays zero: deflation
            Hl = Hl.at[:, j].set(hl)

            def reinit(VhVl):
                Vh, Vl = VhVl
                zh, zl = _df_random_unit(
                    jax.random.fold_in(key, j), n, Vh.dtype, Vh, Vl, mask
                )
                return Vh.at[j + 1].set(zh), Vl.at[j + 1].set(zl)

            Vh, Vl = lax.cond(
                j + 1 < n,
                reinit,
                lambda VhVl: (VhVl[0].at[j + 1].set(wh),
                              VhVl[1].at[j + 1].set(wl)),
                (Vh, Vl),
            )
            return Vh, Vl, Hh, Hl

        return lax.cond(breakdown, handle_breakdown, keep, Vh, Vl, Hh, Hl)

    return lax.fori_loop(j0, j1, body, (Vh, Vl, Hh, Hl))


df_expand_range = jax.jit(df_expand_range_impl, donate_argnums=(1, 2, 3, 4))


def _df_basis_change_impl(Vh, Vl, Qh, Ql):
    """V <- Qbig^T V with BOTH the basis and the (m+1, m+1) basis-change
    matrix double-word: out[i] = sum_j Q[j, i] * V[j], accumulated with
    df adds (a scan over the m+1 rows — small m, n-sized rows)."""
    m1 = Vh.shape[0]

    def body(carry, jrow):
        outh, outl = carry
        Qjh, Qjl, Vjh, Vjl = jrow
        th, tl = df32.df_mul(
            Qjh[:, None], Qjl[:, None], Vjh[None, :], Vjl[None, :]
        )
        return df32.df_add(outh, outl, th, tl), None

    zero = jnp.zeros_like(Vh)
    (outh, outl), _ = lax.scan(
        body, (zero, jnp.zeros_like(Vl)), (Qh, Ql, Vh, Vl)
    )
    return outh, outl


df_apply_basis_change = jax.jit(_df_basis_change_impl, donate_argnums=(0, 1))


@partial(jax.jit, donate_argnums=(1, 2, 3, 4))
def df_truncate_and_expand(op, Vh, Vl, Hh, Hl, Qh, Ql, j0, j1, key):
    """One fused device step per restart (extended-precision twin of
    ops/expansion.py::truncate_and_expand)."""
    Vh, Vl = _df_basis_change_impl(Vh, Vl, Qh, Ql)
    return df_expand_range_impl(op, Vh, Vl, Hh, Hl, j0, j1, key)


@partial(jax.jit, donate_argnums=(0, 1))
def df_set_initial_vector(Vh, Vl, v):
    """V[0] = v / ||v|| in double-word (v plain, not mutated)."""
    vh = v.astype(Vh.dtype)
    (sh, sl), _ = _df_normalize(vh, jnp.zeros_like(vh))
    return Vh.at[0].set(sh), Vl.at[0].set(sl)


@partial(jax.jit, donate_argnums=(0, 1))
def df_reorthogonalize_row(Vh, Vl, j):
    """Re-orthogonalize row j against rows [0, j) and renormalize, all in
    double-word — used on warm starts, where the seed row was placed by
    the plain single-word path and is only single-word orthogonal to the
    locked (double-word) prefix."""
    m1 = Vh.shape[0]
    mask = jnp.arange(m1) < j
    wh, wl = Vh[j], Vl[j]
    _, (wh, wl) = _df_masked_project(Vh, Vl, wh, wl, mask)
    _, (wh, wl) = _df_masked_project(Vh, Vl, wh, wl, mask)
    (wh, wl), _ = _df_normalize(wh, wl)
    return Vh.at[j].set(wh), Vl.at[j].set(wl)


@partial(jax.jit, donate_argnums=(0, 1))
def df_set_random_vector(Vh, Vl, j, key):
    m1, n = Vh.shape
    mask = jnp.arange(m1) < j
    zh, zl = _df_random_unit(key, n, Vh.dtype, Vh, Vl, mask)
    return Vh.at[j].set(zh), Vl.at[j].set(zl)


def split_f64(Q, dtype):
    """Split a host float64 matrix into a double-word pair of `dtype`
    (hi = round(Q), lo = round(Q - hi)) — for feeding the host dense
    layer's basis-change matrices to the df device kernels."""
    import numpy as np

    hi = np.asarray(Q, dtype=dtype)
    lo = np.asarray(Q - hi.astype(np.float64), dtype=dtype)
    return jnp.asarray(hi), jnp.asarray(lo)
