"""Fully on-device Krylov-Schur solve: the restart loop as a compiled
device program, dispatched in bounded-duration chunks.

The host driver (driver.py) keeps the dense restart work on the host and
pays one host<->device round trip per restart.  This module runs the complete algorithm — Arnoldi expansion,
Francis QR, Ritz extraction, locking/purging decisions, Sylvester-swap
partitioning, Hessenberg restoration, truncation — inside a
`lax.while_loop` over restarts (dense/device.py kernels), so the only
recurring transfer is ONE scalar `done` flag per chunk of restarts.

Why chunks: a dispatch-size heuristic shared with the host path's
expansion slicing (ops/expansion.py DISPATCH_BUDGET_S) — the host regains
control every ~40 s (env-tunable) instead of blocking once for the whole
solve.  The loop is split into dispatches of at most `it_stop - it`
restarts, sized adaptively from the measured per-restart wall.  Because
`it_stop` is a traced scalar, every chunk size reuses one compiled
program.

Semantics mirror driver._partial_schur restart-for-restart (same
convergence criterion, same truncation rule, same conjugate-pair and
purge handling).  The dense arithmetic (H, Q) runs on the device in
float64 — the host path's precision — whatever the global
jax_enable_x64 setting: `fused_solve` turns 64-bit types on for its own
dispatches.  In float32 the Francis QR's accumulated rotations lose
~25 eps_f32 of orthogonality per restart (m=20), and over a solve the
basis drifts past the float32 Schur-residual bound.  The convergence
floor is eps(basis dtype) * ||H||_F (docs/precision.md).  Real dtypes
only: the dense kernels carry conjugate pairs as real 2x2 blocks.

Behavioral reference: ArnoldiMethod.jl src/run.jl:224-392 via driver.py.
"""

from __future__ import annotations

import os
import time
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from .dense.device import (
    eigenvalues_jax,
    local_schur_jax,
    order_key_jax,
    partition_three_way_jax,
    residuals_jax,
    restore_arnoldi_jax,
    sort_schur_jax,
)
from .ops.expansion import _PREC, DISPATCH_BUDGET_S, expand_range_impl

__all__ = ["fused_solve"]

# Per-dispatch wall-clock target (seconds): one shared knob with the
# expansion slicing (ARNOLDI_CHUNK_SECONDS, ops/expansion.py).
_CHUNK_SECONDS = DISPATCH_BUDGET_S
# Restart count of the FIRST dispatch (compile time makes its wall
# useless for rate estimation, so it is fixed and small-ish).
_CHUNK_INIT = int(os.environ.get("ARNOLDI_FUSED_CHUNK", "16"))
_CHUNK_MAX = 512


@partial(jax.jit, donate_argnums=(1, 2))
def _fused_init(op, V, H, active0, restarts, key):
    """Initial expansion straight to maxdim (driver.py does the same);
    returns the loop-carried state for the first chunk."""
    m = H.shape[1]
    active0 = jnp.int32(active0)
    V, H = expand_range_impl(op, V, H, active0, m, jax.random.fold_in(key, 0))
    return (
        V,
        H,
        active0,
        jnp.int32(m) - active0,   # prods
        jnp.int32(0),             # it
        jnp.int32(0),             # purges
        jnp.int32(restarts) <= 0,  # restarts=0: no dense phase (host parity)
        jnp.asarray(True),        # qr_ok
    )


@partial(jax.jit, static_argnames=("which", "maxiter_qr"),
         donate_argnums=(1, 2))
def _fused_chunk(op, V, H, active, prods, it, purges, done, qr_ok,
                 nev, mindim, tol, restarts, it_stop, key, which,
                 maxiter_qr=None):
    """Run restart iterations until converged/exhausted OR `it_stop` is
    reached (the dispatch-duration bound).  State threads through
    unchanged shapes, so every chunk reuses one compiled program."""
    m = H.shape[1]
    dtype = H.dtype  # dense restart arithmetic
    eps = float(jnp.finfo(dtype).eps)  # deflation in the dense kernels
    eps_work = float(jnp.finfo(V.dtype).eps)  # the basis's noise floor
    idxv = jnp.arange(m)

    nev = jnp.int32(nev)
    mindim = jnp.int32(mindim)
    restarts = jnp.int32(restarts)
    it_stop = jnp.int32(it_stop)
    tol = jnp.asarray(tol, dtype)

    def body(state):
        V, H, active, prods, it, purges, done, qr_ok = state

        # --- dense restart phase (all on device) -----------------------
        Q = jnp.eye(m, dtype=dtype)
        H, Q, ok = local_schur_jax(H, Q, active, m, eps, maxiter_qr)
        qr_ok = qr_ok & ok
        lam_re, lam_im, _ = eigenvalues_jax(H, eps)
        rs = residuals_jax(H, Q, H[m, m - 1], active, m, eps)
        # Schur-coupling floor (driver._schur_coupling_floor twin): lock
        # only when the coupling the truncation would DISCARD is below
        # tol too; 2x2 blocks take the block max.
        coupling = jnp.abs(H[m, m - 1]) * jnp.abs(Q[m - 1, :])
        rs = jnp.maximum(rs, coupling)
        sub = jnp.concatenate([jnp.diag(H[:m, :m], -1), jnp.zeros(1, dtype)])
        first = (sub != 0) & (idxv < m - 1)          # (j, j+1) pair head
        second = jnp.concatenate([jnp.zeros(1, bool), first[:-1]])
        nxt = jnp.concatenate([rs[1:], jnp.zeros(1, dtype)])
        rs = jnp.where(first, jnp.maximum(rs, nxt), rs)
        prv = jnp.concatenate([jnp.zeros(1, dtype), rs[:-1]])
        rs = jnp.where(second, jnp.maximum(rs, prv), rs)
        hfrob = jnp.linalg.norm(H)

        keys = order_key_jax(which, lam_re, lam_im)
        ord_ = jnp.argsort(keys, stable=True)
        lre_s = lam_re[ord_]
        lim_s = lam_im[ord_]
        conv_s = rs[ord_] <= jnp.maximum(
            eps_work * hfrob, tol * jnp.hypot(lre_s, lim_s)
        )

        # Conjugate pair at sorted position p (pairs are exactly
        # conjugate by construction, so bit-equality mirrors the host's
        # np.conj equality test).
        lre_n = jnp.concatenate([lre_s[1:], jnp.zeros(1, dtype)])
        lim_n = jnp.concatenate([lim_s[1:], jnp.zeros(1, dtype)])
        pair_at = (
            (lim_s != 0)
            & (lre_s == lre_n)
            & (lim_s == -lim_n)
            & (idxv < m - 1)
        )
        effective_nev = nev + pair_at[jnp.maximum(nev - 1, 0)]

        head = idxv < effective_nev
        nlock = jnp.sum(jnp.where(conv_s & head, 1, 0)).astype(jnp.int32)
        maxdim_c = jnp.int32(m)
        ideal = jnp.minimum(nlock + mindim, (mindim + maxdim_c) // 2)

        # Tail walk (positions >= effective_nev, stepping over pairs):
        # groups 2 (retained) until k reaches ideal, then 3 (purged);
        # converged-but-unwanted values are purged (driver.py loop).
        def scan_body(carry, inp):
            k, skip, grp_prev = carry
            pos, pair, conv = inp
            in_tail = pos >= effective_nev
            grp_lead = jnp.where((k < ideal) & ~conv, 2, 3)
            grp = jnp.where(skip, grp_prev, grp_lead)
            num = jnp.where(pair, 2, 1)
            k2 = jnp.where(in_tail & ~skip & (grp == 2), k + num, k)
            out = jnp.where(in_tail, grp, jnp.where(conv, 1, 2))
            skip2 = in_tail & ~skip & pair
            return (k2, skip2, grp), out

        (k, _, _), grp_sorted = lax.scan(
            scan_body,
            (effective_nev, jnp.asarray(False), jnp.int32(0)),
            (idxv, pair_at, conv_s),
        )
        groups = jnp.zeros(m, jnp.int32).at[ord_].set(grp_sorted)

        cand = (idxv < active) & (groups != 1)
        purge = jnp.min(jnp.where(cand, idxv, active))
        purges = purges + jnp.where(purge < active, 1, 0)

        H, Q = partition_three_way_jax(H, Q, groups)
        H, Q = restore_arnoldi_jax(H, Q, nlock, k)

        # --- truncation basis change (driver.py Qbig) ------------------
        colsQ = jnp.arange(m + 1)
        rowsQ = jnp.arange(m + 1)
        Qpad = jnp.zeros((m + 1, m + 1), dtype).at[:m, :m].set(Q)
        eye_b = jnp.eye(m + 1, dtype=dtype)
        colmask = (colsQ >= purge) & (colsQ < k)
        inner = (rowsQ[:, None] >= purge) & (rowsQ[:, None] < m)
        Qbig = jnp.where(colmask[None, :], jnp.where(inner, Qpad, 0.0), eye_b)
        e_m = (rowsQ == m).astype(dtype)
        Qbig = Qbig.at[:, jnp.minimum(k, m)].set(
            jnp.where(k < m, e_m, Qbig[:, jnp.minimum(k, m)])
        )
        V = jnp.matmul(Qbig.T.astype(V.dtype), V, precision=_PREC)

        active = nlock
        it = it + 1
        done = (active >= nev) | (it >= restarts)

        # --- re-expansion (skipped on the final iteration) -------------
        def expand(VH):
            V, H = VH
            return expand_range_impl(op, V, H, k, m, jax.random.fold_in(key, it))

        V, H = lax.cond(done, lambda VH: VH, expand, (V, H))
        prods = prods + jnp.where(done, 0, m - k)
        return V, H, active, prods, it, purges, done, qr_ok

    def cond(state):
        done, it = state[6], state[4]
        return ~done & (it < it_stop)

    return lax.while_loop(
        cond, body, (V, H, active, prods, it, purges, done, qr_ok)
    )


@partial(jax.jit, static_argnames=("which",), donate_argnums=(0, 1))
def _fused_finish(V, H, active, which):
    """Final sort into the target order + the corresponding basis change
    + eigenvalue extraction, as one dispatch."""
    m = H.shape[1]
    dtype = H.dtype
    Q = jnp.eye(m, dtype=dtype)
    H, Q = sort_schur_jax(H, Q, active, which)
    Qbig = jnp.eye(m + 1, dtype=dtype).at[:m, :m].set(Q)
    V = jnp.matmul(Qbig.T.astype(V.dtype), V, precision=_PREC)
    lam_re, lam_im, _ = eigenvalues_jax(H)
    return V, H, lam_re, lam_im


def fused_solve(op, V, H, nev, mindim, tol, restarts, key, which, active0=0,
                maxiter_qr=None):
    """Run the complete Krylov-Schur iteration on device.

    V: (m+1, n) with V[active0] the normalized start vector; for a warm
    start (active0 > 0) rows [0, active0) hold locked Schur vectors and
    H's leading columns the locked R block (run.jl:131-179 semantics).
    H: (m+1, m) host array, columns [active0, m) zero.  Returns (V, H,
    lam_re, lam_im, nconverged, prods, its, purges, qr_ok) — V/H already
    truncated and sorted into the target order, eigenvalues of the
    leading blocks in lam_re/lam_im; H and the eigenvalues are float64.

    Host-side wrapper: dispatches the compiled restart loop in bounded
    chunks (see module docstring) and re-sizes the chunk from the
    measured per-restart rate; only a scalar `done` crosses the link per
    chunk until the final readback.
    """
    with jax.enable_x64(True):
        return _fused_solve(op, V, jnp.asarray(H, jnp.float64), nev, mindim,
                            tol, restarts, key, which, active0, maxiter_qr)


def _fused_solve(op, V, H, nev, mindim, tol, restarts, key, which, active0,
                 maxiter_qr):
    state = _fused_init(op, V, H, active0, restarts, key)
    done_host = bool(jax.device_get(state[6]))
    it_host = 0
    chunk = max(1, _CHUNK_INIT)
    first = True
    while not done_host and it_host < restarts:
        t0 = time.perf_counter()
        state = _fused_chunk(
            op, *state, nev, mindim, tol, restarts, it_host + chunk, key,
            which, maxiter_qr=maxiter_qr,
        )
        done_host = bool(jax.device_get(state[6]))  # blocks on the chunk
        wall = time.perf_counter() - t0
        if done_host:
            break
        it_host += chunk
        # The first dispatch's wall is dominated by compilation; keep the
        # chunk small once more so the second (warm) timing sets the rate.
        if not first:
            per_restart = max(wall / chunk, 1e-4)
            # Floor at 1, not a fixed minimum: for slow configs (large
            # n x maxdim) an 8-restart floor could make one dispatch far
            # longer than the target — _CHUNK_SECONDS stays authoritative.
            chunk = int(min(_CHUNK_MAX, max(1, _CHUNK_SECONDS / per_restart)))
        first = False

    V, H, active, prods, it, purges, done, qr_ok = state
    V, H, lam_re, lam_im = _fused_finish(V, H, active, which)
    return V, H, lam_re, lam_im, active, prods, it, purges, qr_ok
