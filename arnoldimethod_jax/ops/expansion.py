"""Arnoldi expansion: the only n-sized device work in the solver.

One jitted `lax.fori_loop` performs matvec + classical Gram-Schmidt with
DGKS reorthogonalization (eta = sqrt(2)/2, the ARPACK constant) per Krylov
step, using fixed shapes and row masks — no dynamic shapes, so XLA compiles
one kernel for every (j0, j1) range.  The basis V is stored with vectors as
*rows* of a (maxdim+1, n) array: n is the minor axis and the sharded
dimension on a device mesh; the Gram-Schmidt coefficients come from
one (maxdim+1, n) x (n,) matvec whose contraction XLA turns into a psum
over the mesh.

Behavioral reference: ArnoldiMethod.jl src/expansion.jl (orthogonalize!
:69-109, reinitialize! :12-59, iterate_arnoldi! :116-133).  Breakdown
(new vector numerically in the span) zeroes H[j+1, j] and replaces the
column with a fresh random vector orthogonal to the basis — the
invariant-subspace path — except when the basis already spans the space.
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

ETA = 0.7071067811865476  # sqrt(2)/2, the ARPACK DGKS constant

# Target wall-clock length of ONE dispatch — a dispatch-size heuristic, not
# a limit of any device: the driver slices long expansions (and fused.py its
# restart loop) into dispatches predicted to take about this long, so the
# host regains control between them.
DISPATCH_BUDGET_S = float(os.environ.get("ARNOLDI_CHUNK_SECONDS", "40"))

# Orthogonalization accuracy is what the whole algorithm stands on: a
# float32 product with no precision given may run in TF32 on the GPU
# (~3 decimal digits), which destroys the basis orthogonality.  All
# projection / basis-change contractions therefore request full-precision
# accumulation.
_PREC = lax.Precision.HIGHEST


def _norm(w):
    return jnp.sqrt(jnp.real(jnp.vdot(w, w, precision=_PREC)))


def _masked_project(V, w, mask):
    """h = V[:rows<=j]^H w and the projection update, fixed shape."""
    h = jnp.where(mask, jnp.matmul(V.conj(), w, precision=_PREC), 0)
    return h, w - jnp.matmul(h, V, precision=_PREC)


def _dgks_orthogonalize(V, w, mask):
    """Two-stage DGKS: returns (w, h, wnorm, refnorm) where breakdown is
    declared by the caller iff wnorm <= ETA * refnorm
    (ref: expansion.jl:69-109)."""
    rnorm = _norm(w)
    h, w = _masked_project(V, w, mask)
    wnorm = _norm(w)

    def second_pass(args):
        w, h, wnorm = args
        c, w2 = _masked_project(V, w, mask)
        return w2, h + c, _norm(w2), wnorm

    def no_second_pass(args):
        w, h, wnorm = args
        return w, h, wnorm, rnorm

    return lax.cond(
        wnorm < ETA * rnorm, second_pass, no_second_pass, (w, h, wnorm)
    )


def _random_unit_vector(key, n, dtype, V, mask):
    """Fresh random vector orthonormalized against the masked rows of V
    (ref: reinitialize!, expansion.jl:12-59)."""
    v = jax.random.normal(key, (n,), dtype=dtype)
    _, v = _masked_project(V, v, mask)
    _, v = _masked_project(V, v, mask)
    return v / _norm(v)


def expand_range_impl(op, V, H, j0, j1, key):
    """Extend the Arnoldi relation A V[:j].T = V[:j+1].T H[:j+1, :j] by
    computing basis rows j0+1 .. j1 and H columns j0 .. j1-1.

    V: (maxdim+1, n) basis rows; H: (maxdim+1, maxdim) device Hessenberg
    (only columns [j0, j1) are written — the caller owns the authoritative
    host copy of older columns).  Returns updated (V, H).

    Unjitted implementation — use `expand_range` (jitted, donating) from
    the driver; this impl is reused by the fused multi-device step.
    """
    m1, n = V.shape
    rows = jnp.arange(m1)

    def body(j, carry):
        V, H = carry
        w = op.matvec(V[j])
        mask = rows <= j
        w, h, wnorm, refnorm = _dgks_orthogonalize(V, w, mask)
        breakdown = wnorm <= ETA * refnorm

        def keep(V, H):
            Hcol = jnp.where(rows == j + 1, wnorm.astype(H.dtype), h)
            return V.at[j + 1].set(w / wnorm), H.at[:, j].set(Hcol)

        def handle_breakdown(V, H):
            H = H.at[:, j].set(h)  # H[j+1, j] stays zero: deflation

            def reinit(V):
                v = _random_unit_vector(
                    jax.random.fold_in(key, j), n, V.dtype, V, mask
                )
                return V.at[j + 1].set(v)

            # When the basis already spans the whole space (j+1 == n) there
            # is no new direction (expansion.jl:127).
            V = lax.cond(j + 1 < n, reinit, lambda V: V.at[j + 1].set(w), V)
            return V, H

        return lax.cond(breakdown, handle_breakdown, keep, V, H)

    V, H = lax.fori_loop(j0, j1, body, (V, H))
    return V, H


expand_range = jax.jit(expand_range_impl, donate_argnums=(1, 2))


def expand_range_lowsync_impl(op, V, H, j0, j1, key):
    """Low-synchronization expansion: TWO global reductions per Krylov
    step instead of the 3-5 of the DGKS path — the latency lever for
    meshes where the Gram-Schmidt psums dominate (SURVEY §7.3 item 4;
    cf. the low-synch Gram-Schmidt literature, PAPERS.md).

    Trick: the not-yet-normalized w is stored into the basis's spare row
    j+1 BEFORE projecting, so the single masked contraction V @ w yields
    the projection coefficients (rows <= j) AND w's squared norm (row
    j+1) in one reduction.  Reorthogonalization runs unconditionally
    (plain CGS2 — at least as robust as conditional DGKS), its reduction
    again carrying the post-first-pass norm; the final norm comes from
    the Pythagorean identity ||w2||^2 = ||w1||^2 - ||h2||^2, exact to
    O(eps^2) because the second-pass coefficients are O(eps)*||w||, so
    no third reduction is needed.  Breakdown semantics mirror
    expansion.jl:99-108: declared when the reorthogonalized norm falls
    below eta * (pre-pass norm).
    """
    m1, n = V.shape
    rows = jnp.arange(m1)

    def body(j, carry):
        V, H = carry
        w = op.matvec(V[j])
        mask = rows <= j

        # Reduction 1: coefficients + ||w||^2 in one contraction.  The
        # conjugate matters twice over: complex projections need <v_i, w>
        # = conj(v_i).w, and it makes the spare-row entry exactly
        # conj(w).w = ||w||^2 (real, nonnegative).
        V = V.at[j + 1].set(w)
        c1 = jnp.matmul(V.conj(), w, precision=_PREC)
        h = jnp.where(mask, c1, 0)
        rnorm2 = jnp.real(c1[j + 1])
        w = w - jnp.matmul(h, V, precision=_PREC)

        # Reduction 2: second-pass coefficients + ||w1||^2.
        V = V.at[j + 1].set(w)
        c2 = jnp.matmul(V.conj(), w, precision=_PREC)
        h2 = jnp.where(mask, c2, 0)
        w1norm2 = jnp.real(c2[j + 1])
        w = w - jnp.matmul(h2, V, precision=_PREC)
        h = h + h2

        wnorm2 = jnp.maximum(
            w1norm2 - jnp.real(jnp.vdot(h2, h2, precision=_PREC)), 0.0
        )
        wnorm = jnp.sqrt(wnorm2)
        # DGKS breakdown reference: the norm BEFORE the last pass (the
        # post-first-pass norm w1), exactly as _dgks_orthogonalize's
        # second-pass branch uses — NOT the original rnorm, which a valid
        # tiny new direction is legitimately far below.  rnorm2 feeds
        # nothing else; a first pass that leaves w healthy keeps
        # wnorm ~ w1norm and never triggers this.
        del rnorm2
        breakdown = wnorm <= ETA * jnp.sqrt(jnp.maximum(w1norm2, 0.0))

        def keep(V, H):
            Hcol = jnp.where(rows == j + 1, wnorm.astype(H.dtype), h)
            return V.at[j + 1].set(w / wnorm), H.at[:, j].set(Hcol)

        def handle_breakdown(V, H):
            H = H.at[:, j].set(h)  # H[j+1, j] stays zero: deflation

            def reinit(V):
                v = _random_unit_vector(
                    jax.random.fold_in(key, j), n, V.dtype, V, mask
                )
                return V.at[j + 1].set(v)

            V = lax.cond(j + 1 < n, reinit, lambda V: V.at[j + 1].set(w), V)
            return V, H

        return lax.cond(breakdown, handle_breakdown, keep, V, H)

    V, H = lax.fori_loop(j0, j1, body, (V, H))
    return V, H


expand_range_lowsync = jax.jit(expand_range_lowsync_impl, donate_argnums=(1, 2))


@partial(jax.jit, donate_argnums=(1, 2))
def truncate_and_expand_lowsync(op, V, H, Qbig, j0, j1, key):
    """Low-sync twin of truncate_and_expand."""
    V = jnp.matmul(Qbig.T, V, precision=_PREC)
    return expand_range_lowsync_impl(op, V, H, j0, j1, key)


def _tiled_basis_change(V, Qbig, tiles):
    """V <- Qbig^T @ V computed column-tile by column-tile, in place.

    The one-GEMM basis change needs a second V-sized output buffer; at
    north-star scale ((m+1) x n = 201 x 16.8M f32 = 13.5 GB) that doubles
    the basis memory.  Each output tile depends only on the SAME input tile
    (columns are independent in Qbig^T V), so a fori_loop of
    dynamic_slice -> small GEMM -> dynamic_update_slice on the donated V
    is exact and bounds the extra memory to one (m+1, n/tiles) tile.

    `tiles` need not divide n: the loop covers ceil-width full tiles and
    the (static) ragged remainder gets one last in-place update — an
    overlapping clamped dynamic_slice would apply Qbig^T twice to
    already-updated columns, so the remainder MUST be its own exact-width
    slice (ADVICE r4 medium finding)."""
    m1, n = V.shape
    T = -(-n // tiles)  # ceil: full tiles of width T, then the remainder
    full = n // T
    rem = n - full * T

    def body(i, V):
        tile = lax.dynamic_slice(V, (0, i * T), (m1, T))
        new = jnp.matmul(Qbig.T, tile, precision=_PREC)
        return lax.dynamic_update_slice(V, new, (0, i * T))

    V = lax.fori_loop(0, full, body, V)
    if rem:  # static at trace time (n, tiles both static)
        new = jnp.matmul(Qbig.T, V[:, full * T :], precision=_PREC)
        V = lax.dynamic_update_slice(V, new, (0, full * T))
    return V


# Tile target ~256 MB.
_TILE_BYTES = 1 << 28


def tiled_threshold_bytes(device):
    """Basis size above which the truncation basis change runs tiled in
    place: when two copies of V would take more than half of the
    device's memory (below that a second buffer is cheap and one big
    GEMM is fastest).  The device's memory is the allocator's
    `bytes_limit` where the backend keeps allocator statistics (GPU), and
    the host's physical memory for a CPU device (whose arrays live there)."""
    stats = device.memory_stats()
    if stats and "bytes_limit" in stats:
        return int(stats["bytes_limit"]) // 4
    if device.platform == "cpu":
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") // 4
    raise RuntimeError(
        f"{device.platform} device {device} reports no "
        "memory_stats()['bytes_limit']; cannot size the basis change"
    )


def pick_tiles(n, row_bytes):
    """Tile count with n/tiles * row_bytes <= ~256 MB.  Divisibility is
    NOT required (_tiled_basis_change handles a ragged remainder tile),
    so this is a plain ceil-division — no divisor hunt that could return
    tiles ~ n for prime n (ADVICE r4 medium finding)."""
    return int(max(1, -(-n * row_bytes // _TILE_BYTES)))


@partial(jax.jit, static_argnames=("tiles",), donate_argnums=(1, 2))
def truncate_and_expand_tiled(op, V, H, Qbig, j0, j1, key, tiles):
    """truncate_and_expand for basis arrays too large to double-buffer
    (single-device only: the column tiling would fight an n-sharding)."""
    V = _tiled_basis_change(V, Qbig, tiles)
    return expand_range_impl(op, V, H, j0, j1, key)


@partial(jax.jit, static_argnames=("tiles",), donate_argnums=(0,))
def apply_basis_change_tiled(V, Qbig, tiles):
    """apply_basis_change, tiled in place (see _tiled_basis_change)."""
    return _tiled_basis_change(V, Qbig, tiles)


@partial(jax.jit, donate_argnums=(1, 2))
def truncate_and_expand(op, V, H, Qbig, j0, j1, key):
    """One fused device step per restart: the Krylov-Schur truncation
    basis-change GEMM followed by the expansion sweep back to maxdim.

    Fusing the two into a single dispatch leaves exactly one (dispatch +
    H readback) per restart, the host path's per-restart floor.  j0/j1 are traced scalars, so every (k, maxdim) pair reuses
    one compiled program."""
    V = jnp.matmul(Qbig.T, V, precision=_PREC)
    return expand_range_impl(op, V, H, j0, j1, key)


@partial(jax.jit, donate_argnums=(0,))
def set_initial_vector(V, v):
    """V[0] = v / ||v||; v is not mutated and need not be normalized
    (ref: run.jl:38, reinitialize! with j == 0)."""
    v = v.astype(V.dtype)
    return V.at[0].set(v / _norm(v))


@partial(jax.jit, donate_argnums=(0,))
def set_random_vector(V, j, key):
    """V[j] = fresh random unit vector orthogonal to rows [0, j) — the
    warm-start reinitialization (partialschur! with initialize=true)."""
    m1, n = V.shape
    mask = jnp.arange(m1) < j
    v = jax.random.normal(key, (n,), dtype=V.dtype)
    _, v = _masked_project(V, v, mask)
    _, v = _masked_project(V, v, mask)
    return V.at[j].set(v / _norm(v))


@partial(jax.jit, donate_argnums=(0,))
def orthonormalize_rows(X, key):
    """Orthonormalize the rows of X (k, n) in place with CGS2/DGKS —
    the in-house tall-skinny-QR replacement (no jnp.linalg.qr: stays
    LAPACK-free and, unlike CholeskyQR2, cannot fail on the highly
    correlated blocks a Chebyshev filter produces).  Rows that fall in
    the span of earlier rows (breakdown) are replaced with fresh random
    orthonormal directions, so the result always has full row rank."""
    k, n = X.shape
    rows = jnp.arange(k)

    def body(j, X):
        w = X[j]
        mask = rows < j
        w, h, wnorm, refnorm = _dgks_orthogonalize(X, w, mask)

        def keep(X):
            return X.at[j].set(w / wnorm)

        def reinit(X):
            v = _random_unit_vector(
                jax.random.fold_in(key, j), n, X.dtype, X, mask
            )
            return X.at[j].set(v)

        return lax.cond(wnorm <= ETA * refnorm, reinit, keep, X)

    return lax.fori_loop(0, k, body, X)


@partial(jax.jit, donate_argnums=(0,))
def apply_basis_change(V, Qbig):
    """V <- Qbig^T @ V: one fixed-shape (m+1, m+1) x (m+1, n) GEMM
    implements the Krylov-Schur truncation / final reordering of the basis
    (ref: run.jl:363-365, 382-383 — there a tall-skinny GEMM into V_tmp;
    here the row convention turns it into a small-by-wide matmul with V
    sharded along n)."""
    return jnp.matmul(Qbig.T, V, precision=_PREC)
