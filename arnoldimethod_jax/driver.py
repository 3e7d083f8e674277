"""The Krylov-Schur restart driver: `partial_schur`.

Orchestrates the two layers of the solver: jitted device kernels for the
n-sized work (Arnoldi expansion, basis-change GEMM — ops/expansion.py) and
the host float64 dense kernels for the (maxdim+1)-sized work (Francis QR,
reordering, restoration — dense/).  All restart decisions (locking counts,
purge index, conjugate-pair splits, truncation size) are made on host from
the tiny replicated H — the device only ever sees fixed-shape SpMV/GEMM
work, which is exactly what keeps the device path compile-once and
collective-friendly.

Behavioral reference: ArnoldiMethod.jl src/run.jl (driver `_partialschur`
:224-392, convergence criterion :188-208, three-way partition :394-457,
final sort :459-502, residuals :519-545).
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from .dense.eig import collect_eigen, copy_eigenvalues, eigenvalue
from .dense.restore import restore_arnoldi
from .dense.schur import local_schur
from .dense.swaps import (
    is_end_of_11_block,
    is_start_of_11_block,
    rotate_right,
    swap,
)
from .dense import native as _native
from .models.operators import _NOMINAL_BYTES_PER_S, DenseOperator, as_operator
from .ops.expansion import (
    DISPATCH_BUDGET_S,
    apply_basis_change,
    apply_basis_change_tiled,
    expand_range,
    expand_range_lowsync,
    pick_tiles,
    set_initial_vector,
    set_random_vector,
    tiled_threshold_bytes,
    truncate_and_expand,
    truncate_and_expand_tiled,
    truncate_and_expand_lowsync,
)
from .targets import as_target, get_order
from .workspace import ArnoldiWorkspace

__all__ = ["History", "PartialSchur", "partial_schur"]

import os

# Debug assertions (SURVEY.md §5: the numerical analogue of sanitizers):
# with ARNOLDI_DEBUG=1, every restart validates finiteness of H and the
# orthonormality of the basis (the latter pulls V — debug only).
_DEBUG = os.environ.get("ARNOLDI_DEBUG", "0") != "0"


def _debug_checks(H, V, k, it):
    if not np.isfinite(H).all():
        raise FloatingPointError(
            f"non-finite Hessenberg entries after restart {it}"
        )
    # Rows [0, k) are the basis proper; row k (the next-vector slot) is
    # legitimately ~0 when the Krylov space is exhausted.
    Vn = np.asarray(V[:k])
    G = Vn.conj() @ Vn.T
    err = float(np.linalg.norm(G - np.eye(k)))
    limit = 1e-3 if Vn.real.dtype == np.float32 else 1e-8
    if err > limit:
        raise FloatingPointError(
            f"basis orthonormality lost after restart {it}: ||V V^H - I|| = {err:.2e}"
        )


class History:
    """Convergence summary: matrix-vector product count, number of
    converged eigenvalues, and whether the request was met
    (ref: run.jl:211-222, show.jl).  `restarts` additionally counts the
    Krylov-Schur restart cycles, and `purges` the restarts in which a
    previously locked Schur vector was unlocked/purged because better
    candidates displaced it (ref: run.jl:341-353) — observability beyond
    the reference."""

    def __init__(self, mvproducts, nconverged, converged, nev, restarts=0,
                 purges=0, timings=None):
        self.mvproducts = mvproducts
        self.nconverged = nconverged
        self.converged = converged
        self.nev = nev
        self.restarts = restarts
        self.purges = purges
        # Host wall-clock breakdown in seconds: 'device' covers jitted
        # dispatch + H readback (the host<->device round trips), 'dense'
        # the host restart kernels.
        self.timings = timings or {}

    def __repr__(self):
        status = "Converged" if self.converged else "Not converged"
        return (
            f"{status}: {self.nconverged} of {self.nev} eigenvalues "
            f"in {self.mvproducts} matrix-vector products"
        )


class PartialSchur:
    """Partial Schur decomposition A Q = Q R: Q is an orthonormal
    (n, nconverged) device array, R the (nconverged, nconverged) host
    quasi-upper-triangular factor, and `eigenvalues` the complex-valued
    diagonal-block eigenvalues (always complex-typed, ref:
    ArnoldiMethod.jl:120-137).

    The basis is held in the solver's natural ROWS layout (nconverged, n)
    — n on the minor axis — and `Q` materializes the (n, nconverged)
    columns view lazily on first access: at north-star scale (100 x 10M)
    the columns copy is 4+ GB, so memory-conscious callers should use
    `Q_rows` (rayleigh_ritz accepts it via rows_layout=True)."""

    def __init__(self, Q, R, eigenvalues, Q_rows=None):
        if (Q is None) == (Q_rows is None):
            raise ValueError("exactly one of Q / Q_rows must be given")
        self._Q = Q
        self._Q_rows = Q_rows
        self.R = R
        self.eigenvalues = eigenvalues

    @property
    def Q(self):
        if self._Q is None:
            self._Q = self._Q_rows.T
        return self._Q

    @property
    def Q_rows(self):
        if self._Q_rows is None:
            self._Q_rows = self._Q.T
        return self._Q_rows

    @property
    def _qshape(self):
        q = self._Q_rows if self._Q is None else self._Q
        return tuple(q.shape[::-1]) if self._Q is None else tuple(q.shape)

    def __repr__(self):
        return (
            f"PartialSchur decomposition (Q: {self._qshape}, "
            f"R: {tuple(self.R.shape)}) with eigenvalues:\n"
            + repr(self.eigenvalues)
        )


def _is_pair_at(lams, ord_, pos, is_real):
    """True iff the sorted Ritz positions pos, pos+1 hold a conjugate pair
    (ref: include_conjugate_pair, run.jl:510-517)."""
    if not is_real or pos + 1 >= len(ord_):
        return False
    l1 = lams[ord_[pos]]
    return l1.imag != 0 and np.conj(l1) == lams[ord_[pos + 1]]


def _partition_three_way(R, Q, groups):
    """Partition the Schur blocks into [locked | retained | purged] by
    rotating group-1 and group-2 blocks forward (ref: run.jl:394-457)."""
    m = R.shape[1]
    hi = mi = lo = 0
    while hi < m:
        group = groups[hi]
        bs = 1 if is_start_of_11_block(R, hi) else 2
        if group == 3:
            hi += bs
        elif group == 2:
            rotate_right(R, mi, hi, Q)
            hi += bs
            mi += bs
        else:
            rotate_right(R, lo, hi, Q)
            hi += bs
            mi += bs
            lo += bs


def _sort_schur(R, Q, count, key):
    """Insertion sort of the leading `count` Schur blocks into the user's
    target order via direct swaps (ref: run.jl:459-502)."""
    if count <= 1:
        return
    next_idx = 0
    while next_idx < count:
        curr = next_idx
        curr_size = 1 if is_start_of_11_block(R, curr) else 2
        lam_curr = eigenvalue(R, curr)
        while curr > 0:
            prev_size = 1 if is_end_of_11_block(R, curr - 1) else 2
            prev = curr - prev_size
            lam_prev = eigenvalue(R, prev)
            if not key(lam_curr) < key(lam_prev):
                break
            swap(R, prev, prev_size == 1, curr_size == 1, Q)
            curr -= prev_size
        next_idx += curr_size


def _copy_residuals(rs, H, Q, h_last, x, lo, hi):
    """Ritz residuals ||A x - lam x|| = |q_m^T y| * |h_{m+1,m}| computed
    from the Hessenberg eigenvector y and the last row of Q
    (ref: run.jl:519-545)."""
    m = H.shape[1]
    rs[:] = 0.0
    for i in range(lo, hi):
        x[:] = 0
        klen = collect_eigen(x, H[:m, :], i)
        tmp = Q[m - 1, :klen] @ x[:klen]
        rs[i] = abs(tmp * h_last)
    return rs


def _schur_coupling_floor(rs, H, Q, h_last, lo, hi):
    """Floor each residual estimate by the SCHUR-column coupling
    |h_{m+1,m}| * |Q[m-1, i]| the truncation would discard when locking
    column i, with 2x2 blocks treated as a unit (both columns take the
    block max).

    Why this goes beyond the reference: run.jl:519-545 judges convergence
    per RITZ EIGENVECTOR, but locking deflates the SCHUR basis — for the
    ill-conditioned 2x2 blocks a highly non-normal operator produces
    (convection-diffusion past the oscillatory threshold), the discarded
    Schur coupling can exceed the Ritz residual by orders of magnitude,
    and the advertised ||A Q - Q R|| quietly degrades ~40x past tol
    (measured vs an f64 ARPACK oracle, docs/precision.md).  For normal
    operators eigenvectors coincide with Schur columns and this floor
    changes nothing (README parity holds)."""
    m = H.shape[1]
    coupling = np.abs(h_last) * np.abs(np.asarray(Q[m - 1, :]))
    j = lo
    while j < hi:
        pair = j + 1 < m and H[j + 1, j] != 0
        if pair:
            v = max(rs[j], rs[j + 1], coupling[j], coupling[j + 1])
            rs[j] = rs[j + 1] = v
            j += 2
        else:
            rs[j] = max(rs[j], coupling[j])
            j += 1
    return rs


def partial_schur(
    A,
    *,
    n=None,
    dtype=None,
    v1=None,
    nev=None,
    which="LM",
    tol=None,
    mindim=None,
    maxdim=None,
    restarts=200,
    workspace=None,
    start_from=None,
    initialize=None,
    seed=0,
    sharding=None,
    method=None,
    extended=False,
    lowsync=False,
    split_complex=False,
    sparse_format="auto",
):
    """Compute an approximate partial Schur decomposition A Q = Q R with
    `nev` eigenvalues near the target `which`.

    A can be a LinearOperator, a square 2-D array, or a jit-traceable
    callable (then pass n= and dtype=).  Returns (PartialSchur, History).

    Keyword defaults mirror the reference exactly (run.jl:100-129):
    nev = min(6, n); which = 'LM'; tol = sqrt(eps(real dtype));
    mindim = min(max(10, nev), n); maxdim = min(max(20, 2 nev), n);
    restarts = 200.  Convergence: ||A x - lam x|| <= max(eps ||H||_F,
    tol |lam|), scale-invariant with a machine-epsilon floor
    (ref: run.jl:188-208).

    Warm start / resume: pass `workspace` (an ArnoldiWorkspace holding a
    previous decomposition) plus `start_from` = previous nconverged, to
    continue locking more eigenvalues — the checkpoint/resume mechanism
    (ref: partialschur!, run.jl:131-179).

    `method` selects where the dense restart work runs:
      - "host" — host float64 dense kernels, one device round trip per
        restart (the numpy/C++ layer; supports every dtype and warm
        starts);
      - "device" — the ENTIRE restart loop compiles into one device
        program (fused.py; real dtypes, warm starts included): no
        per-restart host<->device round trip;
      - None (default) — "host" on every platform.  The host/device
        crossover has not been measured on the GPU yet; until it is,
        the default does not guess one.

    `lowsync=True` switches the expansion to the low-synchronization
    CGS2 variant (ops/expansion.py::expand_range_lowsync_impl): TWO
    global reductions per Krylov step instead of 3-5 — the latency lever
    when Gram-Schmidt psums dominate on a large mesh.  Host method only;
    numerics are plain unconditional CGS2 (final norm via the
    Pythagorean identity, accurate to O(eps^2)).

    `extended=True` runs the n-sized device work (matvec, Gram-Schmidt,
    basis changes) in DOUBLE-WORD arithmetic (ops/df_expansion.py): the
    Krylov basis is an unevaluated hi+lo pair, giving ~eps_work^2
    effective precision — tolerances down to ~1e-12 with float32 words
    (the reference's readme.md:81-99 workflow; float64 words give
    double-double).  Requires a real
    dtype and (for full accuracy) an operator implementing
    `matvec_df(xh, xl)` — DiaOperator (and everything built on it:
    laplacian_1d, tridiagonal, ...) does.  Forces method="host" (the
    dense restart layer runs in host float64, far below the double-word
    noise floor).

    Complex matrices run natively in complex64/complex128 by default.
    `split_complex=True` instead carries the Krylov basis as a real
    (re, im) pair on device (ops/sc_expansion.py), with the dense
    restart layer in host complex128.  Dense complex inputs work out of
    the box; matrix-free operators implement
    `matvec_sc(xr, xi) -> (yr, yi)`.

    `sparse_format` ("auto" default): scipy.sparse input is repacked
    into a layout chosen from its pattern — DIA (banded),
    BSR (clustered), or SELL (irregular) — per
    models.operators.pick_sparse_format; pass "csr" to keep the plain
    CSR gather path or a layout name to force one.  Ignored for
    operator/dense/callable input.
    """
    op = as_operator(A, n=n, dtype=dtype, sparse_format=sparse_format)
    n = op.shape[0]
    if op.shape[0] != op.shape[1]:
        raise ValueError("matrix is not square")
    target = as_target(which)

    if nev is None:
        nev = min(6, n)
    if nev < 1:
        raise ValueError("nev cannot be less than 1")
    if mindim is None:
        mindim = min(max(10, nev), n)
    if maxdim is None:
        maxdim = min(max(20, 2 * nev), n)
    if workspace is not None:
        mindim = min(mindim, workspace.V.shape[0] - 1)
        maxdim = min(maxdim, workspace.V.shape[0] - 1)
    if not (nev <= mindim <= maxdim <= n):
        raise ValueError(
            "nev <= mindim <= maxdim <= size(A, 1) does not hold, got "
            f"{nev} <= {mindim} <= {maxdim} <= {n}"
        )

    # Working dtype: follow the operator (canonicalized under the current
    # x64 setting), like the reference's vtype genericity.
    work_dtype = jax.dtypes.canonicalize_dtype(jnp.dtype(op.dtype))
    sc = bool(split_complex) and jnp.issubdtype(
        work_dtype, jnp.complexfloating
    )
    if sc and not hasattr(op, "matvec_sc"):
        from .models.operators import SplitComplexDenseOperator

        if isinstance(op, DenseOperator):
            word = (
                jnp.float32
                if work_dtype == jnp.dtype("complex64")
                else jnp.float64
            )
            op = SplitComplexDenseOperator(np.asarray(op.A), word_dtype=word)
        else:
            raise ValueError(
                "split-complex solves need an operator implementing "
                "matvec_sc(xr, xi) -> (yr, yi)"
            )
    order_key = get_order(target)
    if tol is None:
        # extended: the double-word noise floor is ~eps^2, so the default
        # tolerance drops to eps of the single word.
        tol = (
            float(jnp.finfo(work_dtype).eps)
            if extended
            else float(np.sqrt(jnp.finfo(work_dtype).eps))
        )

    key = jax.random.PRNGKey(seed)

    if sc:
        from .ops.sc_expansion import (
            sc_set_initial_vector,
            sc_set_random_vector,
        )

        # Device words are real; the host Hessenberg is complex128 (the
        # generic host dense layer).
        word = jnp.dtype(getattr(op, "word_dtype", jnp.float32))
        if workspace is None:
            ws = ArnoldiWorkspace(n, maxdim, dtype=word, sharding=sharding)
            if start_from is not None and start_from != 0:
                raise ValueError("start_from requires an explicit workspace")
            active0 = 0
            ws.H = np.zeros_like(ws.H, dtype=np.complex128)
            ws.Vim = jnp.zeros_like(ws.V)
            if v1 is not None:
                v1 = np.asarray(v1)
                if v1.shape != (n,):
                    raise ValueError("v1 should have the same dimension as A")
                ws.V, ws.Vim = sc_set_initial_vector(
                    ws.V, ws.Vim,
                    jnp.asarray(np.real(v1), word),
                    jnp.asarray(np.imag(v1), word),
                )
            else:
                ws.V, ws.Vim = sc_set_random_vector(
                    ws.V, ws.Vim, 0, jax.random.fold_in(key, 2**31)
                )
        else:
            ws = workspace
            if jnp.issubdtype(ws.dtype, jnp.complexfloating):
                raise ValueError(
                    "split-complex solves store the basis as a real "
                    "(re, im) pair: pass a float32 workspace (its Vim "
                    "holds the imaginary word) — see docs/precision.md"
                )
            if maxdim >= ws.V.shape[0]:
                raise ValueError(
                    "maxdim should be strictly less than V's row count"
                )
            if not np.iscomplexobj(ws.H):
                ws.H = ws.H.astype(np.complex128)
            if getattr(ws, "Vim", None) is None:
                ws.Vim = jnp.zeros_like(ws.V)
            active0 = 0 if start_from is None else int(start_from)
            if not 0 <= active0 <= maxdim:
                raise ValueError("start_from should be between 0 and maxdim")
            ws.H[:, active0:] = 0
            if initialize is None:
                initialize = active0 == 0 and v1 is None
            if v1 is not None:
                if active0 != 0:
                    raise ValueError("v1 requires start_from == 0")
                v1 = np.asarray(v1)
                ws.V, ws.Vim = sc_set_initial_vector(
                    ws.V, ws.Vim,
                    jnp.asarray(np.real(v1), word),
                    jnp.asarray(np.imag(v1), word),
                )
            elif initialize:
                ws.V, ws.Vim = sc_set_random_vector(
                    ws.V, ws.Vim, active0, jax.random.fold_in(key, 2**31)
                )
    elif workspace is None:
        ws = ArnoldiWorkspace(n, maxdim, dtype=work_dtype, sharding=sharding)
        if start_from is not None and start_from != 0:
            raise ValueError("start_from requires an explicit workspace")
        active0 = 0
        if v1 is not None:
            v1 = jnp.asarray(v1)
            if v1.shape != (n,):
                raise ValueError("v1 should have the same dimension as A")
            ws.V = set_initial_vector(ws.V, v1)
        else:
            ws.V = set_random_vector(ws.V, 0, jax.random.fold_in(key, 2**31))
    else:
        ws = workspace
        if maxdim >= ws.V.shape[0]:
            raise ValueError("maxdim should be strictly less than V's row count")
        active0 = 0 if start_from is None else int(start_from)
        if not 0 <= active0 <= maxdim:
            raise ValueError("start_from should be between 0 and maxdim")
        ws.H[:, active0:] = 0
        if initialize is None:
            initialize = active0 == 0 and v1 is None
        if v1 is not None:
            if active0 != 0:
                raise ValueError("v1 requires start_from == 0")
            ws.V = set_initial_vector(ws.V, jnp.asarray(v1))
        elif initialize:
            ws.V = set_random_vector(
                ws.V, active0, jax.random.fold_in(key, 2**31)
            )

    is_real = not jnp.issubdtype(work_dtype, jnp.complexfloating)
    if lowsync and extended:
        raise ValueError(
            "lowsync applies to the plain expansion; extended=True has its "
            "own (double-word) orthogonalization"
        )
    if lowsync and method == "device":
        raise ValueError("lowsync is a host-method option")
    if lowsync:
        method = "host"
    if extended:
        if not is_real:
            raise ValueError("extended=True supports real dtypes only")
        if method == "device":
            raise ValueError(
                "extended=True runs the dense layer on host (its float64 is "
                "below the double-word floor); method='device' is not "
                "compatible"
            )
        method = "host"
    if sc:
        if lowsync or extended:
            raise ValueError(
                "split-complex solves use the plain DGKS expansion "
                "(lowsync/extended are real-dtype options)"
            )
        if method == "device":
            raise ValueError(
                "complex matrices run split-complex on the host method"
            )
        method = "host"
    if method is None:
        # No host/device crossover has been measured on the GPU; until
        # one is, the default is the host dense layer everywhere.
        method = "host"
    if method not in ("host", "device"):
        raise ValueError(f"method must be 'host' or 'device', got {method!r}")
    if method == "device":
        if not is_real:
            raise ValueError(
                "method='device' supports real dtypes only (the fused "
                "restart's dense kernels are real; fused.py)"
            )
        return _partial_schur_device(
            op, ws, mindim, maxdim, nev, tol, restarts, target, key, active0
        )

    schur, history = _partial_schur(
        op, ws, mindim, maxdim, nev, tol, restarts, target, order_key, active0,
        key, extended=extended, lowsync=lowsync, sc=sc,
    )
    return schur, history


def _partial_schur_device(op, ws, mindim, maxdim, nev, tol, restarts, target, key,
                          active0=0):
    """Dispatch the fully fused on-device solve (fused.py) and repackage
    its outputs in the same PartialSchur/History types, leaving the
    workspace coherent for a subsequent warm start (either method).  For a
    warm start the locked H block round-trips through the device in
    float64, the host's dense dtype (fused.py)."""
    import time as _time

    from .fused import fused_solve

    t0 = _time.perf_counter()
    V, Hd, lre, lim, ncv, prods, its, purges, qr_ok = fused_solve(
        op, ws.V, ws.H, nev, mindim, tol, restarts, key, type(target).__name__,
        active0,
    )
    # ONE batched readback instead of eight sequential scalar reads, each
    # of which would wait for the device separately.
    Hh, lre, lim, ncv, prods, its, purges, qr_ok = jax.device_get(
        (Hd, lre, lim, ncv, prods, its, purges, qr_ok)
    )
    Hh = np.asarray(Hh, dtype=ws.H.dtype)
    ncv = int(ncv)
    lam = np.asarray(lre, dtype=np.float64) + 1j * np.asarray(lim, dtype=np.float64)
    device_s = _time.perf_counter() - t0
    if not bool(qr_ok):
        raise RuntimeError("QR algorithm did not converge")

    ws.V = V
    ws.H[:] = Hh
    # Real single-word path: extended / split-complex extra words from any
    # previous run on this workspace are stale now.
    ws.Vlo = None
    ws.Vim = None
    ws.Hlo = None

    history = History(
        int(prods),
        ncv,
        ncv >= nev,
        nev,
        restarts=int(its),
        purges=int(purges),
        timings={"device": device_s, "dense": 0.0},
    )
    schur = PartialSchur(
        None, Hh[:ncv, :ncv].copy(), lam[:ncv].copy(), Q_rows=V[:ncv]
    )
    return schur, history


def _partial_schur(op, ws, mindim, maxdim, nev, tol, restarts, target, order_key,
                   active0, key, extended=False, lowsync=False, sc=False):
    m = maxdim
    # Dense restart kernels: native C++ fast path when the library is built
    # and the workspace fits its scratch buffers; the numpy layer is the
    # tested reference fallback (identical semantics).
    use_native = _native.available() and m + 1 <= _native.MAX_DIM
    n = op.shape[0]
    H = ws.H  # host authority, float64/complex128
    V = ws.V
    is_real = not np.issubdtype(H.dtype, np.complexfloating)
    eps_work = float(jnp.finfo(ws.dtype).eps)
    # extended with FLOAT64 words: the dense restart layer itself runs in
    # double-double (ops/dd.py object arrays through the same numpy
    # kernels), so the criterion floor is the dd epsilon (~4.9e-32) and
    # tolerances down to ~1e-28 certify — the reference's Double64
    # workflow (readme.md:81-105).  With f32 words the combined hi+lo
    # value fits f64 exactly, so the plain f64 dense layer suffices.
    dd = extended and np.dtype(ws.dtype) == np.dtype("float64") and not np.issubdtype(H.dtype, np.complexfloating)
    if dd:
        from .ops.dd import DD_EPS, dd_collapse, dd_hi, dd_lo, dd_pack

        eps_work = max(eps_work * eps_work, DD_EPS)
        dense_tol = DD_EPS
        use_native = False  # the C++ layer is f64-only
    elif extended:
        # Double-word device arithmetic: the criterion floor drops to the
        # square of the single word's epsilon (ops/df_expansion.py) — but
        # never below the HOST dense layer's float64 epsilon, which the
        # restart kernels inject into the relation.
        eps_work = max(eps_work * eps_work, float(np.finfo(H.dtype).eps))
        dense_tol = None
    else:
        dense_tol = None

    lams = np.zeros(m, dtype=complex)
    rs = np.zeros(m, dtype=float)
    x = np.zeros(m, dtype=complex)
    groups = np.zeros(m, dtype=int)

    if sc:
        from .ops.sc_expansion import (
            sc_apply_basis_change,
            sc_expand_range,
            sc_truncate_and_expand,
        )

        Vim = ws.Vim
        Hdev = jnp.asarray(H.real, dtype=ws.dtype)
        Hdev_i = jnp.asarray(H.imag, dtype=ws.dtype)
    else:
        Hdev = jnp.asarray(H, dtype=ws.dtype)

    # Huge single-device bases: the one-GEMM truncation basis change
    # needs a second V-sized buffer — switch to the tiled in-place change
    # (ops/expansion.py::_tiled_basis_change) when two copies of V would
    # take more than half of the device's memory.  An n-sharded V keeps
    # the one-GEMM path: per-device shards are small again and the column
    # tiling would fight the sharding.
    basis_tiles = 0
    if (
        getattr(V, "sharding", None) is not None
        and len(V.sharding.device_set) == 1
        and V.size * V.dtype.itemsize
        > tiled_threshold_bytes(next(iter(V.sharding.device_set)))
    ):
        basis_tiles = pick_tiles(n, (m + 1) * V.dtype.itemsize)

    if extended:
        from .ops.df_expansion import (
            df_apply_basis_change,
            df_expand_range,
            df_reorthogonalize_row,
            df_set_initial_vector,
            df_truncate_and_expand,
            split_f64,
        )

        # Resume the low word from a previous extended run when available
        # (warm start at double-word accuracy); rows past the locked
        # prefix are stale and zeroed either way.
        prev_lo = getattr(ws, "Vlo", None)
        if prev_lo is not None and prev_lo.shape == V.shape:
            Vlo = prev_lo.at[active0:].set(0.0)
        else:
            Vlo = jnp.zeros_like(V)
        Hlo = jnp.zeros_like(Hdev)
        if active0 == 0:
            # Re-normalize the start vector to double-word accuracy (its
            # hi word was normalized in single precision).
            V, Vlo = df_set_initial_vector(V, Vlo, V[0])
        else:
            # Warm start: the seed row was placed by the single-word path
            # and is only f32-orthogonal to the locked double-word prefix.
            V, Vlo = df_reorthogonalize_row(V, Vlo, active0)

    import time as _time

    active = active0
    prods = m - active0
    purge_events = 0
    timings = {"device": 0.0, "dense": 0.0}

    # Dispatch-size heuristic: a maxdim-step expansion over an expensive
    # operator (a degree-1000 Chebyshev filter at n=10M is ~200k SpMVs)
    # is dispatched in slices predicted to last about DISPATCH_BUDGET_S,
    # with a 4-byte sync readback in between; slice sizes start from the
    # static cost model (matvec_cost_hint, nominal seconds) and are
    # refined from each measured slice.  Ordinary problems take one slice
    # and pay nothing.
    est_step = [
        (
            op.matvec_cost_hint()
            + 4.0 * (m + 1) * n * np.dtype(ws.dtype).itemsize
            / _NOMINAL_BYTES_PER_S
        ) * (3.0 if extended else (2.0 if sc else 1.0))
    ]

    def _run_sliced(dispatch, j0, sync):
        """dispatch(a, b) advances the expansion arrays over [a, b);
        sync() forces execution of everything queued (tiny readback)."""
        j = j0
        first = True
        while j < m:
            budget = DISPATCH_BUDGET_S * (0.5 if first else 1.0)
            steps = max(1, min(m - j, int(budget / max(est_step[0], 1e-9))))
            t0 = _time.perf_counter()
            dispatch(j, j + steps)
            j += steps
            if j < m:
                sync()
                dt = _time.perf_counter() - t0
                # The first slice's wall includes compilation, inflating
                # the estimate — that errs SMALL on the next slice and
                # self-corrects from its measurement.
                est_step[0] = max(dt / steps, 1e-9)
            first = False

    # Initial expansion straight to a maxdim-sized relation (the reference
    # stops at mindim first, but nothing happens in between — run.jl:260-275
    # — so one dispatch does both).  H transfers are always full-array
    # (fixed shape): varying-shape slices would trigger a fresh XLA compile
    # per distinct shape.  The host array stays authoritative for locked
    # columns (no low-precision round trip of converged data).
    t0 = _time.perf_counter()
    with jax.profiler.TraceAnnotation("arnoldi:expand"):
        key0 = jax.random.fold_in(key, 0)
        if extended:
            def _disp0(a0, b0):
                nonlocal V, Vlo, Hdev, Hlo
                V, Vlo, Hdev, Hlo = df_expand_range(
                    op, V, Vlo, Hdev, Hlo, a0, b0, key0
                )

            _run_sliced(_disp0, active0, lambda: np.asarray(Hdev[:1, :1]))
            if dd:
                Hpull = dd_pack(np.asarray(Hdev), np.asarray(Hlo))
            else:
                Hpull = np.asarray(Hdev, dtype=H.dtype) + np.asarray(
                    Hlo, dtype=H.dtype
                )
        elif sc:
            def _disp0(a0, b0):
                nonlocal V, Vim, Hdev, Hdev_i
                V, Vim, Hdev, Hdev_i = sc_expand_range(
                    op, V, Vim, Hdev, Hdev_i, a0, b0, key0
                )

            _run_sliced(_disp0, active0, lambda: np.asarray(Hdev[:1, :1]))
            Hpull = np.asarray(Hdev, np.float64) + 1j * np.asarray(
                Hdev_i, np.float64
            )
        else:
            _expand = expand_range_lowsync if lowsync else expand_range

            def _disp0(a0, b0):
                nonlocal V, Hdev
                V, Hdev = _expand(op, V, Hdev, a0, b0, key0)

            _run_sliced(_disp0, active0, lambda: np.asarray(Hdev[:1, :1]))
            Hpull = np.asarray(Hdev, dtype=H.dtype)
    if dd:
        # The host Hessenberg becomes an object array of DD scalars for
        # the whole restart loop: the dense kernels run unchanged on it
        # (ws.H keeps the f64 hi words, ws.Hlo the lo words — synced
        # after every restart and on exit so the workspace stays
        # resumable at full double-double accuracy; a warm start
        # rehydrates the locked block from both words).
        Hlo_host = getattr(ws, "Hlo", None)
        if active0 > 0 and Hlo_host is not None:
            H = dd_pack(H, Hlo_host)
        else:
            H = dd_pack(H)
    H[:, active0:m] = Hpull[:, active0:m]
    timings["device"] += _time.perf_counter() - t0

    # The truncation basis change of each restart is fused into the *next*
    # restart's expansion (one device dispatch + one H readback per restart
    # — the round-trip count is the host path's latency floor).
    # On exit, `pending_Q` holds the not-yet-applied final truncation; it
    # is composed with the final sort into a single GEMM.
    pending_Q = None

    it = 0
    for it in range(1, restarts + 1):
        # Dense restart phase (host, f64).
        t0 = _time.perf_counter()
        Q = np.eye(m, dtype=H.dtype)
        if use_native:
            _native.local_schur(H[:m, :], active, m, Q)
            _native.copy_eigenvalues(lams, H[:m, :], 0, m)
            _native.copy_residuals(rs, H[:m, :], Q, H[m, m - 1], active, m)
        else:
            local_schur(H[:m, :], active, m, Q, tol=dense_tol)
            copy_eigenvalues(lams, H[:m, :], 0, m, tol=dense_tol)
            # Residual ESTIMATES evaluate in f64 even in dd mode: the
            # tiny last-row couplings the dd Schur produced are exact
            # f64 values (only their low words are dropped), so the
            # estimate keeps ~1e-16 RELATIVE accuracy at any magnitude —
            # all the locking decision needs.  The similarity
            # TRANSFORMS above stay dd.
            He = dd_collapse(H) if dd else H
            Qe = dd_collapse(Q) if dd else Q
            _copy_residuals(rs, He, Qe, He[m, m - 1], x, active, m)
        if not use_native:
            _schur_coupling_floor(rs, He, Qe, He[m, m - 1], active, m)
        else:
            _schur_coupling_floor(rs, H, Q, H[m, m - 1], active, m)
        ord_ = np.array(
            sorted(range(m), key=lambda i: (order_key(lams[i]), i))
        )
        h_frob = np.linalg.norm(dd_hi(H) if dd else H)

        def isconverged(idx):
            return rs[idx] <= max(eps_work * h_frob, tol * abs(lams[idx]))

        # [locked | retained | purged] partitioning.  Keep nev or nev+1
        # depending on whether the cut would split a conjugate pair.
        effective_nev = nev + 1 if _is_pair_at(lams, ord_, nev - 1, is_real) else nev

        nlock = 0
        for i in range(effective_nev):
            if isconverged(ord_[i]):
                groups[ord_[i]] = 1
                nlock += 1
            else:
                groups[ord_[i]] = 2

        # Truncation size k: roughly mindim active columns, at most halfway
        # to maxdim, never splitting a pair (ref: run.jl:310-339).
        ideal_size = min(nlock + mindim, (mindim + maxdim) // 2)
        k = effective_nev
        i = effective_nev
        while i < m:
            pair = _is_pair_at(lams, ord_, i, is_real)
            num = 2 if pair else 1
            if k < ideal_size and not isconverged(ord_[i]):
                group = 2
                k += num
            else:
                group = 3
            groups[ord_[i]] = group
            if pair:
                groups[ord_[i + 1]] = group
            i += num

        # Index of the first formerly-locked vector that is being purged
        # (locked values can be unlocked when better ones appear,
        # ref: run.jl:341-353).
        purge = 0
        while purge < active and groups[purge] == 1:
            purge += 1
        if purge < active:
            purge_events += 1

        if use_native:
            _native.partition_three_way(H[:m, :], Q, groups)
            _native.restore_arnoldi(H, nlock, k, Q)
        else:
            _partition_three_way(H[:m, :], Q, groups)
            restore_arnoldi(H, nlock, k, Q)

        # Fixed-shape basis-change matrix: columns [purge, k) from Q, row k
        # takes the old row m (the next-vector slot), everything else
        # passes through untouched (ref: run.jl:363-365).
        Qbig = np.eye(m + 1, dtype=H.dtype)
        Qbig[:, purge:k] = 0
        Qbig[purge:m, purge:k] = Q[purge:m, purge:k]
        if k < m:
            Qbig[:, k] = 0
            Qbig[m, k] = 1
        timings["dense"] += _time.perf_counter() - t0

        active = nlock
        if active >= nev or it == restarts:
            # Applied below, composed with the final sort's GEMM.
            pending_Q = Qbig
            break

        # One fused device dispatch: apply the truncation to V and expand
        # the Krylov subspace from k back to maxdim; then the one H
        # readback of this restart.
        t0 = _time.perf_counter()
        with jax.profiler.TraceAnnotation("arnoldi:truncate_expand"):
            keyit = jax.random.fold_in(key, it)
            # The first slice carries the truncation basis change; any
            # further slices are plain expansions of the remaining range.
            if extended:
                if dd:
                    # Qbig is a DD object array: feed its TRUE hi/lo
                    # words to the df kernels (split_f64 of the rounded
                    # value would zero the low word).
                    Qh = jnp.asarray(dd_hi(Qbig))
                    Ql = jnp.asarray(dd_lo(Qbig))
                else:
                    Qh, Ql = split_f64(Qbig, ws.dtype)

                def _dispt(a0, b0):
                    nonlocal V, Vlo, Hdev, Hlo
                    if a0 == k:
                        V, Vlo, Hdev, Hlo = df_truncate_and_expand(
                            op, V, Vlo, Hdev, Hlo, Qh, Ql, a0, b0, keyit
                        )
                    else:
                        V, Vlo, Hdev, Hlo = df_expand_range(
                            op, V, Vlo, Hdev, Hlo, a0, b0, keyit
                        )

                _run_sliced(_dispt, k, lambda: np.asarray(Hdev[:1, :1]))
                if dd:
                    Hpull = dd_pack(np.asarray(Hdev), np.asarray(Hlo))
                else:
                    Hpull = np.asarray(Hdev, dtype=H.dtype) + np.asarray(
                        Hlo, dtype=H.dtype
                    )
            elif sc:
                Qr = jnp.asarray(np.ascontiguousarray(Qbig.real), ws.dtype)
                Qi = jnp.asarray(np.ascontiguousarray(Qbig.imag), ws.dtype)

                def _dispt(a0, b0):
                    nonlocal V, Vim, Hdev, Hdev_i
                    if a0 == k:
                        V, Vim, Hdev, Hdev_i = sc_truncate_and_expand(
                            op, V, Vim, Hdev, Hdev_i, Qr, Qi, a0, b0, keyit
                        )
                    else:
                        V, Vim, Hdev, Hdev_i = sc_expand_range(
                            op, V, Vim, Hdev, Hdev_i, a0, b0, keyit
                        )

                _run_sliced(_dispt, k, lambda: np.asarray(Hdev[:1, :1]))
                Hpull = np.asarray(Hdev, np.float64) + 1j * np.asarray(
                    Hdev_i, np.float64
                )
            else:
                Qdev = jnp.asarray(Qbig, dtype=ws.dtype)
                if lowsync:
                    _texp, _expand = (
                        truncate_and_expand_lowsync, expand_range_lowsync
                    )
                elif basis_tiles:
                    _texp = partial(
                        truncate_and_expand_tiled, tiles=basis_tiles
                    )
                    _expand = expand_range
                else:
                    _texp, _expand = truncate_and_expand, expand_range

                def _dispt(a0, b0):
                    nonlocal V, Hdev
                    if a0 == k:
                        V, Hdev = _texp(op, V, Hdev, Qdev, a0, b0, keyit)
                    else:
                        V, Hdev = _expand(op, V, Hdev, a0, b0, keyit)

                _run_sliced(_dispt, k, lambda: np.asarray(Hdev[:1, :1]))
                Hpull = np.asarray(Hdev, dtype=H.dtype)
        H[:, k:m] = Hpull[:, k:m]
        prods += m - k
        timings["device"] += _time.perf_counter() - t0

        if _DEBUG and not sc and not dd:
            # (split-complex: V alone is only the real word; dd: H is an
            # object array the finiteness check cannot see through)
            _debug_checks(H, V, m, it)

        # Keep the workspace coherent after every restart so an exception
        # (or a caller-side abort) leaves a resumable state.
        ws.V = V
        if extended:
            ws.Vlo = Vlo
        if sc:
            ws.Vim = Vim
        if dd:
            # H is a fresh object array in dd mode (it no longer aliases
            # ws.H), so sync both words explicitly — without this, an
            # abort mid-solve would leave ws.V many restarts ahead of a
            # stale ws.H.
            ws.H[:] = dd_hi(H)
            ws.Hlo = dd_lo(H)

    nconverged = active

    # Sort the converged eigenvalues in the user's target order, and apply
    # the pending truncation + sort to V in one composed GEMM.
    t0 = _time.perf_counter()
    Q = np.eye(m, dtype=H.dtype)
    if use_native:
        _native.sort_schur(H[:m, :], Q, nconverged, type(target).__name__)
    else:
        _sort_schur(H[:m, :], Q, nconverged, order_key)
    Qbig = np.eye(m + 1, dtype=H.dtype)
    Qbig[:m, :m] = Q
    if pending_Q is not None:
        Qbig = pending_Q @ Qbig
    timings["dense"] += _time.perf_counter() - t0
    t0 = _time.perf_counter()
    if extended:
        if dd:
            V, Vlo = df_apply_basis_change(
                V, Vlo, jnp.asarray(dd_hi(Qbig)), jnp.asarray(dd_lo(Qbig))
            )
        else:
            V, Vlo = df_apply_basis_change(
                V, Vlo, *split_f64(Qbig, ws.dtype)
            )
    elif sc:
        V, Vim = sc_apply_basis_change(
            V, Vim,
            jnp.asarray(np.ascontiguousarray(Qbig.real), ws.dtype),
            jnp.asarray(np.ascontiguousarray(Qbig.imag), ws.dtype),
        )
    elif basis_tiles:
        V = apply_basis_change_tiled(
            V, jnp.asarray(Qbig, dtype=ws.dtype), tiles=basis_tiles
        )
    else:
        V = apply_basis_change(V, jnp.asarray(Qbig, dtype=ws.dtype))
    timings["device"] += _time.perf_counter() - t0

    if nconverged > 0:
        if use_native:
            _native.copy_eigenvalues(lams, H[:m, :], 0, nconverged)
        else:
            copy_eigenvalues(lams, H[:m, :], 0, nconverged, tol=dense_tol)

    ws.V = V
    # The low word makes the workspace a DOUBLE-WORD checkpoint after an
    # extended run; a plain solve invalidates it (V moved without lo
    # tracking).
    ws.Vlo = Vlo if extended else None
    if not dd:
        # Non-dd solves carry H in a single word: any double-double low
        # word from a previous run on this workspace is stale now.
        ws.Hlo = None
    # A plain solve moves V without tracking an imaginary word, so any
    # split-complex state from a previous run is stale now (same rule as
    # the extended low word above).
    ws.Vim = Vim if sc else None

    history = History(prods, nconverged, nconverged >= nev, nev, restarts=it,
                      purges=purge_events, timings=timings)
    if dd:
        # Keep the hi/lo words SEPARATE: with f64 words, hi + lo rounds
        # lo away, so Q/R carry the hi word and the extra attributes
        # Q_lo/R_lo carry the rest — together a ~1e-32-accurate pair
        # (the Double64-class return; docs/precision.md).
        ws.H[:] = dd_hi(H)  # resumable state: hi words here, lo in Hlo
        ws.Hlo = dd_lo(H)
        schur = PartialSchur(
            np.asarray(V, np.float64)[:nconverged].T.copy(),
            dd_hi(H[:nconverged, :nconverged]),
            lams[:nconverged].copy(),
        )
        schur.Q_lo = np.asarray(Vlo, np.float64)[:nconverged].T.copy()
        schur.R_lo = dd_lo(H[:nconverged, :nconverged])
        return schur, history
    if extended:
        # Return Q at full double-word accuracy: one host f64 combine
        # (f32 words: the combined value is exact in f64).
        Vfull = np.asarray(V, np.float64) + np.asarray(Vlo, np.float64)
        schur = PartialSchur(
            Vfull[:nconverged].T.copy(),
            H[:nconverged, :nconverged].copy(),
            lams[:nconverged].copy(),
        )
        return schur, history
    if sc:
        # Recombine the (re, im) words on host in complex128.
        Vfull = np.asarray(V[:nconverged], np.float64) + 1j * np.asarray(
            Vim[:nconverged], np.float64
        )
        schur = PartialSchur(
            Vfull.T.copy(),
            H[:nconverged, :nconverged].copy(),
            lams[:nconverged].copy(),
        )
        return schur, history
    schur = PartialSchur(
        None,
        H[:nconverged, :nconverged].copy(),
        lams[:nconverged].copy(),
        Q_rows=V[:nconverged],
    )
    return schur, history
