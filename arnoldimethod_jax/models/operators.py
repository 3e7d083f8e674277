"""Linear operator protocol and concrete operator types (the 'models' of
this framework: the matrix families partial_schur operates on).

The contract mirrors the reference's matrix-free `mul!`/`eltype`/`size`
protocol (run.jl:21-23): an operator exposes `shape`, `dtype` and
`matvec(x)`, where matvec is traceable under jax.jit.  Operators are
registered as pytrees so they can be passed straight into jitted device
functions: their arrays are traced (no recompilation across calls), their
structure is static.
"""

from __future__ import annotations

import logging

import numpy as np

import jax
import jax.numpy as jnp
from jax.tree_util import register_pytree_node_class

_LOG = logging.getLogger("arnoldimethod_jax")

# Scale of matvec_cost_hint: nominal bytes per second, a fixed constant of
# the dispatch-size heuristic, not a rate measured on any device.
_NOMINAL_BYTES_PER_S = 8.0e11

__all__ = [
    "LinearOperator",
    "DenseOperator",
    "EllOperator",
    "CsrOperator",
    "SellOperator",
    "sell_from_csr",
    "ShardedCsrOperator",
    "FunctionOperator",
    "ShiftInvertDenseOperator",
    "SplitComplexDenseOperator",
    "SplitComplexOperator",
    "TridiagonalShiftInvertOperator",
    "as_operator",
    "csr_to_ell",
    "csr_to_dia",
    "pick_sparse_format",
]


class LinearOperator:
    """Protocol base class.  Subclasses define `shape`, `dtype`, and
    `matvec(x) -> y` (jit-traceable)."""

    shape: tuple
    dtype: np.dtype

    def matvec(self, x):
        raise NotImplementedError

    def matvec_cost_hint(self):
        """Rough relative cost of one matvec, in nominal seconds — the
        driver's dispatch-size heuristic for slicing long expansions into
        several dispatches (ops/expansion.py DISPATCH_BUDGET_S).  The
        divisor _NOMINAL_BYTES_PER_S is a fixed scale, not a measured rate
        of any device; only ratios between operators matter.  Default
        model: ~6 n-sized memory passes; operators whose matvec is much
        heavier (polynomial filters, shift-invert solves) override this."""
        n = self.shape[0]
        item = np.dtype(self.dtype).itemsize
        return 6.0 * n * item / _NOMINAL_BYTES_PER_S

    def matmat(self, X):
        """Block matvec A @ X for X of shape (n, K) — default: K
        sequential matvecs inside one dispatch.  Sparse formats override
        this with K-amortized gathers: gathering K-wide rows of X pays one
        index per K elements instead of one per element."""
        return jax.lax.map(self.matvec, X.T).T

    def __matmul__(self, x):
        return self.matvec(x)


@register_pytree_node_class
class DenseOperator(LinearOperator):
    """Dense matrix operator; matvec is one XLA matrix-vector product."""

    def __init__(self, A):
        self.A = A if isinstance(A, jax.Array) else jnp.asarray(A)
        self.shape = self.A.shape
        self.dtype = self.A.dtype

    def matvec(self, x):
        # Full-precision accumulation: an f32 product with no precision
        # given may run in TF32 on the GPU (~3 decimal digits), which is
        # not accurate enough for an eigensolver's matvec.
        return jnp.matmul(self.A, x, precision=jax.lax.Precision.HIGHEST)

    def matvec_cost_hint(self):
        n = self.shape[0]
        return n * n * np.dtype(self.dtype).itemsize / _NOMINAL_BYTES_PER_S

    def tree_flatten(self):
        return (self.A,), (self.shape, self.dtype)

    @classmethod
    def tree_unflatten(cls, aux, children):
        # Children may be tracers/sentinels during jit transforms: bypass
        # __init__'s array coercion entirely.
        obj = object.__new__(cls)
        obj.A = children[0]
        obj.shape, obj.dtype = aux
        return obj


@register_pytree_node_class
class EllOperator(LinearOperator):
    """Sparse matrix in padded ELL format: `data` (n, K) holds up to K
    nonzeros per row (zero-padded), `cols` (n, K) the column indices
    (padded entries point at column 0 with zero data).

    Fully static shapes: the matvec is one XLA gather plus a dense row
    reduction.  CSR input is converted via `csr_to_ell`.
    """

    def __init__(self, data, cols, shape):
        self.data = data if isinstance(data, jax.Array) else jnp.asarray(data)
        self.cols = cols if isinstance(cols, jax.Array) else jnp.asarray(cols, dtype=jnp.int32)
        self.shape = tuple(shape)
        self.dtype = self.data.dtype

    @property
    def nnz(self):
        return int(self.data.size)

    def matvec(self, x):
        return jnp.sum(self.data * x[self.cols], axis=1)

    def tree_flatten(self):
        return (self.data, self.cols), (self.shape, self.dtype)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.data, obj.cols = children
        obj.shape, obj.dtype = aux
        return obj


@register_pytree_node_class
class DiaOperator(LinearOperator):
    """Sparse matrix in DIA (diagonal) format: `offsets` is a static tuple
    of diagonal offsets, `diags` is (ndiag, n) with
    diags[d, i] = A[i, i + offsets[d]] (zero where out of range).

    The layout for banded/stencil matrices (Laplacians,
    convection-diffusion — every matrix in the reference's README/bench
    set): the matvec is ndiag fused multiply-adds on statically shifted
    views of x — no gather, one streaming elementwise pass.  Under a
    row-sharded mesh the static shifts become exactly the neighbor halo
    exchanges (XLA inserts collective-permutes).
    """

    def __init__(self, diags, offsets, shape):
        self.diags = diags if isinstance(diags, jax.Array) else jnp.asarray(diags)
        self.offsets = tuple(int(o) for o in offsets)
        self.shape = tuple(shape)
        self.dtype = self.diags.dtype

    @property
    def nnz(self):
        return int(self.diags.size)

    def matvec(self, x):
        n = self.shape[0]
        lo = max(0, -min(self.offsets))
        hi = max(0, max(self.offsets))
        xp = jnp.pad(x, (lo, hi))
        y = self.diags[0] * jax.lax.slice(xp, (lo + self.offsets[0],), (lo + self.offsets[0] + n,))
        for d in range(1, len(self.offsets)):
            off = self.offsets[d]
            y = y + self.diags[d] * jax.lax.slice(xp, (lo + off,), (lo + off + n,))
        return y

    def matvec_df(self, xh, xl):
        """Double-word matvec (yh, yl) = A @ (xh, xl): the same shifted
        multiply-adds carried in error-free double-word arithmetic
        (ops/df32.py) — the extended-precision expansion path's operator
        hook.  ~10x the flops of `matvec`, still elementwise work."""
        from ..ops import df32

        n = self.shape[0]
        lo = max(0, -min(self.offsets))
        hi = max(0, max(self.offsets))
        xph = jnp.pad(xh, (lo, hi))
        xpl = jnp.pad(xl, (lo, hi))
        yh = yl = None
        for d, off in enumerate(self.offsets):
            sh = jax.lax.slice(xph, (lo + off,), (lo + off + n,))
            sl = jax.lax.slice(xpl, (lo + off,), (lo + off + n,))
            th, tl = df32.df_scale(sh, sl, self.diags[d])
            yh, yl = (
                (th, tl) if yh is None else df32.df_add(yh, yl, th, tl)
            )
        return yh, yl

    def tree_flatten(self):
        return (self.diags,), (self.offsets, self.shape, self.dtype)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.diags = children[0]
        obj.offsets, obj.shape, obj.dtype = aux
        return obj


@register_pytree_node_class
class Stencil5Operator(LinearOperator):
    """Constant-coefficient 5-point stencil on an (ny, nx) grid, acting on
    flattened row-major vectors of length n = ny*nx.

    The matvec reshapes x to the grid (free, layout-preserving) and applies
    the stencil with 2-D shifts; Dirichlet boundaries fall out of the 2-D
    slicing automatically.  Since the coefficients are scalars, the only
    HBM traffic is x and y themselves — the speed-of-light formulation for
    grid Laplacians / convection-diffusion (BASELINE.json configs 2-3).
    """

    def __init__(self, coeffs, grid, dtype=jnp.float32, boundary="dirichlet"):
        # coeffs: (center, west, east, north, south) scalars — real or
        # complex.  Complex coefficients make this a complex operator:
        # `dtype` becomes complex64/128; `matvec_sc` also serves the
        # explicit split-complex path.
        # boundary: "dirichlet" (zero-padded halo) or "periodic" (the
        # shifts wrap via jnp.roll — a 2-D circulant, hence a NORMAL
        # operator even with nonsymmetric convection coefficients; its
        # exact spectrum is the 2-D DFT symbol, the checkable
        # nonsymmetric-at-scale model problem).
        if boundary not in ("dirichlet", "periodic"):
            raise ValueError("boundary must be 'dirichlet' or 'periodic'")
        self.boundary = boundary
        cs = tuple(complex(c) for c in coeffs)
        self._complex_coeffs = any(c.imag != 0.0 for c in cs)
        self.coeffs = cs if self._complex_coeffs else tuple(
            c.real for c in cs
        )
        self.grid = (int(grid[0]), int(grid[1]))  # (ny, nx)
        n = self.grid[0] * self.grid[1]
        self.shape = (n, n)
        dt = jnp.dtype(dtype)
        if jnp.issubdtype(dt, jnp.complexfloating):
            word = (
                jnp.dtype("float32")
                if dt == jnp.dtype("complex64")
                else jnp.dtype("float64")
            )
        elif self._complex_coeffs:
            word = dt
            dt = jnp.dtype(
                "complex64" if word == jnp.dtype("float32") else "complex128"
            )
        else:
            word = dt
        self.dtype = dt
        self.word_dtype = word

    @property
    def nnz(self):
        ny, nx = self.grid
        n = ny * nx
        if self.boundary == "periodic":
            return 5 * n
        # center everywhere; west/east miss one column; north/south one row.
        return n + 2 * ny * (nx - 1) + 2 * (ny - 1) * nx

    def _shifted(self, g):
        """The four neighbor reads (west, east, north, south) of grid g
        under this operator's boundary condition.  west multiplies
        x[i, j-1] etc.; Dirichlet reads a zero-padded halo, periodic
        wraps via roll (XLA lowers both to fused slice/concat reads)."""
        if self.boundary == "periodic":
            return (
                jnp.roll(g, 1, axis=1),
                jnp.roll(g, -1, axis=1),
                jnp.roll(g, 1, axis=0),
                jnp.roll(g, -1, axis=0),
            )
        gp = jnp.pad(g, ((1, 1), (1, 1)))
        return (
            gp[1:-1, :-2],
            gp[1:-1, 2:],
            gp[:-2, 1:-1],
            gp[2:, 1:-1],
        )

    def matvec_sc(self, xr, xi):
        """Split-complex stencil application (yr, yi) = A @ (xr + i*xi)
        for complex coefficients, fused so xr/xi are each read ONCE and
        yr/yi written once — half the HBM traffic of composing two real
        stencil passes per output part.  Also exact for real
        coefficients (the imaginary terms fold to zero constants)."""
        ny, nx = self.grid
        gr, gi = xr.reshape(ny, nx), xi.reshape(ny, nx)
        views = ((gr, gi),) + tuple(
            zip(self._shifted(gr), self._shifted(gi))
        )
        yr = yi = 0.0
        for c, (tr, ti) in zip(self.coeffs, views):
            cr, ci = float(np.real(c)), float(np.imag(c))
            yr = yr + cr * tr - ci * ti
            yi = yi + cr * ti + ci * tr
        return yr.reshape(ny * nx), yi.reshape(ny * nx)

    def matvec(self, x):
        ny, nx = self.grid
        if self._complex_coeffs:
            # CPU-oracle path: complex in/out through the split kernel.
            yr, yi = self.matvec_sc(
                jnp.real(x).astype(self.word_dtype),
                jnp.imag(x).astype(self.word_dtype),
            )
            return yr + 1j * yi
        c, w, e, no, so = self.coeffs
        g = x.reshape(ny, nx)
        # One halo (zero-padded or wrapped) + five shifted reads in a
        # single fused elementwise expression (XLA fuses this into one
        # pass over the grid; scatter-style .at[].add would not fuse).
        # Under a row-sharded mesh the row shifts become GSPMD halo
        # collectives.
        vw, ve, vn, vs = self._shifted(g)
        y = c * g + w * vw + e * ve + no * vn + so * vs
        return y.reshape(ny * nx)

    def matvec_df(self, xh, xl):
        """Double-word stencil application (extended-precision hook): the
        five shifted scalar multiplies carried in df arithmetic
        (ops/df32.py) — the coefficients are exact scalars, so each term
        is one df_scale and four df_adds per point."""
        from ..ops import df32

        ny, nx = self.grid
        c, w, e, no, so = self.coeffs
        gh = xh.reshape(ny, nx)
        gl = xl.reshape(ny, nx)
        coef = jnp.asarray
        yh, yl = df32.df_scale(gh, gl, coef(c, dtype=gh.dtype))
        for cf, sh, sl in zip(
            (w, e, no, so), self._shifted(gh), self._shifted(gl)
        ):
            th, tl = df32.df_scale(sh, sl, coef(cf, dtype=gh.dtype))
            yh, yl = df32.df_add(yh, yl, th, tl)
        return yh.reshape(ny * nx), yl.reshape(ny * nx)

    def tree_flatten(self):
        return (), (self.coeffs, self.grid, self.dtype, self.boundary)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*aux)


def dia_from_diagonals(diagonals, shape, dtype=None):
    """Build a DiaOperator from {offset: values}: values may be a scalar
    (constant diagonal) or an array of length n; entry d of the diagonal at
    `offset` multiplies x[i + offset] in row i.  Out-of-range positions are
    zeroed.

    Complex values (or a complex `dtype`) return a `SplitComplexOperator`
    over two real DiaOperators: its `matvec` takes complex vectors (the
    native complex path) and its `matvec_sc` real (re, im) pairs (the
    explicit split_complex=True path)."""
    offsets = sorted(diagonals)
    n = shape[0]
    values_complex = any(
        np.iscomplexobj(np.asarray(v)) for v in diagonals.values()
    )
    dtype = dtype or (np.complex128 if values_complex else np.float64)
    if np.issubdtype(np.dtype(dtype), np.complexfloating) or values_complex:
        # The split parts' REAL word honors the requested precision: a
        # complex64 request — or complex values with a real float32
        # dtype — gives float32 words.
        word = (
            np.float32
            if np.dtype(dtype) in (np.dtype("complex64"),
                                   np.dtype("float32"))
            else np.float64
        )
        diags = np.zeros((len(offsets), n), dtype=np.complex128)
    else:
        word = None
        diags = np.zeros((len(offsets), n), dtype=dtype)
    for d, off in enumerate(offsets):
        diags[d, :] = diagonals[off]
        if off > 0:
            diags[d, n - off :] = 0
        elif off < 0:
            diags[d, :-off] = 0
    if word is None:
        return DiaOperator(diags, offsets, shape)
    re = DiaOperator(diags.real.astype(word), offsets, shape)
    im = (
        DiaOperator(diags.imag.astype(word), offsets, shape)
        if np.any(diags.imag)
        else None
    )
    return SplitComplexOperator(re, im)


def pack_bsr(block_cols, block_data):
    """One-time packing of natural-orientation BSR operands.

    block_cols: (nbr, KB) int — block column index per slot;
    block_data: (nbr, KB, B, B) — dense blocks, block_data[r, k] is the
      (B, B) block at block-row r, block-col block_cols[r, k].

    Returns (cols, dataT) with each block transposed:
    dataT[r, k, j, i] = block_data[r, k, i, j], the layout
    BsrOperator.matvec's einsum contracts.
    """
    block_cols = np.asarray(block_cols)
    block_data = np.asarray(block_data)
    dataT = np.ascontiguousarray(block_data.transpose(0, 1, 3, 2))
    return block_cols.astype(np.int32), dataT


@register_pytree_node_class
class BsrOperator(LinearOperator):
    """Block-sparse rows (block-level ELL): dense (B, B) blocks, up to KB
    per block-row.  The format for matrices with clustered structure: the
    matvec gathers the x block of every stored block and contracts it
    with one einsum, so the block data is streamed once."""

    def __init__(self, block_cols, block_data, shape):
        # Packed once at construction (pack_bsr), so no matvec copies the
        # streamed block array.
        cols, dataT = pack_bsr(block_cols, block_data)
        self.block_cols = jnp.asarray(cols)
        self.block_dataT = jnp.asarray(dataT)
        self.shape = tuple(shape)
        self.dtype = self.block_dataT.dtype

    @property
    def block_size(self):
        return self.block_dataT.shape[-1]

    @property
    def block_data(self):
        """Blocks in natural orientation (materializes a transposed copy —
        storage is the packed transposed layout)."""
        return self.block_dataT.transpose(0, 1, 3, 2)

    @property
    def nnz(self):
        return int(self.block_dataT.size)

    def matvec(self, x):
        B = self.block_size
        n = self.shape[0]
        nbc = -(-n // B)
        if x.shape[0] != nbc * B:  # n not a block multiple: zero-pad x
            x = jnp.pad(x, (0, nbc * B - x.shape[0]))
        xb = x.reshape(-1, B)
        gathered = xb[self.block_cols]  # (nbr, KB, B)
        return jnp.einsum(
            "rkji,rkj->ri",  # blocks stored transposed: dataT[r,k,j,i]=A[i,j]
            self.block_dataT,
            gathered,
            precision=jax.lax.Precision.HIGHEST,
        ).reshape(-1)[:n]

    def tree_flatten(self):
        return (self.block_cols, self.block_dataT), (self.shape, self.dtype)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.block_cols, obj.block_dataT = children
        obj.shape, obj.dtype = aux
        return obj


def dense_to_bsr(A, block_size=128):
    """Convert a dense matrix to BsrOperator, keeping only nonzero blocks
    (host-side; n must be a multiple of block_size)."""
    A = np.asarray(A)
    n = A.shape[0]
    B = block_size
    if n % B:
        raise ValueError(f"n ({n}) must be a multiple of block_size ({B})")
    nb = n // B
    blocks = A.reshape(nb, B, nb, B).transpose(0, 2, 1, 3)
    nz = np.abs(blocks).sum(axis=(2, 3)) != 0
    KB = max(1, int(nz.sum(axis=1).max()))
    block_cols = np.zeros((nb, KB), dtype=np.int32)
    block_data = np.zeros((nb, KB, B, B), dtype=A.dtype)
    for i in range(nb):
        cols = np.nonzero(nz[i])[0]
        block_cols[i, : len(cols)] = cols
        block_data[i, : len(cols)] = blocks[i, cols]
    return BsrOperator(block_cols, block_data, A.shape)


@register_pytree_node_class
class SellOperator(LinearOperator):
    """Bucketed / sorted ELL ("SELL"): rows grouped by rounded-up
    power-of-two nonzero count, each bucket stored as an exact little ELL
    block.  The layout for *irregular* (power-law) row-length matrices on
    one device:

      * padding is bounded by 2x nnz per bucket (vs O(n * K_max) for
        plain padded ELL — a zipf row distribution with K_max=512 would
        blow plain ELL up ~200x);
      * the reduction over each bucket is a dense sum along the K axis —
        no scatter/segment_sum;
      * every shape is static: <= log2(K_max)+1 buckets, one fused kernel
        per bucket plus one inverse-permutation gather on the output.

    Output rows come back in original order via `inv_perm`.  Built from
    CSR with `CsrOperator.to_sell()` / `sell_from_csr`.
    """

    def __init__(self, buckets, inv_perm, shape, nnz_true):
        # buckets: tuple of (data (r_b, K_b), cols (r_b, K_b)) pairs.
        self.buckets = tuple(buckets)
        self.inv_perm = inv_perm
        self.shape = tuple(shape)
        self.dtype = self.buckets[0][0].dtype
        self._nnz_true = int(nnz_true)

    @property
    def nnz(self):
        return self._nnz_true

    @property
    def nnz_stored(self):
        return int(sum(d.size for d, _ in self.buckets))

    def matvec(self, x):
        parts = [
            jnp.sum(data * x[cols], axis=1) for data, cols in self.buckets
        ]
        return jnp.concatenate(parts)[self.inv_perm]

    def matmat(self, X):
        """Block SpMM, K-amortized: `jnp.take(X, cols, axis=0)` fetches a
        K-wide row of X per nonzero — one index per K elements instead
        of one per element."""
        parts = [
            jnp.sum(
                data[:, :, None] * jnp.take(X, cols, axis=0), axis=1
            )
            for data, cols in self.buckets
        ]
        return jnp.take(jnp.concatenate(parts), self.inv_perm, axis=0)

    def tree_flatten(self):
        return (self.buckets, self.inv_perm), (self.shape, self._nnz_true)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.buckets, obj.inv_perm = children
        obj.shape, obj._nnz_true = aux
        obj.buckets = tuple(tuple(b) for b in obj.buckets)
        obj.dtype = getattr(obj.buckets[0][0], "dtype", None)
        return obj


def sell_from_csr(indptr, indices, data, shape, dtype=None):
    """Build a SellOperator from host CSR arrays (one host pass)."""
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    data = np.asarray(data, dtype=dtype or data.dtype)
    n = shape[0]
    row_nnz = np.diff(indptr).astype(np.int64)
    # Bucket id: ceil-pow2 of the row length (empty rows -> width-1 bucket
    # of zero data, keeping every row represented exactly once).
    widths = np.maximum(row_nnz, 1)
    bucket_k = (1 << np.ceil(np.log2(widths)).astype(np.int64))
    order = np.argsort(bucket_k, kind="stable")
    inv_perm = np.empty(n, dtype=np.int64)
    inv_perm[order] = np.arange(n)

    # The masked fancy-indexing below still evaluates data[idx]/indices[idx]
    # eagerly, which needs at least one addressable entry even when the
    # matrix has no nonzeros (then idx is all-zero and valid all-False).
    data_ix = data if data.size else np.zeros(1, dtype=data.dtype)
    cols_ix = indices if indices.size else np.zeros(1, dtype=np.int64)

    buckets = []
    sorted_k = bucket_k[order]
    start = 0
    while start < n:
        K = int(sorted_k[start])
        stop = int(np.searchsorted(sorted_k, K, side="right"))
        rows = order[start:stop]
        slot = np.arange(K, dtype=np.int64)[None, :]
        valid = slot < row_nnz[rows][:, None]
        idx = np.where(valid, indptr[rows][:, None] + slot, 0)
        bdata = np.where(valid, data_ix[idx], 0).astype(data.dtype)
        bcols = np.where(valid, cols_ix[idx], 0).astype(np.int32)
        buckets.append((jnp.asarray(bdata), jnp.asarray(bcols)))
        start = stop
    return SellOperator(
        buckets, jnp.asarray(inv_perm, dtype=jnp.int32), shape, data.size
    )


@register_pytree_node_class
class CsrOperator(LinearOperator):
    """Sparse matrix in CSR, kept in CSR (ref: the SpMV surface behind the
    reference's `mul!` is SparseArrays CSC/CSR — SURVEY.md §2.3).

    The matvec is one XLA gather plus a `segment_sum` over a
    *precomputed* per-nonzero row-id vector (static shapes: nnz is fixed at
    construction, `indices_are_sorted` because CSR rows are contiguous).
    This keeps arbitrary row-length distributions exact with no padding; for
    matrices with bounded rows, `.to_ell()` converts to the padded-ELL
    layout whose matvec is a dense row reduction and row-shards under
    `shard_operator` (CSR's nnz axis has no even row split, so it stays
    single-device; convert to ELL/BSR to distribute).
    """

    def __init__(self, indptr, indices, data, shape):
        indptr = np.asarray(indptr)
        self.rows = jnp.asarray(
            np.repeat(np.arange(shape[0], dtype=np.int32), np.diff(indptr)),
        )
        self.indptr = jnp.asarray(indptr, dtype=jnp.int32)
        self.indices = jnp.asarray(indices, dtype=jnp.int32)
        self.data = data if isinstance(data, jax.Array) else jnp.asarray(data)
        self.shape = tuple(shape)
        self.dtype = self.data.dtype

    @property
    def nnz(self):
        return int(self.data.size)

    def matvec(self, x):
        prods = self.data * x[self.indices]
        return jax.ops.segment_sum(
            prods, self.rows, num_segments=self.shape[0],
            indices_are_sorted=True,
        )

    def matmat(self, X):
        """Block SpMM: the row gather of X amortizes the per-address cost
        over K columns (see SellOperator.matmat); the segment_sum's
        per-address cost amortizes identically."""
        prods = self.data[:, None] * jnp.take(X, self.indices, axis=0)
        return jax.ops.segment_sum(
            prods, self.rows, num_segments=self.shape[0],
            indices_are_sorted=True,
        )

    def to_ell(self):
        """Padded-ELL version of this matrix (the distributable layout)."""
        return csr_to_ell(
            np.asarray(self.indptr), np.asarray(self.indices),
            np.asarray(self.data), self.shape,
        )

    def to_sell(self):
        """Bucketed-ELL version (the fast single-device layout for
        power-law row lengths — see SellOperator)."""
        return sell_from_csr(
            np.asarray(self.indptr), np.asarray(self.indices),
            np.asarray(self.data), self.shape,
        )

    def to_bsr(self, block_size=128):
        """Re-block this matrix into BsrOperator (dense blocks, einsum
        matvec).

        Nonzeros are binned into (block_size x block_size) dense blocks;
        any block containing at least one nonzero is stored densely, so
        the value is highest for matrices with clustered structure.  The
        returned operator reports its zero-fill via `fill_ratio` =
        stored_nnz / true_nnz; for scattered sparsity (fill_ratio >>
        ~20-30) prefer `.to_sell()` instead.  The operator keeps the TRUE
        (n, n) shape — when n is not a block multiple the matvec
        zero-pads x internally and slices the result, so the spectrum is
        untouched."""
        indptr = np.asarray(self.indptr)
        indices = np.asarray(self.indices)
        data = np.asarray(self.data)
        n = self.shape[0]
        B = block_size
        nb = -(-n // B)
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
        br, bc = rows // B, indices // B
        # Unique nonzero blocks per block-row.
        key = br * nb + bc
        uniq, inv = np.unique(key, return_inverse=True)
        ubr, ubc = uniq // nb, uniq % nb
        counts = np.bincount(ubr, minlength=nb)
        KB = max(1, int(counts.max()))
        block_cols = np.zeros((nb, KB), dtype=np.int32)
        block_data = np.zeros((nb, KB, B, B), dtype=data.dtype)
        slot_of = np.empty(len(uniq), dtype=np.int64)
        next_slot = np.zeros(nb, dtype=np.int64)
        for u, (r, c) in enumerate(zip(ubr, ubc)):
            s = next_slot[r]
            slot_of[u] = s
            block_cols[r, s] = c
            next_slot[r] = s + 1
        np.add.at(
            block_data,
            (br, slot_of[inv], rows % B, indices % B),
            data,
        )
        op = BsrOperator(block_cols, block_data, (n, n))
        op.fill_ratio = op.nnz / max(1, self.nnz)
        return op

    def tree_flatten(self):
        children = (self.rows, self.indptr, self.indices, self.data)
        return children, (self.shape, self.dtype)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.rows, obj.indptr, obj.indices, obj.data = children
        obj.shape, obj.dtype = aux
        return obj


@register_pytree_node_class
class ShardedCsrOperator(LinearOperator):
    """Row-partitioned general-sparse operator over a 1-D device mesh —
    the distributable layout for *irregular* row-length distributions
    (the reference's `sprand` examples, test/schur_to_eigen.jl:7-12,
    reached through the matrix-free `mul!` contract, run.jl:21-23).

    Layout: rows are split into mesh-size contiguous, equal-count chunks;
    each chunk's nonzeros are stored flat (CSR order) and padded to the
    max per-chunk nnz.  Padding entries carry zero data and point at the
    chunk's last local row, so segment ids stay sorted.  Unlike padded
    ELL, the padding scales with the nnz *imbalance between shards* — not
    with the max row length — so power-law rows cost ~nothing when row
    order is uncorrelated with row weight.  (If all heavy rows cluster in
    one chunk, apply a symmetric permutation to the matrix first; that is
    a similarity transform, so the spectrum is unchanged.)

    The matvec is a `shard_map` with two communication strategies:

      * gather="footprint" (default when it pays): at build time each
        (dest, source) shard pair's COLUMN FOOTPRINT — the unique x
        entries of `source` that `dest`'s nonzeros actually reference —
        is precomputed; the matvec runs ndev-1 `ppermute` rounds, each
        device sending exactly the footprint segment its round-r neighbor
        needs.  Comm bytes per device are proportional to the footprint,
        not to n — the property that decides multi-chip SpMV scaling
        (BASELINE.json:5).  Nonzeros are SPLIT at build time into a
        local part (columns in the own shard, indexing x_shard directly)
        and a remote part (columns re-based into the concatenated
        receive buffers): the local segment_sum has no data dependency on
        any collective, so the compiler can overlap the permute rounds
        with the bulk of the compute.
      * gather="all": one tiled all_gather of x (O(n) bytes/device) —
        the fallback when the footprint is dense, and the former default.

    gather="auto" (the build default) picks footprint iff its padded
    per-device receive volume is below half of the all_gather's.
    """

    def __init__(self, arrs, shape, mesh, mode="all"):
        """arrs: mode "all" -> (rows, cols, data); mode "footprint" ->
        (rows_l, cols_l, vals_l, rows_r, cols_r, vals_r, send_idx),
        all (ndev, ...) row-sharded.  Use `build` rather than this."""
        from ..parallel.mesh import ROWS

        self.arrs = tuple(arrs)
        self.shape = tuple(shape)
        self.dtype = self.arrs[2].dtype  # vals sit at index 2 in both modes
        self.mesh = mesh
        self.mode = mode
        self._axis = ROWS

    # mode="all" storage accessors (kept for compatibility/introspection)
    @property
    def rows(self):
        return self.arrs[0]

    @property
    def cols(self):
        return self.arrs[1]

    @property
    def data(self):
        return self.arrs[2]

    @property
    def send_idx(self):
        return self.arrs[6] if self.mode == "footprint" else None

    @classmethod
    def build(cls, indptr, indices, data, shape, mesh, dtype=None,
              gather="auto"):
        """Partition host CSR arrays over `mesh` (host-side, one pass).

        gather: "footprint" | "all" | "auto" (see class docstring).
        """
        from jax.sharding import NamedSharding, PartitionSpec as P
        from ..parallel.mesh import ROWS

        indptr = np.asarray(indptr)
        indices = np.asarray(indices)
        data = np.asarray(data, dtype=dtype or data.dtype)
        n = shape[0]
        ndev = mesh.devices.size
        if n % ndev != 0:
            raise ValueError(
                f"matrix rows ({n}) must be divisible by the mesh size "
                f"({ndev}); pad the problem to a multiple first"
            )
        n_local = n // ndev
        row_nnz = np.diff(indptr)
        chunk_nnz = np.array([
            int(indptr[(r + 1) * n_local] - indptr[r * n_local])
            for r in range(ndev)
        ])
        nnz_pad = max(1, int(chunk_nnz.max()))
        rows = np.full((ndev, nnz_pad), n_local - 1, dtype=np.int32)
        cols = np.zeros((ndev, nnz_pad), dtype=np.int32)
        vals = np.zeros((ndev, nnz_pad), dtype=data.dtype)
        for r in range(ndev):
            lo, hi = indptr[r * n_local], indptr[(r + 1) * n_local]
            k = hi - lo
            rows[r, :k] = np.repeat(
                np.arange(n_local, dtype=np.int32),
                row_nnz[r * n_local : (r + 1) * n_local],
            )
            cols[r, :k] = indices[lo:hi]
            vals[r, :k] = data[lo:hi]

        mode, send_idx_np = gather, None
        if mode == "footprint" and ndev == 1:
            # A single-device mesh has no remote shards, so there is no
            # footprint to gather; constructing mode="all" behind the
            # caller's back would make sop.mode lie about what they asked
            # for (advisor round-3 finding).
            raise ValueError(
                "gather='footprint' requires a mesh with >= 2 devices; "
                "use gather='auto' (or 'all') on a single-device mesh"
            )
        if mode != "all" and ndev > 1:
            # Column footprints: fps[d][s] = sorted unique global columns
            # of dest shard d that live in source shard s.
            fps = [[None] * ndev for _ in range(ndev)]
            F = 1
            for d in range(ndev):
                lo, hi = indptr[d * n_local], indptr[(d + 1) * n_local]
                cu = np.unique(indices[lo:hi])
                src = cu // n_local
                for s in range(ndev):
                    if s != d:
                        fps[d][s] = cu[src == s]
                        F = max(F, len(fps[d][s]))
            if mode == "auto":
                # The padded receive volume must beat the all_gather's
                # n - n_local by a margin (ppermute rounds also serialize).
                mode = "footprint" if (ndev - 1) * F <= (n - n_local) // 2 \
                    else "all"
            if mode == "footprint":
                send_idx_np = np.zeros((ndev, ndev, F), dtype=np.int32)
                for d in range(ndev):
                    for s in range(ndev):
                        if s == d:
                            continue
                        f = fps[d][s]
                        send_idx_np[s, d, : len(f)] = f - s * n_local
                # Split each shard's nonzeros into a LOCAL part (columns
                # in the own shard, indexing x_shard directly) and a
                # REMOTE part (columns re-based into the concatenated
                # receive buffers [recv_r=1 | ... | recv_r=ndev-1], where
                # round r delivers source s = (d - r) mod ndev).  The
                # local segment_sum then has no dependency on any
                # collective, so the permute rounds overlap with it.
                parts = {"l": [], "r": []}
                for d in range(ndev):
                    lo, hi = indptr[d * n_local], indptr[(d + 1) * n_local]
                    cg = indices[lo:hi].astype(np.int64)
                    rg = np.repeat(
                        np.arange(n_local, dtype=np.int32),
                        row_nnz[d * n_local : (d + 1) * n_local],
                    )
                    vg = data[lo:hi]
                    src = cg // n_local
                    is_loc = src == d
                    out = np.zeros(len(cg), dtype=np.int64)
                    out[is_loc] = cg[is_loc] - d * n_local
                    for s in range(ndev):
                        if s == d or not (src == s).any():
                            continue
                        sel = src == s
                        off = (((d - s) % ndev) - 1) * F
                        out[sel] = off + np.searchsorted(fps[d][s], cg[sel])
                    parts["l"].append((rg[is_loc], out[is_loc], vg[is_loc]))
                    parts["r"].append((rg[~is_loc], out[~is_loc], vg[~is_loc]))

                def pad_part(triples):
                    kmax = max(1, max(len(t[0]) for t in triples))
                    pr = np.full((ndev, kmax), n_local - 1, dtype=np.int32)
                    pc = np.zeros((ndev, kmax), dtype=np.int32)
                    pv = np.zeros((ndev, kmax), dtype=data.dtype)
                    for d, (r_, c_, v_) in enumerate(triples):
                        pr[d, : len(r_)] = r_
                        pc[d, : len(c_)] = c_
                        pv[d, : len(v_)] = v_
                    return pr, pc, pv

                rl, cl, vl = pad_part(parts["l"])
                rr, cr, vr = pad_part(parts["r"])
                rowwise = NamedSharding(mesh, P(ROWS, None))
                arrs = tuple(
                    jax.device_put(jnp.asarray(a), rowwise)
                    for a in (rl, cl, vl, rr, cr, vr)
                ) + (
                    jax.device_put(
                        jnp.asarray(send_idx_np),
                        NamedSharding(mesh, P(ROWS, None, None)),
                    ),
                )
                return cls(arrs, shape, mesh, mode="footprint")
        elif mode == "auto":
            mode = "all"

        rowwise = NamedSharding(mesh, P(ROWS, None))
        return cls(
            tuple(
                jax.device_put(jnp.asarray(a), rowwise)
                for a in (rows, cols, vals)
            ),
            shape,
            mesh,
            mode="all",
        )

    @property
    def nnz(self):
        if self.mode == "footprint":
            return int(self.arrs[2].size + self.arrs[5].size)
        return int(self.data.size)

    @property
    def footprint_elems(self):
        """Per-device per-round receive size (0 on the all_gather path)."""
        return 0 if self.send_idx is None else int(self.send_idx.shape[-1])

    def matvec(self, x):
        from jax.sharding import PartitionSpec as P

        ndev = self.mesh.devices.size
        n_local = self.shape[0] // ndev
        axis = self._axis

        if self.mode == "footprint":
            perms = [
                [(s, (s + r) % ndev) for s in range(ndev)]
                for r in range(1, ndev)
            ]

            def local_mv(rl, cl, vl, rr, cr, vr, send_tbl, x_shard):
                me = jax.lax.axis_index(axis)
                # Issue all permute rounds first; the LOCAL segment_sum
                # below has no data dependency on them, so the compiler
                # is free to overlap the communication with it.
                recvs = []
                for r in range(1, ndev):
                    dest = (me + r) % ndev
                    idx = jax.lax.dynamic_index_in_dim(
                        send_tbl[0], dest, keepdims=False
                    )
                    recvs.append(
                        jax.lax.ppermute(x_shard[idx], axis, perms[r - 1])
                    )
                y = jax.ops.segment_sum(
                    vl[0] * x_shard[cl[0]], rl[0], num_segments=n_local,
                    indices_are_sorted=True,
                )
                x_rem = jnp.concatenate(recvs)
                y = y + jax.ops.segment_sum(
                    vr[0] * x_rem[cr[0]], rr[0], num_segments=n_local,
                    indices_are_sorted=True,
                )
                return y

            return jax.shard_map(
                local_mv,
                mesh=self.mesh,
                in_specs=(
                    P(axis, None), P(axis, None), P(axis, None),
                    P(axis, None), P(axis, None), P(axis, None),
                    P(axis, None, None), P(axis),
                ),
                out_specs=P(axis),
            )(*self.arrs, x)

        def local_mv(rows, cols, data, x_shard):
            x_full = jax.lax.all_gather(x_shard, axis, axis=0, tiled=True)
            prods = data[0] * x_full[cols[0]]
            return jax.ops.segment_sum(
                prods, rows[0], num_segments=n_local, indices_are_sorted=True
            )

        return jax.shard_map(
            local_mv,
            mesh=self.mesh,
            in_specs=(P(axis, None), P(axis, None), P(axis, None), P(axis)),
            out_specs=P(axis),
        )(*self.arrs, x)

    def tree_flatten(self):
        return (self.arrs,), (
            self.shape,
            self.mesh,
            self.mode,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        (obj.arrs,) = children
        obj.shape, obj.mesh, obj.mode = aux
        obj.dtype = getattr(obj.arrs[2], "dtype", None)
        from ..parallel.mesh import ROWS

        obj._axis = ROWS
        return obj


def csr_to_ell(indptr, indices, data, shape, dtype=None):
    """Convert CSR arrays to the padded ELL layout (host-side)."""
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    data = np.asarray(data)
    n = shape[0]
    row_nnz = np.diff(indptr)
    K = max(1, int(row_nnz.max()))
    ell_data = np.zeros((n, K), dtype=dtype or data.dtype)
    ell_cols = np.zeros((n, K), dtype=np.int32)
    for i in range(n):
        lo, hi = indptr[i], indptr[i + 1]
        ell_data[i, : hi - lo] = data[lo:hi]
        ell_cols[i, : hi - lo] = indices[lo:hi]
    return EllOperator(ell_data, ell_cols, shape)


@register_pytree_node_class
class FunctionOperator(LinearOperator):
    """Wrap an arbitrary jit-traceable callable y = f(x) as an operator.
    The callable is static structure; any arrays it closes over are baked
    into the jit cache (pass them via a custom operator if they change)."""

    def __init__(self, f, n, dtype):
        self.f = f
        self.shape = (n, n)
        self.dtype = np.dtype(dtype)

    def matvec(self, x):
        return self.f(x)

    def tree_flatten(self):
        return (), (self.f, self.shape[0], self.dtype)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*aux)


@register_pytree_node_class
class ShiftInvertDenseOperator(LinearOperator):
    """Shift-invert spectral transform x -> (A - sigma*I)^{-1} x for a
    dense A, via a precomputed LU factorization (two triangular solves per
    matvec).  Eigenvalues transform as theta = 1 / (lambda - sigma); use
    `which='LM'` and map back lambda = sigma + 1/theta
    (ref: docs/src/index.md:234-303 shift-invert recipe).
    """

    def __init__(self, lu, piv, sigma, shape):
        self.lu = lu
        self.piv = piv
        self.sigma = sigma
        self.shape = tuple(shape)
        self.dtype = lu.dtype

    @classmethod
    def build(cls, A, sigma):
        A = jnp.asarray(A)
        dtype = jnp.result_type(A.dtype, type(sigma))
        n = A.shape[0]
        B = A.astype(dtype) - sigma * jnp.eye(n, dtype=dtype)
        lu, piv = jax.scipy.linalg.lu_factor(B)
        return cls(lu, piv, sigma, A.shape)

    def matvec(self, x):
        return jax.scipy.linalg.lu_solve((self.lu, self.piv), x)

    def matvec_cost_hint(self):
        # Two dense triangular solves stream the n x n LU factors once.
        n = self.shape[0]
        return 2.0 * n * n * np.dtype(self.dtype).itemsize / _NOMINAL_BYTES_PER_S

    def tree_flatten(self):
        return (self.lu, self.piv, self.sigma), (self.shape, self.dtype)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.lu, obj.piv, obj.sigma = children
        obj.shape, obj.dtype = aux
        return obj


@register_pytree_node_class
class TridiagonalShiftInvertOperator(LinearOperator):
    """Shift-invert transform x -> (A - sigma*I)^{-1} x for a *tridiagonal*
    A, via a host-precomputed pivoted LU whose two triangular solves run on
    device as log-depth `associative_scan`s (ops/tridiag.py) — the sparse
    factorization + ldiv! shift-invert of the reference's docs
    (docs/src/index.md:234-303) and benchmark (bench/partial_schur.jl:37-52).

    Eigenvalues transform as theta = 1/(lambda - sigma): solve with
    which='LM', map back lambda = sigma + 1/theta.

    `refine=True` (default when the solve dtype is narrower than float64)
    wraps each solve in one step of iterative refinement: the residual is
    recomputed from the shifted bands held in the *solve* dtype, so the
    step drives the error down to that dtype's representation floor
    (it cannot go beyond it — see docs/transforms.md), recovering most of
    the accuracy an f32 factorization loses for ~2x solve cost.
    """

    def __init__(self, factors, bands, sigma, shape, dtype, refine):
        self.factors = factors  # (l, swap, d0, du1, du2) device arrays
        self.bands = bands  # (dl, d, du) of A - sigma*I, length-n padded
        self.sigma = sigma
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.refine = bool(refine)

    @classmethod
    def build(cls, dl, d, du, sigma=0.0, dtype=None, refine=None):
        """Factorize A - sigma*I on host (float64, once) from the
        tridiagonal bands dl (n-1), d (n), du (n-1)."""
        from ..ops.tridiag import factor_tridiagonal

        d = np.asarray(d)
        n = d.shape[0]
        if dtype is None:
            # Promote across all bands AND the shift: a complex sigma (or
            # complex bands with a real diagonal) must yield complex
            # factors, matching ShiftInvertDenseOperator.build.
            dtype = np.result_type(
                d.dtype,
                np.asarray(dl).dtype,
                np.asarray(du).dtype,
                type(sigma),
                np.float32,
            )
        dtype = np.dtype(dtype)
        if refine is None:
            refine = np.finfo(dtype).eps > np.finfo(np.float64).eps
        ds = d.astype(np.promote_types(d.dtype, np.float64)) - sigma
        fac = factor_tridiagonal(dl, ds, du)
        factors = tuple(
            jnp.asarray(a) if a.dtype == bool else jnp.asarray(a, dtype=dtype)
            for a in fac.arrays()
        )
        pad = np.zeros(1, dtype=ds.dtype)
        bands = tuple(
            jnp.asarray(a, dtype=dtype)
            for a in (
                np.concatenate([np.asarray(dl, ds.dtype), pad]),
                ds,
                np.concatenate([np.asarray(du, ds.dtype), pad]),
            )
        )
        return cls(factors, bands, sigma, (n, n), dtype, refine)

    @classmethod
    def from_operator(cls, op, sigma=0.0, dtype=None, refine=None):
        """Build from a DiaOperator whose offsets are within {-1, 0, 1} —
        or a SplitComplexOperator over two such parts (what
        `dia_from_diagonals` returns for complex values): the parts are
        recombined into complex bands for the host factorization, the
        CPU/oracle complex shift-invert workflow."""
        if isinstance(op, SplitComplexOperator):
            parts = [p for p in (op.re, op.im) if p is not None]
            if not all(isinstance(p, DiaOperator) for p in parts):
                raise TypeError(
                    "from_operator expects DiaOperator split-complex parts"
                )
            offsets = sorted(
                {int(o) for p in parts for o in p.offsets}
            )
            if not set(offsets) <= {-1, 0, 1}:
                raise ValueError("operator is not tridiagonal")
            n = op.shape[0]
            bands = {o: np.zeros(n, dtype=np.complex128) for o in (-1, 0, 1)}
            for part, unit in ((op.re, 1.0), (op.im, 1.0j)):
                if part is None:
                    continue
                for i, o in enumerate(part.offsets):
                    bands[int(o)] += unit * np.asarray(part.diags[i])
            # Same DIA storage convention as the plain branch below:
            # entry j of offset -1 multiplies x[j-1] on row j.
            return cls.build(
                bands[-1][1:], bands[0], bands[1][:-1],
                sigma=sigma,
                dtype=dtype or (
                    np.complex64
                    if op.word_dtype == jnp.dtype("float32")
                    else np.complex128
                ),
                refine=refine,
            )
        if not isinstance(op, DiaOperator):
            raise TypeError("from_operator expects a DiaOperator")
        if not set(int(o) for o in op.offsets) <= {-1, 0, 1}:
            raise ValueError("operator is not tridiagonal")
        n = op.shape[0]
        diags = {int(o): np.asarray(op.diags[i]) for i, o in enumerate(op.offsets)}
        zero = np.zeros(n, dtype=np.dtype(op.diags.dtype))
        # DiaOperator stores diag k at positions max(0,-k)..; entry j of
        # offset -1 multiplies x[j-1] on row j -> dl[j-1] = diags[-1][j].
        dl = diags.get(-1, zero)[1:]
        d = diags.get(0, zero)
        du = diags.get(1, zero)[:-1]
        return cls.build(dl, d, du, sigma=sigma, dtype=dtype, refine=refine)

    def _shifted_matvec(self, x):
        dl, d, du = self.bands
        lower = jnp.concatenate([x[:1] * 0, dl[:-1] * x[:-1]])
        upper = jnp.concatenate([du[:-1] * x[1:], x[:1] * 0])
        return d * x + lower + upper

    def matvec(self, b):
        from ..ops.tridiag import tridiag_lu_solve

        x = tridiag_lu_solve(*self.factors, b)
        if not self.refine:
            return x
        # One iterative-refinement step (static structure: each variant
        # compiles once).  The residual matvec is 5 fused axpys.
        r = b - self._shifted_matvec(x)
        return x + tridiag_lu_solve(*self.factors, r)

    def tree_flatten(self):
        return (self.factors, self.bands, self.sigma), (
            self.shape,
            self.dtype,
            self.refine,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.factors, obj.bands, obj.sigma = children
        obj.shape, obj.dtype, obj.refine = aux
        return obj


@register_pytree_node_class
class SplitComplexDenseOperator(LinearOperator):
    """Complex dense matrix held as a REAL (Ar, Ai) pair — the operator
    form of the explicit split-complex path (partial_schur's
    split_complex=True; ops/sc_expansion.py has the solver side).

    `matvec_sc(xr, xi) -> (yr, yi)` computes A @ (xr + i*xi) with four
    real matvecs; `matvec` takes and returns complex vectors."""

    def __init__(self, A, word_dtype=jnp.float32):
        A = np.asarray(A)
        self.Ar = jnp.asarray(A.real, dtype=word_dtype)
        self.Ai = jnp.asarray(A.imag, dtype=word_dtype)
        self.shape = A.shape
        # The SOLVER dtype is complex (drives the host dense layer and
        # target semantics); the device words are real.
        self.dtype = jnp.dtype(
            "complex64" if jnp.dtype(word_dtype) == jnp.float32 else "complex128"
        )
        self.word_dtype = jnp.dtype(word_dtype)

    def matvec_sc(self, xr, xi):
        prec = jax.lax.Precision.HIGHEST
        yr = jnp.matmul(self.Ar, xr, precision=prec) - jnp.matmul(
            self.Ai, xi, precision=prec
        )
        yi = jnp.matmul(self.Ar, xi, precision=prec) + jnp.matmul(
            self.Ai, xr, precision=prec
        )
        return yr, yi

    def matvec(self, x):
        yr, yi = self.matvec_sc(jnp.real(x).astype(self.word_dtype),
                                jnp.imag(x).astype(self.word_dtype))
        return yr + 1j * yi

    def matvec_cost_hint(self):
        n = self.shape[0]
        return 4.0 * n * n * self.word_dtype.itemsize / _NOMINAL_BYTES_PER_S

    def tree_flatten(self):
        return (self.Ar, self.Ai), (self.shape, self.dtype, self.word_dtype)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.Ar, obj.Ai = children
        obj.shape, obj.dtype, obj.word_dtype = aux
        return obj


@register_pytree_node_class
class SplitComplexOperator(LinearOperator):
    """Complex sparse / matrix-free operator held as TWO REAL operators,
    A = re + i*im.

    The reference handles complex sparse matrices through the same
    `mul!` contract as everything else (run.jl:21-23, expansion.jl:121).
    Here the parts are real operators of ANY format (Dia, Stencil5, Csr,
    Sell, Bsr, Ell, FunctionOperator ...).  `matvec` (complex in/out)
    serves the native complex solve; `matvec_sc(xr, xi) -> (yr, yi)` —
    four real matvecs, two when the matrix is purely real or purely
    imaginary — serves the explicit split_complex=True path
    (ops/sc_expansion.py).  Either part may be None (zero part).
    """

    def __init__(self, re_op=None, im_op=None):
        if re_op is None and im_op is None:
            raise ValueError("need at least one of re_op / im_op")
        if re_op is not None and im_op is not None:
            # Catch mismatched parts here, not as an opaque XLA shape (or
            # silent-promotion) error deep inside a matvec_sc dispatch.
            if tuple(re_op.shape) != tuple(im_op.shape):
                raise ValueError(
                    "re/im parts disagree in shape: "
                    f"{tuple(re_op.shape)} vs {tuple(im_op.shape)}"
                )
            if jnp.dtype(re_op.dtype) != jnp.dtype(im_op.dtype):
                raise ValueError(
                    "re/im parts disagree in word dtype: "
                    f"{jnp.dtype(re_op.dtype)} vs {jnp.dtype(im_op.dtype)}"
                )
        self.re = re_op
        self.im = im_op
        some = re_op if re_op is not None else im_op
        self.shape = tuple(some.shape)
        word = jnp.dtype(some.dtype)
        if jnp.issubdtype(word, jnp.complexfloating):
            raise ValueError("the re/im parts must be REAL operators")
        self.dtype = jnp.dtype(
            "complex64" if word == jnp.dtype("float32") else "complex128"
        )
        self.word_dtype = word

    @property
    def nnz(self):
        return sum(
            int(o.nnz) for o in (self.re, self.im) if o is not None
        )

    def matvec_sc(self, xr, xi):
        """(yr, yi) = A @ (xr + i*xi):
        yr = Re(A) xr - Im(A) xi,  yi = Re(A) xi + Im(A) xr."""
        yr = yi = None
        if self.re is not None:
            yr, yi = self.re.matvec(xr), self.re.matvec(xi)
        if self.im is not None:
            tr, ti = self.im.matvec(xi), self.im.matvec(xr)
            yr = -tr if yr is None else yr - tr
            yi = ti if yi is None else yi + ti
        return yr, yi

    def matvec(self, x):
        yr, yi = self.matvec_sc(
            jnp.real(x).astype(self.word_dtype),
            jnp.imag(x).astype(self.word_dtype),
        )
        return yr + 1j * yi

    def matvec_cost_hint(self):
        return 2.0 * sum(
            o.matvec_cost_hint() for o in (self.re, self.im)
            if o is not None
        )

    def _map_parts(self, f):
        return SplitComplexOperator(
            f(self.re) if self.re is not None else None,
            f(self.im) if self.im is not None else None,
        )

    def to_sell(self):
        return self._map_parts(lambda o: o.to_sell())

    def to_ell(self):
        return self._map_parts(lambda o: o.to_ell())

    def tree_flatten(self):
        return (self.re, self.im), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.re, obj.im = children
        some = obj.re if obj.re is not None else obj.im
        obj.shape = tuple(getattr(some, "shape", (0, 0)))
        word = jnp.dtype(getattr(some, "dtype", jnp.float32))
        obj.word_dtype = word
        obj.dtype = jnp.dtype(
            "complex64" if word == jnp.dtype("float32") else "complex128"
        )
        return obj


def pick_sparse_format(indptr, indices, shape, block_size=128):
    """Choose a sparse layout for a CSR sparsity pattern:

      dia   banded: no gather at all, one streaming pass — accepted when
            <= 32 distinct diagonals cover the pattern with <= 4x
            storage fill;
      bsr   clustered: the einsum streams dense block data once —
            accepted when 128x128 blocking fills <= 16x and the block
            data stays under ~2 GB;
      sell  everything else: bucketed ELL, gather-bound, with no scatter.

    The thresholds predate any GPU measurement; re-setting them from
    per-format rates on the card is an open item (docs/sparse.md).

    Returns (format_name, info_dict).  Pattern analysis is host-side
    numpy over the index arrays only (no matrix data touched).
    """
    n = int(shape[0])
    indptr = np.asarray(indptr)
    indices = np.asarray(indices, dtype=np.int64)
    nnz = int(indices.size)
    if nnz == 0:
        return "sell", {"reason": "empty"}
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    ndiag = int(np.unique(indices - rows).size)
    if ndiag <= 32 and ndiag * n <= 4 * nnz:
        return "dia", {"ndiag": ndiag}
    B = int(block_size)
    nb = -(-n // B)
    nblocks = int(np.unique((rows // B) * nb + indices // B).size)
    fill = nblocks * B * B / nnz
    if fill <= 16 and nblocks * B * B * 8 <= (2 << 30):
        return "bsr", {"fill": round(float(fill), 2)}
    return "sell", {"bsr_fill": round(float(fill), 2)}


def csr_to_dia(indptr, indices, data, shape):
    """Exact DIA repack of a canonical CSR triple (unique, sorted column
    indices per row — scipy's tocsr() guarantees this)."""
    n = int(shape[0])
    indptr = np.asarray(indptr)
    indices = np.asarray(indices, dtype=np.int64)
    data = np.asarray(data)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    offs, inv = np.unique(indices - rows, return_inverse=True)
    diags = np.zeros((offs.size, n), dtype=data.dtype)
    diags[inv, rows] = data
    return DiaOperator(diags, [int(o) for o in offs], shape)


def _format_csr(csr_op, sparse_format, block_size=128):
    """Apply the requested (or auto-selected) sparse layout to a freshly
    built CsrOperator."""
    if sparse_format == "csr":
        return csr_op
    fmt = sparse_format
    if sparse_format in (None, "auto"):
        fmt, info = pick_sparse_format(
            np.asarray(csr_op.indptr), np.asarray(csr_op.indices),
            csr_op.shape, block_size,
        )
        _LOG.info(
            "as_operator: sparse format auto-selected -> %s %s "
            "(override with sparse_format=)", fmt, info,
        )
    if fmt == "dia":
        return csr_to_dia(
            np.asarray(csr_op.indptr), np.asarray(csr_op.indices),
            np.asarray(csr_op.data), csr_op.shape,
        )
    if fmt == "bsr":
        return csr_op.to_bsr(block_size)
    if fmt == "sell":
        return csr_op.to_sell()
    if fmt == "ell":
        return csr_op.to_ell()
    raise ValueError(
        f"unknown sparse_format {fmt!r}: expected one of "
        "'auto', 'csr', 'dia', 'bsr', 'sell', 'ell'"
    )


def as_operator(A, n=None, dtype=None, sparse_format="auto"):
    """Coerce A (operator, 2-D array, scipy.sparse matrix, or callable) to
    a LinearOperator.

    scipy.sparse inputs are repacked into a layout chosen from their
    sparsity pattern (`pick_sparse_format`: DIA for banded, BSR
    for clustered, SELL otherwise — the reference's sparse examples all
    start from SparseArrays matrices, test/schur_to_eigen.jl:7-12, and
    arrive here the same way via scipy).  `sparse_format` overrides:
    'csr' keeps the exact gather+segment_sum CSR path, or name a layout
    directly.  Integer/bool sparse data is promoted to float64 like the
    dense branch (vtype promotion, run.jl:9-12).
    """
    if isinstance(A, LinearOperator):
        return A
    # scipy.sparse duck-typing: anything exposing .tocsr() with CSR triple
    # attributes.  scipy is imported only by the caller, never here.
    if hasattr(A, "tocsr") and hasattr(A, "shape"):
        if A.shape[0] != A.shape[1]:
            raise ValueError(
                f"matrix is not square: dimensions are {tuple(A.shape)}"
            )
        csr = A.tocsr()
        if not getattr(csr, "has_canonical_format", True):
            # Duplicate (row, col) entries: the gather+segment_sum matvec
            # and the ELL/SELL/BSR repacks all SUM duplicates, but
            # csr_to_dia's scatter would keep only the last one — make the
            # triple canonical up front (on a copy: sum_duplicates mutates).
            csr = csr.copy()
            csr.sum_duplicates()
        data = np.asarray(csr.data)
        if np.issubdtype(data.dtype, np.integer) or np.issubdtype(
            data.dtype, np.bool_
        ):
            data = data.astype(np.float64)
        return _format_csr(
            CsrOperator(csr.indptr, csr.indices, data, csr.shape),
            sparse_format,
        )
    if callable(A) and not hasattr(A, "ndim"):
        if n is None or dtype is None:
            raise ValueError(
                "wrapping a callable requires the n= and dtype= keywords"
            )
        return FunctionOperator(A, n, dtype)
    arr = A if isinstance(A, jax.Array) else np.asarray(A)
    if arr.ndim != 2:
        raise ValueError("A must be a square 2-D array, operator, or callable")
    if arr.shape[0] != arr.shape[1]:
        raise ValueError(
            f"matrix is not square: dimensions are {tuple(arr.shape)}"
        )
    # vtype promotion: integer/bool matrices solve in floating point
    # (ref: run.jl:9-12).
    if np.issubdtype(arr.dtype, np.integer) or np.issubdtype(arr.dtype, np.bool_):
        arr = np.asarray(arr, dtype=np.float64)
    return DenseOperator(jnp.asarray(arr))
