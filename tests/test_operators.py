"""Operator layer tests: DIA / ELL / dense matvec agreement on the model
problems, CSR conversion, the function-operator wrapper, and shift-invert."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from arnoldimethod_jax import partial_schur
from arnoldimethod_jax.models import (
    DenseOperator,
    FunctionOperator,
    ShiftInvertDenseOperator,
    as_operator,
    convection_diffusion_2d,
    csr_to_ell,
    dia_from_diagonals,
    laplacian_1d,
    laplacian_2d,
    tridiagonal,
)


def _to_dense(op):
    n = op.shape[0]
    A = np.zeros((n, n), dtype=np.dtype(op.dtype))
    for i in range(n):
        e = np.zeros(n, dtype=A.dtype)
        e[i] = 1
        A[:, i] = np.asarray(op.matvec(jnp.asarray(e)))
    return A


@pytest.mark.parametrize(
    "builder,args",
    [
        (laplacian_1d, (17,)),
        (tridiagonal, (12, -1.0, 2.0, -1.001)),
        (laplacian_2d, (5, 4)),
        (convection_diffusion_2d, (5, 4)),
    ],
)
def test_dia_ell_agree(builder, args):
    op_dia = builder(*args, fmt="dia")
    op_ell = builder(*args, fmt="ell")
    A_dia = _to_dense(op_dia)
    A_ell = _to_dense(op_ell)
    assert np.array_equal(A_dia, A_ell)


def test_laplacian_2d_structure():
    A = _to_dense(laplacian_2d(3, 3))
    # Row 4 (grid center) has all four neighbors.
    assert A[4, 4] == 4 and A[4, 3] == A[4, 5] == A[4, 1] == A[4, 7] == -1
    # Row 2 (end of first grid row) has no east neighbor.
    assert A[2, 3] == 0
    assert np.array_equal(A, A.T)


def test_convection_diffusion_nonsymmetric():
    A = _to_dense(convection_diffusion_2d(6, 6, peclet=50.0))
    assert not np.allclose(A, A.T)
    lams = np.linalg.eigvals(A)
    assert np.any(np.abs(lams.imag) > 1e-8)


def test_csr_to_ell():
    # 4x4 with irregular row lengths.
    indptr = np.array([0, 2, 3, 6, 6])
    indices = np.array([0, 2, 1, 0, 2, 3])
    data = np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    op = csr_to_ell(indptr, indices, data, (4, 4))
    A = _to_dense(op)
    want = np.array(
        [
            [1.0, 0, 2.0, 0],
            [0, 3.0, 0, 0],
            [4.0, 0, 5.0, 6.0],
            [0, 0, 0, 0],
        ]
    )
    assert np.array_equal(A, want)


def test_dia_from_diagonals():
    op = dia_from_diagonals({-2: 1.0, 0: 3.0, 1: np.arange(6, dtype=float)}, (6, 6))
    A = _to_dense(op)
    assert np.all(np.diag(A) == 3.0)
    assert np.all(np.diag(A, -2) == 1.0)
    assert np.allclose(np.diag(A, 1), np.arange(5))


def test_function_operator():
    n = 16
    d = jnp.arange(1.0, n + 1)
    op = FunctionOperator(lambda x: d * x, n, np.float64)
    decomp, history = partial_schur(op, nev=3, which="LM", tol=1e-10)
    assert history.converged
    assert np.allclose(
        np.sort(decomp.eigenvalues.real)[::-1][:3], [16.0, 15.0, 14.0], atol=1e-8
    )


def test_function_operator_requires_metadata():
    with pytest.raises(ValueError):
        as_operator(lambda x: x)


@pytest.mark.slow
def test_shift_invert_dense():
    """Shift-invert targeting interior eigenvalues: find the eigenvalues of
    the 1-D Laplacian closest to sigma via LM on (A - sigma I)^{-1}
    (ref: docs/src/index.md:234-303 recipe)."""
    n = 64
    op = laplacian_1d(n)
    A = _to_dense(op)
    sigma = 1.0
    si = ShiftInvertDenseOperator.build(A, sigma)
    decomp, history = partial_schur(si, nev=4, which="LM", tol=1e-9)
    assert history.converged
    # Map back: lambda = sigma + 1/theta.
    lams = sigma + 1.0 / decomp.eigenvalues.real
    exact = 2 - 2 * np.cos(np.pi * np.arange(1, n + 1) / (n + 1))
    nearest = exact[np.argsort(np.abs(exact - sigma))][:4]
    assert np.allclose(np.sort(lams), np.sort(nearest), atol=1e-7)


@pytest.mark.slow
def test_csr_operator_matvec_and_solve():
    """First-class CSR: exact matvec on irregular row lengths (incl. an
    empty row), ELL round-trip, and end-to-end partial_schur."""
    from arnoldimethod_jax import CsrOperator

    rng = np.random.default_rng(3)
    n = 40
    A = np.zeros((n, n))
    for i in range(n):
        A[i, i] = i + 1.0
        for j in rng.choice(n, size=rng.integers(0, 6), replace=False):
            A[i, j] += rng.standard_normal() * 0.01
    A[7, :] = 0.0  # empty row exercises the zero-length segment
    import scipy.sparse as sp

    S = sp.csr_matrix(A)
    op = CsrOperator(S.indptr, S.indices, S.data, S.shape)
    assert op.nnz == S.nnz
    x = rng.standard_normal(n)
    np.testing.assert_allclose(
        np.asarray(op.matvec(jnp.asarray(x))), A @ x, rtol=1e-12
    )
    ell = op.to_ell()
    np.testing.assert_allclose(
        np.asarray(ell.matvec(jnp.asarray(x))), A @ x, rtol=1e-12
    )

    decomp, history = partial_schur(op, nev=4, which="LM", tol=1e-9)
    assert history.converged
    lam = np.sort(np.asarray(decomp.eigenvalues.real))
    expect = np.sort(np.linalg.eigvals(A).real)[-4:]
    np.testing.assert_allclose(lam, expect, rtol=1e-6)


def test_as_operator_scipy_sparse():
    """scipy.sparse matrices coerce straight to CsrOperator — the drop-in
    path for the reference's sprand examples (test/schur_to_eigen.jl:7-12)."""
    import scipy.sparse as sp

    from arnoldimethod_jax import CsrOperator, partial_eigen

    rng = np.random.default_rng(5)
    n = 100
    # spdiagm(0 => 1:100) + 0.1*sprand(100, 100, 5/100), like the reference.
    S = sp.diags(np.arange(1, n + 1.0)).tocsr() + 0.1 * sp.random(
        n, n, density=0.05, random_state=rng, format="csr"
    )
    # Auto format selection: this scattered pattern picks SELL (1.6x the
    # CSR gather path, docs/sparse.md); sparse_format="csr" keeps CSR.
    from arnoldimethod_jax.models.operators import SellOperator

    op = as_operator(S)
    assert isinstance(op, SellOperator)
    assert op.shape == (n, n)
    op_csr = as_operator(S, sparse_format="csr")
    assert isinstance(op_csr, CsrOperator)
    xc = np.random.default_rng(9).standard_normal(n)
    np.testing.assert_allclose(
        np.asarray(op_csr.matvec(jnp.asarray(xc))), S @ xc, rtol=1e-12
    )
    x = rng.standard_normal(n)
    np.testing.assert_allclose(
        np.asarray(op.matvec(jnp.asarray(x))), S @ x, rtol=1e-12
    )

    # partial_schur accepts the scipy matrix directly.
    decomp, history = partial_schur(S, nev=6, which="LM", tol=1e-8)
    assert history.converged
    vals, vecs = partial_eigen(decomp)
    A = S.toarray()
    for k in range(len(vals)):
        r = np.linalg.norm(A @ np.asarray(vecs)[:, k] - vals[k] * np.asarray(vecs)[:, k])
        assert r < 1e-6 * abs(vals[k])

    # Integer sparse data is vtype-promoted (run.jl:9-12).
    Si = sp.csr_matrix(np.diag(np.arange(1, 8)))
    opi = as_operator(Si)
    assert np.dtype(opi.dtype) == np.float64

    # Non-square raises.
    with pytest.raises(ValueError, match="not square"):
        as_operator(sp.random(6, 7, density=0.5, format="csr"))


@pytest.mark.slow
def test_as_operator_scipy_sparse_complex_cpu():
    """Complex sparse matrices run end-to-end natively (the reference
    supports any eltype incl. Complex, readme.md:63-69)."""
    import scipy.sparse as sp

    rng = np.random.default_rng(0)
    n = 60
    S = sp.diags(
        np.arange(1, n + 1).astype(np.complex128) * (1 + 0.5j)
    ).tocsr() + 0.1 * sp.random(
        n, n, density=0.05, random_state=rng, format="csr"
    ).astype(np.complex128)
    d, h = partial_schur(as_operator(S), nev=4, which="LM", tol=1e-9)
    assert h.converged
    A = S.toarray()
    Q, R = np.asarray(d.Q), np.asarray(d.R)
    assert np.linalg.norm(A @ Q - Q @ R) < 1e-6


@pytest.mark.slow
def test_sell_operator():
    """Bucketed ELL (SELL): exact matvec on power-law row lengths with
    empty rows, bounded padding, and end-to-end partial_schur agreement
    with the CSR path."""
    import scipy.sparse as sp

    from arnoldimethod_jax import CsrOperator
    from arnoldimethod_jax.models import SellOperator

    rng = np.random.default_rng(11)
    n = 300
    # Power-law row lengths: most rows short, a few with ~n/4 nonzeros.
    row_nnz = np.minimum(rng.zipf(1.6, size=n), n // 4)
    row_nnz[5] = 0  # empty row
    rows, cols = [], []
    for i, k in enumerate(row_nnz):
        rows.extend([i] * k)
        cols.extend(rng.choice(n, size=k, replace=False))
    vals = rng.standard_normal(len(rows)) * 0.05
    S = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    S = S + sp.diags(np.arange(1, n + 1.0))
    S = S.tocsr()

    csr = CsrOperator(S.indptr, S.indices, S.data, S.shape)
    sell = csr.to_sell()
    assert isinstance(sell, SellOperator)
    assert sell.nnz == S.nnz
    # Pow2 bucketing bounds stored slots by 2x the true nnz.
    assert sell.nnz_stored <= 2 * S.nnz + n

    x = rng.standard_normal(n)
    y_ref = S @ x
    np.testing.assert_allclose(
        np.asarray(sell.matvec(jnp.asarray(x))), y_ref, rtol=1e-12, atol=1e-12
    )
    # jit-traceable as a pytree argument.
    y_jit = jax.jit(lambda op, v: op.matvec(v))(sell, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y_jit), y_ref, rtol=1e-12, atol=1e-12)

    decomp, history = partial_schur(sell, nev=4, which="LM", tol=1e-9)
    assert history.converged
    lam = np.sort(np.asarray(decomp.eigenvalues.real))
    expect = np.sort(np.linalg.eigvals(S.toarray()).real)[-4:]
    np.testing.assert_allclose(lam, expect, rtol=1e-7)


def test_matmat_matches_matvec_csr_sell():
    """Block SpMM fast paths (K-amortized row gathers) agree with K
    separate matvecs for CSR and SELL."""
    import jax.numpy as jnp
    from arnoldimethod_jax.models.operators import CsrOperator

    rng = np.random.default_rng(3)
    n, K = 96, 5
    density = 0.07
    A = (rng.random((n, n)) < density) * rng.standard_normal((n, n))
    import scipy.sparse as sp  # noqa: F401 -- if absent, build CSR by hand
    indptr = np.zeros(n + 1, np.int64)
    cols, vals = [], []
    for i in range(n):
        nz = np.nonzero(A[i])[0]
        indptr[i + 1] = indptr[i] + len(nz)
        cols.append(nz)
        vals.append(A[i, nz])
    cols = np.concatenate(cols).astype(np.int32)
    vals = np.concatenate(vals).astype(np.float32)
    op = CsrOperator(indptr, cols, vals, (n, n))
    X = jnp.asarray(rng.standard_normal((n, K)), jnp.float32)

    ref = np.stack(
        [np.asarray(op.matvec(X[:, j])) for j in range(K)], axis=1
    )
    got_csr = np.asarray(op.matmat(X))
    got_sell = np.asarray(op.to_sell().matmat(X))
    assert np.allclose(got_csr, ref, atol=1e-5)
    assert np.allclose(got_sell, ref, atol=1e-5)


def test_matmat_default_path():
    """LinearOperator.matmat default (lax.map) on a stencil operator."""
    import jax.numpy as jnp
    from arnoldimethod_jax.models.operators import Stencil5Operator

    op = Stencil5Operator((4.0, -1.0, -1.0, -1.0, -1.0), (8, 8),
                          dtype=jnp.float32)
    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.standard_normal((64, 3)), jnp.float32)
    ref = np.stack([np.asarray(op.matvec(X[:, j])) for j in range(3)], axis=1)
    assert np.allclose(np.asarray(op.matmat(X)), ref, atol=1e-5)


def test_pick_sparse_format_hierarchy():
    """pick_sparse_format follows the measured roofline hierarchy
    (docs/sparse.md): DIA for banded, BSR for clustered, SELL for
    scattered patterns."""
    import scipy.sparse as sp

    from arnoldimethod_jax.models.operators import pick_sparse_format

    # Banded: tridiagonal -> dia.
    n = 512
    T = sp.diags([np.ones(n - 1), 2 * np.ones(n), np.ones(n - 1)],
                 [-1, 0, 1]).tocsr()
    fmt, info = pick_sparse_format(T.indptr, T.indices, T.shape)
    assert fmt == "dia" and info["ndiag"] == 3

    # Clustered: a few dense 128x128 blocks -> bsr.
    rng = np.random.default_rng(0)
    A = np.zeros((512, 512))
    for i in range(0, 512, 128):
        A[i : i + 128, i : i + 128] = rng.standard_normal((128, 128))
    B = sp.csr_matrix(A)
    fmt, info = pick_sparse_format(B.indptr, B.indices, B.shape)
    assert fmt == "bsr" and info["fill"] <= 1.01

    # Scattered: sprand -> sell.
    S = sp.random(2048, 2048, density=0.002, random_state=1, format="csr")
    fmt, _ = pick_sparse_format(S.indptr, S.indices, S.shape)
    assert fmt == "sell"


def test_auto_format_solves_match_csr():
    """The auto-selected layout is exact: same spectrum as the forced-CSR
    solve for each pattern class."""
    import scipy.sparse as sp

    from arnoldimethod_jax import partial_schur
    from arnoldimethod_jax.models.operators import (
        DiaOperator,
        SellOperator,
        as_operator,
    )

    n = 120
    # Banded pattern -> DiaOperator, same eigenvalues.
    T = sp.diags(
        [np.full(n - 1, -1.0), np.arange(1.0, n + 1), np.full(n - 1, -1.0)],
        [-1, 0, 1],
    ).tocsr()
    op = as_operator(T)
    assert isinstance(op, DiaOperator)
    d0, h0 = partial_schur(T, nev=4, which="LM", tol=1e-9)
    d1, h1 = partial_schur(T, nev=4, which="LM", tol=1e-9,
                           sparse_format="csr")
    assert h0.converged and h1.converged
    np.testing.assert_allclose(
        np.sort(d0.eigenvalues.real), np.sort(d1.eigenvalues.real),
        atol=1e-8,
    )

    # Scattered pattern -> SellOperator, same eigenvalues.
    rng = np.random.default_rng(5)
    S = sp.diags(np.arange(1, n + 1.0)).tocsr() + 0.1 * sp.random(
        n, n, density=0.05, random_state=rng, format="csr"
    )
    assert isinstance(as_operator(S), SellOperator)
    d2, h2 = partial_schur(S, nev=4, which="LM", tol=1e-9)
    d3, h3 = partial_schur(S, nev=4, which="LM", tol=1e-9,
                           sparse_format="csr")
    assert h2.converged and h3.converged
    np.testing.assert_allclose(
        np.sort_complex(d2.eigenvalues), np.sort_complex(d3.eigenvalues),
        atol=1e-8,
    )


def test_csr_to_dia_exact():
    import scipy.sparse as sp

    from arnoldimethod_jax.models.operators import csr_to_dia

    n = 40
    T = sp.diags(
        [np.arange(1.0, n - 1), 2 * np.ones(n), np.full(n - 3, -0.5)],
        [-2, 0, 3],
    ).tocsr()
    op = csr_to_dia(T.indptr, T.indices, T.data, T.shape)
    x = np.random.default_rng(2).standard_normal(n)
    np.testing.assert_allclose(
        np.asarray(op.matvec(jnp.asarray(x))), T @ x, rtol=1e-12
    )


def test_dia_from_diagonals_complex_float32_words():
    """Regression: complex values with a REAL float32 dtype request must
    give float32 split words, not silently fall back to
    float64/complex128."""
    vals = np.array([1 + 2j, 3 - 1j, 0.5j, 2.0], dtype=np.complex128)
    op = dia_from_diagonals({0: vals}, (4, 4), dtype=np.float32)
    assert op.re.diags.dtype == np.float32
    assert op.im.diags.dtype == np.float32
    x = np.arange(1.0, 5.0)
    y = np.asarray(op.re.matvec(x)) + 1j * np.asarray(op.im.matvec(x))
    np.testing.assert_allclose(y, vals * x, rtol=1e-6)


def test_as_operator_empty_sparse_matrix():
    """Regression: a zero-nonzero scipy matrix auto-routes to SELL, whose
    repack used to crash indexing the empty data array."""
    import scipy.sparse as sp

    A = sp.csr_matrix((16, 16))
    op = as_operator(A)
    y = np.asarray(op.matvec(jnp.ones(16)))
    np.testing.assert_array_equal(y, np.zeros(16))
    assert op.nnz == 0


def test_as_operator_sums_duplicate_entries_in_dia():
    """Regression: duplicate (row, col) COO entries must SUM in every
    layout — csr_to_dia's scatter kept only the last one."""
    import scipy.sparse as sp

    n = 32
    rows = np.r_[np.arange(n), np.arange(n), np.arange(1, n)]
    cols = np.r_[np.arange(n), np.arange(n), np.arange(n - 1)]
    vals = np.r_[np.full(n, 1.5), np.full(n, 0.5), np.full(n - 1, -1.0)]
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n))  # banded: 2, -1
    op = as_operator(A)  # auto -> DIA for this band
    x = np.arange(1.0, n + 1.0)
    y = np.asarray(op.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(y, A.tocsr() @ x, rtol=1e-12)

