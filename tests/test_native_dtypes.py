"""float64, complex64 and complex128 solves on the default path: the basis
stays in the operator's own dtype (no split-complex words, no double-word
pairs) and the answers match numpy."""

import numpy as np
import jax.numpy as jnp
import pytest

from arnoldimethod_jax import partial_eigen, partial_schur
from arnoldimethod_jax.models.operators import (
    CsrOperator,
    DenseOperator,
    SplitComplexOperator,
    as_operator,
    dia_from_diagonals,
)
from arnoldimethod_jax.models.problems import laplacian_1d


def test_float64_native_readme_config():
    """The README config in float64 at tol=1e-12: a float64 device basis
    and a residual at the float64 level."""
    n = 100
    decomp, history = partial_schur(
        laplacian_1d(n, dtype=np.float64), nev=10, which="SR", tol=1e-12
    )
    assert history.converged
    assert decomp.Q_rows.dtype == jnp.float64
    A = (np.diag(np.full(n, 2.0)) + np.diag(np.full(n - 1, -1.0), 1)
         + np.diag(np.full(n - 1, -1.0), -1))
    Q = np.asarray(decomp.Q)
    assert np.linalg.norm(A @ Q - Q @ decomp.R) < 1e-11


@pytest.mark.parametrize("dtype,tol", [(np.complex128, 1e-10),
                                       (np.complex64, 1e-5)])
def test_complex_dense_native(dtype, tol):
    """Complex dense input stays a DenseOperator (no split into real
    words) and the :LI eigenvalues match numpy's."""
    rng = np.random.default_rng(0)
    n = 120
    A = ((rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
         / np.sqrt(n)).astype(dtype)
    assert isinstance(as_operator(A), DenseOperator)
    decomp, history = partial_schur(A, nev=6, which="LI", tol=tol,
                                    mindim=16, maxdim=32, restarts=500)
    assert history.converged
    assert decomp.Q_rows.dtype == jnp.dtype(dtype)
    ref = np.linalg.eigvals(A.astype(np.complex128))
    ref = np.sort(ref[np.argsort(-ref.imag)][:6].imag)
    got = np.sort(decomp.eigenvalues.imag)
    np.testing.assert_allclose(got, ref, atol=100 * tol)
    vals, X = partial_eigen(decomp)
    X = np.asarray(X, np.complex128)
    resid = np.linalg.norm(A.astype(np.complex128) @ X - X * vals, axis=0)
    assert resid.max() < 100 * tol


def test_complex_sparse_native():
    """A complex scipy matrix becomes a complex CsrOperator-family
    operator (not a split pair) and solves natively."""
    sp = pytest.importorskip("scipy.sparse")
    rng = np.random.default_rng(3)
    n = 400
    d = rng.uniform(-1, 1, n) + 1j * rng.uniform(0, 1, n)
    planted = np.linspace(2.0, 2.5, 6)
    d[rng.choice(n, 6, replace=False)] = 1j * planted
    S = sp.diags([d, np.full(n - 1, 0.01), np.full(n - 1, 0.01j)],
                 [0, 1, -1]).tocsr()
    op = as_operator(S, sparse_format="csr")
    assert isinstance(op, CsrOperator)
    assert jnp.issubdtype(op.dtype, jnp.complexfloating)
    decomp, history = partial_schur(op, nev=4, which="LI", tol=1e-10,
                                    mindim=12, maxdim=24, restarts=500)
    assert history.converged
    assert jnp.issubdtype(decomp.Q_rows.dtype, jnp.complexfloating)
    ref = np.linalg.eigvals(S.toarray())
    ref = np.sort(ref[np.argsort(-ref.imag)][:4])
    got = np.sort(decomp.eigenvalues)
    np.testing.assert_allclose(got, ref, atol=1e-8)


def test_complex_dia_native_matches_split():
    """The complex DIA operator (a SplitComplexOperator) solves natively
    through its complex matvec and agrees with split_complex=True."""
    rng = np.random.default_rng(42)
    n = 2048
    z = rng.uniform(-1.0, 1.0, n) + 1j * rng.uniform(0.0, 1.0, n)
    z[rng.choice(n, 8, replace=False)] = 1j * np.linspace(2.0, 2.7, 8)
    op = dia_from_diagonals({0: z, 1: 0.01, -1: 0.01j}, (n, n),
                            dtype=np.complex128)
    assert isinstance(op, SplitComplexOperator)
    kw = dict(nev=6, which="LI", tol=1e-10, mindim=16, maxdim=32,
              restarts=500)
    d_nat, h_nat = partial_schur(op, **kw)
    d_sc, h_sc = partial_schur(op, split_complex=True, **kw)
    assert h_nat.converged and h_sc.converged
    assert d_nat.Q_rows.dtype == jnp.complex128
    np.testing.assert_allclose(np.sort(d_nat.eigenvalues),
                               np.sort(d_sc.eigenvalues), atol=1e-8)
