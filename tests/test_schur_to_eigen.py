"""End-to-end: partial_schur + partial_eigen eigenpair residuals on seeded
sparse-ish matrices (ref: test/schur_to_eigen.jl): for several seeds and
dtypes, every eigenpair satisfies ||A v - lam v|| < tol * |lam|."""

import numpy as np
import jax.numpy as jnp
import pytest

from arnoldimethod_jax import partial_eigen, partial_schur


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_eigenpair_residuals(dtype, seed):
    rng = np.random.default_rng(seed)
    n = 100
    # diag(1..n) plus a sparse random perturbation (ref: spdiagm + sprand).
    A = np.diag(np.arange(1, n + 1)).astype(dtype)
    mask = rng.random((n, n)) < 0.05
    P = rng.standard_normal((n, n)) * mask
    if np.issubdtype(dtype, np.complexfloating):
        P = P + 1j * rng.standard_normal((n, n)) * mask
    A = A + P

    tol = 1e-10
    decomp, history = partial_schur(A, nev=6, tol=tol, seed=seed)
    assert history.converged

    vals, X = partial_eigen(decomp)
    X = np.asarray(X)
    for i in range(len(vals)):
        r = np.linalg.norm(A @ X[:, i] - vals[i] * X[:, i])
        assert r < 100 * tol * max(1.0, abs(vals[i]))


def test_conjugate_pairs_through_eigen():
    """Real nonsymmetric matrix with complex pairs: partial_eigen returns
    complex eigenpairs with small residuals."""
    rng = np.random.default_rng(11)
    n = 60
    A = rng.standard_normal((n, n))
    decomp, history = partial_schur(A, nev=6, which="LM", tol=1e-9)
    assert history.converged
    vals, X = partial_eigen(decomp)
    X = np.asarray(X)
    assert np.iscomplexobj(vals) or np.all(np.asarray(decomp.eigenvalues).imag == 0)
    for i in range(len(vals)):
        r = np.linalg.norm(A @ X[:, i] - vals[i] * X[:, i])
        assert r < 1e-6 * max(1.0, abs(vals[i]))


def test_hermitian_schur_vectors_are_eigenvectors():
    """For symmetric A the Schur form is already diagonal: R is diagonal
    and Q columns are eigenvectors (ref: eigvals.jl:72-81 note)."""
    rng = np.random.default_rng(12)
    A = rng.standard_normal((50, 50))
    A = (A + A.T) / 2
    decomp, history = partial_schur(A, nev=4, tol=1e-10)
    assert history.converged
    R = np.asarray(decomp.R)
    assert np.linalg.norm(R - np.diag(np.diag(R))) < 1e-7
