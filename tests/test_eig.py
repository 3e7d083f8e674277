"""Unit tests for quasi-triangular eigenvalue/eigenvector extraction
(dense/eig.py), mirroring reference test/collect_eigen.jl: eigenvectors
match LAPACK (numpy) up to phase, conjugate-pair blocks at the start and in
the middle, and eigenvalue extraction on subranges."""

import numpy as np
import pytest

from arnoldimethod_jax.dense import collect_eigen, copy_eigenvalues, eigenvalues
from utils import realimag_sort


def _compare_with_numpy(R):
    n = R.shape[1]
    w, V = np.linalg.eig(R)
    lams = eigenvalues(R)
    for j in range(n):
        x = np.zeros(n, dtype=complex)
        k = collect_eigen(x, R, j)
        lam = lams[j]
        # Find the numpy eigenpair closest to ours.
        idx = int(np.argmin(np.abs(w - lam)))
        ref = V[:, idx]
        # Compare up to phase.
        assert np.allclose(np.abs(x[:k]), np.abs(ref[:k]), atol=1e-8)
        assert np.linalg.norm(ref[k:]) < 1e-8
        # Residual check: R x = lam x.
        assert np.linalg.norm(R[:k, :k] @ x[:k] - lam * x[:k]) < 1e-10 * max(
            1, abs(lam)
        )


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_triangular_eigenvectors(dtype):
    rng = np.random.default_rng(5)
    R = np.triu(rng.standard_normal((12, 12))).astype(dtype)
    if np.issubdtype(dtype, np.complexfloating):
        R = R + 1j * np.triu(rng.standard_normal((12, 12)))
    _compare_with_numpy(R)


@pytest.mark.parametrize("pos", [0, 9])
def test_quasi_triangular_conjugate_pair(pos):
    """2x2 conjugate block at the first or last-but-one position
    (ref: test/collect_eigen.jl)."""
    rng = np.random.default_rng(6)
    n = 11
    R = np.triu(rng.standard_normal((n, n)))
    R[pos + 1, pos] = -2.0
    R[pos, pos + 1] = 3.0

    lams = eigenvalues(R)
    assert np.imag(lams[pos]) != 0
    assert np.isclose(lams[pos], np.conj(lams[pos + 1]))

    w = np.linalg.eigvals(R)
    x = np.zeros(n, dtype=complex)
    k = collect_eigen(x, R, pos)
    lam = lams[pos]
    assert np.linalg.norm(R[:k, :k] @ x[:k] - lam * x[:k]) < 1e-10
    assert abs(np.linalg.norm(x[:k]) - 1) < 1e-12
    assert np.min(np.abs(w - lam)) < 1e-10


def test_copy_eigenvalues_subrange():
    rng = np.random.default_rng(7)
    R = np.triu(rng.standard_normal((8, 8)))
    lams = np.zeros(8, dtype=complex)
    copy_eigenvalues(lams, R, 2, 6)
    assert np.allclose(lams[2:6], np.diag(R)[2:6])
    assert np.all(lams[:2] == 0) and np.all(lams[6:] == 0)


def test_exactly_singular_backward_sub():
    """Zero matrix: the sigma == 0 pivot path sets the component to zero
    instead of dividing (ref: eigenvector_uppertriangular.jl:29-31)."""
    R = np.zeros((4, 4))
    x = np.zeros(4, dtype=complex)
    k = collect_eigen(x, R, 2)
    assert k == 3
    assert np.isfinite(x[:k]).all()
    assert abs(np.linalg.norm(x[:k]) - 1) < 1e-14


def test_eigenvalues_match_numpy_quasi():
    rng = np.random.default_rng(8)
    R = np.triu(rng.standard_normal((10, 10)))
    R[4, 3] = -1.5
    R[3, 4] = 2.5
    assert np.allclose(
        realimag_sort(eigenvalues(R)), realimag_sort(np.linalg.eigvals(R))
    )
