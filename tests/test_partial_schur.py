"""Integration tests for partial_schur, mirroring reference
test/partial_schur.jl: low-rank matrices with exact matvec counts, error
paths, eigenvector starts, non-dominant targets, repeated-eigenvalue
locking, the zero matrix, and warm restarts."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from arnoldimethod_jax import (
    ArnoldiWorkspace,
    partial_schur,
)
from arnoldimethod_jax.models.problems import laplacian_1d

EPS = np.finfo(np.float64).eps


def _dense(op_or_arr, n=None):
    if hasattr(op_or_arr, "matvec"):
        n = op_or_arr.shape[0]
        A = np.zeros((n, n), dtype=np.dtype(op_or_arr.dtype))
        for i in range(n):
            e = np.zeros(n, dtype=A.dtype)
            e[i] = 1
            A[:, i] = np.asarray(op_or_arr.matvec(jnp.asarray(e)))
        return A
    return np.asarray(op_or_arr)


def _residual(A, decomp):
    Q = np.asarray(decomp.Q)
    R = np.asarray(decomp.R)
    return np.linalg.norm(A @ Q - Q @ R)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_rank_3_matrix_breakdown(dtype):
    """Rank-3 10x10: converges in exactly 7 matvecs via the breakdown/
    reinitialization path; trailing eigenvalues ~ 0
    (ref: test/partial_schur.jl:6-27)."""
    rng = np.random.default_rng(1)
    W = rng.standard_normal((10, 3)).astype(dtype)
    if np.issubdtype(dtype, np.complexfloating):
        W = W + 1j * rng.standard_normal((10, 3))
    B = W @ W.conj().T

    decomp, history = partial_schur(B, nev=5, mindim=5, maxdim=7, tol=EPS)

    assert history.converged
    assert history.mvproducts == 7
    Q = np.asarray(decomp.Q)
    assert np.linalg.norm(Q.conj().T @ Q - np.eye(5)) < 1000 * EPS
    assert _residual(B, decomp) < 1000 * EPS * np.linalg.norm(B)
    assert np.linalg.norm(np.diag(np.asarray(decomp.R))[3:]) < 1000 * EPS * np.linalg.norm(B)


def test_full_spectrum_small_matrix():
    """3x3: full spectrum in exactly 3 matvecs (ref: :47-52)."""
    rng = np.random.default_rng(2)
    A = rng.standard_normal((3, 3))
    decomp, history = partial_schur(A)
    assert history.converged
    assert history.mvproducts == 3
    assert _residual(A, decomp) < 1e-12


def test_incorrect_input():
    rng = np.random.default_rng(3)
    A = rng.standard_normal((6, 6))
    with pytest.raises(ValueError):
        partial_schur(rng.standard_normal((4, 3)))
    with pytest.raises(ValueError):
        partial_schur(A, mindim=5, maxdim=3)
    with pytest.raises(ValueError):
        partial_schur(A, nev=5, mindim=3)
    with pytest.raises(ValueError):
        partial_schur(A, nev=5, maxdim=3)
    with pytest.raises(ValueError):
        partial_schur(A, nev=10)
    with pytest.raises(ValueError):
        partial_schur(A, nev=0)


@pytest.mark.slow
def test_integer_matrix_promotes():
    """Integer matrices solve in floating point (ref: :41-45, vtype)."""
    rng = np.random.default_rng(4)
    A = rng.integers(0, 2, size=(10, 10))
    decomp, history = partial_schur(A, nev=2, mindim=3, maxdim=8)
    assert np.asarray(decomp.Q).dtype == np.float64


def test_eigenvector_as_initial_vector():
    """Starting from an exact eigenvector is not problematic (ref: :65-76)."""
    rng = np.random.default_rng(5)
    A = rng.standard_normal((30, 30))
    A = A + A.T
    w, X = np.linalg.eigh(A)
    lam, x = w[-1], X[:, -1]

    decomp, history = partial_schur(A, v1=x, nev=2, tol=1e-8)
    assert history.converged
    assert _residual(A, decomp) < 1e-7
    assert abs(np.max(decomp.eigenvalues.real) - lam) < 1e-7


def test_target_non_dominant():
    """Dominant eigenvalues 50..53, but :SR targets the smallest real part
    (ref: :79-84)."""
    d = np.concatenate([np.arange(1, 10.05, 0.1), [50.0, 51.0, 52.0, 53.0]])
    A = np.diag(d)
    decomp, history = partial_schur(A, which="SR")
    assert np.all(decomp.eigenvalues.real <= 10.0)


def test_repeated_eigenvalues_locking():
    """Triple eigenvalue 10.0 at the target: locking/partitioning survives
    irregular convergence (ref: :86-106)."""
    d = np.concatenate([np.arange(1, 9.05, 0.1), [9.97, 9.98, 9.99, 10.0, 10.0, 10.0]])
    A = np.diag(d)
    decomp, history = partial_schur(A, nev=5, maxdim=20, tol=1e-12)
    assert history.converged
    Q = np.asarray(decomp.Q)
    assert np.linalg.norm(Q.T @ Q - np.eye(Q.shape[1])) < 100 * EPS
    assert _residual(A, decomp) < A.shape[0] * 1e-12 * np.linalg.norm(A, 1)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_zero_matrix(dtype):
    """Convergence uses <= (not <) and backward substitution handles the
    exactly singular diagonal (ref: :108-120)."""
    A = np.zeros((5, 5), dtype=dtype)
    decomp, history = partial_schur(A)
    assert history.converged
    assert history.mvproducts == 5
    assert history.nconverged == 5
    Q = np.asarray(decomp.Q)
    assert np.linalg.norm(Q.conj().T @ Q - np.eye(5)) < 100 * EPS
    assert _residual(A, decomp) == 0


def test_warm_start_continuation():
    """Compute 3 eigenvalues, then resume from the locked decomposition to
    find 5 at a different tolerance (ref: :122-138)."""
    rng = np.random.default_rng(7)
    A = rng.standard_normal((100, 100))

    ws = ArnoldiWorkspace(100, 20, dtype=jnp.float64)
    F, history = partial_schur(A, workspace=ws, nev=3, tol=1e-12)
    assert history.converged
    assert history.nconverged in (3, 4)
    assert _residual(A, F) < 1e-10

    F2, history2 = partial_schur(
        A, workspace=ws, nev=5, start_from=history.nconverged, tol=1e-8
    )
    assert history2.converged
    assert history2.nconverged in (5, 6)
    assert _residual(A, F2) < 1e-6
    # The warm start must cost fewer matvecs than from scratch.
    assert history2.mvproducts < history.mvproducts + 100


def test_readme_parity_laplacian():
    """The README example: 100x100 1-D Laplacian, nev=10, :SR, tol=1e-6.
    The reference needs 174 matvecs (RNG-dependent); we assert the same
    ballpark plus the documented residual quality (ref: readme.md:30-60,
    BASELINE.md)."""
    op = laplacian_1d(100)
    decomp, history = partial_schur(op, nev=10, which="SR", tol=1e-6)
    assert history.converged
    assert history.mvproducts < 300  # reference: 174

    A = _dense(op)
    assert _residual(A, decomp) < 1e-6
    exact = np.sort(2 - 2 * np.cos(np.pi * np.arange(1, 101) / 101))[:10]
    assert np.allclose(np.sort(decomp.eigenvalues.real), exact, atol=1e-6)


def test_tolerance_in_different_precision():
    """tol tighter than the dtype's sqrt(eps) still works: f64 Laplacian
    at tol=1e-10 (analogue of the BigFloat/Float64-tol test, ref: :29-39)."""
    op = laplacian_1d(100)
    decomp, history = partial_schur(op, nev=2, maxdim=30, mindim=10, tol=1e-10)
    assert history.converged
    A = _dense(op)
    assert _residual(A, decomp) < 100 * 1e-10


def test_purge_unlocks_displaced_eigenvalues():
    """A locked eigenvalue is later displaced by better candidates: the
    purge pass (driver purge < active) must unlock it and the final basis
    stay orthonormal.  The reference admits this path is under-covered
    (test/partial_schur.jl:96-99 TODO); this constructs it deterministically:
    a tight, slowly-surfacing cluster {11, 10.999} is given ~1e-12 weight in
    v1, so the isolated decoys 10.0/9.5/9.0 converge and lock as the
    provisional top-3 first; once the cluster's Ritz values surface they
    displace the locked 9.5/9.0 (ref: run.jl:341-353)."""
    n = 100
    d = np.concatenate([[11.0, 10.999, 10.0, 9.5, 9.0], np.linspace(1.0, 8.0, n - 5)])
    A = np.diag(d)
    v1 = np.ones(n)
    v1[0] = v1[1] = 1e-12
    decomp, history = partial_schur(A, v1=v1, nev=3, which="LM", tol=1e-8)
    assert history.purges > 0, "scenario did not exercise the purge path"
    assert history.converged
    got = np.sort(decomp.eigenvalues.real)[::-1][:3]
    assert np.allclose(got, [11.0, 10.999, 10.0], atol=1e-6)
    Q = np.asarray(decomp.Q)
    assert np.linalg.norm(Q.T @ Q - np.eye(Q.shape[1])) < 100 * EPS
    assert _residual(A, decomp) < 1e-6


def test_complex_targets_li_si():
    """LI/SI targets in complex arithmetic select the right eigenvalues."""
    rng = np.random.default_rng(8)
    d = rng.standard_normal(40) + 1j * np.arange(-20, 20)
    A = np.diag(d).astype(np.complex128)
    decomp, history = partial_schur(A, nev=3, which="LI", tol=1e-10)
    assert history.converged
    got = np.sort(decomp.eigenvalues.imag)[::-1][:3]
    want = np.sort(d.imag)[::-1][:3]
    assert np.allclose(got, want, atol=1e-8)


def test_nonnormal_schur_residual_honest():
    """Schur-coupling floor regression (round-4): on a highly non-normal
    operator (convection-diffusion past the oscillatory threshold), the
    per-Ritz criterion alone locks 2x2 blocks whose DISCARDED Schur
    coupling exceeds tol by orders of magnitude; the floor keeps the
    advertised ||A Q - Q R|| at tol level (validated against an f64
    ARPACK oracle: ours 2.4e-8 vs arpack 5.9e-6 at the same tol)."""
    from arnoldimethod_jax import partial_schur
    from arnoldimethod_jax.models.problems import convection_diffusion_2d

    nx = 32
    n = nx * nx
    op = convection_diffusion_2d(nx, peclet=4.0 * (nx + 1),
                                 dtype=np.float64, fmt="stencil")
    decomp, h = partial_schur(op, nev=10, which="LM", tol=1e-8, mindim=20,
                              maxdim=40, restarts=600, method="host")
    assert h.converged
    import jax.numpy as jnp
    Q = np.asarray(decomp.Q, np.float64)
    AQ = np.stack(
        [np.asarray(op.matvec(jnp.asarray(Q[:, j]))) for j in range(10)],
        axis=1,
    ).astype(np.float64)
    R = np.asarray(decomp.R)
    res = np.linalg.norm(AQ - Q @ R, axis=0)
    # complex pairs present (the non-normal regime) and residuals honest
    assert np.sum(decomp.eigenvalues.imag != 0) >= 2
    assert res.max() < 50 * 1e-8 * np.abs(decomp.eigenvalues).max()
