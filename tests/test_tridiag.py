"""Tridiagonal pivoted-LU scan solver + shift-invert operator
(ops/tridiag.py, TridiagonalShiftInvertOperator).

Oracles: dense numpy solve, and the shift-invert eigenvalue map
lambda = sigma + 1/theta against numpy.linalg.eigvals (mirroring the
reference's shift-invert docs recipe, docs/src/index.md:234-303)."""

import numpy as np
import pytest

from arnoldimethod_jax import partial_schur
from arnoldimethod_jax.models.operators import (
    DiaOperator,
    TridiagonalShiftInvertOperator,
)
from arnoldimethod_jax.models.problems import tridiagonal
from arnoldimethod_jax.ops.tridiag import factor_tridiagonal, tridiag_lu_solve


def _dense(dl, d, du):
    n = len(d)
    A = np.diag(d).astype(np.promote_types(np.asarray(d).dtype, np.float64))
    A += np.diag(dl, -1) + np.diag(du, 1)
    return A


@pytest.mark.parametrize("n", [2, 3, 5, 64, 257])
def test_solve_matches_dense(n):
    rng = np.random.default_rng(n)
    dl = rng.standard_normal(n - 1)
    du = rng.standard_normal(n - 1)
    d = rng.standard_normal(n) * 0.1  # small diagonal => pivoting exercised
    A = _dense(dl, d, du)
    b = rng.standard_normal(n)

    fac = factor_tridiagonal(dl, d, du)
    assert fac.swap.any()  # the pivoting path is actually taken
    x = np.asarray(tridiag_lu_solve(*fac.arrays(), b))
    assert np.linalg.norm(A @ x - b) <= 1e-9 * np.linalg.norm(b) * np.linalg.cond(A)


def test_solve_n1():
    """1x1 system: the scan recurrences degenerate entirely (regression:
    the backward pass used to wrap yd[n-2] to yd[-1] and return length 2)."""
    fac = factor_tridiagonal(np.zeros(0), np.array([2.0]), np.zeros(0))
    x = np.asarray(tridiag_lu_solve(*fac.arrays(), np.array([4.0])))
    np.testing.assert_allclose(x, [2.0])


def test_complex_sigma_promotes_dtype():
    """A complex shift with real bands must produce complex factors
    (regression: the solve dtype used to follow d.dtype only, silently
    casting the complex LU to real)."""
    n = 40
    dl = np.full(n - 1, -1.0)
    d = np.full(n, 2.0)
    du = np.full(n - 1, -1.001)
    sigma = 0.5 + 0.3j
    op = TridiagonalShiftInvertOperator.build(dl, d, du, sigma=sigma)
    assert np.issubdtype(op.dtype, np.complexfloating)
    rng = np.random.default_rng(11)
    b = rng.standard_normal(n)
    x = np.asarray(op.matvec(b.astype(op.dtype)))
    A = _dense(dl, d, du).astype(complex) - sigma * np.eye(n)
    xs = np.linalg.solve(A, b)
    np.testing.assert_allclose(x, xs, rtol=1e-8, atol=1e-10)


def test_solve_no_pivoting_needed():
    n = 100
    dl = np.full(n - 1, -1.0)
    du = np.full(n - 1, -1.001)
    d = np.full(n, 4.0)  # strongly diagonally dominant: no swaps
    fac = factor_tridiagonal(dl, d, du)
    assert not fac.swap.any()
    b = np.linspace(-1, 1, n)
    x = np.asarray(tridiag_lu_solve(*fac.arrays(), b))
    xs = np.linalg.solve(_dense(dl, d, du), b)
    np.testing.assert_allclose(x, xs, rtol=1e-10, atol=1e-12)


def test_singular_shift_raises():
    n = 20
    d = np.arange(1.0, n + 1)
    z = np.zeros(n - 1)
    with pytest.raises(np.linalg.LinAlgError):
        # sigma = 3 is exactly an eigenvalue of diag(1..n)
        TridiagonalShiftInvertOperator.build(z, d, z, sigma=3.0)


def test_complex_solve():
    n = 50
    rng = np.random.default_rng(7)
    dl = rng.standard_normal(n - 1) + 1j * rng.standard_normal(n - 1)
    du = rng.standard_normal(n - 1) + 1j * rng.standard_normal(n - 1)
    d = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    fac = factor_tridiagonal(dl, d, du)
    x = np.asarray(tridiag_lu_solve(*fac.arrays(), b))
    xs = np.linalg.solve(_dense(dl, d, du).astype(complex), b)
    np.testing.assert_allclose(x, xs, rtol=1e-8, atol=1e-10)


@pytest.mark.slow
def test_shift_invert_eigenvalues():
    """nev eigenvalues nearest sigma of the reference bench matrix
    (bench/partial_schur.jl:9: n tridiagonal (-1, 2, -1.001)), via
    theta = 1/(lambda - sigma)."""
    n = 400
    sigma = 0.5
    dl = np.full(n - 1, -1.0)
    d = np.full(n, 2.0)
    du = np.full(n - 1, -1.001)
    op = TridiagonalShiftInvertOperator.build(dl, d, du, sigma=sigma)
    assert op.shape == (n, n)

    decomp, history = partial_schur(op, nev=6, which="LM", tol=1e-9)
    assert history.converged
    lams = sigma + 1.0 / np.asarray(decomp.eigenvalues)

    exact = np.linalg.eigvals(_dense(dl, d, du))
    nearest = exact[np.argsort(np.abs(exact - sigma))][:6]
    np.testing.assert_allclose(
        np.sort(lams.real), np.sort(nearest.real), rtol=1e-6
    )


def test_from_operator_extracts_bands():
    n = 64
    op = tridiagonal(n, -1.0, 2.0, -1.001, fmt="dia")
    assert isinstance(op, DiaOperator)
    si = TridiagonalShiftInvertOperator.from_operator(op, sigma=0.3)
    rng = np.random.default_rng(1)
    b = rng.standard_normal(n)
    A = _dense(np.full(n - 1, -1.0), np.full(n, 2.0), np.full(n - 1, -1.001))
    x = np.asarray(si.matvec(b))
    xs = np.linalg.solve(A - 0.3 * np.eye(n), b)
    np.testing.assert_allclose(x, xs, rtol=1e-8, atol=1e-10)


def test_refine_recovers_f32_accuracy():
    """With an f32 factorization, one refinement step should push the
    backward error well below plain-f32 solve error."""
    n = 512
    dl = np.full(n - 1, -1.0)
    d = np.full(n, 2.0)
    du = np.full(n - 1, -1.001)
    A = _dense(dl, d, du)
    rng = np.random.default_rng(3)
    b = rng.standard_normal(n)

    plain = TridiagonalShiftInvertOperator.build(
        dl, d, du, sigma=0.0, dtype=np.float32, refine=False
    )
    refined = TridiagonalShiftInvertOperator.build(
        dl, d, du, sigma=0.0, dtype=np.float32, refine=True
    )
    x0 = np.asarray(plain.matvec(b.astype(np.float32)), dtype=np.float64)
    x1 = np.asarray(refined.matvec(b.astype(np.float32)), dtype=np.float64)
    r0 = np.linalg.norm(A @ x0 - b)
    r1 = np.linalg.norm(A @ x1 - b)
    assert r1 < r0 / 5


def test_from_operator_split_complex_parts():
    """Regression: dia_from_diagonals returns a SplitComplexOperator for
    complex values, which used to be rejected here — silently removing the
    CPU complex tridiagonal shift-invert workflow.  from_operator now
    recombines the (re, im) DiaOperator parts into complex bands."""
    from arnoldimethod_jax.models.operators import (
        SplitComplexOperator,
        dia_from_diagonals,
    )

    n = 48
    rng = np.random.default_rng(7)
    d = rng.standard_normal(n) + 1j * rng.standard_normal(n) + 3.0
    dl = rng.standard_normal(n - 1) + 1j * rng.standard_normal(n - 1)
    du = rng.standard_normal(n - 1) + 1j * rng.standard_normal(n - 1)
    op = dia_from_diagonals(
        {-1: np.concatenate([[0.0], dl]),
         0: d,
         1: np.concatenate([du, [0.0]])},
        (n, n),
    )
    assert isinstance(op, SplitComplexOperator)
    sigma = 0.4 + 0.1j
    si = TridiagonalShiftInvertOperator.from_operator(op, sigma=sigma)
    A = _dense(dl, d, du)
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    x = np.asarray(si.matvec(b))
    xs = np.linalg.solve(A - sigma * np.eye(n), b)
    np.testing.assert_allclose(x, xs, rtol=1e-8, atol=1e-10)


def test_split_complex_rejects_mismatched_parts():
    """The (re, im) parts must agree in shape and word dtype — a mismatch
    fails at construction, not as an XLA shape error inside matvec_sc."""
    from arnoldimethod_jax.models.operators import SplitComplexOperator

    a = tridiagonal(8, -1.0, 2.0, -1.0, fmt="dia")
    b = tridiagonal(16, -1.0, 2.0, -1.0, fmt="dia")
    with pytest.raises(ValueError, match="shape"):
        SplitComplexOperator(a, b)
    c32 = DiaOperator(np.asarray(a.diags, dtype=np.float32), a.offsets, a.shape)
    with pytest.raises(ValueError, match="dtype"):
        SplitComplexOperator(a, c32)
