"""Unit tests for the tiny Sylvester solver (ref: test/sylvester.jl):
A X - X B = C for all block-size combinations, and the singularity flag
when the spectra of A and B coincide."""

import numpy as np
import pytest

from arnoldimethod_jax.dense import solve_complete_pivot, sylv


@pytest.mark.parametrize("p,q", [(2, 2), (2, 1), (1, 2), (1, 1)])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_sylv_solves(p, q, dtype):
    rng = np.random.default_rng(10 * p + q)
    for _ in range(20):
        A = rng.standard_normal((p, p)).astype(dtype)
        B = rng.standard_normal((q, q)).astype(dtype)
        C = rng.standard_normal((p, q)).astype(dtype)
        if np.issubdtype(dtype, np.complexfloating):
            A = A + 1j * rng.standard_normal((p, p))
            B = B + 1j * rng.standard_normal((q, q))
            C = C + 1j * rng.standard_normal((p, q))
        X, singular = sylv(A, B, C)
        assert not singular
        assert np.linalg.norm(A @ X - X @ B - C) < 1e-11 * max(
            1, np.linalg.norm(X)
        )


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_sylv_singular_flag_for_equal_spectra(dtype):
    """Equal spectra of A and B make the system exactly singular
    (ref: test/sylvester.jl:20-42)."""
    rng = np.random.default_rng(3)

    # Identical 1x1 blocks.
    _, singular = sylv(
        np.array([[2.0]], dtype), np.array([[2.0]], dtype), np.array([[1.0]], dtype)
    )
    assert singular

    A22 = np.array([[1.0, 2.0], [0.0, 1.0]], dtype)
    B22 = np.array([[1.0, 3.0], [0.0, 1.0]], dtype)
    _, singular = sylv(A22, B22, rng.standard_normal((2, 2)).astype(dtype))
    assert singular

    _, singular = sylv(
        np.array([[1.0]], dtype), B22, rng.standard_normal((1, 2)).astype(dtype)
    )
    assert singular

    _, singular = sylv(A22, np.array([[1.0]], dtype), rng.standard_normal((2, 1)).astype(dtype))
    assert singular


def test_complete_pivot_solver():
    rng = np.random.default_rng(7)
    for n in (1, 2, 3, 4):
        M = rng.standard_normal((n, n))
        b = rng.standard_normal(n)
        x, singular = solve_complete_pivot(M, b)
        assert not singular
        assert np.linalg.norm(M @ x - b) < 1e-12

    # Exactly singular matrix raises the flag.
    M = np.array([[1.0, 2.0], [2.0, 4.0]])
    _, singular = solve_complete_pivot(M, np.ones(2))
    assert singular
