"""Unit tests for the L1 Givens primitives, mirroring the oracles of
reference test/givens_rotation.jl: ranged application must agree with the
explicitly materialized rotation matrix, for real and complex scalars."""

import numpy as np
import pytest

from arnoldimethod_jax.dense import (
    givens,
    lmul2,
    lmul3,
    rmul2,
    rmul3,
    rot2_matrix,
    rot3_matrix,
)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_givens_zeroing_and_unitarity(dtype):
    rng = np.random.default_rng(1)
    for _ in range(50):
        f, g = rng.standard_normal(2).astype(np.float64)
        if dtype == np.complex128:
            f = f + 1j * rng.standard_normal()
            g = g + 1j * rng.standard_normal()
        c, s, r = givens(f, g)
        # [c s; -conj(s) c] @ [f, g] == [r, 0]
        assert abs(c * f + s * g - r) < 1e-13
        assert abs(-np.conj(s) * f + c * g) < 1e-13
        assert abs(c * np.conj(c) + s * np.conj(s) - 1) < 1e-13
        assert np.imag(c) == 0


def test_givens_edge_cases():
    c, s, r = givens(0.0, 0.0)
    assert (c, s, r) == (1.0, 0.0, 0.0)
    c, s, r = givens(3.0, 0.0)
    assert (c, s, r) == (1.0, 0.0, 3.0)
    c, s, r = givens(0.0, -2.0)
    assert c == 0.0 and abs(abs(s) - 1) < 1e-15 and abs(s * -2.0 - r) < 1e-15
    # Overflow safety
    big = 1e300
    c, s, r = givens(big, big)
    assert np.isfinite(r) and abs(c - np.sqrt(0.5)) < 1e-15


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_ranged_rot2_matches_materialized(dtype):
    rng = np.random.default_rng(2)
    n = 7
    for i in range(n - 1):
        A = rng.standard_normal((n, n)).astype(dtype)
        if np.issubdtype(dtype, np.complexfloating):
            A = A + 1j * rng.standard_normal((n, n))
        f, g = A[i, 0], A[i + 1, 0]
        c, s, _ = givens(f, g)
        G = rot2_matrix(c, s, i, n)

        B = A.copy()
        lmul2(c, s, B, i, 0, n)
        assert np.linalg.norm(B - G @ A) < 1e-12

        B = A.copy()
        rmul2(B, c, s, i, 0, n)
        assert np.linalg.norm(B - A @ G.conj().T) < 1e-12

        # Partial ranges touch only the covered columns/rows.
        B = A.copy()
        lmul2(c, s, B, i, 2, 5)
        full = G @ A
        assert np.allclose(B[:, 2:5], full[:, 2:5])
        assert np.array_equal(B[:, :2], A[:, :2])
        assert np.array_equal(B[:, 5:], A[:, 5:])


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_ranged_rot3_matches_materialized(dtype):
    rng = np.random.default_rng(3)
    n = 7
    for i in range(n - 2):
        A = rng.standard_normal((n, n)).astype(dtype)
        if np.issubdtype(dtype, np.complexfloating):
            A = A + 1j * rng.standard_normal((n, n))
        p1, p2, p3 = A[i : i + 3, 0]
        c1, s1, n1 = givens(p2, p3)
        c2, s2, _ = givens(p1, n1)
        G = rot3_matrix(c1, s1, c2, s2, i, n)

        B = A.copy()
        lmul3(c1, s1, c2, s2, B, i, 0, n)
        assert np.linalg.norm(B - G @ A) < 1e-12
        # The rotation maps [p1,p2,p3] to a multiple of e1.
        assert abs(B[i + 1, 0]) < 1e-13 and abs(B[i + 2, 0]) < 1e-13

        B = A.copy()
        rmul3(B, c1, s1, c2, s2, i, 0, n)
        assert np.linalg.norm(B - A @ G.conj().T) < 1e-12
