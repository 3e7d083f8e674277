"""Unit tests for Schur reordering (dense/swaps.py), mirroring reference
test/sort_schur.jl: each swap preserves similarity and exchanges the right
eigenvalues; rotate_right circular-shifts blocks; Stewart's example and the
Bai-Demmel ill-conditioned Sylvester swap stay stable; identical
eigenvalues are a silent no-op."""

import numpy as np
import pytest

from arnoldimethod_jax.dense import (
    eigenvalues,
    rotate_right,
    swap11,
    swap12,
    swap21,
    swap22,
)
from utils import realimag_sort

EPS = np.finfo(np.float64).eps
DTYPES = [np.float64, np.complex128]


def _rand(rng, shape, dtype):
    A = rng.standard_normal(shape).astype(dtype)
    if np.issubdtype(dtype, np.complexfloating):
        A = A + 1j * rng.standard_normal(shape)
    return A


@pytest.mark.parametrize("dtype", DTYPES)
def test_swap11(dtype):
    rng = np.random.default_rng(0)
    R1 = np.triu(_rand(rng, (2, 2), dtype))
    R2 = R1.copy()
    Q = np.eye(2, dtype=dtype)
    swap11(R2, 0, Q)
    assert np.isclose(R2[0, 0], R1[1, 1])
    assert np.isclose(R2[1, 1], R1[0, 0])
    assert np.allclose(R1 @ Q, Q @ R2)


@pytest.mark.parametrize("dtype", DTYPES)
def test_swap12(dtype):
    rng = np.random.default_rng(1)
    R1 = np.triu(_rand(rng, (3, 3), dtype))
    R1[2, 1] = _rand(rng, (), dtype)
    R2 = R1.copy()
    Q = np.eye(3, dtype=dtype)
    swap12(R2, 0, Q)
    assert R2[2, 0] == 0 and R2[2, 1] == 0
    assert np.isclose(R2[2, 2], R1[0, 0])
    assert np.allclose(
        realimag_sort(np.linalg.eigvals(R1[1:, 1:])),
        realimag_sort(np.linalg.eigvals(R2[:2, :2])),
    )
    assert np.allclose(R1 @ Q, Q @ R2)


@pytest.mark.parametrize("dtype", DTYPES)
def test_swap21(dtype):
    rng = np.random.default_rng(2)
    R1 = np.triu(_rand(rng, (3, 3), dtype))
    R1[1, 0] = _rand(rng, (), dtype)
    R2 = R1.copy()
    Q = np.eye(3, dtype=dtype)
    swap21(R2, 0, Q)
    assert R2[1, 0] == 0 and R2[2, 0] == 0
    assert np.isclose(R2[0, 0], R1[2, 2])
    assert np.allclose(
        realimag_sort(np.linalg.eigvals(R1[:2, :2])),
        realimag_sort(np.linalg.eigvals(R2[1:, 1:])),
    )
    assert np.allclose(R1 @ Q, Q @ R2)


@pytest.mark.parametrize("dtype", DTYPES)
def test_swap22(dtype):
    rng = np.random.default_rng(3)
    R1 = np.triu(_rand(rng, (4, 4), dtype))
    R1[1, 0] = _rand(rng, (), dtype)
    R1[3, 2] = _rand(rng, (), dtype)
    R2 = R1.copy()
    Q = np.eye(4, dtype=dtype)
    swap22(R2, 0, Q)
    assert np.all(R2[2:, :2] == 0)
    assert np.allclose(
        realimag_sort(np.linalg.eigvals(R1[:2, :2])),
        realimag_sort(np.linalg.eigvals(R2[2:, 2:])),
    )
    assert np.allclose(
        realimag_sort(np.linalg.eigvals(R1[2:, 2:])),
        realimag_sort(np.linalg.eigvals(R2[:2, :2])),
    )
    assert np.allclose(R1 @ Q, Q @ R2)


def _check_rotation(R, lo, hi, block_positions, seed, dtype):
    """Build a 10x10 quasi-triangular R with 2x2 blocks at the given
    positions, rotate_right over [lo, hi], and check similarity,
    orthonormality of Q and the cyclic shift of eigenvalues."""
    rng = np.random.default_rng(seed)
    R = np.triu(_rand(rng, (10, 10), dtype))
    for (i, a, b) in block_positions:
        R[i + 1, i] = a
        R[i, i + 1] = b
    Q = np.eye(10, dtype=dtype)
    lam_before = eigenvalues(R)

    R_after = R.copy()
    rotate_right(R_after, lo, hi, Q)
    lam_after = eigenvalues(R_after)

    nrmR = np.linalg.norm(R, 1)
    assert np.linalg.norm(R - Q @ R_after @ Q.conj().T, 1) < 20 * EPS * nrmR
    assert np.linalg.norm(Q.conj().T @ Q - np.eye(10)) < 20 * EPS
    return lam_before, lam_after


@pytest.mark.parametrize("dtype", DTYPES)
def test_rotate_right_singles(dtype):
    """2x2 block at R[3:5,3:5], rotate the whole range: every eigenvalue
    shifts one position (ref: test/sort_schur.jl:113-139)."""
    lam_before, lam_after = _check_rotation(None, 0, 9, [(3, 2.0, -2.0)], 11, dtype)
    for i in range(10):
        assert np.isclose(lam_before[i], lam_after[(i + 1) % 10])


@pytest.mark.parametrize("dtype", DTYPES)
def test_rotate_right_two_pairs(dtype):
    """Blocks at [1:3] and [5:7], rotate [2, 5] (0-based block starts):
    middle eigenvalues shift by two (ref: test/sort_schur.jl:141-176)."""
    lam_before, lam_after = _check_rotation(
        None, 2, 5, [(1, -2.0, 2.0), (5, 3.0, -2.0)], 12, dtype
    )
    assert lam_before[0] == lam_after[0]
    for i, j in zip(range(1, 7), np.roll(range(1, 7), -2)):
        assert np.isclose(lam_before[i], lam_after[j])
    assert np.array_equal(lam_before[7:], lam_after[7:])


@pytest.mark.parametrize("dtype", DTYPES)
def test_rotate_right_block_on_right(dtype):
    lam_before, lam_after = _check_rotation(None, 1, 5, [(5, 2.0, -2.0)], 13, dtype)
    assert lam_before[0] == lam_after[0]
    for i, j in zip(range(1, 7), np.roll(range(1, 7), -2)):
        assert np.isclose(lam_before[i], lam_after[j])
    assert np.array_equal(lam_before[7:], lam_after[7:])


def test_stewarts_example():
    """Stewart's forward-instability example (Bai & Demmel): direct swapping
    handles it for increasing coupling tau (ref: test/sort_schur.jl:251-278)."""
    for tau in (1.0, 10.0, 100.0):
        B = np.array(
            [
                [7.001, -87.0, 39.4 * tau, 22.4 * tau],
                [5.0, 7.001, -12.4 * tau, 36.0 * tau],
                [0.0, 0.0, 7.01, -0.7567],
                [0.0, 0.0, 37.0, 7.01],
            ]
        )
        lam_before = eigenvalues(B)
        swap22(B, 0)
        lam_after = eigenvalues(B)
        assert np.isclose(abs(lam_before[0]), abs(lam_after[2]))
        assert np.isclose(abs(lam_before[2]), abs(lam_after[0]))


def test_bai_demmel_small_separation():
    """Ill-conditioned Sylvester equation: the swap must stay backward
    stable (ref: test/sort_schur.jl:281-301)."""
    A = np.array(
        [
            [1.0, -100.0, 400.0, -1000.0],
            [0.01, 1.0, 1200.0, -10.0],
            [0.0, 0.0, 1.0 + EPS, -0.01],
            [0.0, 0.0, 100.0, 1.0 + EPS],
        ]
    )
    Ap = A.copy()
    Q = np.eye(4)
    lam_before = eigenvalues(A)
    swap22(Ap, 0, Q)
    lam_after = eigenvalues(Ap)
    assert np.isclose(abs(lam_before[0]), abs(lam_after[2]))
    assert np.isclose(abs(lam_before[2]), abs(lam_after[0]))
    assert np.linalg.norm(np.eye(4) - Q.T @ Q, 1) < 10 * EPS
    assert np.linalg.norm(A @ Q - Q @ Ap, 1) < np.linalg.norm(A, 1) * EPS


def test_identical_eigenvalues_are_noop():
    """Singular Sylvester -> swap silently skipped, no blow-up
    (ref: test/sort_schur.jl:303-320)."""
    A = np.array(
        [
            [1.0, 2.0, 3.0, 4.0],
            [0.0, 1.0, 5.0, 6.0],
            [0.0, 0.0, 1.0, 7.0],
            [0.0, 0.0, 0.0, 1.0],
        ]
    )
    Ap = A.copy()
    swap22(Ap, 0)
    assert np.array_equal(A, Ap)
    swap12(Ap, 0)
    assert np.array_equal(A, Ap)
    swap21(Ap, 0)
    assert np.array_equal(A, Ap)
