"""Unit tests for the Householder reflector and the Krylov-Schur
truncation restore (dense/restore.py).

The restore step is verified through the invariant it exists for: starting
from a valid Arnoldi relation A V_m = V_{m+1} H, apply an orthogonal
similarity Q (from a Schur factorization + reordering) and truncate to k
columns; restore_arnoldi must produce H' Hessenberg and Q' such that
A (V Q')[:, :k] = (V Q')[:, :k] H'[:k, :k] + h v_new e_k^T still holds.
"""

import numpy as np
import pytest

from arnoldimethod_jax.dense import local_schur, reflector, restore_arnoldi, rotate_right
from utils import is_hessenberg


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_reflector_maps_to_ek(dtype):
    rng = np.random.default_rng(0)
    for k in (2, 3, 7):
        y = rng.standard_normal(k).astype(dtype)
        if np.issubdtype(dtype, np.complexfloating):
            y = y + 1j * rng.standard_normal(k)
        y0 = y.copy()
        # The returned value is the multiplier t for P = I - t w w^H
        # (the reference stores reflector!'s return directly in G.tau and
        # multiplies with it in lmul!).
        tau = reflector(y)
        v = np.concatenate([y[:-1], [1.0]])
        P = np.eye(k, dtype=complex) - tau * np.outer(v, v.conj())
        out = P @ y0
        # P y = beta e_k with beta = y[-1]
        assert np.linalg.norm(out[:-1]) < 1e-12 * max(1, abs(y[-1]))
        assert np.isclose(out[-1], y[-1])
        # P is unitary
        assert np.linalg.norm(P @ P.conj().T - np.eye(k)) < 1e-12
        assert 1 - 1e-12 <= np.real(tau) <= 2 + 1e-12


def test_reflector_trivial_case():
    y = np.array([0.0, 0.0, 3.0])
    tau = reflector(y)
    assert tau == 0
    assert np.array_equal(y, [0.0, 0.0, 3.0])


def _random_arnoldi(rng, n, m, dtype):
    """Build a genuine Arnoldi relation A V = V_ H with V_ = [V, v_extra]."""
    A = rng.standard_normal((n, n)).astype(dtype)
    if np.issubdtype(dtype, np.complexfloating):
        A = A + 1j * rng.standard_normal((n, n))
    V = np.zeros((n, m + 1), dtype=dtype)
    H = np.zeros((m + 1, m), dtype=dtype)
    v = rng.standard_normal(n).astype(dtype)
    if np.issubdtype(dtype, np.complexfloating):
        v = v + 1j * rng.standard_normal(n)
    V[:, 0] = v / np.linalg.norm(v)
    for j in range(m):
        w = A @ V[:, j]
        for _ in range(2):
            h = V[:, : j + 1].conj().T @ w
            w = w - V[:, : j + 1] @ h
            H[: j + 1, j] += h
        H[j + 1, j] = np.linalg.norm(w)
        V[:, j + 1] = w / H[j + 1, j]
    return A, V, H


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("lo,k", [(0, 4), (0, 6), (2, 5)])
def test_restore_arnoldi_preserves_relation(dtype, lo, k):
    rng = np.random.default_rng(42)
    n, m = 30, 8
    A, V, H = _random_arnoldi(rng, n, m, dtype)

    # Schur-factorize and reorder, as the driver does.  When lo > 0 the
    # driver guarantees H[lo, lo-1] == 0 (lo is a Schur block boundary), so
    # factorize the full window and snap lo to the nearest block start.
    Q = np.eye(m, dtype=dtype)
    local_schur(H[:m, :], 0, m, Q)
    if lo > 0 and H[lo, lo - 1] != 0:
        lo += 1
        k += 1
    last_block_start = m - 1 if H[m - 1, m - 2] == 0 else m - 2
    rotate_right(H[:m, :], lo, last_block_start, Q)
    if H[k, k - 1] != 0:
        k += 1  # never truncate through a 2x2 block

    restore_arnoldi(H, lo, k, Q)

    # Invariant 1: H[:k] is Hessenberg again in the active window.
    assert is_hessenberg(H[: k + 1, :k])

    # Invariant 2: truncated Arnoldi relation holds for the new basis.
    Vk = V[:, :m] @ Q[:, :k]
    v_next = V[:, m]
    rel = A @ Vk - Vk @ H[:k, :k]
    rel[:, -1] -= H[k, k - 1] * v_next
    # Columns lo..k-1 must satisfy the relation; the locked part (cols < lo)
    # was untouched by construction.
    assert np.linalg.norm(rel[:, lo:]) < 1e-9 * np.linalg.norm(A)

    # Invariant 3: the new basis is orthonormal.
    assert np.linalg.norm(Vk.conj().T @ Vk - np.eye(k)) < 1e-10
