"""Native (C++) dense kernels vs the numpy reference layer: identical
in-place results on randomized Hessenberg/Schur workloads for both real
and complex dtypes."""

import numpy as np
import pytest

from arnoldimethod_jax.dense import native
from arnoldimethod_jax.dense import (
    copy_eigenvalues,
    local_schur,
    restore_arnoldi,
    rotate_right,
)
from arnoldimethod_jax.dense.swaps import is_start_of_11_block
from arnoldimethod_jax.driver import (
    _copy_residuals,
    _partition_three_way,
    _sort_schur,
)
from arnoldimethod_jax.targets import get_order
from utils import normal_hessenberg_matrix, realimag_sort

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library not built"
)

DTYPES = [np.float64, np.complex128]


def _hessenberg(rng, m, dtype):
    if np.issubdtype(dtype, np.complexfloating):
        vals = rng.standard_normal(m) + 1j * rng.standard_normal(m)
        return normal_hessenberg_matrix(vals, rng, complex_dtype=True)
    # Mix of real eigenvalues and conjugate pairs.
    vals = []
    i = 0
    while len(vals) < m:
        if i % 3 == 0 and len(vals) + 2 <= m:
            a, b = rng.standard_normal(), abs(rng.standard_normal())
            vals += [a + 1j * b, a - 1j * b]
        else:
            vals.append(rng.standard_normal() + 0j)
        i += 1
    return normal_hessenberg_matrix(np.array(vals), rng)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_local_schur_matches(dtype, seed):
    rng = np.random.default_rng(seed)
    m = 12
    H0 = np.zeros((m + 1, m), dtype=dtype)
    H0[:m, :] = _hessenberg(rng, m, dtype)

    H_np = H0.copy()
    Q_np = np.eye(m, dtype=dtype)
    local_schur(H_np[:m, :], 0, m, Q_np)

    H_nat = H0.copy()
    Q_nat = np.eye(m, dtype=dtype)
    assert native.local_schur(H_nat[:m, :], 0, m, Q_nat)

    assert np.allclose(H_nat, H_np, atol=1e-12)
    assert np.allclose(Q_nat, Q_np, atol=1e-12)


@pytest.mark.parametrize("dtype", DTYPES)
def test_partition_and_sort_match(dtype):
    rng = np.random.default_rng(3)
    m = 12
    H0 = np.zeros((m + 1, m), dtype=dtype)
    H0[:m, :] = _hessenberg(rng, m, dtype)
    Q0 = np.eye(m, dtype=dtype)
    local_schur(H0[:m, :], 0, m, Q0)

    # Random groups respecting block boundaries.
    groups = np.zeros(m, dtype=int)
    i = 0
    while i < m:
        bs = 1 if is_start_of_11_block(H0[:m, :], i) else 2
        g = rng.integers(1, 4)
        groups[i : i + bs] = g
        i += bs

    H_np, Q_np = H0.copy(), Q0.copy()
    _partition_three_way(H_np[:m, :], Q_np, groups)
    H_nat, Q_nat = H0.copy(), Q0.copy()
    native.partition_three_way(H_nat[:m, :], Q_nat, groups)
    assert np.allclose(H_nat, H_np, atol=1e-12)
    assert np.allclose(Q_nat, Q_np, atol=1e-12)

    for which in ("LM", "LR", "SR"):
        H_np2, Q_np2 = H_np.copy(), np.eye(m, dtype=dtype)
        _sort_schur(H_np2[:m, :], Q_np2, m, get_order(which))
        H_nat2, Q_nat2 = H_np.copy(), np.eye(m, dtype=dtype)
        native.sort_schur(H_nat2[:m, :], Q_nat2, m, which)
        assert np.allclose(H_nat2, H_np2, atol=1e-12), which
        assert np.allclose(Q_nat2, Q_np2, atol=1e-12), which


@pytest.mark.parametrize("dtype", DTYPES)
def test_restore_and_residuals_match(dtype):
    rng = np.random.default_rng(4)
    m = 10
    H0 = np.zeros((m + 1, m), dtype=dtype)
    H0[:m, :] = _hessenberg(rng, m, dtype)
    H0[m, m - 1] = 0.37
    Q0 = np.eye(m, dtype=dtype)
    local_schur(H0[:m, :], 0, m, Q0)

    # Residuals
    rs_np = np.zeros(m)
    x = np.zeros(m, dtype=complex)
    _copy_residuals(rs_np, H0, Q0, H0[m, m - 1], x, 0, m)
    rs_nat = np.zeros(m)
    native.copy_residuals(rs_nat, H0[:m, :], Q0, H0[m, m - 1], 0, m)
    assert np.allclose(rs_nat, rs_np, atol=1e-13)

    # Eigenvalues
    l_np = np.zeros(m, dtype=complex)
    copy_eigenvalues(l_np, H0[:m, :], 0, m)
    l_nat = np.zeros(m, dtype=complex)
    native.copy_eigenvalues(l_nat, H0[:m, :], 0, m)
    assert np.allclose(realimag_sort(l_nat), realimag_sort(l_np), atol=1e-13)

    # Restore after a rotation (use a valid truncation point).
    k = m - 2
    if H0[k, k - 1] != 0:
        k += 1
    H_np, Q_np = H0.copy(), Q0.copy()
    restore_arnoldi(H_np, 0, k, Q_np)
    H_nat, Q_nat = H0.copy(), Q0.copy()
    native.restore_arnoldi(H_nat, 0, k, Q_nat)
    assert np.allclose(H_nat, H_np, atol=1e-12)
    assert np.allclose(Q_nat, Q_np, atol=1e-12)


def test_full_solver_native_vs_numpy(monkeypatch):
    """End to end: the solver gives identical results with the native and
    numpy dense layers (identical RNG, identical arithmetic)."""
    import arnoldimethod_jax.driver as drv
    from arnoldimethod_jax.models.problems import laplacian_1d

    op = laplacian_1d(80)
    d_nat, h_nat = drv.partial_schur(op, nev=4, which="SR", tol=1e-8)

    monkeypatch.setattr(drv._native, "_lib", None)
    assert not drv._native.available()
    d_np, h_np = drv.partial_schur(op, nev=4, which="SR", tol=1e-8)

    assert h_nat.mvproducts == h_np.mvproducts
    assert np.allclose(d_nat.eigenvalues, d_np.eigenvalues, atol=1e-12)
    assert np.allclose(np.asarray(d_nat.Q), np.asarray(d_np.Q), atol=1e-10)
