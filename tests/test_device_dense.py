"""On-device dense kernels (dense/device.py) vs the numpy twins: the numpy
layer is the tested behavioral reference (it carries the reference's own
oracles), so equality up to roundoff transfers those guarantees."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from arnoldimethod_jax.dense.device import (
    eigenvalues_jax,
    givens_jax,
    local_schur_jax,
    residuals_jax,
)
from arnoldimethod_jax.dense.rotations import givens
from arnoldimethod_jax.dense.schur import local_schur
from arnoldimethod_jax.dense.eig import eigenvalues
from arnoldimethod_jax.driver import _copy_residuals


def _random_hessenberg(m, seed, shape_rows=None):
    rng = np.random.default_rng(seed)
    H = np.zeros((shape_rows or m, m))
    H[:m, :m] = np.triu(rng.standard_normal((m, m)), -1)
    return H


@pytest.mark.parametrize("seed", range(4))
def test_givens_matches_numpy(seed):
    rng = np.random.default_rng(seed)
    for f, g in [
        (rng.standard_normal(), rng.standard_normal()),
        (0.0, rng.standard_normal()),
        (rng.standard_normal(), 0.0),
        (0.0, 0.0),
        (-3.0, 4.0),
        (1e-30, 1e30),
    ]:
        c0, s0, r0 = givens(f, g)
        c1, s1, r1 = jax.jit(givens_jax)(jnp.float64(f), jnp.float64(g))
        assert np.allclose([c0, s0, r0], [float(c1), float(s1), float(r1)], rtol=1e-14)


def _assert_quasi_triangular(R, m, tol=1e-12):
    """Subdiagonal has no two consecutive nonzeros; below-subdiagonal is 0."""
    for i in range(m - 2):
        assert abs(R[i + 1, i]) < tol * 100 or abs(R[i + 2, i + 1]) < tol * 100
    assert np.allclose(np.tril(R[:m, :m], -2), 0, atol=tol)


@pytest.mark.parametrize("seed", range(6))
def test_local_schur_invariants(seed):
    """Exact iterate-level equality with the numpy twin is not a valid
    oracle (the QR iteration is chaotic in roundoff: a 1-ulp difference in
    one rotation eventually flips a deflation order; both results are valid
    Schur forms).  Assert the invariants the numpy layer itself is tested
    by: similarity, orthonormality, quasi-triangular structure, and
    eigenvalue preservation vs numpy.linalg."""
    m = 12
    H0 = _random_hessenberg(m, seed, shape_rows=m + 1)
    H0[m, m - 1] = 0.3

    Hj, Qj, ok = jax.jit(local_schur_jax)(jnp.asarray(H0), jnp.eye(m), 0, m)
    assert bool(ok)
    Hj = np.asarray(Hj)
    Qj = np.asarray(Qj)

    A = H0[:m, :]
    nrm = max(1, np.linalg.norm(A))
    assert np.linalg.norm(A @ Qj - Qj @ Hj[:m, :]) < 1e-12 * nrm
    assert np.linalg.norm(Qj.T @ Qj - np.eye(m)) < 1e-13
    _assert_quasi_triangular(Hj, m)
    want = np.sort_complex(np.linalg.eigvals(A))
    lre, lim, _ = jax.jit(eigenvalues_jax)(jnp.asarray(Hj))
    got = np.sort_complex(np.asarray(lre) + 1j * np.asarray(lim))
    assert np.allclose(got, want, atol=1e-8)


@pytest.mark.parametrize("seed", range(6))
def test_local_schur_window_offset(seed):
    """QR on a sub-window [lo, hi) preserves similarity of the enclosing
    matrix and does not touch the decoupled leading block's diagonal."""
    m = 14
    lo, hi = 3, 11
    H0 = _random_hessenberg(m, seed)
    # Decouple the window above AND below, as in every driver call site
    # (rotations applied to window columns would otherwise mix the coupled
    # row below into the sub-subdiagonal — same as the numpy twin).
    H0[lo, lo - 1] = 0
    H0[hi, hi - 1] = 0

    Hj, Qj, ok = jax.jit(local_schur_jax)(jnp.asarray(H0), jnp.eye(m), lo, hi)
    assert bool(ok)
    Hj = np.asarray(Hj)
    Qj = np.asarray(Qj)
    assert np.linalg.norm(H0 @ Qj - Qj @ Hj) < 1e-12 * np.linalg.norm(H0)
    assert np.linalg.norm(Qj.T @ Qj - np.eye(m)) < 1e-13
    # Leading block untouched, Q acts only inside the window.
    assert np.allclose(Hj[:lo, :lo], H0[:lo, :lo])
    assert np.allclose(Qj[:lo, :lo], np.eye(lo))
    # Window is quasi-triangular with the window's eigenvalues.
    want = np.sort_complex(np.linalg.eigvals(H0[lo:hi, lo:hi]))
    got = np.sort_complex(np.linalg.eigvals(Hj[lo:hi, lo:hi]))
    assert np.allclose(got, want, atol=1e-8)


@pytest.mark.parametrize("seed", range(6))
def test_eigenvalues_match_numpy(seed):
    m = 12
    H0 = _random_hessenberg(m, seed, shape_rows=m + 1)
    Hn = H0[:m, :].copy()
    Qn = np.eye(m)
    local_schur(Hn, 0, m, Qn)
    lam_np = eigenvalues(Hn)

    H1 = np.zeros_like(H0)
    H1[:m, :] = Hn
    lre, lim, starts = jax.jit(eigenvalues_jax)(jnp.asarray(H1))
    lam_dev = np.asarray(lre) + 1j * np.asarray(lim)
    assert np.allclose(lam_dev, lam_np, atol=1e-12)


@pytest.mark.parametrize("seed", range(6))
def test_residuals_match_numpy(seed):
    m = 12
    H0 = _random_hessenberg(m, seed, shape_rows=m + 1)
    h_last = 0.37
    H0[m, m - 1] = h_last

    Hn = H0.copy()
    Qn = np.eye(m)
    local_schur(Hn[:m, :], 0, m, Qn)

    rs_np = np.zeros(m)
    x = np.zeros(m, dtype=complex)
    _copy_residuals(rs_np, Hn, Qn, h_last, x, 0, m)

    rs_dev = jax.jit(residuals_jax)(jnp.asarray(Hn), jnp.asarray(Qn), h_last, 0, m)
    assert np.allclose(np.asarray(rs_dev), rs_np, atol=1e-12)


def test_local_schur_known_spectrum():
    """Eigenvalues preserved vs numpy.linalg.eigvals on a Hessenberg
    matrix with a mix of real eigenvalues and complex pairs."""
    m = 16
    H0 = _random_hessenberg(m, 42)
    want = np.sort_complex(np.linalg.eigvals(H0))

    Hj, Qj, ok = jax.jit(local_schur_jax)(jnp.asarray(H0), jnp.eye(m), 0, m)
    assert bool(ok)
    H1 = np.zeros((m + 1, m))
    H1[:m, :] = np.asarray(Hj)
    lre, lim, _ = jax.jit(eigenvalues_jax)(jnp.asarray(H1))
    got = np.sort_complex(np.asarray(lre) + 1j * np.asarray(lim))
    assert np.allclose(got, want, atol=1e-8)


# --- Swaps / partition / sort / restore vs numpy twins ----------------------

from arnoldimethod_jax.dense.device import (
    partition_three_way_jax,
    restore_arnoldi_jax,
    rotate_right_jax,
    sort_schur_jax,
    swap_jax,
)
from arnoldimethod_jax.dense.swaps import (
    is_start_of_11_block,
    rotate_right,
    swap,
)
from arnoldimethod_jax.dense.restore import restore_arnoldi
from arnoldimethod_jax.driver import _partition_three_way, _sort_schur
from arnoldimethod_jax.targets import get_order, as_target


def _quasi_schur(m, seed, pair_positions=()):
    """Random quasi-upper-triangular R with 2x2 conjugate blocks at the
    given positions, padded to (m+1, m)."""
    rng = np.random.default_rng(seed)
    R = np.triu(rng.standard_normal((m, m)))
    for p in pair_positions:
        a, b = 0.5 * rng.standard_normal(), 1.0 + rng.random()
        R[p, p] = a
        R[p + 1, p + 1] = a
        R[p, p + 1] = b
        R[p + 1, p] = -b  # eigenvalues a +- ib
    out = np.zeros((m + 1, m))
    out[:m] = R
    return out


@pytest.mark.parametrize(
    "pairs,i,c11,n11",
    [
        ((), 3, True, True),
        ((4,), 3, True, False),
        ((3,), 3, False, True),
        ((3, 5), 3, False, False),
    ],
)
def test_swap_matches_numpy(pairs, i, c11, n11):
    m = 8
    H0 = _quasi_schur(m, 11, pairs)
    Hn = H0.copy()
    Qn = np.eye(m)
    swap(Hn[:m, :], i, c11, n11, Qn)

    Hj, Qj = jax.jit(swap_jax)(jnp.asarray(H0), jnp.eye(m), i, c11, n11)
    assert np.allclose(np.asarray(Hj)[:m], Hn[:m], atol=1e-12)
    assert np.allclose(np.asarray(Qj), Qn, atol=1e-12)


@pytest.mark.slow
def test_rotate_right_matches_numpy():
    m = 10
    H0 = _quasi_schur(m, 12, (2, 6))
    Hn = H0.copy()
    Qn = np.eye(m)
    rotate_right(Hn[:m, :], 0, 8, Qn)

    Hj, Qj = jax.jit(rotate_right_jax)(jnp.asarray(H0), jnp.eye(m), 0, 8)
    assert np.allclose(np.asarray(Hj)[:m], Hn[:m], atol=1e-11)
    assert np.allclose(np.asarray(Qj), Qn, atol=1e-11)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.slow
def test_partition_matches_numpy(seed):
    m = 10
    H0 = _quasi_schur(m, seed + 20, (2, 7))
    rng = np.random.default_rng(seed)
    groups = np.zeros(m, dtype=int)
    # Consistent groups per block (pairs share their group).
    i = 0
    while i < m:
        g = int(rng.integers(1, 4))
        if is_start_of_11_block(H0[:m, :], i):
            groups[i] = g
            i += 1
        else:
            groups[i] = groups[i + 1] = g
            i += 2

    Hn = H0.copy()
    Qn = np.eye(m)
    _partition_three_way(Hn[:m, :], Qn, groups)

    Hj, Qj = jax.jit(partition_three_way_jax)(
        jnp.asarray(H0), jnp.eye(m), jnp.asarray(groups, dtype=jnp.int32)
    )
    assert np.allclose(np.asarray(Hj)[:m], Hn[:m], atol=1e-11)
    assert np.allclose(np.asarray(Qj), Qn, atol=1e-11)


@pytest.mark.parametrize("which", ["LM", "SR", "LR"])
@pytest.mark.slow
def test_sort_schur_matches_numpy(which):
    m = 9
    H0 = _quasi_schur(m, 33, (1, 5))
    Hn = H0.copy()
    Qn = np.eye(m)
    _sort_schur(Hn[:m, :], Qn, m, get_order(as_target(which)))

    Hj, Qj = jax.jit(sort_schur_jax, static_argnums=(3,))(
        jnp.asarray(H0), jnp.eye(m), m, which
    )
    assert np.allclose(np.asarray(Hj)[:m], Hn[:m], atol=1e-11)
    assert np.allclose(np.asarray(Qj), Qn, atol=1e-11)


@pytest.mark.parametrize("seed", range(4))
def test_restore_arnoldi_matches_numpy(seed):
    m = 12
    lo, hi = 2, 9
    rng = np.random.default_rng(seed + 50)
    # A full active block (as after partition), arbitrary Q, residual h.
    H0 = np.zeros((m + 1, m))
    H0[:m] = np.triu(rng.standard_normal((m, m)), -1)
    H0[lo:hi, lo:hi] = rng.standard_normal((hi - lo, hi - lo))
    H0[m, m - 1] = 0.7
    Q0, _ = np.linalg.qr(rng.standard_normal((m, m)))

    Hn = H0.copy()
    Qn = Q0.copy()
    restore_arnoldi(Hn, lo, hi, Qn)

    Hj, Qj = jax.jit(restore_arnoldi_jax)(
        jnp.asarray(H0), jnp.asarray(Q0), lo, hi
    )
    assert np.allclose(np.asarray(Hj), Hn, atol=1e-11)
    assert np.allclose(np.asarray(Qj), Qn, atol=1e-11)


def test_restore_arnoldi_trivial_window():
    m = 8
    H0 = np.random.default_rng(1).standard_normal((m + 1, m))
    Q0 = np.eye(m)
    Hj, Qj = jax.jit(restore_arnoldi_jax)(jnp.asarray(H0), jnp.asarray(Q0), 3, 4)
    assert np.allclose(np.asarray(Hj), H0)
    assert np.allclose(np.asarray(Qj), Q0)
