"""Unit tests for the LAPACK-free Francis QR (dense/schur.py), mirroring
reference test/schurfact.jl: 2x2 edge cases, embedded Hessenberg windows
with known spectra, nearly-repeated eigenvalue stagnation, the two
convergence regressions 'from the wild', and exactly-repeated 2x2 blocks."""

import numpy as np
import pytest

from arnoldimethod_jax.dense import (
    eigenvalues,
    is_offdiagonal_small,
    local_schur,
    upper_triangular_2x2,
    use_single_shift,
)
from utils import is_hessenberg, normal_hessenberg_matrix, realimag_sort

EPS = np.finfo(np.float64).eps


def check_spectrum(H_before, H_after, tol=1e-10):
    want = realimag_sort(np.linalg.eigvals(H_before))
    got = realimag_sort(np.linalg.eigvals(H_after))
    assert np.allclose(want, got, atol=tol * max(1, np.max(np.abs(want))))


def test_2x2_distinct_real():
    H = np.array([[1.0, 2.0], [3.0, 4.0]])
    Hp = H.copy()
    Q = np.eye(2)
    assert local_schur(Hp, 0, 2, Q, EPS, 2)
    assert np.linalg.norm(H @ Q - Q @ Hp) < 10 * EPS
    assert Hp[1, 0] == 0
    assert np.allclose(
        realimag_sort(eigenvalues(Hp)), realimag_sort(np.linalg.eigvals(H))
    )


def test_2x2_already_triangular():
    H = np.array([[1.0, 2.0], [0.0, 4.0]])
    Hp = H.copy()
    Q = np.eye(2)
    assert local_schur(Hp, 0, 2, Q, EPS, 2)
    assert np.linalg.norm(H @ Q - Q @ Hp) < 10 * EPS
    assert Hp[1, 0] == 0


def test_2x2_conjugate_pair_stays():
    H = np.array([[1.0, 4.0], [-5.0, 3.0]])
    Hp = H.copy()
    Q = np.eye(2)
    assert local_schur(Hp, 0, 2, Q, EPS, 2)
    assert np.linalg.norm(H @ Q - Q @ Hp) < 10 * EPS
    assert np.allclose(
        realimag_sort(eigenvalues(Hp)), realimag_sort(np.linalg.eigvals(H))
    )


@pytest.mark.parametrize("offset", range(5))
def test_embedded_real_window(offset):
    """Schur-factorize rows/cols [offset, n-offset) of a larger triangular
    matrix; check convergence, quasi-triangular structure, similarity, and
    spectrum preservation (ref: test/schurfact.jl:57-86)."""
    rng = np.random.default_rng(100 + offset)
    n = 10
    lo, hi = offset, n - offset
    H = np.triu(rng.standard_normal((n, n)))
    H[lo:hi, lo:hi] = normal_hessenberg_matrix(np.arange(lo + 1.0, hi + 1.0), rng)
    Hp = H.copy()
    Q = np.eye(n)

    assert local_schur(Hp, lo, hi, Q)

    for j in range(lo, hi - 1):
        t = Hp[j, j] + Hp[j + 1, j + 1]
        d = Hp[j, j] * Hp[j + 1, j + 1] - Hp[j + 1, j] * Hp[j, j + 1]
        assert is_offdiagonal_small(Hp, j) or t * t < 4 * d

    assert is_hessenberg(Hp)
    assert np.linalg.norm(H @ Q - Q @ Hp) < 1000 * EPS * max(1, np.linalg.norm(H))
    check_spectrum(H, Hp)


@pytest.mark.parametrize("offset", range(5))
def test_embedded_complex_window(offset):
    rng = np.random.default_rng(200 + offset)
    n = 10
    lo, hi = offset, n - offset
    H = np.triu(rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
    vals = (np.arange(lo + 1.0, hi + 1.0)) * (1 + 1j)
    H[lo:hi, lo:hi] = normal_hessenberg_matrix(vals, rng, complex_dtype=True)
    Hp = H.copy()
    Q = np.eye(n, dtype=complex)

    assert local_schur(Hp, lo, hi, Q)

    for j in range(lo, hi - 1):
        assert Hp[j + 1, j] == 0
    assert is_hessenberg(Hp)
    assert np.linalg.norm(H @ Q - Q @ Hp) < 1000 * EPS * max(1, np.linalg.norm(H))
    check_spectrum(H, Hp)


def test_nearly_repeated_eigenvalues_no_stagnation():
    """Tiny perturbations in the shift must not stall convergence
    (ref: test/schurfact.jl:123-135)."""
    eps = EPS
    H = np.array(
        [
            [2.0, 0.0, 0.0],
            [5 * eps, 1 - eps, 2 * eps],
            [0.0, 3 * eps, 1 + eps],
        ]
    )
    assert local_schur(H, 0, 3)


def test_convergence_regressions_from_the_wild():
    """Two matrices that previously needed tens of thousands of QR
    iterations due to unstable shift computation (ref:
    test/schurfact.jl:137-158; the matrices are test data cited verbatim)."""
    H1 = np.array(
        [
            [-9.000000046596169, 9.363971416904122e-6, 0.6216202324428521, 0.783119615978767],
            [-3.1249216068055166e-10, -9.000000125049475, -0.005030734831215954, 0.026538692060151765],
            [0.0, 2.5838932886290116e-12, -8.999999884550379, -4.118678562647915e-7],
            [0.0, 0.0, 5.499735555858365e-9, -8.99999994380397],
        ]
    )
    assert local_schur(H1, 0, 4)

    H2 = np.array(
        [
            [-9.99999999890572, -5.359512176950441e-5, 0.5057150345932383],
            [6.673511665530937e-11, -9.999999865827567, -0.0009029114103036593],
            [0.0, 1.432733142195386e-11, -10.000000096783797],
        ]
    )
    assert local_schur(H2, 0, 3)


def test_exactly_repeated_2x2():
    """A = [1 -1/4; 1 2] has a double eigenvalue 1.5 (zero discriminant):
    the stabilized analysis must see real eigenvalues and produce the exact
    rotation and shift (ref: test/schurfact.jl:160-174)."""
    a11, a12, a21, a22 = 1.0, -0.25, 1.0, 2.0

    is_real, c, s = upper_triangular_2x2(a11, a12, a21, a22)
    assert is_real
    G = np.array([[c, s], [-s, c]])
    A = np.array([[a11, a12], [a21, a22]])
    assert np.allclose(G @ A @ G.T, [[1.5, -1.25], [0.0, 1.5]])
    assert np.allclose(G.T @ G, np.eye(2))

    is_single, lam = use_single_shift(a11, a12, a21, a22)
    assert is_single
    assert abs(lam - 1.5) < 1e-14


def test_upper_triangular_2x2_zero_discriminant_edge():
    """H = [1 -1/4; 1 2] is not upper triangular and has zero discriminant;
    the strict '< 0' comparison must classify it as real
    (ref: schurfact.jl:344-347)."""
    is_real, _, _ = upper_triangular_2x2(1.0, -0.25, 1.0, 2.0)
    assert is_real
    # Conjugate pair case
    is_real, c, s = upper_triangular_2x2(1.0, 4.0, -5.0, 3.0)
    assert not is_real and c == 1.0 and s == 0.0
