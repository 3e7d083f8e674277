"""Spectral transformation recipes, mirroring the reference's worked docs
examples (docs/src/index.md:234-352): shift-invert, generalized
shift-invert, and the B-inner-product Schur decomposition."""

import numpy as np
import pytest
import jax.numpy as jnp

from arnoldimethod_jax import partial_eigen, partial_schur
from arnoldimethod_jax.transforms import (
    BInnerProductOperator,
    GeneralizedShiftInvertOperator,
)


def test_generalized_shift_invert():
    """A x = B x lambda via (A)^{-1} B, nev=4, tol=1e-5: residual
    ||A X - B X diag(lams)|| small (docs example gives 2.8e-6)."""
    rng = np.random.default_rng(42)
    A = rng.standard_normal((100, 100))
    B = rng.standard_normal((100, 100))

    op = GeneralizedShiftInvertOperator.build(A, B, sigma=0.0)
    decomp, history = partial_schur(op, nev=4, which="LM", tol=1e-5, restarts=100)
    assert history.converged

    thetas, X = partial_eigen(decomp)
    lams = np.asarray(op.eigenvalues_back(thetas))
    X = np.asarray(X)
    resid = np.linalg.norm(A @ X - B @ X @ np.diag(lams))
    assert resid < 1e-4


def test_b_inner_product_schur():
    """Q^H A Q = R with Q^H B Q = I for s.p.d. B (docs example residuals
    3.9e-14 / 3.2e-15)."""
    rng = np.random.default_rng(7)
    A = rng.standard_normal((100, 100))
    B = np.diag(np.linspace(1.0, 2.0, 100))

    op = BInnerProductOperator.build(A, B)
    decomp, history = partial_schur(op, nev=4, which="LM", tol=1e-10)
    assert history.converged

    Q = np.asarray(op.recover_q(decomp.Q))
    R = np.asarray(decomp.R)
    assert np.linalg.norm(Q.T @ A @ Q - R) < 1e-8
    assert np.linalg.norm(Q.T @ B @ Q - np.eye(4)) < 1e-10


def test_b_inner_product_symmetric_gives_eigen():
    """If A is also symmetric, R is diagonal and Q holds B-orthonormal
    eigenvectors of the pencil."""
    rng = np.random.default_rng(8)
    A = rng.standard_normal((60, 60))
    A = (A + A.T) / 2
    B = np.diag(np.linspace(0.5, 3.0, 60))

    op = BInnerProductOperator.build(A, B)
    decomp, history = partial_schur(op, nev=3, which="LM", tol=1e-10)
    assert history.converged
    R = np.asarray(decomp.R)
    assert np.linalg.norm(R - np.diag(np.diag(R))) < 1e-7

    Q = np.asarray(op.recover_q(decomp.Q))
    lams = np.diag(R)
    resid = np.linalg.norm(A @ Q - B @ Q @ np.diag(lams))
    assert resid < 1e-7 * np.linalg.norm(A)


def test_chebyshev_filter_smallest_eigenvalues():
    """Chebyshev-filtered LM solve targets A's smallest eigenvalues with
    far fewer restarts than plain :SR; rayleigh_ritz recovers A's spectrum
    to near machine precision (BASELINE.json config-2 acceleration)."""
    from arnoldimethod_jax import (
        ChebyshevFilterOperator,
        partial_schur,
        power_bound,
        rayleigh_ritz,
    )
    from arnoldimethod_jax.models.problems import laplacian_2d

    nx = 32
    op = laplacian_2d(nx, nx)
    lam1 = 2 - 2 * np.cos(np.pi * np.arange(1, nx + 1) / (nx + 1))
    exact = np.sort(np.add.outer(lam1, lam1).ravel())

    b = power_bound(op, iters=30)
    assert b >= exact[-1]  # a true upper bound
    fop = ChebyshevFilterOperator(op, exact[5] * 3, b, 30)
    d, h = partial_schur(fop, nev=5, which="LM", tol=1e-10, method="host")
    assert h.converged
    assert h.restarts <= 5  # plain :SR needs ~3x more

    w, X, res = rayleigh_ritz(op, d.Q)
    assert np.allclose(w[:5], exact[:5], atol=1e-10)
    assert res[:5].max() < 1e-8


def test_chebyshev_filter_matvec_is_polynomial():
    """p(A) x equals the explicit Chebyshev polynomial of the dense matrix."""
    from arnoldimethod_jax import ChebyshevFilterOperator
    from arnoldimethod_jax.models.operators import DenseOperator

    rng = np.random.default_rng(0)
    A = rng.standard_normal((12, 12))
    A = (A + A.T) / 2
    a_int, b_int, deg = 1.0, 3.0, 7
    op = ChebyshevFilterOperator(DenseOperator(jnp.asarray(A)), a_int, b_int, deg)
    x = rng.standard_normal(12)

    c, e = (a_int + b_int) / 2, (b_int - a_int) / 2
    L = (A - c * np.eye(12)) / e
    t0, t1 = np.eye(12), L
    for _ in range(deg - 1):
        t0, t1 = t1, 2 * L @ t1 - t0
    want = t1 @ x
    got = np.asarray(op.matvec(jnp.asarray(x)))
    assert np.allclose(got, want, atol=1e-9)


@pytest.mark.slow
def test_estimate_interval_user_recipe():
    """estimate_interval returns a usable damping interval from solver
    outputs only: a is above the wanted band, b bounds the spectrum, and
    the end-to-end filtered solve converges and recovers A's smallest
    eigenvalues (the exact recipe in docs/transforms.md)."""
    from arnoldimethod_jax import (
        ChebyshevFilterOperator,
        estimate_interval,
        partial_schur,
        rayleigh_ritz,
    )
    from arnoldimethod_jax.models.problems import laplacian_2d

    nx = 32
    op = laplacian_2d(nx, nx)
    lam1 = 2 - 2 * np.cos(np.pi * np.arange(1, nx + 1) / (nx + 1))
    exact = np.sort(np.add.outer(lam1, lam1).ravel())

    nev = 5
    a, b, lo = estimate_interval(op, nev=nev)
    assert b >= exact[-1]          # true spectral upper bound
    assert a > exact[nev - 1]      # wanted band strictly below the interval
    assert a < b
    assert lo <= exact[0] * 1.5    # lower-edge estimate near lambda_min

    fop = ChebyshevFilterOperator(op, a, b, 60, scale_point=lo)
    d, h = partial_schur(fop, nev=nev, which="LM", tol=1e-10, method="host")
    assert h.converged
    w, X, res = rayleigh_ritz(op, d.Q)
    assert np.allclose(w[:nev], exact[:nev], atol=1e-9)
    assert res[:nev].max() < 1e-7


def test_chebyshev_scaled_recurrence_matches_unscaled_direction():
    """The scaled recurrence returns T_k(L)x / T_k(t0): identical to the
    unscaled filter up to the scalar T_k(t0), so eigen-ordering and
    convergence behavior are unchanged while overflow becomes impossible."""
    from arnoldimethod_jax import ChebyshevFilterOperator

    rng = np.random.default_rng(3)
    n = 24
    A = np.diag(np.linspace(0.1, 4.0, n)) + 0.01 * rng.standard_normal((n, n))
    A = (A + A.T) / 2
    x = rng.standard_normal(n)
    a, b, deg = 1.0, 4.5, 9
    y_un = np.asarray(ChebyshevFilterOperator(A, a, b, deg).matvec(jnp.asarray(x)))
    y_sc = np.asarray(
        ChebyshevFilterOperator(A, a, b, deg, scale_point=0.05).matvec(
            jnp.asarray(x)
        )
    )
    # Proportional: the ratio is T_deg(t(scale_point)), constant over entries.
    ratio = y_un / y_sc
    assert np.allclose(ratio, ratio[0], rtol=1e-8)
    assert np.max(np.abs(y_sc)) < np.max(np.abs(y_un))  # normalized down


def test_chebyshev_wraps_raw_matrices():
    """ChebyshevFilterOperator accepts raw arrays/lists: shape/dtype come
    from the WRAPPED operator (regression: they were read off the raw
    argument, crashing on lists and misreporting scipy dtypes)."""
    from arnoldimethod_jax import ChebyshevFilterOperator

    fop = ChebyshevFilterOperator([[2.0, -1.0], [-1.0, 2.0]], 1.0, 4.0, 3)
    assert fop.shape == (2, 2)
    y = np.asarray(fop.matvec(jnp.ones(2)))
    assert y.shape == (2,)


def test_dense_eig_host_matches_lapack():
    """The in-house _dense_eig_host (Hessenberg + Francis QR +
    quasi-triangular eigenvectors) vs np.linalg.eig as oracle, real and
    complex, including conjugate pairs."""
    from arnoldimethod_jax.transforms import _dense_eig_host

    rng = np.random.default_rng(11)
    for S in [
        rng.standard_normal((12, 12)),
        rng.standard_normal((7, 7)) + 1j * rng.standard_normal((7, 7)),
        np.diag(np.arange(1.0, 6.0)),
    ]:
        w, V = _dense_eig_host(S)
        wref = np.linalg.eigvals(S)
        assert np.allclose(
            np.sort_complex(np.asarray(w, complex)), np.sort_complex(wref),
            atol=1e-8 * (1 + np.abs(wref).max()),
        )
        R = S @ V - V * w[None, :]
        assert np.linalg.norm(R) < 1e-7 * (1 + np.abs(wref).max())


def test_orthonormalize_rows():
    """In-house tall-skinny QR replacement: orthonormal rows spanning the
    input row space; rank-deficient rows replaced with fresh directions."""
    import jax
    import jax.numpy as jnp
    from arnoldimethod_jax.ops.expansion import orthonormalize_rows

    rng = np.random.default_rng(5)
    X = jnp.asarray(rng.standard_normal((6, 40)), jnp.float32)
    Q = np.asarray(orthonormalize_rows(jnp.array(X), jax.random.PRNGKey(0)))
    assert np.linalg.norm(Q @ Q.T - np.eye(6)) < 1e-5
    # row space preserved: each original row is in span(Q)
    Xn = np.asarray(X)
    proj = Xn - (Xn @ Q.T) @ Q
    assert np.linalg.norm(proj) < 1e-4 * np.linalg.norm(Xn)

    # rank-deficient: duplicate rows -> still orthonormal output
    Xd = np.vstack([Xn[:3], Xn[:3]])
    Qd = np.asarray(
        orthonormalize_rows(jnp.asarray(Xd, jnp.float32), jax.random.PRNGKey(1))
    )
    assert np.linalg.norm(Qd @ Qd.T - np.eye(6)) < 1e-4


def test_rayleigh_ritz_chunked_options():
    """rows_layout / return_vectors / chunk options agree with the plain
    column API on a symmetric operator."""
    from arnoldimethod_jax import rayleigh_ritz
    from arnoldimethod_jax.models.problems import laplacian_1d
    import jax.numpy as jnp

    op = laplacian_1d(60)
    rng = np.random.default_rng(2)
    Q, _ = np.linalg.qr(rng.standard_normal((60, 8)))
    Qd = jnp.asarray(Q, jnp.float32)
    w0, X0, r0 = rayleigh_ritz(op, Qd)
    w1, X1, r1 = rayleigh_ritz(op, Qd.T, rows_layout=True, chunk=3)
    w2, X2, r2 = rayleigh_ritz(op, Qd, return_vectors=False)
    assert X2 is None
    assert np.allclose(w0, w1, atol=1e-5) and np.allclose(w0, w2, atol=1e-5)
    assert np.allclose(r0, r1, atol=1e-4) and np.allclose(r0, r2, atol=1e-4)
    assert np.allclose(np.abs(np.asarray(X1).T), np.abs(np.asarray(X0)), atol=1e-4)


# --- Periodic stencils, the FFT circulant shift-invert, and the LM
# --- interval recipe (round 5: the nonsymmetric-at-scale story). ------


def _periodic_symbol(N, s, cx, cy):
    th = 2 * np.pi * np.arange(N) / N
    return s * (
        (2 - 2 * np.cos(th))[:, None]
        + (2 - 2 * np.cos(th))[None, :]
        + 2j * (cx * np.sin(th)[:, None] + cy * np.sin(th)[None, :])
    )


def test_periodic_stencil_matvec_matches_symbol_spectrum():
    """The periodic Stencil5Operator is the 2-D circulant whose spectrum
    is the DFT symbol, and it is NORMAL despite nonsymmetric convection."""
    from arnoldimethod_jax.models import convection_diffusion_periodic_2d

    N, s, cx, cy = 8, 0.13, 0.15, 0.08
    op = convection_diffusion_periodic_2d(N, cx=cx, cy=cy, scale=s)
    n = N * N
    A = np.zeros((n, n))
    for i in range(n):
        e = np.zeros(n, np.float32)
        e[i] = 1
        A[:, i] = np.asarray(op.matvec(jnp.asarray(e)), np.float64)
    assert np.linalg.norm(A @ A.T - A.T @ A) < 1e-10  # normal
    lam = np.linalg.eigvals(A)
    se = _periodic_symbol(N, s, cx, cy).ravel()
    d = max(min(abs(l - t) for t in se) for l in lam)
    assert d < 1e-6


def test_circulant_shift_invert_matvec_oracle():
    from arnoldimethod_jax import CirculantShiftInvertOperator
    from arnoldimethod_jax.models import convection_diffusion_periodic_2d

    N, s, cx, cy, sigma = 8, 0.13, 0.15, 0.08, 1.3
    op = convection_diffusion_periodic_2d(N, cx=cx, cy=cy, scale=s)
    n = N * N
    A = np.zeros((n, n))
    for i in range(n):
        e = np.zeros(n, np.float32)
        e[i] = 1
        A[:, i] = np.asarray(op.matvec(jnp.asarray(e)), np.float64)
    si = CirculantShiftInvertOperator.build(op, sigma)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(n).astype(np.float32)
    y = np.asarray(si.matvec(jnp.asarray(x)), np.float64)
    y_ref = np.linalg.solve(A - sigma * np.eye(n), x)
    assert np.max(np.abs(y - y_ref)) < 1e-5
    # rejects non-periodic operators
    from arnoldimethod_jax.models.operators import Stencil5Operator

    with pytest.raises(ValueError, match="periodic"):
        CirculantShiftInvertOperator.build(
            Stencil5Operator((4, -1, -1, -1, -1), (4, 4)), 1.0
        )


def test_circulant_shift_invert_lm_solve():
    """The nonsymmetric-at-scale recipe at test size: periodic
    convection-diffusion, FFT shift-invert near the top, :LM — converges
    the quadratically clustered edge with conjugate pairs, checked
    against the exact DFT symbol."""
    from arnoldimethod_jax import (
        CirculantShiftInvertOperator,
        partial_schur,
        rayleigh_ritz,
    )
    from arnoldimethod_jax.models import convection_diffusion_periodic_2d

    N, s, cx, cy = 32, 0.13, 0.15, 0.08
    op = convection_diffusion_periodic_2d(N, cx=cx, cy=cy, scale=s)
    se = _periodic_symbol(N, s, cx, cy).ravel()
    sigma = float(np.max(se.real)) * 1.0005
    si = CirculantShiftInvertOperator.build(op, sigma)
    d, h = partial_schur(si, nev=10, which="LM", tol=1e-8, mindim=15,
                         maxdim=30, method="host")
    assert h.converged
    w, X, res = rayleigh_ritz(op, d.Q)
    w = np.asarray(w)
    assert np.max(res) < 1e-5
    # every Ritz value is a true eigenvalue...
    assert max(min(abs(l - t) for t in se) for l in w) < 1e-5
    # ...the exact top-6 are all captured...
    top6 = se[np.argsort(-np.abs(se))][:6]
    assert max(min(abs(t - l) for l in w) for t in top6) < 1e-5
    # ...and genuine conjugate pairs are present.
    assert int(np.sum(np.abs(w.imag) > 1e-7)) >= 4
    # eigenvalues_back maps the transformed values consistently.
    lam_back = si.eigenvalues_back(np.asarray(d.eigenvalues))
    assert max(min(abs(l - t) for t in se) for l in lam_back) < 1e-4


def test_estimate_interval_lm_symmetric():
    """which='LM' interval recipe on the (symmetric) periodic Laplacian:
    the damped interval must cover the lower spectrum and the scale
    point must sit at the top edge (within power/Ritz accuracy)."""
    from arnoldimethod_jax import (
        ChebyshevFilterOperator,
        estimate_interval,
        partial_schur,
        rayleigh_ritz,
    )
    from arnoldimethod_jax.models import convection_diffusion_periodic_2d

    N, s = 64, 0.13
    op = convection_diffusion_periodic_2d(N, cx=0.0, cy=0.0, scale=s)
    iv = estimate_interval(op, nev=8, which="LM", refine=3,
                           refine_degree=(100, 200, 300))
    top = 8 * s
    assert iv.a < 0.01  # lower edge at/below the true bottom (0)
    assert iv.a < iv.b < iv.lo
    assert abs(iv.lo - top) < 0.02 * top  # scale point at the top edge
    # The filtered solve localizes the top band: ~1e-3 eigenvalue
    # accuracy and ~1e-2 residuals — the filter route is the cheap
    # LOCALIZER (it feeds interval/edge estimates); full f32-floor
    # accuracy at the clustered :LM edge is the shift-invert route's
    # job (test_circulant_shift_invert_lm_solve reaches ~1e-5 on the
    # same spectrum class).
    fop = ChebyshevFilterOperator(op, iv.a, iv.b, 150, scale_point=iv.lo)
    d, h = partial_schur(fop, nev=12, which="LM", tol=1e-7, mindim=18,
                         maxdim=36, method="host")
    w, _, res = rayleigh_ritz(op, d.Q)
    se = _periodic_symbol(N, s, 0.0, 0.0).ravel().real
    top6 = np.sort(se)[-6:]
    cov = max(min(abs(t - l) for l in np.asarray(w).real) for t in top6)
    assert cov < 2e-3  # f32 filtered-path eigenvalue accuracy
    assert float(np.max(res)) < 2e-2


def test_chebyshev_filter_preserves_periodic_boundary():
    """Regression: the filter must apply the polynomial of the operator it
    was given — an earlier stencil rebuild inside the filter dropped the
    periodic boundary and applied the DIRICHLET operator's polynomial.
    Oracle: the scaled Chebyshev recurrence in float64 numpy over the
    dense periodic matrix."""
    from arnoldimethod_jax import ChebyshevFilterOperator
    from arnoldimethod_jax.models import convection_diffusion_periodic_2d

    N = 8
    op = convection_diffusion_periodic_2d(N, cx=0.15, cy=0.08, scale=0.13)
    assert op.boundary == "periodic"
    a, b, deg, lo = 0.5, 1.5, 4, 0.01
    fop = ChebyshevFilterOperator(op, a, b, deg, scale_point=lo)
    assert fop.op is op

    A = np.stack([
        np.asarray(op.matvec(jnp.asarray(e, op.dtype)), np.float64)
        for e in np.eye(N * N)
    ], axis=1)
    c, e = (a + b) / 2, (b - a) / 2
    t0 = (lo - c) / e
    sig = 1.0 / t0
    rng = np.random.default_rng(0)
    x = rng.standard_normal(N * N)
    ykm1, yk = x, sig * (A @ x - c * x) / e
    for _ in range(deg - 1):
        sig_next = 1.0 / (2.0 * t0 - sig)
        ykm1, yk = yk, (2.0 * sig_next * (A @ yk - c * yk) / e
                        - sig * sig_next * ykm1)
        sig = sig_next
    y = np.asarray(fop.matvec(jnp.asarray(x, op.dtype)), np.float64)
    np.testing.assert_allclose(y, yk, rtol=1e-5, atol=1e-5)


def test_circulant_shift_invert_rejects_complex_coeffs():
    """Regression: matvec returns only the real inverse-FFT word, which
    is exact ONLY for a conjugate-symmetric (real-coefficient) symbol —
    complex coefficients must fail loudly, not return a truncated solve
    (measured 47% relative error before the fix)."""
    from arnoldimethod_jax import CirculantShiftInvertOperator
    from arnoldimethod_jax.models.operators import Stencil5Operator

    op = Stencil5Operator((4 + 2j, -1, -1 + 0.5j, -1, -1.25j), (8, 8),
                          boundary="periodic")
    with pytest.raises(NotImplementedError, match="complex"):
        CirculantShiftInvertOperator.build(op, 9.0)


def test_estimate_interval_validates_which_before_device_work():
    """A typo'd `which` must raise BEFORE the power bound / coarse
    Arnoldi pass — at 1M+ rows those are minutes of device work."""
    from arnoldimethod_jax import estimate_interval
    from arnoldimethod_jax.models.operators import FunctionOperator

    calls = []

    def mv(x):
        calls.append(1)
        return x

    op = FunctionOperator(mv, 64, jnp.float64)
    with pytest.raises(ValueError, match="SR"):
        estimate_interval(op, nev=4, which="lm")
    assert not calls  # no matvec was dispatched


def test_power_bound_complex_operator():
    """Regression: the power-iteration carry initialized its norm slot at
    the operator dtype — complex, while jnp.linalg.norm returns real —
    crashing the fori_loop with a carry-type mismatch."""
    from arnoldimethod_jax import power_bound

    rng = np.random.default_rng(3)
    A = (rng.standard_normal((40, 40))
         + 1j * rng.standard_normal((40, 40))).astype(np.complex128)
    b = float(power_bound(A, iters=30))
    rho = np.max(np.abs(np.linalg.eigvals(A)))
    assert b >= rho * 0.99
    assert b < rho * 3.0


def test_rayleigh_ritz_skips_residuals_when_asked():
    """Regression: compute_residuals=False with return_vectors=True used
    to run the full residual pass anyway (an extra A@X device sweep)."""
    from arnoldimethod_jax import rayleigh_ritz

    rng = np.random.default_rng(4)
    A = rng.standard_normal((60, 60))
    A = A + A.T
    Q, _ = np.linalg.qr(rng.standard_normal((60, 8)))
    w, X, res = rayleigh_ritz(A, jnp.asarray(Q), compute_residuals=False)
    assert res is None
    assert X is not None and np.shape(X) == (60, 8)
    w2, _, res2 = rayleigh_ritz(A, jnp.asarray(Q))
    np.testing.assert_allclose(np.sort(np.asarray(w).real),
                               np.sort(np.asarray(w2).real), rtol=1e-10)
    assert res2 is not None
