"""Stencil5Operator (the XLA pad-and-shift matvec) against independent
references: the DIA matvec for Dirichlet boundaries and a dense numpy
matrix built from the stencil's definition, for both boundaries."""

import numpy as np
import jax.numpy as jnp
import pytest

from arnoldimethod_jax.models.operators import Stencil5Operator
from arnoldimethod_jax.models.problems import (
    _grid_2d,
    convection_diffusion_2d,
    laplacian_2d,
)

# Grid shapes (ny, nx): square and wide grids, rows that are and are not
# multiples of 8, and single-digit row counts.
GRIDS = [
    (16, 128), (32, 128), (64, 256), (8, 128), (48, 128),
    (24, 128), (16, 8), (5, 7), (1, 32), (3, 2),
]
NONSYM = (4.0, -1.2, -0.8, -1.1, -0.9)  # catches west/east, north/south swaps


def _dense_stencil(coeffs, ny, nx, periodic):
    """y[i, j] = c x[i, j] + w x[i, j-1] + e x[i, j+1] + no x[i-1, j]
    + so x[i+1, j] on the row-major flattened grid, out-of-grid reads
    zero (Dirichlet) or wrapped (periodic)."""
    c, w, e, no, so = coeffs
    n = ny * nx
    A = np.zeros((n, n))
    for i in range(ny):
        for j in range(nx):
            r = i * nx + j
            A[r, r] += c
            for di, dj, v in ((0, -1, w), (0, 1, e), (-1, 0, no), (1, 0, so)):
                ii, jj = i + di, j + dj
                if periodic:
                    ii, jj = ii % ny, jj % nx
                elif not (0 <= ii < ny and 0 <= jj < nx):
                    continue
                A[r, ii * nx + jj] += v
    return A


@pytest.mark.parametrize("ny,nx", GRIDS)
def test_stencil_matches_dia_dirichlet(ny, nx):
    op = Stencil5Operator(NONSYM, (ny, nx), dtype=jnp.float32)
    dia = _grid_2d(nx, ny, *NONSYM, np.float32, "dia")
    x = np.random.default_rng(ny * nx).standard_normal(ny * nx)
    x = jnp.asarray(x, jnp.float32)
    np.testing.assert_allclose(
        np.asarray(op.matvec(x)), np.asarray(dia.matvec(x)), atol=1e-5
    )


@pytest.mark.parametrize("ny,nx", GRIDS)
def test_stencil_matches_dense_periodic(ny, nx):
    op = Stencil5Operator(NONSYM, (ny, nx), dtype=jnp.float64,
                          boundary="periodic")
    A = _dense_stencil(NONSYM, ny, nx, periodic=True)
    x = np.random.default_rng(ny + nx).standard_normal(ny * nx)
    np.testing.assert_allclose(
        np.asarray(op.matvec(jnp.asarray(x))), A @ x, rtol=1e-12, atol=1e-12
    )


@pytest.mark.parametrize("boundary", ["dirichlet", "periodic"])
def test_stencil_convection_diffusion(boundary):
    """The convection-diffusion coefficients (fmt="stencil") against the
    dense definition; for Dirichlet also against the DIA build."""
    nx = ny = 16
    h = 1.0 / (nx + 1)
    beta = 10.0 * h / 2.0
    coeffs = (4.0, -1.0 - beta, -1.0 + beta, -1.0, -1.0)
    op = Stencil5Operator(coeffs, (ny, nx), dtype=jnp.float64,
                          boundary=boundary)
    A = _dense_stencil(coeffs, ny, nx, periodic=boundary == "periodic")
    x = np.random.default_rng(5).standard_normal(ny * nx)
    y = np.asarray(op.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(y, A @ x, rtol=1e-12, atol=1e-12)
    if boundary == "dirichlet":
        dia = convection_diffusion_2d(nx, ny, peclet=10.0, dtype=np.float64,
                                      fmt="dia")
        np.testing.assert_allclose(
            y, np.asarray(dia.matvec(jnp.asarray(x))), rtol=1e-12
        )


def test_stencil_operator_through_solver():
    """The Stencil5Operator drives partial_schur end to end."""
    from arnoldimethod_jax import partial_schur

    op = laplacian_2d(16, 16, fmt="stencil", dtype=jnp.float64)
    decomp, history = partial_schur(op, nev=4, which="SR", tol=1e-8)
    assert history.converged
    # Every returned eigenvalue is in the exact spectrum (multiplicities
    # need not all be found — documented Arnoldi behavior, ref:
    # test/partial_schur.jl:93-94), and the smallest one is found.
    k = np.pi * np.arange(1, 17) / 17
    mu = 2 - 2 * np.cos(k)
    spectrum = np.sort((mu[:, None] + mu[None, :]).ravel())
    got = np.sort(decomp.eigenvalues.real)
    for lam in got:
        assert np.min(np.abs(spectrum - lam)) < 1e-7
    assert abs(got[0] - spectrum[0]) < 1e-7
