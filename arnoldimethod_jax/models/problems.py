"""Model problems: standard test/benchmark matrices as sparse operators.

These mirror the matrices used throughout the reference's README, docs and
bench harnesses (1-D Laplacian readme.md:30-34, n=6000 tridiagonal
bench/partial_schur.jl:9, 2-D Laplacian / convection-diffusion from
BASELINE.json configs).

Each builder returns the DIA (diagonal) layout by default — the
streaming format for stencil matrices (no gather) — or padded ELL with
fmt="ell" (the general-sparse layout that exercises the gather path).
"""

from __future__ import annotations

import numpy as np

from .operators import DiaOperator, EllOperator, Stencil5Operator

__all__ = ["laplacian_1d", "tridiagonal", "laplacian_2d", "convection_diffusion_2d", "convection_diffusion_periodic_2d"]


def _dia(offset_values, n, dtype):
    offsets = sorted(offset_values)
    diags = np.zeros((len(offsets), n), dtype=dtype)
    for d, off in enumerate(offsets):
        diags[d] = offset_values[off]
        if off > 0:
            diags[d, n - off :] = 0
        elif off < 0:
            diags[d, : -off] = 0
    return DiaOperator(diags, offsets, (n, n))


def _ell_from_dia(offset_values, n, dtype):
    offsets = sorted(offset_values)
    K = len(offsets)
    data = np.zeros((n, K), dtype=dtype)
    cols = np.zeros((n, K), dtype=np.int32)
    i = np.arange(n)
    for d, off in enumerate(offsets):
        valid = (i + off >= 0) & (i + off < n)
        vals = np.broadcast_to(np.asarray(offset_values[off], dtype=dtype), (n,))
        data[valid, d] = vals[valid]
        cols[valid, d] = i[valid] + off
    return EllOperator(data, cols, (n, n))


def _build(offset_values, n, dtype, fmt):
    if fmt == "dia":
        return _dia(offset_values, n, dtype)
    if fmt == "ell":
        return _ell_from_dia(offset_values, n, dtype)
    raise ValueError(f"unknown sparse format {fmt!r}")


def tridiagonal(n, lower, diag, upper, dtype=np.float64, fmt="dia"):
    """Tridiagonal Toeplitz matrix."""
    return _build({-1: lower, 0: diag, 1: upper}, n, dtype, fmt)


def laplacian_1d(n, dtype=np.float64, fmt="dia"):
    """1-D Laplacian (-1, 2, -1): the README parity matrix
    (ref: readme.md:30-34)."""
    return tridiagonal(n, -1.0, 2.0, -1.0, dtype=dtype, fmt=fmt)


def _grid_2d(nx, ny, center, west, east, north, south, dtype, fmt):
    if fmt == "stencil":
        return Stencil5Operator((center, west, east, north, south), (ny, nx), dtype=dtype)
    n = nx * ny
    i = np.arange(n)
    in_row_left = i % nx != 0  # has a west neighbor
    in_row_right = i % nx != nx - 1  # has an east neighbor
    offset_values = {
        -nx: np.full(n, north, dtype=dtype),
        -1: np.where(in_row_left, west, 0.0).astype(dtype),
        0: np.full(n, center, dtype=dtype),
        1: np.where(in_row_right, east, 0.0).astype(dtype),
        nx: np.full(n, south, dtype=dtype),
    }
    return _build(offset_values, n, dtype, fmt)


def laplacian_2d(nx, ny=None, dtype=np.float64, fmt="dia"):
    """2-D 5-point Laplacian on an nx-by-ny grid (row-major ordering),
    n = nx*ny rows with <= 5 nonzeros per row."""
    if ny is None:
        ny = nx
    return _grid_2d(nx, ny, 4.0, -1.0, -1.0, -1.0, -1.0, dtype, fmt)


def convection_diffusion_2d(nx, ny=None, peclet=10.0, dtype=np.float64, fmt="dia"):
    """Nonsymmetric 2-D convection-diffusion (central-difference convection
    in x): produces complex conjugate eigenvalue pairs for the 2x2-block
    real Schur path (BASELINE.json config 3)."""
    if ny is None:
        ny = nx
    h = 1.0 / (nx + 1)
    beta = peclet * h / 2.0
    return _grid_2d(nx, ny, 4.0, -1.0 - beta, -1.0 + beta, -1.0, -1.0, dtype, fmt)


def convection_diffusion_periodic_2d(nx, ny=None, cx=0.15, cy=0.08,
                                     scale=1.0, dtype=np.float32):
    """Periodic (torus) convection-diffusion: the 2-D circulant stencil

        scale * [ 4, -1-cx, -1+cx, -1-cy, -1+cy ]  (c, w, e, n, s)

    — genuinely NONSYMMETRIC (central-difference convection in both
    directions) yet NORMAL (a 2-D circulant), so its eigenproblem is
    well-conditioned at any n, unlike the Dirichlet operator whose
    departure from normality grows like ((1+beta)/(beta-1))^(nx/2) for
    beta > 1 and makes the true spectrum unreachable by ANY
    backward-stable method at large nx (docs/precision.md).  The exact
    spectrum is the DFT symbol

        lam(j, k) = scale * [ (2 - 2 cos th_j) + (2 - 2 cos ph_k)
                              + 2 i (cx sin th_j + cy sin ph_k) ]

    with th_j = 2 pi j / nx, ph_k = 2 pi k / ny: complex conjugate
    pairs (j <-> nx - j), real parts in [0, 8 scale] — the checkable
    nonsymmetric model problem at the 1M-row scale (bench `conv1m`,
    docs/transforms.md 'nonsymmetric filtering')."""
    if ny is None:
        ny = nx
    c = [4.0, -1.0 - cx, -1.0 + cx, -1.0 - cy, -1.0 + cy]
    return Stencil5Operator(
        tuple(scale * v for v in c), (ny, nx), dtype=dtype,
        boundary="periodic",
    )
