"""End-to-end float32 coverage: the GPU production dtype, exercised on the CPU
mesh with appropriately scaled tolerances (analogue of the reference's
multi-eltype sweep, test/schur_to_eigen.jl:7-25).

The achievable tolerance floor per dtype is set by the scale-invariant
convergence criterion rs <= max(eps_work * ||H||_F, tol * |lam|)
(driver, ref run.jl:188-208): for float32 the eps floor is ~1.2e-7 * ||H||,
so tol below ~1e-6 relative buys nothing — see docs/precision.md.
"""

import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest

from arnoldimethod_jax import ArnoldiWorkspace, partial_eigen, partial_schur
from arnoldimethod_jax.models.problems import laplacian_1d

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

EPS32 = float(np.finfo(np.float32).eps)


def _residual(A, decomp):
    Q = np.asarray(decomp.Q, dtype=np.float64)
    R = np.asarray(decomp.R)
    return np.linalg.norm(A @ Q - Q @ R)


def _laplacian_dense(n):
    return (
        np.diag(np.full(n, 2.0))
        + np.diag(np.full(n - 1, -1.0), 1)
        + np.diag(np.full(n - 1, -1.0), -1)
    )


def test_readme_parity_f32():
    """The README config in float32: converges in the same
    matvec ballpark with residual at the f32 criterion floor."""
    op = laplacian_1d(100, dtype=np.float32)
    decomp, history = partial_schur(op, nev=10, which="SR", tol=1e-6)
    assert history.converged
    assert history.mvproducts < 300  # reference f64: 174
    A = _laplacian_dense(100)
    assert _residual(A, decomp) < 1e-5
    exact = np.sort(2 - 2 * np.cos(np.pi * np.arange(1, 101) / 101))[:10]
    assert np.allclose(np.sort(decomp.eigenvalues.real), exact, atol=1e-5)


def test_partial_eigen_f32():
    """partial_eigen keeps the Schur-level residual in f32 (regression for
    the bf16-matmul back-transform bug: the X = Q S GEMM must request
    full-precision accumulation)."""
    op = laplacian_1d(100, dtype=np.float32)
    decomp, history = partial_schur(op, nev=10, which="SR", tol=1e-6)
    vals, X = partial_eigen(decomp)
    A = _laplacian_dense(100)
    X = np.asarray(X, dtype=np.float64)
    assert np.linalg.norm(A @ X - X * np.asarray(vals)) < 1e-5


def test_zero_matrix_f32():
    """Convergence <= edge + singular backward substitution in f32
    (ref: test/partial_schur.jl:108-120)."""
    A = np.zeros((5, 5), dtype=np.float32)
    decomp, history = partial_schur(A)
    assert history.converged
    assert history.mvproducts == 5
    assert history.nconverged == 5
    Q = np.asarray(decomp.Q)
    assert np.linalg.norm(Q.T @ Q - np.eye(5)) < 100 * EPS32
    assert _residual(A.astype(np.float64), decomp) == 0


def test_rank3_breakdown_f32():
    """Rank-3 10x10 in f32: the breakdown/reinitialization path still
    converges in exactly 7 matvecs (ref: test/partial_schur.jl:6-27)."""
    rng = np.random.default_rng(1)
    W = rng.standard_normal((10, 3)).astype(np.float32)
    B = (W @ W.T).astype(np.float32)
    decomp, history = partial_schur(B, nev=5, mindim=5, maxdim=7, tol=EPS32)
    assert history.converged
    assert history.mvproducts == 7
    Q = np.asarray(decomp.Q)
    assert np.linalg.norm(Q.T @ Q - np.eye(5)) < 1000 * EPS32
    assert _residual(B.astype(np.float64), decomp) < 1000 * EPS32 * np.linalg.norm(B)


def test_warm_start_f32():
    """Workspace save/resume in the device dtype (ref: run.jl:131-179)."""
    rng = np.random.default_rng(7)
    A = rng.standard_normal((100, 100)).astype(np.float32)

    ws = ArnoldiWorkspace(100, 20, dtype=jnp.float32)
    F, history = partial_schur(A, workspace=ws, nev=3, tol=1e-5)
    assert history.converged

    F2, history2 = partial_schur(
        A, workspace=ws, nev=5, start_from=history.nconverged, tol=1e-4
    )
    assert history2.converged
    assert history2.nconverged >= 5
    assert _residual(A.astype(np.float64), F2) < 1e-2


def test_f32_tol_floor_documented():
    """tol far below the f32 criterion floor still terminates (the eps *
    ||H||_F floor takes over) and delivers f32-limited residuals — the
    behavior docs/precision.md documents."""
    op = laplacian_1d(100, dtype=np.float32)
    decomp, history = partial_schur(
        op, nev=4, which="SR", tol=1e-12, restarts=60
    )
    # The floor lets the solver terminate; the residual is f32-limited.
    A = _laplacian_dense(100)
    assert history.nconverged >= 4
    assert _residual(A, decomp) < 1e-4


def test_device_dense_float64_without_x64():
    """With JAX's default x64 off, the fused restart still does its dense
    arithmetic in float64: the float32 README solve matches the host
    method's Schur residual (the float32 dense version drifted past the
    5e-6 bound).  Child process: this suite turns x64 on for itself."""
    code = """
import jax, numpy as np
jax.config.update("jax_platforms", "cpu")
assert not jax.config.jax_enable_x64
from arnoldimethod_jax import partial_schur
from arnoldimethod_jax.models.problems import laplacian_1d
A = np.diag(np.full(100, 2.0)) - np.eye(100, k=1) - np.eye(100, k=-1)
res = []
for method in ("host", "device"):
    d, h = partial_schur(laplacian_1d(100, dtype=np.float32), nev=10,
                         which="SR", tol=1e-6, method=method)
    assert h.converged and d.Q_rows.dtype == np.float32
    Q = np.asarray(d.Q, np.float64)
    res.append(np.linalg.norm(A @ Q - Q @ np.asarray(d.R)))
assert res[1] <= 5e-6 and abs(res[1] - res[0]) <= 1e-9, res
assert not jax.config.jax_enable_x64
"""
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("JAX_ENABLE_X64", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
