"""Shift-invert convergence benchmark: n=6000 tridiagonal
(-1, 2, -1.001), nev=10, mindim=11, maxdim=22 — the reference's
bench/partial_schur.jl:37-52 configuration (there via a sparse
factorization + ldiv!; here via the pivoted tridiagonal LU whose
triangular solves run as log-depth associative scans on device,
TridiagonalShiftInvertOperator).  The dense-LU operator runs as a
comparison point."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time

import numpy as np
import jax
import jax.numpy as jnp

from arnoldimethod_jax import (
    ShiftInvertDenseOperator,
    TridiagonalShiftInvertOperator,
    partial_eigen,
    partial_schur,
)


def _report(name, A, si, t_fact, exact, nev=10, tol=1e-7):
    t0 = time.perf_counter()
    decomp, history = partial_schur(
        si, nev=nev, which="LM", tol=tol, mindim=11, maxdim=22
    )
    jax.block_until_ready(decomp.Q)
    t_solve = time.perf_counter() - t0
    # warm second solve: all device programs compiled
    t0 = time.perf_counter()
    decomp, history = partial_schur(
        si, nev=nev, which="LM", tol=tol, mindim=11, maxdim=22
    )
    jax.block_until_ready(decomp.Q)
    t_warm = time.perf_counter() - t0

    thetas, X = partial_eigen(decomp)
    lams = si.sigma + 1.0 / np.asarray(thetas)
    X = np.asarray(X).astype(np.complex128 if np.iscomplexobj(lams) else np.float64)

    # Oracles, evaluated on host in float64: (a) spectral-normalized
    # eigenvalue error against the analytic Toeplitz spectrum
    # lam_k = b + 2 sqrt(ac) cos(k pi/(n+1)); (b) per-pair residuals
    # |A x - lam x| (absolute — the wanted lams cluster near sigma, so a
    # lam-relative quotient would just measure 1/|lam|).
    normA = 4.003
    eig_err = max(np.min(np.abs(exact - l)) for l in lams) / normA
    resid = np.median(
        [np.linalg.norm(A @ X[:, i] - lams[i] * X[:, i]) for i in range(len(lams))]
    )
    print(
        f"{name}: factorize {t_fact:.2f}s, solve {t_solve:.2f}s "
        f"(warm {t_warm:.2f}s), {history.mvproducts} matvecs, "
        f"{history.restarts} restarts, eig err {eig_err:.2e} (of ||A||), "
        f"median |Ax-lx| {resid:.2e}"
    )


def run(n=6000):
    dl = np.full(n - 1, -1.0)
    d = np.full(n, 2.0)
    du = np.full(n - 1, -1.001)
    A = np.diag(d) + np.diag(dl, -1) + np.diag(du, 1)
    exact = 2.0 + 2.0 * np.sqrt(1.001) * np.cos(
        np.arange(1, n + 1) * np.pi / (n + 1)
    )

    t0 = time.perf_counter()
    si = TridiagonalShiftInvertOperator.build(dl, d, du, sigma=0.0, dtype=np.float32)
    jax.block_until_ready(si.factors[0])
    _report(f"tridiag-LU scan solve n={n}", A, si, time.perf_counter() - t0, exact)

    t0 = time.perf_counter()
    si = ShiftInvertDenseOperator.build(jnp.asarray(A, dtype=jnp.float32), 0.0)
    si.sigma = 0.0
    jax.block_until_ready(si.lu)
    _report(f"dense-LU solve        n={n}", A, si, time.perf_counter() - t0, exact)


if __name__ == "__main__":
    run()
