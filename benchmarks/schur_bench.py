"""Dense-kernel microbenchmark: our LAPACK-free Schur factorization
(numpy and native C++) vs numpy.linalg.eigvals on an n=30 Hessenberg
matrix (mirrors reference bench/schur.jl:4-11)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time

import numpy as np

from arnoldimethod_jax.dense import local_schur
from arnoldimethod_jax.dense import native


def hessenberg(rng, n):
    H = np.triu(rng.standard_normal((n, n)), -1)
    return H


def run(n=30, reps=200):
    rng = np.random.default_rng(0)
    H0 = hessenberg(rng, n)

    t0 = time.perf_counter()
    for _ in range(reps):
        H = H0.copy()
        local_schur(H, 0, n)
    t_numpy = (time.perf_counter() - t0) / reps

    t_native = float("nan")
    if native.available():
        t0 = time.perf_counter()
        for _ in range(reps):
            H = H0.copy()
            native.local_schur(H, 0, n)
        t_native = (time.perf_counter() - t0) / reps

    t0 = time.perf_counter()
    for _ in range(reps):
        np.linalg.eigvals(H0)
    t_lapack = (time.perf_counter() - t0) / reps

    print(f"n={n}: local_schur numpy {t_numpy*1e6:8.1f} us | "
          f"native {t_native*1e6:8.1f} us | numpy(LAPACK) eigvals {t_lapack*1e6:8.1f} us")


if __name__ == "__main__":
    for n in (10, 30, 100):
        run(n)
