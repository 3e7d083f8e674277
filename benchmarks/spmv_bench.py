"""SpMV format shoot-out on the 2-D Laplacian: DIA vs ELL vs stencil —
nnz/s per device (BASELINE.json)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time

import numpy as np
import jax
import jax.numpy as jnp

from arnoldimethod_jax.models.problems import laplacian_2d


def bench_op(label, op, iters=100):
    n = op.shape[0]

    @jax.jit
    def run(y, steps):
        return jax.lax.fori_loop(0, steps, lambda i, y: op.matvec(y) * 0.125, y)

    x = jnp.ones(n, dtype=jnp.float32)
    y = run(x, 2)
    jax.block_until_ready(y)
    t0 = time.perf_counter()
    y = run(x, iters)
    jax.block_until_ready(y)
    dt = (time.perf_counter() - t0) / iters
    nnz = op.nnz
    print(f"{label:24s} {nnz/dt/1e9:8.2f} GNNZ/s   {dt*1e6:8.1f} us/iter")


def main(grid=1024):
    for fmt in ("dia", "ell", "stencil"):
        op = laplacian_2d(grid, grid, dtype=jnp.float32, fmt=fmt)
        bench_op(f"laplacian_2d[{fmt}]", op)


if __name__ == "__main__":
    main()
