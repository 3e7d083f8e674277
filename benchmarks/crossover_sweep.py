"""Host-vs-fused-device crossover sweep.

Measures the warm wall of a FIXED-restart-count Krylov-Schur solve for
every (n, maxdim, method) cell of the crossover surface:

    n       in {65_536 (nx=256), 1_048_576 (nx=1024)}
    maxdim  in {20, 40, 60, 80}   (mindim = maxdim // 2)
    method  in {"host", "device"}

The solve is pinned to exactly R restarts by asking for the SMALLEST
eigenvalues of the 2-D Laplacian at a tolerance f32 cannot reach in R
restarts, so the wall measures per-restart cost (truncation + expansion
+ dense restart work + host<->device round trips), not convergence
luck.  Each cell is run once cold (compile) and >= 3x warm; min and
median are reported per the bench.py `_min_med` protocol.

The surface is what a `method=None` auto-select boundary would be set
from; until it is measured on the GPU, `method=None` means "host".  Run
on one GPU, from any directory:

    python benchmarks/crossover_sweep.py [--restarts 12] [--warm 3]

Reference framing: the reference has a single (host, Julia) execution
path (the reference's src/run.jl); which side of the host<->device
boundary runs the dense restart layer is a design question of this
implementation.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# The repo root (for bench.py and the package), whatever the cwd.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _stencil_op(grid):
    import jax.numpy as jnp

    from arnoldimethod_jax.models.operators import Stencil5Operator

    s = 0.130
    return Stencil5Operator(
        tuple(s * c for c in (4.0, -1.0, -1.0, -1.0, -1.0)),
        (grid, grid),
        dtype=jnp.float32,
    )


# One measurement protocol for the sweep and the phases it calibrates:
# bench.py owns min/median.
from bench import _min_med  # noqa: E402


def run_cell(op, maxdim, method, restarts, warm):
    from arnoldimethod_jax import partial_schur

    import numpy as np

    kw = dict(
        nev=5,
        which="SR",
        tol=1e-12,
        mindim=maxdim // 2,
        maxdim=maxdim,
        restarts=restarts,
        method=method,
    )
    t0 = time.perf_counter()
    decomp, history = partial_schur(op, **kw)
    np.asarray(decomp.Q[:, :1])
    cold = time.perf_counter() - t0

    walls = []
    for _ in range(warm):
        t0 = time.perf_counter()
        decomp, history = partial_schur(op, **kw)
        np.asarray(decomp.Q[:, :1])
        walls.append(time.perf_counter() - t0)
    wmin, wmed = _min_med(walls)
    return {
        "cold_s": round(cold, 2),
        "warm_min_s": wmin,
        "warm_med_s": wmed,
        "restarts_done": history.restarts,
        "nconverged": history.nconverged,
        "ms_per_restart": round(1e3 * wmin / max(history.restarts, 1), 1),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--restarts", type=int, default=12)
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--grids", type=int, nargs="*", default=[256, 1024])
    ap.add_argument("--maxdims", type=int, nargs="*", default=[20, 40, 60, 80])
    args = ap.parse_args()

    import jax

    print(f"# devices: {jax.devices()}", file=sys.stderr)

    out = {}
    rows = []
    for grid in args.grids:
        op = _stencil_op(grid)
        n = grid * grid
        for maxdim in args.maxdims:
            cells = {}
            for method in ("host", "device"):
                r = run_cell(op, maxdim, method, args.restarts, args.warm)
                cells[method] = r
                key = f"x_{n}_{maxdim}_{method}"
                out[key + "_warm_min_s"] = r["warm_min_s"]
                out[key + "_warm_med_s"] = r["warm_med_s"]
                print(
                    f"n={n} maxdim={maxdim} {method}: {r}",
                    file=sys.stderr,
                    flush=True,
                )
            ratio = round(
                cells["host"]["warm_min_s"] / cells["device"]["warm_min_s"], 2
            )
            out[f"x_{n}_{maxdim}_device_speedup"] = ratio
            rows.append((n, maxdim, cells["host"], cells["device"], ratio))

    print("\n| n | maxdim | host warm min/med (s) | device warm min/med (s) "
          "| device speedup |")
    print("|---|---|---|---|---|")
    for n, maxdim, h, d, ratio in rows:
        print(
            f"| {n:,} | {maxdim} | {h['warm_min_s']} / {h['warm_med_s']} "
            f"| {d['warm_min_s']} / {d['warm_med_s']} | **{ratio}x** |"
        )
    print()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
