"""Extended precision: Double64-class tolerances from float32 words.

The reference demonstrates converging the README Laplacian to tol=1e-28
by switching the element type to Double64 — double-word float64
arithmetic (ref: readme.md:81-105).  `extended=True` applies the same
technique to float32 words: the device-side work runs in double-word
FLOAT32 (ops/df32.py error-free transforms), reaching tolerances around
1e-12 where plain float32 stops at ~1e-6 (251 matvecs on the README
config).  Native float64 (jax_enable_x64) reaches ~1e-14 directly.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from arnoldimethod_jax import partial_schur
from arnoldimethod_jax.models import laplacian_1d

op = laplacian_1d(100, dtype=np.float32)  # float32 words

decomp, history = partial_schur(op, nev=10, which="SR", tol=1e-12,
                                extended=True)
print(history)

A = (
    np.diag(np.full(100, 2.0))
    + np.diag(np.full(99, -1.0), 1)
    + np.diag(np.full(99, -1.0), -1)
)
Q = np.asarray(decomp.Q)  # full double-word combine, float64
R = np.asarray(decomp.R)
print(f"Schur residual ||AQ - QR||   = {np.linalg.norm(A @ Q - Q @ R):.3e}")
print(f"orthonormality ||Q'Q - I||   = "
      f"{np.linalg.norm(Q.T @ Q - np.eye(10)):.3e}")
exact = np.sort(2 - 2 * np.cos(np.pi * np.arange(1, 101) / 101))[:10]
print(f"max eigenvalue error         = "
      f"{np.max(np.abs(np.sort(decomp.eigenvalues.real) - exact)):.3e}")

# ---------------------------------------------------------------------------
# The full Double64 workflow: float64 WORDS + double-double dense layer.
#
# With float64 input on an x64 backend (CPU mesh), extended=True carries
# the device basis as double-word float64 (~eps 4.9e-32) AND runs the
# host Hessenberg restart kernels in double-double scalars (ops/dd.py),
# so tolerances around 1e-28 are certified end-to-end — reproducing the
# reference's Double64 recipe (readme.md:81-105: 442 matvecs, residual
# ~5e-30).  Measured here against an exact rational-arithmetic oracle:
# tol=1e-28 converges in 451 matvecs with true Schur residual < 1e-27.
# Run on CPU with JAX x64 enabled:
#
#   JAX_PLATFORMS=cpu python examples/extended_precision.py
#
# (Guarded: this block is skipped on f32-only backends.)
import jax

if jax.local_devices()[0].platform == "cpu":
    jax.config.update("jax_enable_x64", True)
    op64 = laplacian_1d(100, dtype=np.float64)
    decomp64, history64 = partial_schur(op64, nev=10, which="SR",
                                        tol=1e-26, extended=True)
    print(history64)
    # Q/R return the HIGH words; Q_lo/R_lo carry the low words.  The
    # residual below evaluates in f64 only, so it floors near 1e-16 —
    # docs/precision.md shows the dd-true residual (7.7e-28 at tol=1e-26)
    # measured with the exact-arithmetic oracle in tests/test_dd.py.
    Q64, R64 = np.asarray(decomp64.Q), np.asarray(decomp64.R)
    print(f"f64-evaluated Schur residual = "
          f"{np.linalg.norm(A @ Q64 - Q64 @ R64):.3e}  (f64 eval floor)")
