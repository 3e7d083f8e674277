"""Complex matrices: native complex64 and the split-complex path.

`partial_schur` solves complex inputs natively (complex64 Krylov basis on
the device); `split_complex=True` carries the basis as a real (re, im)
pair instead (ops/sc_expansion.py).  The complex-only :LI target —
eigenvalues with the largest imaginary part — runs both ways.

Run:  python examples/split_complex.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from arnoldimethod_jax import partial_schur

rng = np.random.default_rng(0)
n = 400
A = (
    rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
).astype(np.complex64) / np.sqrt(n)

decomp, history = partial_schur(A, nev=6, which="LI", tol=1e-5,
                                mindim=12, maxdim=24, restarts=500)
print(history)
_, history_sc = partial_schur(A, nev=6, which="LI", tol=1e-5, mindim=12,
                              maxdim=24, restarts=500, split_complex=True)
print("split_complex=True:", history_sc)

Q = np.asarray(decomp.Q)
R = np.asarray(decomp.R)
A64 = A.astype(np.complex128)
print("Schur residual ||AQ - QR|| / ||A|| =",
      np.linalg.norm(A64 @ Q - Q @ R) / np.linalg.norm(A64))
print("largest-imaginary eigenvalues:")
print(np.round(decomp.eigenvalues, 4))
