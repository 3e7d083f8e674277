"""Quickstart: the reference README example.

Computes the 10 smallest-real-part eigenvalues of the 100x100 1-D
Laplacian to tol=1e-6 (ref: readme.md:24-60 — converges in ~160-190
matvecs; the count depends on the random initial vector), then turns the
Schur form into eigenpairs."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from arnoldimethod_jax import partial_eigen, partial_schur
from arnoldimethod_jax.models import laplacian_1d

op = laplacian_1d(100)
decomp, history = partial_schur(op, nev=10, which="SR", tol=1e-6)
print(history)

A = (
    np.diag(np.full(100, 2.0))
    + np.diag(np.full(99, -1.0), 1)
    + np.diag(np.full(99, -1.0), -1)
)
Q = np.asarray(decomp.Q)
R = np.asarray(decomp.R)
print("Schur residual ||AQ - QR|| =", np.linalg.norm(A @ Q - Q @ R))

vals, X = partial_eigen(decomp)
X = np.asarray(X)
print("eigenpair residual ||AX - X diag(vals)|| =", np.linalg.norm(A @ X - X * vals))
print("eigenvalues:", np.round(np.sort(np.real(vals)), 6))
