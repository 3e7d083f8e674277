"""Interior eigenvalues by shift-and-invert (ref docs recipe,
docs/src/index.md:234-260): eigenvalues of the 1-D Laplacian nearest
sigma = 1.0."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from arnoldimethod_jax import ShiftInvertDenseOperator, partial_eigen, partial_schur

n = 256
A = (
    np.diag(np.full(n, 2.0))
    + np.diag(np.full(n - 1, -1.0), 1)
    + np.diag(np.full(n - 1, -1.0), -1)
)
sigma = 1.0

si = ShiftInvertDenseOperator.build(A, sigma)
decomp, history = partial_schur(si, nev=4, which="LM", tol=1e-9)
print(history)

thetas, X = partial_eigen(decomp)
lams = sigma + 1.0 / thetas
X = np.asarray(X)
print("eigenvalues nearest", sigma, ":", np.round(np.sort(np.real(lams)), 6))
print("residual:", np.linalg.norm(A @ X - X * lams))
