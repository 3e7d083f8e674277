"""partial_eigen: turn a partial Schur decomposition into eigenpairs.

Unlike the reference — whose `partialeigen` is its single LAPACK call
(eigvals.jl:82-95) — this stays LAPACK-free: the eigenvectors of the tiny
(quasi-)triangular R come from our own shifted backward substitution
(dense/eig.py), and the n-sized back-transformation X = Q @ S is one device
GEMM.

The reference's documented caveats carry over: unnecessary (and for
repeated eigenvalues potentially orthogonality-losing) for Hermitian
problems — the Schur vectors are then already eigenvectors
(ref: eigvals.jl:72-81).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .dense.eig import collect_eigen, eigenvalues
from .driver import PartialSchur

__all__ = ["partial_eigen"]


def partial_eigen(decomp: PartialSchur):
    """Return (values, vectors): values is a complex (or real, if the
    spectrum is real) numpy vector of length k, vectors an (n, k) array
    with unit-norm columns satisfying A @ vectors ~= vectors * values.

    vectors is a device array, except when the Schur basis is real but the
    spectrum has complex pairs: then the two real GEMMs are combined on
    host and vectors is a complex *numpy* array.
    """
    R = np.asarray(decomp.R)
    k = R.shape[0]
    if k == 0:
        return np.zeros(0), decomp.Q

    vals = eigenvalues(R)
    S = np.zeros((k, k), dtype=complex)
    buf = np.zeros(k, dtype=complex)
    for j in range(k):
        buf[:] = 0
        klen = collect_eigen(buf, R, j)
        col = np.zeros(k, dtype=complex)
        col[:klen] = buf[:klen]
        if not np.iscomplexobj(R) and j > 0 and R[j, j - 1] != 0:
            # Second member of a conjugate pair: conjugate eigenvector.
            col = np.conj(col)
        S[:, j] = col

    # Full-precision accumulation: an f32 matmul with no precision given
    # may run in TF32 on the GPU (~3 decimal digits), which would inflate
    # the eigenpair residual (same rule as every contraction in
    # ops/expansion.py).
    def _gemm(Q, S):
        return jnp.matmul(Q, S, precision=jax.lax.Precision.HIGHEST)

    all_real = bool(np.all(vals.imag == 0))
    if all_real:
        vals = vals.real
        S = S.real
        X = _gemm(decomp.Q, jnp.asarray(S, dtype=decomp.Q.dtype))
    else:
        if jnp.issubdtype(decomp.Q.dtype, jnp.complexfloating):
            X = _gemm(decomp.Q, jnp.asarray(S, dtype=decomp.Q.dtype))
        else:
            # Real Schur basis, complex pairs: two real device GEMMs
            # (the basis stays in its real dtype), combined on host.
            Sr = jnp.asarray(S.real, dtype=decomp.Q.dtype)
            Si = jnp.asarray(S.imag, dtype=decomp.Q.dtype)
            X = np.asarray(_gemm(decomp.Q, Sr)) + 1j * np.asarray(
                _gemm(decomp.Q, Si)
            )
    return vals, X
