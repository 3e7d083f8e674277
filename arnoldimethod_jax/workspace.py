"""Arnoldi workspace: the large arrays of the solver and their ownership.

The device/host split follows the L3/L2 boundary of the algorithm
(SURVEY.md §3.1): the n-sized Krylov basis V lives on device as a
(maxdim+1, n) array (vectors are rows; n is the sharded axis), while the
(maxdim+1) x maxdim Hessenberg matrix H is authoritative on host in
float64/complex128 — the dense restart kernels run there and only freshly
expanded columns ever round-trip through the device dtype.

Behavioral reference: ArnoldiMethod.jl src/ArnoldiMethod.jl:41-93
(ArnoldiWorkspace with V, H, V_tmp, Q).  V_tmp is unnecessary here (the
basis change is a functional XLA GEMM with buffer donation) and Q is a
transient of each restart.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["ArnoldiWorkspace"]


class ArnoldiWorkspace:
    """Holds V ((maxdim+1, n) device array, basis vectors as rows) and H
    ((maxdim+1, maxdim) host float64/complex128).  The Arnoldi relation
    maintained is A @ V[:k].T = V[:k+1].T @ H[:k+1, :k].

    Supports the same three uses as the reference type: fresh allocation,
    warm restart from an existing decomposition (`partial_schur` with
    start_from), and reuse across calls without reallocation.
    """

    def __init__(self, n, maxdim, dtype=jnp.float32, V=None, H=None, sharding=None):
        if maxdim > n:
            raise ValueError("Krylov dimension should be less than matrix order.")
        if maxdim < 1:
            raise ValueError("Krylov dimension must be at least 1.")
        self.n = int(n)
        self.maxdim = int(maxdim)

        if V is None:
            V = jnp.zeros((maxdim + 1, n), dtype=dtype)
        else:
            # Copy: the driver donates V buffers to the jitted kernels, so
            # the workspace must own its storage, not alias the caller's.
            V = jnp.array(V, dtype=dtype, copy=True)
            if V.shape != (maxdim + 1, n):
                raise ValueError(
                    f"V must have shape {(maxdim + 1, n)}, got {V.shape}"
                )
        if sharding is not None:
            V = jax.device_put(V, sharding)
        self.V = V
        # Low word of the basis for extended-precision solves
        # (partial_schur(..., extended=True)): set by the driver after an
        # extended run so a warm start resumes at double-word accuracy;
        # None after plain solves (which track only the single-word V).
        self.Vlo = None
        # Imaginary word of the basis for split-complex solves
        # (split_complex=True — ops/sc_expansion.py); None for real/plain
        # complex solves.
        self.Vim = None
        # Low word of the HOST Hessenberg for double-double solves
        # (extended=True with float64 words): H stores the hi words, Hlo
        # the lo words, so a warm start resumes the locked block at the
        # full ~1e-32 accuracy the criterion certifies.  None otherwise.
        self.Hlo = None
        self.sharding = sharding

        host_dtype = (
            np.complex128 if jnp.issubdtype(jnp.dtype(dtype), jnp.complexfloating) else np.float64
        )
        if H is None:
            H = np.zeros((maxdim + 1, maxdim), dtype=host_dtype)
        else:
            H = np.array(H, dtype=host_dtype)
            if H.shape != (maxdim + 1, maxdim):
                raise ValueError(
                    f"H must have shape {(maxdim + 1, maxdim)}, got {H.shape}"
                )
        self.H = H

    @property
    def dtype(self):
        return self.V.dtype

    # -- Checkpoint / resume ------------------------------------------------
    #
    # The workspace *is* the solver's checkpoint (ref: run.jl:131-179 —
    # partialschur! with start_from): V holds the locked Schur vectors, H
    # the locked R block.  Together with `partial_schur(...,
    # workspace=ws, start_from=nconverged)` a run can resume after a
    # restart, change nev/tol, or move between hosts.

    def save(self, path):
        """Serialize to an .npz file (host-side; V is fetched)."""
        extra = {}
        if self.Vlo is not None:
            extra["Vlo"] = np.asarray(self.Vlo)
        if self.Vim is not None:
            extra["Vim"] = np.asarray(self.Vim)
        if self.Hlo is not None:
            extra["Hlo"] = np.asarray(self.Hlo)
        np.savez(
            path,
            V=np.asarray(self.V),
            H=self.H,
            n=self.n,
            maxdim=self.maxdim,
            dtype=str(self.V.dtype),
            **extra,
        )

    @classmethod
    def load(cls, path, sharding=None):
        """Restore a workspace saved with `save`."""
        with np.load(path, allow_pickle=False) as f:
            ws = cls(
                int(f["n"]),
                int(f["maxdim"]),
                dtype=jnp.dtype(str(f["dtype"])),
                V=f["V"],
                H=f["H"],
                sharding=sharding,
            )
            if "Vlo" in f:
                Vlo = jnp.asarray(f["Vlo"], dtype=ws.dtype)
                if sharding is not None:
                    Vlo = jax.device_put(Vlo, sharding)
                ws.Vlo = Vlo
            if "Vim" in f:
                Vim = jnp.asarray(f["Vim"], dtype=ws.dtype)
                if sharding is not None:
                    Vim = jax.device_put(Vim, sharding)
                ws.Vim = Vim
            if "Hlo" in f:
                ws.Hlo = np.array(f["Hlo"], dtype=np.float64)
            return ws
