"""Row-sharded solve over all visible devices (runs on several GPUs or on
a virtual CPU mesh: XLA_FLAGS=--xla_force_host_platform_device_count=8
JAX_PLATFORMS=cpu)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from arnoldimethod_jax import partial_schur
from arnoldimethod_jax.models import laplacian_2d
from arnoldimethod_jax.parallel import basis_sharding, make_mesh, shard_operator

mesh = make_mesh()
print(f"mesh: {mesh.devices.size} x {jax.devices()[0].platform}")

op = shard_operator(laplacian_2d(64, 64, fmt="dia"), mesh)
# The smallest eigenvalues of a grid Laplacian cluster; give the Krylov
# space some room (for large grids, prefer shift-and-invert instead).
decomp, history = partial_schur(
    op, nev=5, which="SR", tol=1e-6, maxdim=48, mindim=12,
    sharding=basis_sharding(mesh),
)
print(history)
print("eigenvalues:", np.round(decomp.eigenvalues.real, 6))
print("Q sharded over", len(decomp.Q.sharding.device_set), "devices")
