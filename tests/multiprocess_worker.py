"""Worker for test_multiprocess: one controller process of a simulated
multi-host pod (N processes x 4 virtual CPU devices = one global mesh).
Run as: python multiprocess_worker.py <process_id> <num_processes> <port>.
"""

import os
import sys

pid = int(sys.argv[1])
nproc = int(sys.argv[2])
port = sys.argv[3]

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
jax.distributed.initialize(
    coordinator_address=f"localhost:{port}", num_processes=nproc, process_id=pid
)

import numpy as np  # noqa: E402

from arnoldimethod_jax import partial_schur  # noqa: E402
from arnoldimethod_jax.models.problems import laplacian_1d  # noqa: E402
from arnoldimethod_jax.parallel.mesh import (  # noqa: E402
    basis_sharding,
    make_pod_mesh,
    shard_operator,
)

assert jax.device_count() == 4 * nproc, jax.devices()
assert jax.local_device_count() == 4

mesh = make_pod_mesh()
assert mesh.devices.size == 4 * nproc
op = shard_operator(laplacian_1d(256), mesh)
decomp, history = partial_schur(
    op, nev=4, which="SR", tol=1e-8, sharding=basis_sharding(mesh)
)
lams = np.sort(decomp.eigenvalues.real)
exact = np.sort(2 - 2 * np.cos(np.pi * np.arange(1, 257) / 257))[:4]
err = float(np.max(np.abs(lams - exact)))
assert history.converged and err < 1e-7, (history, err)
print(f"RESULT {pid} {history.mvproducts} {err:.3e} OK", flush=True)
