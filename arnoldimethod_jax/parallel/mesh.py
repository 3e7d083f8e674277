"""Device-mesh scaling: 1-D row partitioning over the device interconnect.

The solver's distribution model (SURVEY.md §2.4): the n-sized objects — the
operator's rows and the Krylov basis V's column axis — are sharded over a
1-D `rows` mesh axis spanning the devices, while H/Q and all dense
restart work stay replicated (they are maxdim-sized).  With these
shardings, XLA's GSPMD partitioner inserts exactly the collectives the
algorithm needs:

  * Gram-Schmidt coefficients h = V* w contract over the sharded axis
    -> an all-reduce (psum) over `rows` — the latency-critical reduction,
    two per Arnoldi step with DGKS;
  * the SpMV's x-gather -> an all-gather of the input vector segments
    (the halo exchange generalization);
  * the basis-change GEMM Qbig^T V is elementwise in the sharded axis
    -> no communication at all.

There is nothing else to communicate: `partial_schur(..., sharding=...)`
is the entire multi-device story for the caller.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.operators import (
    CsrOperator,
    DenseOperator,
    DiaOperator,
    EllOperator,
    ShardedCsrOperator,
)

__all__ = [
    "make_mesh",
    "make_pod_mesh",
    "basis_sharding",
    "vector_sharding",
    "replicated_sharding",
    "shard_operator",
]

ROWS = "rows"


def make_mesh(n_devices=None, devices=None):
    """A 1-D mesh over the first `n_devices` (default: all) devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"requested a {n_devices}-device mesh but only "
                f"{len(devices)} JAX devices are visible"
            )
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (ROWS,))


def make_pod_mesh():
    """A 1-D `rows` mesh spanning every device of every host.

    For multi-host runs (BASELINE.json config 5) each host calls
    `jax.distributed.initialize()` first, then this helper: device order
    comes from `mesh_utils.create_device_mesh`, which lays out the global
    device list of all hosts so that mesh-adjacent devices are, where the
    topology allows, on the same host — the row-partition boundary
    collectives (the all_gather of x segments and the Gram-Schmidt psums)
    then cross hosts only at host boundaries.  On a single host this is
    identical to `make_mesh()`.
    """
    from jax.experimental import mesh_utils

    devs = mesh_utils.create_device_mesh((len(jax.devices()),))
    return Mesh(devs, (ROWS,))


def basis_sharding(mesh):
    """Sharding for V (maxdim+1, n): n on the `rows` axis (and the minor
    dimension)."""
    return NamedSharding(mesh, P(None, ROWS))


def vector_sharding(mesh):
    """Sharding for length-n vectors."""
    return NamedSharding(mesh, P(ROWS))


def replicated_sharding(mesh):
    return NamedSharding(mesh, P())


def shard_operator(op, mesh):
    """Place an operator's arrays row-partitioned on the mesh.  Unknown
    operator types are returned unchanged (their closures decide).

    The row count must divide evenly over the mesh: padding a spectral
    problem would perturb the spectrum, so the choice of padding (and its
    sentinel eigenvalue) belongs to the problem builder, not here.
    """
    ndev = mesh.devices.size
    if op.shape[0] % ndev != 0:
        raise ValueError(
            f"matrix rows ({op.shape[0]}) must be divisible by the mesh "
            f"size ({ndev}); pad the problem to a multiple first"
        )
    rowwise = NamedSharding(mesh, P(ROWS, None))
    if isinstance(op, DiaOperator):
        # diags is (ndiag, n): the row axis is the second one.
        return DiaOperator(
            jax.device_put(op.diags, NamedSharding(mesh, P(None, ROWS))),
            op.offsets,
            op.shape,
        )
    if isinstance(op, EllOperator):
        return EllOperator(
            jax.device_put(op.data, rowwise),
            jax.device_put(op.cols, rowwise),
            op.shape,
        )
    if isinstance(op, DenseOperator):
        return DenseOperator(jax.device_put(op.A, rowwise))
    if isinstance(op, CsrOperator):
        # Irregular rows: re-partition the raw CSR arrays into per-shard
        # flat nonzero runs (padding scales with shard imbalance, not max
        # row length) and matvec through an explicit shard_map.
        return ShardedCsrOperator.build(
            np.asarray(op.indptr),
            np.asarray(op.indices),
            np.asarray(op.data),
            op.shape,
            mesh,
        )
    return op
