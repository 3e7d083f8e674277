"""Multi-device tests on the virtual 8-device CPU mesh: the sharded solver
must produce the same answers as single-device, V must actually be
distributed, and the device step must compile and run under the mesh
shardings — the thing the reference cannot test at all (SURVEY.md §4)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from arnoldimethod_jax import partial_schur
from arnoldimethod_jax.models.problems import laplacian_1d, laplacian_2d
from arnoldimethod_jax.parallel import (
    basis_sharding,
    make_mesh,
    shard_operator,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs a multi-device (CPU) mesh"
)


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


@pytest.mark.slow
def test_sharded_partial_schur_matches_single_device():
    n = 256
    op = laplacian_1d(n)
    mesh = make_mesh(8)
    sharded_op = shard_operator(op, mesh)

    d0, h0 = partial_schur(op, nev=4, which="SR", tol=1e-8)
    d1, h1 = partial_schur(
        sharded_op, nev=4, which="SR", tol=1e-8, sharding=basis_sharding(mesh)
    )

    assert h1.converged
    # Identical algorithm, identical RNG seed => identical matvec counts.
    assert h1.mvproducts == h0.mvproducts
    assert np.allclose(
        np.sort(d0.eigenvalues.real), np.sort(d1.eigenvalues.real), atol=1e-10
    )

    # V/Q actually live distributed over the mesh.
    assert len(d1.Q.sharding.device_set) == 8


@pytest.mark.slow
def test_sharded_2d_laplacian_residual():
    op = laplacian_2d(16, 16)  # n = 256
    mesh = make_mesh(8)
    sharded_op = shard_operator(op, mesh)
    decomp, history = partial_schur(
        sharded_op,
        nev=5,
        which="SR",
        tol=1e-8,
        sharding=basis_sharding(mesh),
    )
    assert history.converged

    # Verify the residual with a dense reconstruction via matvecs.
    n = op.shape[0]
    A = np.zeros((n, n))
    for i in range(n):
        e = np.zeros(n)
        e[i] = 1
        A[:, i] = np.asarray(op.matvec(jnp.asarray(e)))
    Q = np.asarray(decomp.Q)
    R = np.asarray(decomp.R)
    assert np.linalg.norm(A @ Q - Q @ R) < 1e-6


def test_uneven_shard_sizes_clear_error():
    """n not divisible by the device count raises a clear error (padding a
    spectral problem is a problem-builder decision, not a silent default)."""
    op = laplacian_1d(250)  # not divisible by 8
    mesh = make_mesh(8)
    with pytest.raises(ValueError, match="divisible"):
        shard_operator(op, mesh)


@pytest.mark.slow
def test_smaller_mesh_subset():
    """A mesh over a subset of devices works too."""
    n = 128
    op = laplacian_1d(n)
    mesh = make_mesh(4)
    decomp, history = partial_schur(
        shard_operator(op, mesh),
        nev=3,
        which="SR",
        tol=1e-8,
        sharding=basis_sharding(mesh),
    )
    assert history.converged
    exact = np.sort(2 - 2 * np.cos(np.pi * np.arange(1, n + 1) / (n + 1)))[:3]
    assert np.allclose(np.sort(decomp.eigenvalues.real), exact, atol=1e-7)


def _powerlaw_csr(n, seed=0, dtype=np.float64):
    """sprand-like matrix with power-law row lengths (a few rows carry
    hundreds of nonzeros, most carry a handful) — the irregular-sparsity
    shape padded-ELL cannot distribute without O(n * K_max) blowup."""
    rng = np.random.default_rng(seed)
    row_nnz = np.minimum(
        rng.zipf(1.6, size=n), n // 2
    )  # heavy-tailed row lengths
    indptr = np.zeros(n + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(row_nnz)
    indices = np.empty(indptr[-1], dtype=np.int32)
    data = np.empty(indptr[-1], dtype=dtype)
    for i in range(n):
        k = row_nnz[i]
        cols = rng.choice(n, size=k, replace=False)
        cols.sort()
        indices[indptr[i] : indptr[i + 1]] = cols
        data[indptr[i] : indptr[i + 1]] = rng.standard_normal(k)
    # Shift the diagonal so the spectrum is not pathological.
    A = np.zeros((n, n), dtype=dtype)
    for i in range(n):
        A[i, indices[indptr[i] : indptr[i + 1]]] = data[indptr[i] : indptr[i + 1]]
    A[np.arange(n), np.arange(n)] += 3.0
    # Rebuild exact CSR from the dense form (diagonal now included).
    from arnoldimethod_jax.models.operators import CsrOperator

    indptr2 = [0]
    idx, vals = [], []
    for i in range(n):
        nz = np.nonzero(A[i])[0]
        idx.append(nz.astype(np.int32))
        vals.append(A[i, nz])
        indptr2.append(indptr2[-1] + len(nz))
    op = CsrOperator(
        np.asarray(indptr2), np.concatenate(idx), np.concatenate(vals), (n, n)
    )
    return A, op


def test_sharded_csr_matvec_exact():
    """ShardedCsrOperator reproduces the dense matvec exactly for a
    power-law row-length matrix on the 8-device mesh."""
    n = 256
    A, op = _powerlaw_csr(n, seed=1)
    mesh = make_mesh(8)
    sop = shard_operator(op, mesh)

    from arnoldimethod_jax.models.operators import ShardedCsrOperator

    assert isinstance(sop, ShardedCsrOperator)
    x = np.linspace(-1, 1, n)
    y = np.asarray(jax.jit(sop.matvec)(jnp.asarray(x)))
    assert np.allclose(y, A @ x, atol=1e-12)
    # Padding is bounded by shard imbalance, far below n * K_max.
    kmax = max(
        np.diff(np.asarray(op.indptr))
    )
    assert sop.nnz < 2 * op.nnz
    assert sop.nnz < n * kmax


def test_sharded_csr_partial_schur():
    """End-to-end: the power-law sparse matrix solves on the mesh and the
    eigenvalues match the dense solve (ref: test/schur_to_eigen.jl's
    sprand matrices, distributed here)."""
    n = 256
    A, op = _powerlaw_csr(n, seed=2)
    mesh = make_mesh(8)
    sop = shard_operator(op, mesh)

    decomp, history = partial_schur(
        sop, nev=4, which="LM", tol=1e-8, sharding=basis_sharding(mesh)
    )
    assert history.converged
    Q = np.asarray(decomp.Q)
    R = np.asarray(decomp.R)
    assert np.linalg.norm(A @ Q - Q @ R) < 1e-6 * np.linalg.norm(A)
    assert len(decomp.Q.sharding.device_set) == 8

    got = decomp.eigenvalues  # may be nev+1 when a pair straddles the cut
    lam = np.linalg.eigvals(A)
    want = lam[np.argsort(-np.abs(lam))][: len(got)]
    assert np.allclose(
        np.sort(np.abs(got)), np.sort(np.abs(want)), rtol=1e-6
    )


def test_pod_mesh_single_host():
    """make_pod_mesh on a single host spans all visible devices with the
    same `rows` axis; the multi-host path differs only in device order."""
    from arnoldimethod_jax.parallel import make_pod_mesh

    mesh = make_pod_mesh()
    assert mesh.axis_names == ("rows",)
    assert mesh.devices.size == len(jax.devices())


def _banded_csr(n, bw=3, dtype=np.float64):
    """Banded sparse matrix: each shard's column footprint is only the
    ~bw boundary entries of its neighbors — the footprint-gather case."""
    from arnoldimethod_jax.models.operators import CsrOperator

    rng = np.random.default_rng(5)
    indptr = [0]
    idx, vals = [], []
    for i in range(n):
        cols = np.arange(max(0, i - bw), min(n, i + bw + 1))
        idx.append(cols.astype(np.int32))
        v = rng.standard_normal(len(cols))
        v[cols == i] += 4.0
        vals.append(v)
        indptr.append(indptr[-1] + len(cols))
    A = np.zeros((n, n), dtype=dtype)
    for i in range(n):
        A[i, idx[i]] = vals[i]
    return A, CsrOperator(
        np.asarray(indptr), np.concatenate(idx), np.concatenate(vals), (n, n)
    )


@pytest.mark.parametrize("gather", ["footprint", "all"])
def test_sharded_csr_gather_modes_exact(gather):
    """Both communication strategies produce the exact dense matvec."""
    from arnoldimethod_jax.models.operators import ShardedCsrOperator

    n = 256
    A, op = _banded_csr(n)
    mesh = make_mesh(8)
    sop = ShardedCsrOperator.build(
        np.asarray(op.indptr), np.asarray(op.indices), np.asarray(op.data),
        op.shape, mesh, gather=gather,
    )
    assert sop.mode == gather
    x = np.linspace(-1, 1, n)
    y = np.asarray(jax.jit(sop.matvec)(jnp.asarray(x)))
    assert np.allclose(y, A @ x, atol=1e-12)


def test_sharded_csr_auto_picks_footprint_for_banded():
    """auto selects the footprint path when the footprint is sparse (banded)
    and the all_gather path when it is dense (uniform random)."""
    from arnoldimethod_jax.models.operators import ShardedCsrOperator

    mesh = make_mesh(8)
    n = 256
    _, op = _banded_csr(n)
    sop = ShardedCsrOperator.build(
        np.asarray(op.indptr), np.asarray(op.indices), np.asarray(op.data),
        op.shape, mesh,
    )
    assert sop.mode == "footprint"
    # bw=3 band: each shard needs <= 3 entries of each neighbour.
    assert sop.footprint_elems <= 3

    rng = np.random.default_rng(0)
    dense_idx = np.stack([rng.permutation(n) for _ in range(n)])[:, :64]
    indptr = np.arange(n + 1) * 64
    sop2 = ShardedCsrOperator.build(
        indptr, np.sort(dense_idx, axis=1).ravel(),
        np.ones(n * 64), (n, n), mesh,
    )
    assert sop2.mode == "all"


def test_sharded_csr_footprint_comm_bytes():
    """The compiled footprint matvec communicates O(footprint) elements via
    collective-permute and contains NO all-gather: comm bytes are
    proportional to the boundary, not to n (VERDICT r2 item 5)."""
    import re

    from arnoldimethod_jax.models.operators import ShardedCsrOperator

    n = 1024
    _, op = _banded_csr(n)
    mesh = make_mesh(8)
    sop = ShardedCsrOperator.build(
        np.asarray(op.indptr), np.asarray(op.indices), np.asarray(op.data),
        op.shape, mesh,
    )
    assert sop.mode == "footprint"
    x = jnp.asarray(np.linspace(-1, 1, n))
    txt = jax.jit(sop.matvec).lower(x).compile().as_text()
    assert "all-gather" not in txt
    # Every collective-permute payload is a footprint-sized f64 vector.
    sizes = [int(s) for s in re.findall(r"f64\[(\d+)\][^)]*collective-permute", txt)]
    payloads = [s for s in sizes if s > 1]
    assert payloads, txt[:2000]
    F = sop.footprint_elems
    assert all(s <= F for s in payloads), (payloads, F)
    # Total comm per device: (ndev-1) * F elems, far below n - n_local.
    assert (8 - 1) * F * 8 < (n - n // 8) * 8 / 2


def test_sharded_shift_invert_solve():
    """Config 4's 'distributed sparse-triangular solves': the
    associative-scan tridiagonal solver composes with an 8-device mesh —
    GSPMD partitions the scan into per-device block scans stitched by
    collectives — and the sharded solve matches the single-device one
    matvec-for-matvec (docs/transforms.md 'distributing shift-invert')."""
    import numpy as np
    import jax.numpy as jnp
    from arnoldimethod_jax import TridiagonalShiftInvertOperator, partial_schur
    from arnoldimethod_jax.parallel.mesh import make_mesh, basis_sharding

    n = 1024
    dl = np.full(n - 1, -1.0)
    d = np.full(n, 2.0)
    du = np.full(n - 1, -1.001)
    si = TridiagonalShiftInvertOperator.build(dl, d, du, sigma=0.0,
                                              dtype=np.float64)
    mesh = make_mesh(8)
    d1, h1 = partial_schur(si, nev=6, which="LM", tol=1e-9, mindim=8,
                           maxdim=16, sharding=basis_sharding(mesh),
                           method="host")
    d0, h0 = partial_schur(si, nev=6, which="LM", tol=1e-9, mindim=8,
                           maxdim=16, method="host")
    assert h1.converged and h0.converged
    assert h1.mvproducts == h0.mvproducts
    assert np.allclose(np.sort(d1.eigenvalues.real),
                       np.sort(d0.eigenvalues.real), atol=1e-10)
