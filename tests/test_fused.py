"""The fully on-device solve (method='device', fused.py) vs the host path:
identical RNG => identical matvec counts and matching spectra across the
integration scenarios, including breakdown, purging, and conjugate pairs."""

import numpy as np
import pytest

pytestmark = pytest.mark.slow  # m=20 lax.while_loop compiles dominate suite wall-clock
import jax.numpy as jnp

from arnoldimethod_jax import partial_schur

EPS = np.finfo(np.float64).eps


def _dense_of(op):
    import jax.numpy as jnp

    n = op.shape[0]
    A = np.zeros((n, n))
    for i in range(n):
        e = np.zeros(n)
        e[i] = 1
        A[:, i] = np.asarray(op.matvec(jnp.asarray(e)))
    return A


def _check(A, decomp, tol):
    Q = np.asarray(decomp.Q)
    R = np.asarray(decomp.R)
    assert np.linalg.norm(A @ Q - Q @ R) < tol * max(1, np.linalg.norm(A))
    k = Q.shape[1]
    assert np.linalg.norm(Q.T @ Q - np.eye(k)) < 1e-10


def test_device_matches_host_readme():
    from arnoldimethod_jax.models.problems import laplacian_1d

    op = laplacian_1d(100)
    d0, h0 = partial_schur(op, nev=10, which="SR", tol=1e-6, method="host")
    d1, h1 = partial_schur(op, nev=10, which="SR", tol=1e-6, method="device")
    assert h1.converged
    assert h1.mvproducts == h0.mvproducts
    assert h1.restarts == h0.restarts
    assert np.allclose(
        np.sort(d0.eigenvalues.real), np.sort(d1.eigenvalues.real), atol=1e-9
    )
    _check(_dense_of(op), d1, 1e-6)


def test_device_lm_nonsymmetric_pairs():
    """Nonsymmetric matrix with complex conjugate pairs at the target:
    2x2-block locking, pair-aware truncation, nev+1 returns."""
    rng = np.random.default_rng(3)
    A = rng.standard_normal((80, 80))
    d0, h0 = partial_schur(A, nev=6, which="LM", tol=1e-9, method="host")
    d1, h1 = partial_schur(A, nev=6, which="LM", tol=1e-9, method="device")
    assert h1.converged
    assert h1.mvproducts == h0.mvproducts
    assert len(d1.eigenvalues) == len(d0.eigenvalues)
    assert np.allclose(
        np.sort(np.abs(d0.eigenvalues)), np.sort(np.abs(d1.eigenvalues)), rtol=1e-8
    )
    assert np.any(d1.eigenvalues.imag != 0)
    _check(A, d1, 1e-8)


def test_device_rank3_breakdown():
    """Rank-3 matrix: breakdown/reinit path inside the fused loop; exactly
    7 matvecs (ref: test/partial_schur.jl:19-22)."""
    rng = np.random.default_rng(1)
    W = rng.standard_normal((10, 3))
    B = W @ W.T
    d, h = partial_schur(B, nev=5, mindim=5, maxdim=7, tol=EPS, method="device")
    assert h.converged
    assert h.mvproducts == 7
    _check(B, d, 1e-10)
    assert np.linalg.norm(np.sort(d.eigenvalues.real)[:2]) < 1e-8 * np.linalg.norm(B)


def test_device_zero_matrix():
    A = np.zeros((5, 5))
    d, h = partial_schur(A, method="device")
    assert h.converged
    assert h.nconverged == 5
    assert h.mvproducts == 5
    Q = np.asarray(d.Q)
    assert np.linalg.norm(Q.T @ Q - np.eye(5)) < 100 * EPS


def test_device_purge_path():
    """The purge/unlock scenario runs identically in the fused loop."""
    n = 100
    dvals = np.concatenate(
        [[11.0, 10.999, 10.0, 9.5, 9.0], np.linspace(1.0, 8.0, n - 5)]
    )
    A = np.diag(dvals)
    v1 = np.ones(n)
    v1[0] = v1[1] = 1e-12
    d, h = partial_schur(A, v1=v1, nev=3, which="LM", tol=1e-8, method="device")
    assert h.purges > 0
    assert h.converged
    got = np.sort(d.eigenvalues.real)[::-1][:3]
    assert np.allclose(got, [11.0, 10.999, 10.0], atol=1e-6)


def test_device_f32():
    """The production configuration: f32 end-to-end in the fused loop."""
    from arnoldimethod_jax.models.problems import laplacian_1d

    op = laplacian_1d(100, dtype=np.float32)
    d, h = partial_schur(op, nev=10, which="SR", tol=1e-6, method="device")
    assert h.converged
    A = _dense_of(op)
    Q = np.asarray(d.Q, dtype=np.float64)
    R = np.asarray(d.R)
    assert np.linalg.norm(A @ Q - Q @ R) < 1e-5
    exact = np.sort(2 - 2 * np.cos(np.pi * np.arange(1, 101) / 101))[:10]
    assert np.allclose(np.sort(d.eigenvalues.real), exact, atol=1e-5)


def test_device_warm_start():
    """Warm start / resume through the fused path: compute 3 eigenvalues,
    then continue from the locked decomposition for 5 (run.jl:131-179
    semantics, ref: test/partial_schur.jl:122-138)."""
    from arnoldimethod_jax import ArnoldiWorkspace

    rng = np.random.default_rng(7)
    A = rng.standard_normal((100, 100))

    ws = ArnoldiWorkspace(100, 20, dtype=jnp.float64)
    F, h1 = partial_schur(A, workspace=ws, nev=3, tol=1e-12, method="device")
    assert h1.converged
    _check(A, F, 1e-9)

    F2, h2 = partial_schur(
        A, workspace=ws, nev=5, start_from=h1.nconverged, tol=1e-8,
        method="device",
    )
    assert h2.converged
    assert h2.nconverged >= 5
    _check(A, F2, 1e-6)
    assert h2.mvproducts < h1.mvproducts + 100


def test_device_warm_start_crosses_methods():
    """A host-path decomposition resumes through the device path and
    vice versa (the workspace is the portable checkpoint)."""
    from arnoldimethod_jax import ArnoldiWorkspace

    rng = np.random.default_rng(9)
    A = rng.standard_normal((100, 100))
    ws = ArnoldiWorkspace(100, 20, dtype=jnp.float64)
    F, h1 = partial_schur(A, workspace=ws, nev=3, tol=1e-10, method="host")
    assert h1.converged
    F2, h2 = partial_schur(
        A, workspace=ws, nev=5, start_from=h1.nconverged, tol=1e-8,
        method="device",
    )
    assert h2.converged and h2.nconverged >= 5
    _check(A, F2, 1e-6)


def test_device_rejects_complex():
    A = np.diag(np.arange(1, 21).astype(np.complex128))
    with pytest.raises(ValueError, match="real dtypes"):
        partial_schur(A, nev=2, method="device")


def test_device_restart_limit():
    rng = np.random.default_rng(2)
    A = rng.standard_normal((300, 300))
    d, h = partial_schur(A, nev=8, tol=1e-14, restarts=1, method="device")
    assert not h.converged
    d0, h0 = partial_schur(A, nev=8, tol=1e-14, restarts=1, method="host")
    assert h.mvproducts == h0.mvproducts
    assert h.nconverged == h0.nconverged


def test_device_method_on_mesh():
    """The fused program compiles and runs under mesh shardings too
    (GSPMD partitions the expansion; the dense while_loop stays
    replicated), with identical matvec counts to single-device."""
    import jax
    from arnoldimethod_jax.models.problems import laplacian_1d
    from arnoldimethod_jax.parallel import (
        basis_sharding,
        make_mesh,
        shard_operator,
    )

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh")
    n = 256
    op = laplacian_1d(n)
    mesh = make_mesh(8)
    sop = shard_operator(op, mesh)
    d0, h0 = partial_schur(op, nev=4, which="SR", tol=1e-8, method="device")
    d1, h1 = partial_schur(
        sop, nev=4, which="SR", tol=1e-8,
        sharding=basis_sharding(mesh), method="device",
    )
    assert h1.mvproducts == h0.mvproducts
    assert len(d1.Q.sharding.device_set) == 8
    assert np.allclose(
        np.sort(d0.eigenvalues.real), np.sort(d1.eigenvalues.real), atol=1e-10
    )


def test_device_repeated_eigenvalues():
    """Triple eigenvalue at the target: locking/partitioning in the fused
    loop survives irregular convergence (ref: test/partial_schur.jl:86-106)."""
    dvals = np.concatenate(
        [np.arange(1, 9.05, 0.1), [9.97, 9.98, 9.99, 10.0, 10.0, 10.0]]
    )
    A = np.diag(dvals)
    d, h = partial_schur(A, nev=5, maxdim=20, tol=1e-12, method="device")
    assert h.converged
    Q = np.asarray(d.Q)
    assert np.linalg.norm(Q.T @ Q - np.eye(Q.shape[1])) < 1e-10
    R = np.asarray(d.R)
    assert np.linalg.norm(A @ Q - Q @ R) < A.shape[0] * 1e-12 * np.linalg.norm(A, 1)


def test_device_target_non_dominant():
    """:SR with dominant unwanted eigenvalues (ref: :79-84)."""
    dvals = np.concatenate([np.arange(1, 10.05, 0.1), [50.0, 51.0, 52.0, 53.0]])
    A = np.diag(dvals)
    d, h = partial_schur(A, which="SR", method="device")
    assert np.all(d.eigenvalues.real <= 10.0)


def test_device_chunked_dispatch_resume(monkeypatch):
    """The restart loop is dispatched in bounded-duration chunks (the
    dispatch-size heuristic, fused.py module docstring).  Force
    1-restart chunks and check the chunk-resume state
    threading is exact: same matvecs/spectrum as one big dispatch."""
    from arnoldimethod_jax import fused
    from arnoldimethod_jax.models.problems import laplacian_1d

    op = laplacian_1d(64)
    d0, h0 = partial_schur(op, nev=6, which="SR", tol=1e-8, method="device")
    monkeypatch.setattr(fused, "_CHUNK_INIT", 1)
    monkeypatch.setattr(fused, "_CHUNK_SECONDS", 1e-9)
    d1, h1 = partial_schur(op, nev=6, which="SR", tol=1e-8, method="device")
    assert h1.converged
    assert h1.mvproducts == h0.mvproducts
    assert h1.restarts == h0.restarts
    assert np.allclose(
        np.sort(d1.eigenvalues.real), np.sort(d0.eigenvalues.real), atol=1e-9
    )
