"""Workspace checkpoint/resume: save to .npz, load, and continue locking
more eigenvalues from the restored state (the reference's partialschur! +
start_from pattern, run.jl:131-179, across a process boundary)."""

import numpy as np
import jax.numpy as jnp

from arnoldimethod_jax import ArnoldiWorkspace, partial_schur


def test_save_load_resume(tmp_path):
    rng = np.random.default_rng(0)
    A = rng.standard_normal((100, 100))

    ws = ArnoldiWorkspace(100, 20, dtype=jnp.float64)
    F, hist = partial_schur(A, workspace=ws, nev=3, tol=1e-12)
    assert hist.converged

    path = tmp_path / "ckpt.npz"
    ws.save(path)
    ws2 = ArnoldiWorkspace.load(path)
    assert ws2.dtype == ws.dtype
    assert np.array_equal(np.asarray(ws2.V), np.asarray(ws.V))
    assert np.array_equal(ws2.H, ws.H)

    F2, hist2 = partial_schur(
        A, workspace=ws2, nev=5, start_from=hist.nconverged, tol=1e-8
    )
    assert hist2.converged
    assert hist2.nconverged >= 5
    Q = np.asarray(F2.Q)
    R = np.asarray(F2.R)
    assert np.linalg.norm(A @ Q - Q @ R) < 1e-6


def test_history_restart_counter():
    from arnoldimethod_jax.models.problems import laplacian_1d

    op = laplacian_1d(100)
    _, hist = partial_schur(op, nev=10, which="SR", tol=1e-6)
    assert hist.restarts > 0
    assert "matrix-vector products" in repr(hist)


def test_workspace_validation():
    try:
        ArnoldiWorkspace(5, 10)
        assert False
    except ValueError:
        pass
