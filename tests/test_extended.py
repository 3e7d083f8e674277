"""Extended-precision (double-word) solve path: partial_schur(...,
extended=True) reaches Double64-class tolerances from single-word device
arithmetic (ops/df_expansion.py) — the analogue of the reference's
Double64 workflow (readme.md:81-99) on hardware without wider floats."""

import numpy as np
import jax.numpy as jnp
import pytest

from arnoldimethod_jax import partial_schur
from arnoldimethod_jax.models.problems import laplacian_1d


def _laplacian_dense(n):
    return (
        np.diag(np.full(n, 2.0))
        + np.diag(np.full(n - 1, -1.0), 1)
        + np.diag(np.full(n - 1, -1.0), -1)
    )


@pytest.mark.slow
def test_extended_f32_reaches_1e12():
    """f32 words, tol=1e-12: the README config converges with a Schur
    residual ~1e-13 and double-word orthonormality — seven orders below
    the plain-f32 floor (measured 1.6e-13 vs 2.2e-6)."""
    op = laplacian_1d(100, dtype=np.float32)
    decomp, history = partial_schur(
        op, nev=10, which="SR", tol=1e-12, extended=True
    )
    assert history.converged
    A = _laplacian_dense(100)
    Q = np.asarray(decomp.Q, np.float64)
    assert Q.dtype == np.float64  # full double-word combine returned
    R = np.asarray(decomp.R)
    assert np.linalg.norm(A @ Q - Q @ R) < 1e-11
    assert np.linalg.norm(Q.T @ Q - np.eye(10)) < 1e-11
    exact = np.sort(2 - 2 * np.cos(np.pi * np.arange(1, 101) / 101))[:10]
    assert np.max(np.abs(np.sort(decomp.eigenvalues.real) - exact)) < 1e-12


@pytest.mark.slow
def test_extended_matches_plain_spectrum():
    """Same eigenvalues as the plain path, just more digits."""
    op = laplacian_1d(64, dtype=np.float32)
    d_ext, h_ext = partial_schur(op, nev=4, which="SR", tol=1e-10,
                                 extended=True)
    d_pln, h_pln = partial_schur(op, nev=4, which="SR", tol=1e-6,
                                 method="host")
    assert h_ext.converged and h_pln.converged
    assert np.allclose(
        np.sort(d_ext.eigenvalues.real), np.sort(d_pln.eigenvalues.real),
        atol=1e-5,
    )


@pytest.mark.slow
def test_extended_fallback_without_matvec_df():
    """Operators without matvec_df still run (two plain matvecs): the
    solve works, floored at the single-word SpMV accuracy."""
    from arnoldimethod_jax.models.operators import DenseOperator

    n = 48
    A = _laplacian_dense(n).astype(np.float32)
    op = DenseOperator(jnp.asarray(A))
    assert not hasattr(op, "matvec_df")
    decomp, history = partial_schur(
        op, nev=4, which="SR", tol=1e-6, extended=True
    )
    assert history.converged
    Q = np.asarray(decomp.Q, np.float64)
    R = np.asarray(decomp.R)
    assert np.linalg.norm(A.astype(np.float64) @ Q - Q @ R) < 1e-5


def test_extended_rejects_complex_and_device():
    op = laplacian_1d(32, dtype=np.complex128)
    with pytest.raises(ValueError, match="real dtypes"):
        partial_schur(op, nev=2, extended=True)
    op2 = laplacian_1d(32, dtype=np.float32)
    with pytest.raises(ValueError, match="method='device'"):
        partial_schur(op2, nev=2, extended=True, method="device")


@pytest.mark.slow
def test_extended_stencil_2d():
    """Stencil5Operator.matvec_df: an anisotropic 2-D Laplacian converges
    to 1e-10 eigenvalue accuracy with f32 words (config-2 matrix family
    at test scale).  Anisotropic so the spectrum is simple: a single
    Krylov sequence finds multiple copies of a DEGENERATE eigenvalue only
    through rounding noise, and with double-word noise at 1e-15 the
    second copy emerges far too slowly for a small test budget — a
    property of the algorithm (the reference behaves the same in exact
    arithmetic), not of this implementation."""
    from arnoldimethod_jax.models.operators import Stencil5Operator

    ny = nx = 16
    op = Stencil5Operator((4.6, -1.0, -1.0, -1.3, -1.3), (ny, nx),
                          dtype=np.float32)
    decomp, history = partial_schur(
        op, nev=4, which="SR", tol=1e-11, extended=True
    )
    assert history.converged
    th = np.pi * np.arange(1, nx + 1) / (nx + 1)
    exact = np.sort(
        np.add.outer(2.6 - 2.6 * np.cos(th), 2.0 - 2.0 * np.cos(th)).ravel()
    )[:4]
    # ~1e-9: far beyond the plain-f32 ceiling (~1e-6 eigenvalue error)
    assert np.max(np.abs(np.sort(decomp.eigenvalues.real) - exact)) < 1e-8
    Q = np.asarray(decomp.Q, np.float64)
    assert np.linalg.norm(Q.T @ Q - np.eye(4)) < 1e-10


@pytest.mark.slow
def test_extended_warm_start_keeps_double_word_accuracy():
    """The workspace keeps the basis low word (ws.Vlo) after an extended
    run, so a warm start (start_from=nconverged) resumes and finishes at
    double-word accuracy — the reference's partialschur! resume story at
    Double64-class precision."""
    from arnoldimethod_jax import ArnoldiWorkspace

    n = 80
    op = laplacian_1d(n, dtype=np.float32)
    ws = ArnoldiWorkspace(n, 20, dtype=np.float32)
    d1, h1 = partial_schur(op, nev=4, which="SR", tol=1e-11, extended=True,
                           workspace=ws)
    assert h1.converged and ws.Vlo is not None
    d2, h2 = partial_schur(op, nev=8, which="SR", tol=1e-11, extended=True,
                           workspace=ws, start_from=h1.nconverged)
    assert h2.converged
    A = _laplacian_dense(n)
    Q = np.asarray(d2.Q, np.float64)
    R = np.asarray(d2.R)
    assert np.linalg.norm(A @ Q - Q @ R) < 1e-9
    assert np.linalg.norm(Q.T @ Q - np.eye(Q.shape[1])) < 1e-9

    # A plain solve on the same workspace invalidates the low word.
    partial_schur(op, nev=4, which="SR", tol=1e-6, workspace=ws,
                  method="host", start_from=0, initialize=True)
    assert ws.Vlo is None


@pytest.mark.slow
def test_extended_sharded_mesh():
    """extended=True composes with the row-sharded mesh: GSPMD partitions
    the double-word kernels (the df products are elementwise; the tree
    reductions lower to collectives) and the solve reaches double-word
    residuals distributed."""
    import jax

    from arnoldimethod_jax.parallel.mesh import (
        basis_sharding,
        make_mesh,
        shard_operator,
    )

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh")
    mesh = make_mesh(8)
    n = 256
    op = shard_operator(laplacian_1d(n, dtype=np.float32), mesh)
    d, h = partial_schur(op, nev=4, which="SR", tol=1e-10, extended=True,
                         sharding=basis_sharding(mesh))
    assert h.converged
    A = _laplacian_dense(n)
    Q = np.asarray(d.Q, np.float64)
    R = np.asarray(d.R)
    assert np.linalg.norm(A @ Q - Q @ R) < 1e-11


def test_extended_exact_breakdown_reinit():
    """Exact invariant subspace (v1 = eigenvector of a diagonal matrix):
    the df DGKS must detect the EXACT zero residual vector as breakdown
    (df_norm(0) must be 0, not NaN) and reinitialize — regression for a
    0/0 NaN that crashed the extended path where the plain path worked."""
    from arnoldimethod_jax.models.operators import DiaOperator

    n = 32
    diag = np.linspace(1.0, 4.0, n).astype(np.float32)
    op = DiaOperator(diag[None, :], (0,), (n, n))
    e1 = np.zeros(n, np.float32)
    e1[0] = 1.0
    d, h = partial_schur(op, nev=2, which="LM", v1=e1, tol=1e-10,
                         extended=True)
    assert h.converged and h.nconverged >= 2
    assert np.allclose(
        np.sort(d.eigenvalues.real)[-2:], np.sort(diag)[-2:], atol=1e-9
    )
