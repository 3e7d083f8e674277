"""BSR block-sparse operator: the einsum matvec against a dense reference,
the packed layout, and end-to-end through the solver."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from arnoldimethod_jax import partial_schur
from arnoldimethod_jax.models.operators import dense_to_bsr


def _block_matrix(rng, n, B, fill=0.3):
    nb = n // B
    A = np.zeros((n, n))
    for i in range(nb):
        for j in range(nb):
            if i == j or rng.random() < fill:
                A[i * B : (i + 1) * B, j * B : (j + 1) * B] = rng.standard_normal(
                    (B, B)
                )
    return A


@pytest.mark.parametrize("B", [8, 32])
def test_bsr_matvec_matches_dense(B):
    rng = np.random.default_rng(0)
    n = 8 * B
    A = _block_matrix(rng, n, B)
    op = dense_to_bsr(A, B)
    x = rng.standard_normal(n)
    y_ref = A @ x
    y = np.asarray(op.matvec(jnp.asarray(x)))
    assert np.allclose(y, y_ref, atol=1e-10)


@pytest.mark.parametrize("nbr,KB,B", [(3, 11, 8), (5, 3, 16), (3, 9, 8)])
def test_bsr_padding_paths(nbr, KB, B):
    """Odd block counts and duplicate-column slots (whose values add)
    against the dense matrix the blocks describe."""
    from arnoldimethod_jax.models.operators import BsrOperator

    rng = np.random.default_rng(3)
    kb_eff = min(KB, nbr)
    block_cols = np.stack(
        [np.sort(rng.choice(nbr, size=kb_eff, replace=False)) for _ in range(nbr)]
    )
    if kb_eff < KB:  # duplicate-column slots are legal (values add)
        block_cols = np.concatenate(
            [block_cols, rng.integers(0, nbr, (nbr, KB - kb_eff))], axis=1
        )
    block_cols = block_cols.astype(np.int32)
    block_data = rng.standard_normal((nbr, KB, B, B))
    n = nbr * B
    op_e = BsrOperator(block_cols, block_data, (n, n))
    x = jnp.asarray(rng.standard_normal(n))
    y_e = np.asarray(op_e.matvec(x))
    A = np.zeros((n, n))
    for i in range(nbr):
        for k in range(KB):
            c = block_cols[i, k]
            A[i * B : (i + 1) * B, c * B : (c + 1) * B] += block_data[i, k]
    assert np.allclose(y_e, A @ np.asarray(x), atol=1e-10)
    assert op_e.nnz == nbr * KB * B * B


def test_pack_bsr_layout():
    """pack_bsr stores every block transposed (the einsum's operand
    layout) with int32 column indices; block_data undoes the transpose."""
    from arnoldimethod_jax.models.operators import BsrOperator, pack_bsr

    rng = np.random.default_rng(4)
    nbr, KB, B = 3, 2, 4
    block_cols = rng.integers(0, nbr, (nbr, KB))
    block_data = rng.standard_normal((nbr, KB, B, B))
    cols, dataT = pack_bsr(block_cols, block_data)
    assert cols.dtype == np.int32 and dataT.shape == (nbr, KB, B, B)
    assert np.array_equal(dataT[1, 0], block_data[1, 0].T)
    op = BsrOperator(block_cols, block_data, (nbr * B, nbr * B))
    assert np.array_equal(np.asarray(op.block_data), block_data)


@pytest.mark.slow
def test_bsr_through_solver():
    rng = np.random.default_rng(1)
    n, B = 128, 16
    A = _block_matrix(rng, n, B, fill=0.2)
    op = dense_to_bsr(A, B)
    d_bsr, h_bsr = partial_schur(op, nev=4, which="LM", tol=1e-9)
    d_dense, h_dense = partial_schur(A, nev=4, which="LM", tol=1e-9)
    assert h_bsr.converged
    assert h_bsr.mvproducts == h_dense.mvproducts
    assert np.allclose(
        np.sort_complex(d_bsr.eigenvalues), np.sort_complex(d_dense.eigenvalues),
        atol=1e-8,
    )


def test_bsr_requires_divisible_n():
    with pytest.raises(ValueError):
        dense_to_bsr(np.eye(100), 16)


@pytest.mark.parametrize("n,B", [(96, 16), (100, 16), (75, 8)])
def test_csr_to_bsr_roundtrip(n, B):
    """CsrOperator.to_bsr re-blocks into the roofline BSR format exactly,
    including n not a multiple of the block size (x padded internally,
    spectrum untouched)."""
    from arnoldimethod_jax.models.operators import CsrOperator

    rng = np.random.default_rng(9)
    A = np.zeros((n, n))
    # clustered sparsity: a band plus a few random blocks
    for i in range(n):
        for j in range(max(0, i - 3), min(n, i + 4)):
            A[i, j] = rng.standard_normal()
    k = n // 4
    A[:k, -k:] = rng.standard_normal((k, k))
    indptr, idx, vals = [0], [], []
    for i in range(n):
        nz = np.nonzero(A[i])[0]
        idx.append(nz.astype(np.int32))
        vals.append(A[i, nz])
        indptr.append(indptr[-1] + len(nz))
    op = CsrOperator(np.asarray(indptr), np.concatenate(idx), np.concatenate(vals), (n, n))
    bop = op.to_bsr(block_size=B)
    assert bop.shape == (n, n)
    assert bop.fill_ratio >= 1.0
    x = rng.standard_normal(n)
    y = np.asarray(bop.matvec(jnp.asarray(x)))
    assert y.shape == (n,)
    assert np.allclose(y, A @ x, atol=1e-10)


def test_csr_to_bsr_through_solver():
    """End-to-end: an irregular CSR matrix re-blocked to BSR solves to the
    same spectrum as the CSR original."""
    from arnoldimethod_jax.models.operators import CsrOperator

    rng = np.random.default_rng(11)
    n = 120
    A = np.diag(np.linspace(1.0, 5.0, n))
    for _ in range(300):
        i, j = rng.integers(0, n, 2)
        A[i, j] += 0.1 * rng.standard_normal()
    indptr, idx, vals = [0], [], []
    for i in range(n):
        nz = np.nonzero(A[i])[0]
        idx.append(nz.astype(np.int32))
        vals.append(A[i, nz])
        indptr.append(indptr[-1] + len(nz))
    op = CsrOperator(np.asarray(indptr), np.concatenate(idx), np.concatenate(vals), (n, n))
    bop = op.to_bsr(block_size=32)
    d1, h1 = partial_schur(op, nev=4, which="LM", tol=1e-9)
    d2, h2 = partial_schur(bop, nev=4, which="LM", tol=1e-9)
    assert h1.converged and h2.converged
    assert np.allclose(
        np.sort_complex(d1.eigenvalues), np.sort_complex(d2.eigenvalues),
        atol=1e-8,
    )

