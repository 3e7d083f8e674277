"""Unit tests for the device-side Arnoldi expansion (ops/expansion.py),
mirroring reference test/expansion.jl: the Arnoldi relation and basis
orthonormality hold after partial and full expansion, and the
invariant-subspace breakdown path zeroes H[j+1, j] and reinitializes with
a fresh orthonormal random column."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from arnoldimethod_jax.models.operators import DenseOperator
from arnoldimethod_jax.ops.expansion import (
    expand_range,
    set_initial_vector,
    set_random_vector,
)


def _relation_errors(A, V, H, k):
    """Return (relation_err, orth_err) for A V[:k].T = V[:k+1].T H[:k+1,:k]."""
    A = np.asarray(A)
    Vn = np.asarray(V)
    Hn = np.asarray(H)
    lhs = A @ Vn[:k].T
    rhs = Vn[: k + 1].T @ Hn[: k + 1, :k]
    rel = np.linalg.norm(lhs - rhs)
    G = Vn[: k + 1].conj() @ Vn[: k + 1].T
    orth = np.linalg.norm(G - np.eye(k + 1))
    return rel, orth


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.complex128])
def test_arnoldi_relation_and_orthonormality(dtype):
    rng = np.random.default_rng(0)
    n, m = 30, 10
    A = rng.standard_normal((n, n))
    if dtype == jnp.complex128:
        A = A + 1j * rng.standard_normal((n, n))
    op = DenseOperator(jnp.asarray(A, dtype=dtype))

    V = jnp.zeros((m + 1, n), dtype=dtype)
    H = jnp.zeros((m + 1, m), dtype=dtype)
    V = set_random_vector(V, 0, jax.random.PRNGKey(1))

    # Partial expansion...
    V, H = expand_range(op, V, H, 0, 4, jax.random.PRNGKey(2))
    rel, orth = _relation_errors(A, V, H, 4)
    assert rel < 1e-12 * np.linalg.norm(A)
    assert orth < 1e-13

    # ... then continue to the full dimension.
    V, H = expand_range(op, V, H, 4, m, jax.random.PRNGKey(3))
    rel, orth = _relation_errors(A, V, H, m)
    assert rel < 1e-12 * np.linalg.norm(A)
    assert orth < 1e-13


def test_invariant_subspace_breakdown():
    """Block-diagonal A with e1 start: the Krylov space closes after 4
    steps -> H[4, 3] == 0, and the basis stays orthonormal after random
    reinitialization (ref: test/expansion.jl:34-55)."""
    rng = np.random.default_rng(4)
    n, m = 8, 6
    A = np.zeros((n, n))
    A[:4, :4] = rng.standard_normal((4, 4))
    A[4:, 4:] = rng.standard_normal((4, 4))
    op = DenseOperator(jnp.asarray(A, dtype=jnp.float64))

    V = jnp.zeros((m + 1, n), dtype=jnp.float64)
    H = jnp.zeros((m + 1, m), dtype=jnp.float64)
    e1 = jnp.zeros(n, dtype=jnp.float64).at[0].set(1.0)
    V = set_initial_vector(V, e1)

    V, H = expand_range(op, V, H, 0, m, jax.random.PRNGKey(5))
    Hn = np.asarray(H)

    # Breakdown at step 3 (0-based): the 4-dim invariant subspace closes.
    assert Hn[4, 3] == 0.0

    # Basis stays orthonormal through the reinitialization.
    _, orth = _relation_errors(A, V, H, m)
    assert orth < 1e-13


def test_breakdown_with_full_space():
    """When the basis spans the whole space (j+1 == n) there is no
    reinitialization; the relation A V = V H becomes exact."""
    rng = np.random.default_rng(6)
    n = 5
    A = rng.standard_normal((n, n))
    op = DenseOperator(jnp.asarray(A, dtype=jnp.float64))
    V = jnp.zeros((n + 1, n), dtype=jnp.float64)
    H = jnp.zeros((n + 1, n), dtype=jnp.float64)
    V = set_random_vector(V, 0, jax.random.PRNGKey(7))
    V, H = expand_range(op, V, H, 0, n, jax.random.PRNGKey(8))
    Hn = np.asarray(H)
    assert Hn[n, n - 1] == 0.0
    Vn = np.asarray(V)
    assert np.linalg.norm(A @ Vn[:n].T - Vn[:n].T @ Hn[:n, :n]) < 1e-11


def test_initial_vector_not_mutated_not_normalized():
    v1 = jnp.full(10, 3.0, dtype=jnp.float64)
    V = jnp.zeros((5, 10), dtype=jnp.float64)
    V = set_initial_vector(V, v1)
    assert np.isclose(np.linalg.norm(np.asarray(V[0])), 1.0)
    assert np.all(np.asarray(v1) == 3.0)


def test_tiled_basis_change_matches_plain():
    """The tiled in-place basis change (used when V is too large to
    double-buffer) is exact tile-for-tile vs the one-GEMM path."""
    import jax
    import jax.numpy as jnp
    from arnoldimethod_jax.ops import expansion as E

    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    V = jax.random.normal(k1, (9, 48), dtype=jnp.float32)
    Qbig = jax.random.normal(k2, (9, 9), dtype=jnp.float32)
    ref = E.apply_basis_change(jnp.array(V), jnp.array(Qbig))
    # 5, 7, 11 do not divide 48: exercises the ragged remainder tile
    # (ADVICE r4 medium — the old divisor-only path degenerated for
    # prime n).
    for tiles in (1, 2, 4, 5, 7, 11, 48):
        out = E.apply_basis_change_tiled(jnp.array(V), Qbig, tiles=tiles)
        assert np.allclose(np.asarray(out), np.asarray(ref), atol=1e-6)


def test_pick_tiles_bounded():
    """pick_tiles keeps each tile under ~256 MB WITHOUT requiring a
    divisor of n — for prime n it must not degenerate toward n tiles."""
    from arnoldimethod_jax.ops.expansion import pick_tiles

    for n in (1 << 24, 10_240_000, 10_000_019, 96):  # incl. a prime
        t = pick_tiles(n, 201 * 4)
        assert -(-n // t) * 201 * 4 <= (1 << 28)
        # never more than one tile past the ideal count
        assert t <= max(1, -(-n * 201 * 4 // (1 << 28)))


def test_driver_tiled_threshold_solve(monkeypatch):
    """Force the tiled path through the full driver and check solver
    equivalence with the plain path (same matvecs, same spectrum)."""
    from arnoldimethod_jax import driver
    from arnoldimethod_jax.models.problems import laplacian_1d
    from arnoldimethod_jax import partial_schur

    op = laplacian_1d(96)
    d0, h0 = partial_schur(op, nev=6, which="SR", tol=1e-8, method="host")
    monkeypatch.setattr(driver, "tiled_threshold_bytes", lambda device: 1)
    d1, h1 = partial_schur(op, nev=6, which="SR", tol=1e-8, method="host")
    assert h1.converged
    assert h1.mvproducts == h0.mvproducts
    assert np.allclose(
        np.sort(d1.eigenvalues.real), np.sort(d0.eigenvalues.real), atol=1e-9
    )


def test_sliced_expansion_dispatch(monkeypatch):
    """Expansion dispatches are sliced to bounded predicted duration (the
    dispatch-size heuristic, ops/expansion.py DISPATCH_BUDGET_S).  Forcing 1-step
    slices must not change the algorithm: identical matvecs/spectrum."""
    from arnoldimethod_jax import driver, partial_schur
    from arnoldimethod_jax.models.problems import laplacian_1d

    op = laplacian_1d(80)
    d0, h0 = partial_schur(op, nev=6, which="SR", tol=1e-8, method="host")
    monkeypatch.setattr(driver, "DISPATCH_BUDGET_S", 1e-12)
    d1, h1 = partial_schur(op, nev=6, which="SR", tol=1e-8, method="host")
    assert h1.converged
    assert h1.mvproducts == h0.mvproducts
    assert np.allclose(
        np.sort(d1.eigenvalues.real), np.sort(d0.eigenvalues.real), atol=1e-9
    )


class _FakeDevice:
    def __init__(self, platform, stats):
        self.platform = platform
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("limit", [80 * 10**9, 16 * 2**30])
def test_tiled_threshold_from_memory_stats(limit):
    """The basis change tiles when two copies of V would exceed half of
    the device's bytes_limit, i.e. above a quarter of it."""
    from arnoldimethod_jax.ops.expansion import tiled_threshold_bytes

    dev = _FakeDevice("gpu", {"bytes_limit": limit, "bytes_in_use": 0})
    assert tiled_threshold_bytes(dev) == limit // 4


def test_tiled_threshold_requires_memory_stats():
    """A device without allocator statistics is an error, not a guess —
    except a CPU device, whose arrays live in host memory."""
    import os

    from arnoldimethod_jax.ops.expansion import tiled_threshold_bytes

    with pytest.raises(RuntimeError, match="bytes_limit"):
        tiled_threshold_bytes(_FakeDevice("gpu", None))
    with pytest.raises(RuntimeError, match="bytes_limit"):
        tiled_threshold_bytes(_FakeDevice("gpu", {"bytes_in_use": 1}))
    host = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    assert tiled_threshold_bytes(_FakeDevice("cpu", None)) == host // 4
    assert tiled_threshold_bytes(jax.devices()[0]) == host // 4
