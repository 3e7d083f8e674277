"""Double-word float32 arithmetic (ops/df32.py): error-free transforms
survive compilation, and the compound kernels reach ~f64 accuracy from
pure f32 ops — the double-word extended-precision building blocks
(reference analogue: Double64 runs, readme.md:81-99)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from arnoldimethod_jax.ops import df32

f32 = jnp.float32


def test_two_sum_exactness():
    """two_sum is error-free under jit: a compiler that rewrites
    (a + b) - a -> b would zero the error term — fail loudly here."""
    s, e = jax.jit(df32.two_sum)(f32(3.0), f32(1e-9))
    assert float(s) == 3.0
    assert float(e) != 0.0
    assert abs(float(s) + float(e) - (3.0 + 1e-9)) < 1e-18


def test_two_prod_exactness():
    a, b = f32(1.0 + 2**-12), f32(1.0 - 2**-12)
    p, e = jax.jit(df32.two_prod)(a, b)
    exact = float(np.float64(float(a)) * np.float64(float(b)))
    assert float(p) + float(e) == exact  # representable exactly in df32


@pytest.mark.parametrize("n", [1000, 100000])
def test_df_dot_accuracy(n):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    exact = np.dot(x.astype(np.float64), y.astype(np.float64))
    plain = float(
        jnp.dot(jnp.asarray(x), jnp.asarray(y),
                precision=jax.lax.Precision.HIGHEST)
    )
    dh, dl = jax.jit(df32.df_dot)(jnp.asarray(x), jnp.asarray(y))
    comp = float(dh) + float(dl)
    scale = np.sum(np.abs(x * y))  # condition-free scale
    assert abs(comp - exact) / scale < 1e-12
    # and it genuinely beats plain f32 on this cancellation-heavy sum
    assert abs(comp - exact) <= abs(plain - exact)


def test_df_add_mul_roundtrip():
    rng = np.random.default_rng(1)
    a = rng.standard_normal(64).astype(np.float32)
    b = (rng.standard_normal(64) * 1e-9).astype(np.float32)
    c = rng.standard_normal(64).astype(np.float32)
    sh, sl = df32.df_add(jnp.asarray(a), jnp.zeros(64, f32), jnp.asarray(b),
                         jnp.zeros(64, f32))
    got = np.asarray(sh, np.float64) + np.asarray(sl, np.float64)
    want = a.astype(np.float64) + b.astype(np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-13)

    ph, pl = df32.df_mul(sh, sl, jnp.asarray(c), jnp.zeros(64, f32))
    got = np.asarray(ph, np.float64) + np.asarray(pl, np.float64)
    want = want * c
    np.testing.assert_allclose(got, want, rtol=1e-13)


def test_df_norm():
    rng = np.random.default_rng(2)
    x = rng.standard_normal(4096).astype(np.float32)
    nh, nl = jax.jit(df32.df_norm)(jnp.asarray(x), jnp.zeros(4096, f32))
    want = np.linalg.norm(x.astype(np.float64))
    assert abs((float(nh) + float(nl)) - want) / want < 1e-13


@pytest.mark.slow  # 19 growing-shape jit compiles
def test_df32_cgs2_orthogonality():
    """CGS2 with the basis, coefficients, and updates ALL in double-word
    f32 keeps a 20-vector Krylov basis orthonormal far beyond f32 storage
    rounding — the measured compensated-orthogonalization experiment
    (VERDICT r2 item 10).  Plain f32 CGS2 sits at ~4e-7 on this problem;
    the double-word basis must be orders better."""
    rng = np.random.default_rng(3)
    m, n = 20, 2048
    A = (rng.standard_normal((n, n)) / np.sqrt(n)).astype(np.float32)

    @jax.jit
    def df_cgs2(Vh, Vl, w):
        wh, wl = w, jnp.zeros_like(w)
        for _ in range(2):
            hh, hl = df32.df_project_coeffs_df(Vh, Vl, wh, wl)
            wh, wl = df32.df_axpy_update_df(wh, wl, hh, hl, Vh, Vl)
        nh, nlo = df32.df_norm(wh, wl)
        ih, il = df32.df_inv(nh, nlo)
        return df32.df_mul(wh, wl, ih, il)

    Vh = np.zeros((m, n), dtype=np.float32)
    Vl = np.zeros((m, n), dtype=np.float32)
    v = rng.standard_normal(n)
    v = v / np.linalg.norm(v)
    Vh[0] = v.astype(np.float32)
    Vl[0] = (v - Vh[0].astype(np.float64)).astype(np.float32)
    for j in range(1, m):
        # The matvec itself stays plain f32 (as the SpMV does on device).
        w = jnp.asarray(A @ Vh[j - 1])
        sh, sl = df_cgs2(jnp.asarray(Vh[:j]), jnp.asarray(Vl[:j]), w)
        Vh[j], Vl[j] = np.asarray(sh), np.asarray(sl)
    V = Vh.astype(np.float64) + Vl.astype(np.float64)
    err = np.linalg.norm(V @ V.T - np.eye(m))
    assert err < 5e-12, err
