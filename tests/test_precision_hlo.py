"""Every contraction the solver lowers onto the device pins HIGHEST
precision: on the GPU a float32 product with no precision given may run in
TF32 (~3 decimal digits), which breaks basis orthogonality.  Checked on
the lowered StableHLO of the expansion step, the fused restart, and the
basis changes."""

import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from arnoldimethod_jax import fused
from arnoldimethod_jax.models.problems import laplacian_1d
from arnoldimethod_jax.ops import expansion as E

N, M = 64, 8


def _op():
    return laplacian_1d(N, dtype=np.float32)


def _state():
    V = jnp.zeros((M + 1, N), jnp.float32).at[0].set(jnp.float32(N ** -0.5))
    H = jnp.zeros((M + 1, M), jnp.float32)
    return V, H


def _lowered(name):
    op = _op()
    V, H = _state()
    Q = jnp.eye(M + 1, dtype=jnp.float32)
    key = jax.random.PRNGKey(0)
    if name == "expand_range":
        return E.expand_range.lower(op, V, H, 0, M, key)
    if name == "expand_range_lowsync":
        return E.expand_range_lowsync.lower(op, V, H, 0, M, key)
    if name == "truncate_and_expand":
        return E.truncate_and_expand.lower(op, V, H, Q, 2, M, key)
    if name == "truncate_and_expand_tiled":
        return E.truncate_and_expand_tiled.lower(op, V, H, Q, 2, M, key,
                                                 tiles=3)
    if name == "apply_basis_change":
        return E.apply_basis_change.lower(V, Q)
    if name == "apply_basis_change_tiled":
        return E.apply_basis_change_tiled.lower(V, Q, tiles=3)
    if name == "fused_chunk":
        i32 = jnp.int32
        return fused._fused_chunk.lower(
            op, V, H, i32(0), i32(M), i32(0), i32(0), jnp.asarray(False),
            jnp.asarray(True), 4, 6, 1e-6, 10, 5, key, which="SR",
        )
    if name == "fused_finish":
        return fused._fused_finish.lower(V, H, jnp.int32(4), which="SR")
    raise ValueError(name)


@pytest.mark.parametrize("name", [
    "expand_range", "expand_range_lowsync", "truncate_and_expand",
    "truncate_and_expand_tiled", "apply_basis_change",
    "apply_basis_change_tiled", "fused_chunk", "fused_finish",
])
def test_every_dot_general_is_highest(name):
    text = _lowered(name).as_text()
    dots = [ln for ln in text.splitlines() if "dot_general" in ln]
    assert dots, f"{name}: no dot_general lowered"
    loose = [ln.strip() for ln in dots
             if not re.search(r"precision = \[HIGHEST, HIGHEST\]", ln)]
    assert not loose, f"{name}: contractions without HIGHEST: {loose[:3]}"
