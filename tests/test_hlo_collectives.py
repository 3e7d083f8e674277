"""Collective-structure guard: the compiled HLO of the sharded device
steps must contain exactly the communication the algorithm needs
(parallel/mesh.py module docstring), and nothing else.  A GSPMD or
layout regression that inserts resharding/all-gathers ships green through
numerical tests — it only shows up as communication, so assert on the
compiled HLO text directly (VERDICT r2 next-round item 4).

Counts of collectives are version-brittle; the assertions are structural:
which collective *kinds* appear, not how many.
"""

import re

import jax
import jax.numpy as jnp
import pytest

from arnoldimethod_jax.models.problems import laplacian_1d
from arnoldimethod_jax.ops.expansion import (
    apply_basis_change,
    truncate_and_expand,
)
from arnoldimethod_jax.parallel.mesh import (
    basis_sharding,
    make_mesh,
    replicated_sharding,
    shard_operator,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device CPU mesh"
)

_COLLECTIVES = (
    "all-reduce",
    "all-gather",
    "all-to-all",
    "collective-permute",
    "reduce-scatter",
)


def _collective_kinds(hlo_text):
    return {
        op
        for op in _COLLECTIVES
        if re.search(rf"\b{op}\b", hlo_text) is not None
    }


_DTYPE_BYTES = {"f64": 8, "f32": 4, "f16": 2, "bf16": 2, "s32": 4, "u32": 4}

_OP_RE = re.compile(
    r"=\s*(\(?[a-z0-9]+\[[0-9,]*\][^)=]*\)?)\s+"
    r"(all-reduce|all-gather|all-to-all|collective-permute|reduce-scatter)"
    r"(?:-start)?\("
)
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")


def collective_bytes(hlo_text, per_step_only=False):
    """Per-execution communication volume of the compiled program,
    parsed from the HLO text: {kind: (op_count, payload_bytes)}.

    With per_step_only=True, only ops inside a while-loop body (the
    Krylov step loop — identified by '/while/body/' in the op_name
    metadata) are counted: these execute once per Krylov STEP, which is
    what a per-restart communication model needs (docs/parallel.md)."""
    out = {}
    for line in hlo_text.splitlines():
        m = _OP_RE.search(line)
        if m is None:
            continue
        if per_step_only and "/while/body/" not in line:
            continue
        nbytes = 0
        for dt, dims in _SHAPE_RE.findall(m.group(1)):
            elems = 1
            for d in dims.split(","):
                if d:
                    elems *= int(d)
            nbytes += elems * _DTYPE_BYTES.get(dt, 4)
        cnt, tot = out.get(m.group(2), (0, 0))
        out[m.group(2)] = (cnt + 1, tot + nbytes)
    return out


def _sharded_inputs(mesh, n=1024, m=20):
    bsh = basis_sharding(mesh)
    rep = replicated_sharding(mesh)
    V = jax.device_put(jnp.zeros((m + 1, n)), bsh)
    H = jax.device_put(jnp.zeros((m + 1, m)), rep)
    Qbig = jax.device_put(jnp.eye(m + 1), rep)
    return V, H, Qbig


def test_basis_change_is_communication_free():
    """V <- Qbig^T V is elementwise in the sharded axis: the compiled
    program must contain NO collectives of any kind."""
    mesh = make_mesh(8)
    V, _, Qbig = _sharded_inputs(mesh)
    txt = (
        jax.jit(apply_basis_change, donate_argnums=(0,))
        .lower(V, Qbig)
        .compile()
        .as_text()
    )
    assert _collective_kinds(txt) == set(), _collective_kinds(txt)


def test_expansion_step_collective_structure():
    """The fused truncation+expansion step over a banded (Dia) operator:
    Gram-Schmidt contractions become all-reduces and the SpMV halo becomes
    collective-permutes; there must be NO all-gather / all-to-all /
    reduce-scatter (a full gather of x would mean GSPMD stopped treating
    the band exchange as a neighbor halo)."""
    mesh = make_mesh(8)
    op = shard_operator(laplacian_1d(1024), mesh)
    V, H, Qbig = _sharded_inputs(mesh)
    key = jax.random.PRNGKey(0)
    txt = (
        jax.jit(truncate_and_expand, donate_argnums=(1, 2))
        .lower(op, V, H, Qbig, 4, 20, key)
        .compile()
        .as_text()
    )
    kinds = _collective_kinds(txt)
    assert "all-reduce" in kinds, kinds  # the two DGKS psums + norms
    assert "collective-permute" in kinds, kinds  # banded halo exchange
    assert "all-gather" not in kinds, kinds
    assert "all-to-all" not in kinds, kinds
    assert "reduce-scatter" not in kinds, kinds


def test_per_step_comm_bytes_bounded():
    """Quantitative comm-volume pin (VERDICT r4 next #7): the bytes each
    Krylov STEP moves over the interconnect, extracted from the compiled
    HLO, must stay within the algorithm's analytic budget — the input to
    docs/parallel.md's scaling model.  A GSPMD/layout regression that
    starts moving O(n) data per step fails HERE, not in a numerics test.

    Budget per step (m = maxdim, f64 on the CPU mesh):
      all-reduce       <= 8 ops (CGS2: 2 masked projections of (m+1) +
                         DGKS-gate/norm scalars, plus the compiled-but-
                         conditional breakdown-reinit branch),
                         <= 6*(m+1)*8 bytes
      collective-permute: the banded halo only — O(bandwidth) elements,
                         NEVER O(n/d); budget 64 elements.
    """
    mesh = make_mesh(8)
    n, m = 1024, 20
    op = shard_operator(laplacian_1d(n), mesh)
    V, H, Qbig = _sharded_inputs(mesh, n=n, m=m)
    key = jax.random.PRNGKey(0)
    txt = (
        jax.jit(truncate_and_expand, donate_argnums=(1, 2))
        .lower(op, V, H, Qbig, 4, m, key)
        .compile()
        .as_text()
    )
    per_step = collective_bytes(txt, per_step_only=True)
    assert "all-gather" not in per_step, per_step
    assert "all-to-all" not in per_step, per_step
    ar_count, ar_bytes = per_step.get("all-reduce", (0, 0))
    assert 1 <= ar_count <= 8, per_step
    assert ar_bytes <= 6 * (m + 1) * 8, per_step
    cp_count, cp_bytes = per_step.get("collective-permute", (0, 0))
    assert cp_count >= 1, per_step  # the halo must be a permute...
    assert cp_bytes <= 64 * 8, per_step  # ...and stay O(bandwidth)
