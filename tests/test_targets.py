"""Ordering tests (ref: test/ordering.jl): sort keys select the right part
of the spectrum, and permutation sorts are stable (ties broken by index, so
conjugate pairs stay adjacent)."""

import numpy as np

from arnoldimethod_jax.targets import LM, LR, SI, SR, as_target, get_order


def test_target_parsing():
    assert as_target("LM") == LM()
    assert as_target(":sr") == SR()
    assert as_target(LR()) == LR()
    try:
        as_target("XX")
        assert False
    except ValueError:
        pass


def test_orderings_select_correctly():
    lams = np.array([1 + 1j, -3 + 0.5j, 0.1 - 2j, 2.0 + 0j])
    key = get_order("LM")
    assert sorted(lams, key=key)[0] == -3 + 0.5j
    key = get_order("SR")
    assert sorted(lams, key=key)[0] == -3 + 0.5j
    key = get_order("LR")
    assert sorted(lams, key=key)[0] == 2.0 + 0j
    key = get_order("LI")
    assert sorted(lams, key=key)[0] == 1 + 1j
    key = get_order(SI())
    assert sorted(lams, key=key)[0] == 0.1 - 2j


def test_stable_permutation_sort():
    # Equal-magnitude conjugate pair must keep its original adjacency,
    # both forward and after reordering the input.
    lams = [2 + 1j, 2 - 1j, 1 + 0j, 2 + 1j, 2 - 1j]
    key = get_order("LM")
    perm = sorted(range(len(lams)), key=lambda i: key(lams[i]))
    assert perm == [0, 1, 3, 4, 2]
