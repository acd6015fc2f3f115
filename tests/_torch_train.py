"""Shared helpers of the training-path parity tests
(``tests/test_torch_train_*.py``).

Trees cross as in `_torch_lm`: the reference's stacked trees of numpy
arrays, the port's dicts keyed by parameter name
(`repro_torch.interop.lm_tree_to_numpy`, `opt_state_from_numpy`).
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro_torch import interop

from _torch_lm import ATOL, RTOL, close, tree_np


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for a file's tests: the models are tiny, and
    under several pytest workers torch's thread pools oversubscribe the
    cores (a 22-step loop took 57 s instead of 1 s)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def leaves(tree) -> list:
    return jax.tree.leaves(tree_np(tree))


def close_named(params, by_name: dict, want, what: str,
                rtol: float = RTOL, atol: float = ATOL) -> None:
    """A port tree keyed by ``params``' names against the reference's
    stacked tree, leaf by leaf (shapes equal; bf16 compared as fp32)."""
    got = leaves(interop.lm_tree_to_numpy(params, by_name))
    want = leaves(want)
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, (what, i, a.shape, b.shape)
        close(a, np.asarray(b, dtype=a.dtype), f"{what} leaf {i}", rtol,
              atol)


def close_8bit_m(params, m: dict, want, what: str,
                 max_flip_frac: float = 1e-3, s_rtol: float = 1e-6) -> None:
    """The 8-bit arm's m against the reference's: the scales (one per
    stacked fallback leaf, `interop.stack_layers` asserts it) to float32
    rounding, q within one quantum, and differing only in a few ties of
    the rounding (inputs that differ in their last bits can round a
    value near q + 0.5 either way)."""
    close_qs(leaves(interop.lm_tree_to_numpy(params, m)), leaves(want),
             what, max_flip_frac, s_rtol)


def close_qs(got: list, want: list, what: str,
             max_flip_frac: float = 1e-3, s_rtol: float = 1e-6) -> None:
    """`close_8bit_m` on two lists of numpy leaves (q and s in turn)."""
    assert len(got) == len(want), what
    flips = total = 0
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype, \
            (what, i, a.shape, b.shape, a.dtype, b.dtype)
        if a.dtype == np.int8:
            diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert diff.max(initial=0) <= 1, (what, i, diff.max())
            flips += int((diff > 0).sum())
            total += a.size
        else:
            close(a, b, f"{what} scale leaf {i}", rtol=s_rtol, atol=0)
    assert flips <= max_flip_frac * total, (what, flips, total)
