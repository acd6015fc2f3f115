"""Shared helpers of the LM substrate's parity tests
(``tests/test_torch_lm*.py``).

Both packages get the same inputs, drawn with numpy from a seed, and
the same weights: the reference's ``init_params`` tree crosses to the
port as numpy arrays (`repro_torch.interop.lm_params_from_numpy`).
Configs are the reduced ones in float32, so the two agree to rounding
(``RTOL``/``ATOL``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as ref_registry
from repro.models import lm as ref_lm

from repro_torch import interop
from repro_torch.configs import registry

#: float32 parity of the port with the reference (different summation
#: orders in matmuls, scans and reductions)
RTOL = ATOL = 1e-4

ARCH_IDS = sorted(registry.ARCHS)
assert ARCH_IDS == sorted(ref_registry.ARCHS)


def reduced(name: str, **kw):
    """The (reference, port) reduced float32 configs of ``name``."""
    ref = ref_registry.get(name, reduced=True).with_(dtype="float32", **kw)
    port = registry.get(name, reduced=True).with_(dtype="float32", **kw)
    assert ref.__dict__ == port.__dict__
    return ref, port


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def cross(tree, cls=None):
    """A reference parameter dict tree as port parameters on the CPU."""
    if cls is None:
        return interop.params_from_numpy(tree_np(tree), "cpu")
    return interop.params_from_numpy(tree_np(tree), "cpu", cls)


def models(name: str, seed: int = 0, **kw):
    """(ref cfg, ref params, port cfg, port LM) with the same weights."""
    rcfg, tcfg = reduced(name, **kw)
    rp = ref_lm.init_params(rcfg, jax.random.PRNGKey(seed))
    return rcfg, rp, tcfg, interop.lm_params_from_numpy(tcfg, tree_np(rp),
                                                        device="cpu")


def normal(rng, shape, scale: float = 1.0) -> np.ndarray:
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def batch(cfg, seed: int, b: int = 2, t: int = 32) -> dict:
    """tokens/labels (+ prefix, src_embeddings) as numpy arrays."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, t + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.prefix_len:
        out["prefix"] = normal(rng, (b, cfg.prefix_len, cfg.d_model), 0.02)
    if cfg.encoder_layers:
        out["src_embeddings"] = normal(rng, (b, 8, cfg.d_model), 0.02)
    return out


def as_jax(d: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in d.items()}


def as_torch(d: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in d.items()}


def close(got, want, what: str, rtol: float = RTOL, atol: float = ATOL):
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=rtol,
                               atol=atol, err_msg=what)


def close_trees(got, want, what: str, rtol: float = RTOL,
                atol: float = ATOL):
    """Two trees of arrays (dicts / lists) equal leaf by leaf."""
    g, w = jax.tree.leaves(got), jax.tree.leaves(tree_np(want))
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        a = to_np(a)
        assert a.shape == b.shape and a.dtype == b.dtype, \
            (what, i, a.shape, b.shape, a.dtype, b.dtype)
        close(a, b, f"{what} leaf {i}", rtol, atol)
