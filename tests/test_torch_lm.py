"""Every architecture at its reduced config, port against reference.

Each of the 10 archs runs in float32 with the reference's weights
crossed by `repro_torch.interop.lm_params_from_numpy` and the same
numpy-seeded batch: ``forward_hidden`` (with the encoder's memory and
the vlm prefix where the arch has them), ``logits_fn``, ``loss_fn``'s
value and metrics, ``init_decode_state`` + 3 ``decode_step``s (logits
and the whole per-layer state) and ``prefill``, within
`_torch_lm.RTOL`/`ATOL`.  The reference's outputs are computed once per
arch, each function jitted once.  Then the port alone: decode equals
forward step by step (the reference's own contract), with danube past
its reduced window of 32.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as ref_lm

from repro_torch import interop
from repro_torch.models import lm

from _torch_lm import (ARCH_IDS, as_jax, as_torch, batch, close, close_trees,
                       models, normal)

B, T, DECODE_STEPS, PREFILL_T = 2, 32, 3, 8


@functools.lru_cache(maxsize=None)
def _run(name: str):
    """The reference's and the port's outputs for ``name``."""
    rcfg, rp, tcfg, tp = models(name)
    bn = batch(rcfg, seed=1, b=B, t=T)
    memory = None
    if rcfg.encoder_layers:
        memory = normal(np.random.default_rng(2), (B, 8, rcfg.d_model), 0.02)

    @jax.jit
    def ref_forward(p, b):
        mem = (ref_lm.encode(p, rcfg, b["src_embeddings"])
               if rcfg.encoder_layers else None)
        hidden, aux = ref_lm.forward_hidden(p, rcfg, b["tokens"],
                                            prefix=b.get("prefix"),
                                            memory=mem)
        loss, metrics = ref_lm.loss_fn(p, rcfg, b)
        return hidden, ref_lm.logits_fn(p, rcfg, hidden), loss, metrics

    ref, port = {}, {}
    rb, tb = as_jax(bn), as_torch(bn)
    ref["hidden"], ref["logits"], ref["loss"], ref["metrics"] = \
        ref_forward(rp, rb)
    t_mem = lm.encode(tp, tcfg, tb["src_embeddings"]) \
        if tcfg.encoder_layers else None
    with torch.no_grad():
        port["hidden"], _ = lm.forward_hidden(
            tp, tcfg, tb["tokens"], prefix=tb.get("prefix"), memory=t_mem)
        port["logits"] = lm.logits_fn(tp, tcfg, port["hidden"])
        port["loss"], port["metrics"] = lm.loss_fn(tp, tcfg, tb)

    # decode: the same tokens on both sides (the reference's argmax)
    r_mem = None if memory is None else jnp.asarray(memory)
    t_mem = None if memory is None else torch.from_numpy(memory)
    ref_step = jax.jit(lambda s, tok, pos: ref_lm.decode_step(
        rp, rcfg, s, tok, pos, r_mem))
    r_st = ref_lm.init_decode_state(rp, rcfg, B, 64)
    t_st = lm.init_decode_state(tp, tcfg, B, 64)
    ref["state0"], port["state0"] = r_st, t_st
    tok = np.array([1, 2], np.int32)
    ref["decode"], port["decode"] = [], []
    for i in range(DECODE_STEPS):
        pos = np.full((B,), i, np.int32)
        r_st, r_l = ref_step(r_st, jnp.asarray(tok), jnp.asarray(pos))
        t_st, t_l = lm.decode_step(tp, tcfg, t_st, torch.from_numpy(tok),
                                   torch.from_numpy(pos), t_mem)
        ref["decode"].append(r_l)
        port["decode"].append(t_l)
        tok = np.asarray(r_l).argmax(-1).astype(np.int32)
    ref["state"], port["state"] = r_st, t_st

    prefix = bn.get("prefix")
    ref["prefill"] = jax.jit(lambda t, pf: ref_lm.prefill(rp, rcfg, t, pf))(
        rb["tokens"][:, :PREFILL_T], None if prefix is None else rb["prefix"])
    port["prefill"] = lm.prefill(
        tp, tcfg, tb["tokens"][:, :PREFILL_T],
        None if prefix is None else tb["prefix"])
    return tcfg, ref, port


@pytest.mark.parametrize("name", ARCH_IDS)
def test_forward_hidden(name):
    cfg, ref, port = _run(name)
    assert port["hidden"].shape == (B, T + cfg.prefix_len, cfg.d_model)
    close(port["hidden"], ref["hidden"], f"{name} forward_hidden")


@pytest.mark.parametrize("name", ARCH_IDS)
def test_logits(name):
    cfg, ref, port = _run(name)
    assert port["logits"].dtype == torch.float32
    close(port["logits"], ref["logits"], f"{name} logits_fn")


@pytest.mark.parametrize("name", ARCH_IDS)
def test_loss_value(name):
    cfg, ref, port = _run(name)
    close(port["loss"], ref["loss"], f"{name} loss")
    for key in ("ce", "lb_loss", "z_loss"):
        close(port["metrics"][key], ref["metrics"][key], f"{name} {key}")
    if cfg.moe:
        assert float(port["metrics"]["lb_loss"]) > 0


@pytest.mark.parametrize("name", ARCH_IDS)
def test_decode_steps(name):
    cfg, ref, port = _run(name)
    close_trees(port["state0"], interop.unstack_layers(
        jax.tree.map(np.asarray, ref["state0"])), f"{name} state0")
    for i, (got, want) in enumerate(zip(port["decode"], ref["decode"])):
        assert got.shape == (B, cfg.vocab_size)
        close(got, want, f"{name} decode step {i}")
    close_trees(port["state"], interop.unstack_layers(
        jax.tree.map(np.asarray, ref["state"])), f"{name} decode state")


@pytest.mark.parametrize("name", ARCH_IDS)
def test_prefill(name):
    cfg, ref, port = _run(name)
    (t_st, t_logits), (r_st, r_logits) = port["prefill"], ref["prefill"]
    close(t_logits, r_logits, f"{name} prefill logits")
    close_trees(t_st, interop.unstack_layers(jax.tree.map(np.asarray, r_st)),
                f"{name} prefill state")


@pytest.mark.parametrize("name,t", [
    ("qwen3-14b", 16), ("rwkv6-3b", 16), ("hymba-1.5b", 16),
    ("h2o-danube-1.8b", 48),   # past the reduced window of 32
])
def test_decode_matches_forward(name, t):
    """Greedy decode logits == full-forward logits, step by step."""
    *_, cfg, params = models(name)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, t)).astype(np.int32))
    with torch.no_grad():
        hidden, _ = lm.forward_hidden(params, cfg, tokens)
        full_logits = lm.logits_fn(params, cfg, hidden)
    states = lm.init_decode_state(params, cfg, B, cache_len=t)
    for i in range(t):
        states, logits = lm.decode_step(
            params, cfg, states, tokens[:, i],
            torch.full((B,), i, dtype=torch.int32))
        close(logits, full_logits[:, i],
              f"{name}: decode diverges from forward at pos {i}",
              rtol=2e-3, atol=2e-3)


def test_decode_state_from_numpy_round_trip():
    """A reference decode state crosses into the port's layer order."""
    rcfg, rp, tcfg, tp = models("llama4")   # moe_stride 2: two stacks
    r_st = jax.tree.map(np.asarray, ref_lm.init_decode_state(rp, rcfg, 2, 8))
    assert len(r_st) == 2
    t_st = interop.decode_state_from_numpy(r_st, "cpu")
    assert len(t_st) == tcfg.n_layers == len(tp["layers"])
    assert ["moe" in blk for blk in tp["layers"]] == [False, True]
    close_trees(t_st, lm.init_decode_state(tp, tcfg, 2, 8), "llama4 state")
