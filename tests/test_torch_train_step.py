"""The port's train step's options against the reference's, on the
reduced qwen3 config of ``test_train_substrate.py`` (float32).

The reference's batches (`repro.data.tokens.batch_at`) go to both
packages as numpy arrays.  Micro-batched accumulation (each micro-batch's
gradients compressed, if asked, before the fp32 sum; then 1/n; the mean
loss; metrics ``{"ce"}`` only) and bf16 gradient compression against the
reference's jitted ``make_train_step``; remat on equals remat off
bitwise on the CPU for five families; the prefill and serve steps; then
copies of the reference's own train-step tests.
"""
from __future__ import annotations

import copy
import functools

import jax
import numpy as np
import pytest
import torch

from repro.data import tokens as ref_tokens
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_ts

from repro_torch import interop
from repro_torch.data.tokens import DataConfig, batch_at
from repro_torch.models import lm
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import (TrainConfig, make_prefill_step,
                                          make_serve_step, make_train_step)

from _torch_lm import as_torch, close, models, tree_np
from _torch_train import close_named, leaves, one_thread  # noqa: F401

ACFG = dict(lr=1e-5, warmup_steps=0, total_steps=10)


@functools.lru_cache(maxsize=None)
def _tiny():
    rcfg, rp, tcfg, tp = models("qwen3", n_layers=2)
    bn = tree_np(ref_tokens.batch_at(
        rcfg, ref_tokens.DataConfig(batch_size=4, seq_len=32), 0))
    return rcfg, rp, tcfg, tp, bn


@pytest.mark.parametrize("accum,compress", [(2, None), (1, "bf16"),
                                            (2, "bf16")])
def test_step_options_match_reference(accum, compress):
    rcfg, rp, tcfg, tp, bn = _tiny()
    rstep = jax.jit(ref_ts.make_train_step(rcfg, ref_ts.TrainConfig(
        adamw=ref_opt.AdamWConfig(**ACFG), accum_steps=accum,
        compress_grads=compress)))
    rp2, rs, rm = rstep(rp, ref_opt.init(rp), bn)
    tp = copy.deepcopy(tp)
    step = make_train_step(tcfg, TrainConfig(
        adamw=opt.AdamWConfig(**ACFG), accum_steps=accum,
        compress_grads=compress))
    _, state, metrics = step(tp, opt.init(tp), as_torch(bn))
    assert set(metrics) == set(rm)
    for key in rm:
        close(metrics[key], rm[key], f"metric {key}")
    close_named(tp, dict(tp.named_parameters()), rp2, "params")
    if compress is None:
        close_named(tp, state["m"], rs["m"], "m")
        close_named(tp, state["v"], rs["v"], "v", atol=1e-9)
        return
    # a gradient that differs in its last fp32 bits can round to the
    # neighbouring bf16 value: one bf16 ulp (2^-8) per micro-batch
    for what in ("m", "v"):
        for i, (a, b) in enumerate(zip(
                leaves(interop.lm_tree_to_numpy(tp, state[what])),
                leaves(rs[what]))):
            np.testing.assert_allclose(a, b, rtol=2 ** -7,
                                       atol=2 ** -7 * np.abs(b).max(),
                                       err_msg=f"{what} leaf {i}")


def test_compression_rounds_each_microbatch(monkeypatch):
    """Accumulated bf16 gradients are the fp32 sum of each micro-batch's
    bf16 gradients, not the bf16 of their sum."""
    *_, tcfg, tp, bn = _tiny()
    tp = copy.deepcopy(tp)
    batch = as_torch(bn)
    micro = []
    for i in range(2):
        mb = {k: v[2 * i:2 * i + 2] for k, v in batch.items()}
        loss, _ = lm.loss_fn(tp, tcfg, mb)
        micro.append(torch.autograd.grad(loss, list(tp.parameters())))
    want = [(a.to(torch.bfloat16).float() + b.to(torch.bfloat16).float())
            * 0.5 for a, b in zip(*micro)]
    seen, update = {}, opt.update

    def spy(cfg, params, grads, state):
        seen.update(grads)
        return update(cfg, params, grads, state)

    monkeypatch.setattr(opt, "update", spy)
    make_train_step(tcfg, TrainConfig(
        adamw=opt.AdamWConfig(**ACFG), accum_steps=2,
        compress_grads="bf16"))(tp, opt.init(tp), batch)
    for (name, _), w in zip(tp.named_parameters(), want):
        assert seen[name].dtype == torch.float32
        assert torch.equal(seen[name], w), name


@pytest.mark.parametrize("name", ["qwen3", "hymba", "llama4", "rwkv6",
                                  "seamless"])
def test_remat_on_equals_off(name):
    """Recomputing the blocks and the CE chunks changes nothing (CPU:
    bitwise)."""
    out = []
    for remat in (True, False):
        *_, cfg, params = models(name, remat=remat)
        bn = {k: torch.from_numpy(v) for k, v in
              tree_np(ref_tokens.batch_at(
                  cfg, ref_tokens.DataConfig(batch_size=2, seq_len=32),
                  0)).items()}
        loss, _ = lm.loss_fn(params, cfg, bn)
        out.append([loss, *torch.autograd.grad(loss,
                                               list(params.parameters()))])
    assert len(out[0]) == len(out[1])
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_prefill_and_serve_steps():
    rcfg, rp, tcfg, tp, bn = _tiny()
    got = make_prefill_step(tcfg)(tp, as_torch(bn))
    want = jax.jit(ref_ts.make_prefill_step(rcfg))(rp, bn)
    close(got, want, "prefill_step")
    states = lm.init_decode_state(tp, tcfg, 4, 16)
    tok = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    pos = torch.zeros(4, dtype=torch.int32)
    a_st, a = make_serve_step(tcfg)(tp, states, tok, pos)
    b_st, b = lm.decode_step(tp, tcfg, states, tok, pos)
    assert torch.equal(a, b)


# Copies of the reference's own train-step tests ------------------------------

def _port_tiny():
    *_, tcfg, tp, _ = _tiny()
    return tcfg, copy.deepcopy(tp)


def test_train_step_descends():
    cfg, params = _port_tiny()
    step = make_train_step(cfg, TrainConfig(
        adamw=opt.AdamWConfig(lr=1e-2, warmup_steps=0)))
    dcfg = DataConfig(batch_size=4, seq_len=64)
    state = opt.init(params)
    losses = []
    for i in range(8):
        _, state, m = step(params, state, batch_at(cfg, dcfg, i % 2, "cpu"))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses


def test_grad_accum_matches_full_batch():
    cfg, params = _port_tiny()
    batch = batch_at(cfg, DataConfig(batch_size=8, seq_len=32), 0, "cpu")
    acfg = opt.AdamWConfig(lr=1e-3, warmup_steps=0)
    out = []
    for accum in (1, 4):
        p = copy.deepcopy(params)
        make_train_step(cfg, TrainConfig(adamw=acfg, accum_steps=accum))(
            p, opt.init(p), batch)
        out.append(p)
    d = max(float((a - b).detach().abs().max()) for a, b in
            zip(out[0].parameters(), out[1].parameters()))
    assert d < 5e-3


def test_gradient_compression_close():
    cfg, params = _port_tiny()
    batch = batch_at(cfg, DataConfig(batch_size=4, seq_len=32), 0, "cpu")
    acfg = opt.AdamWConfig(lr=1e-3, warmup_steps=0)
    out = []
    for compress in (None, "bf16"):
        p = copy.deepcopy(params)
        make_train_step(cfg, TrainConfig(adamw=acfg,
                                         compress_grads=compress))(
            p, opt.init(p), batch)
        out.append(p)
    rel = max(float((a - b).detach().abs().max()
                    / (a.detach().abs().max() + 1e-9))
              for a, b in zip(out[0].parameters(), out[1].parameters()))
    assert rel < 0.1
