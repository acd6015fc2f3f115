"""Loss, gradients and one train step of every reduced arch, port
against reference.

Each of the 10 archs runs in float32 with the reference's weights
(`repro_torch.interop.lm_params_from_numpy`) and the same numpy-seeded
batch, ``remat`` on as the configs have it: the port's autograd through
`lm.loss_fn` against ``jax.value_and_grad`` of the reference's, every
gradient leaf compared in the reference's stacked layout
(`interop.lm_tree_to_numpy`) within `_torch_lm.RTOL`/`ATOL`.  Then one
`make_train_step` under each optimizer arm against the reference's
`update`/`update_8bit` of its own gradients from a fresh state.  The
reference's gradient function is jitted once per arch.

The step runs at lr 1e-5: Adam's first step moves a parameter by about
lr * sign(g), and a gradient within rounding of zero may take either
sign on the two sides; at 1e-5 that is inside ``ATOL``.
"""
from __future__ import annotations

import copy
import functools

import jax
import numpy as np
import pytest
import torch

from repro.models import lm as ref_lm
from repro.train import optimizer as ref_opt

from repro_torch.models import lm
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import TrainConfig, make_train_step

from _torch_lm import (ARCH_IDS, RTOL, as_jax, as_torch, batch, close,
                       models)
from _torch_train import close_8bit_m, close_named, one_thread  # noqa: F401

ACFG = dict(lr=1e-5, warmup_steps=0, total_steps=10)


@functools.lru_cache(maxsize=None)
def _ref(name: str):
    """The reference's loss, metrics and gradients of ``name``."""
    rcfg, rp, tcfg, tp = models(name)
    bn = batch(rcfg, seed=1)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: ref_lm.loss_fn(p, rcfg, b), has_aux=True))
    (loss, metrics), grads = grad_fn(rp, as_jax(bn))
    return tcfg, tp, rp, bn, loss, metrics, grads


@pytest.mark.parametrize("name", ARCH_IDS)
def test_loss_and_gradients(name):
    tcfg, tp, _, bn, want_loss, want_metrics, want_grads = _ref(name)
    assert tcfg.remat
    names, leaves = zip(*tp.named_parameters())
    loss, metrics = lm.loss_fn(tp, tcfg, as_torch(bn))
    grads = torch.autograd.grad(loss, leaves)
    close(loss, want_loss, f"{name} loss")
    for key in ("ce", "lb_loss", "z_loss"):
        close(metrics[key], want_metrics[key], f"{name} {key}")
    close_named(tp, dict(zip(names, grads)), want_grads, f"{name} grads")


@pytest.mark.parametrize("arm", ["fp32", "8bit"])
@pytest.mark.parametrize("name", ARCH_IDS)
def test_train_step(name, arm):
    """One step from a fresh state: loss, grad norm, parameters and the
    optimizer state (the 8-bit arm's scales one per stacked leaf)."""
    tcfg, tp, rp, bn, want_loss, _, want_grads = _ref(name)
    eight = arm == "8bit"
    rcfg = ref_opt.AdamWConfig(**ACFG)
    r_init, r_update = (ref_opt.init_8bit, ref_opt.update_8bit) if eight \
        else (ref_opt.init, ref_opt.update)
    rp2, rs, rstat = jax.jit(lambda p, g, s: r_update(rcfg, p, g, s))(
        rp, want_grads, r_init(rp))

    tp = copy.deepcopy(tp)
    tc = TrainConfig(adamw=opt.AdamWConfig(**ACFG), opt_8bit=eight)
    state = (opt.init_8bit if eight else opt.init)(tp)
    _, state, metrics = make_train_step(tcfg, tc)(tp, state, as_torch(bn))
    close(metrics["loss"], want_loss, f"{name} loss")
    close(metrics["grad_norm"], rstat["grad_norm"], f"{name} grad norm")
    close(metrics["lr"], rstat["lr"], f"{name} lr")
    assert int(state["step"]) == 1
    close_named(tp, dict(tp.named_parameters()), rp2, f"{name} params")
    if eight:
        # the scales follow the gradients' largest entries: RTOL
        close_8bit_m(tp, state["m"], rs["m"], f"{name} m", s_rtol=RTOL)
        close_named(tp, state["v"], rs["v"], f"{name} v", rtol=1e-2,
                    atol=1e-12)
    else:
        close_named(tp, state["m"], rs["m"], f"{name} m")
        close_named(tp, state["v"], rs["v"], f"{name} v", atol=1e-9)
