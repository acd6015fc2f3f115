"""The train step: loss -> gradients -> AdamW, with micro-batched
gradient accumulation and optional gradient compression.

The reference's `train/train_step.py` on torch.  Gradients come from
autograd through `lm.loss_fn`; with ``accum_steps`` = n > 1 each
micro-batch's gradients are taken with `torch.autograd.grad`,
compressed if asked, cast to fp32 and summed, then scaled by 1/n, as
the reference's ``lax.scan`` does (plain ``.grad`` accumulation would
sum before the compression).  The optimizer writes parameters and state
in place (`train.optimizer`).

On a mesh (parameters and batch DTensors, `launch.mesh`) the step runs
under DTensor's implicit replication, so the plain tensors the model
makes (positions, masks, zeros) count as replicated; the caller enters
`models.sharding.logical_axis_rules` for the cut points.  Metrics come
back as plain tensors on every rank.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import is_dtensor
from repro_torch.train import optimizer as opt


@dataclass(frozen=True)
class TrainConfig:
    adamw: opt.AdamWConfig = field(default_factory=opt.AdamWConfig)
    accum_steps: int = 1          # microbatch gradient accumulation
    compress_grads: str | None = None   # None | "bf16"
    opt_8bit: bool = False        # int8 block-quantized m, bf16 v


def _compress(grads: dict, mode) -> dict:
    """Cast gradients to the dtype a cross-replica reduction would carry
    ("bf16" halves its bytes); the optimizer re-casts to fp32."""
    if mode == "bf16":
        return {k: g.to(torch.bfloat16) for k, g in grads.items()}
    return grads


def _mesh_scope(params):
    """DTensor's implicit replication when ``params`` live on a mesh."""
    if any(is_dtensor(p) for p in params.parameters()):
        from torch.distributed.tensor.experimental import implicit_replication
        return implicit_replication()
    return contextlib.nullcontext()


def _full(t):
    return t.full_tensor() if is_dtensor(t) else t


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), ``batch`` a dict of tensors on the parameters' device;
    params and opt_state are updated in place."""

    def grads_of(params, batch):
        names, leaves = zip(*((k, p) for k, p in params.named_parameters()
                              if p.requires_grad))
        loss, metrics = lm.loss_fn(params, cfg, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for k, p, g in zip(names, leaves, grads)}
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            _compress(grads, tcfg.compress_grads)

    def microbatched_grads(params, batch):
        if tcfg.accum_steps == 1:
            return grads_of(params, batch)
        n = tcfg.accum_steps
        acc, loss_acc = None, None
        for i in range(n):
            mb = {k: x.reshape(n, x.shape[0] // n, *x.shape[1:])[i]
                  for k, x in batch.items()}
            loss, _, grads = grads_of(params, mb)
            if acc is None:               # 0 + g, without a zeroed tree
                acc = {k: g.to(torch.float32) for k, g in grads.items()}
                loss_acc = loss.to(torch.float32)
            else:
                for k, g in grads.items():
                    acc[k].add_(g.to(torch.float32))
                loss_acc = loss_acc + loss
            del grads
        inv = 1.0 / n
        for g in acc.values():
            g.mul_(inv)
        return loss_acc * inv, {"ce": loss_acc * inv}, acc

    update_fn = opt.update_8bit if tcfg.opt_8bit else opt.update

    def train_step(params, opt_state, batch):
        with _mesh_scope(params):
            loss, metrics, grads = microbatched_grads(params, batch)
            params, opt_state, stats = update_fn(tcfg.adamw, params, grads,
                                                 opt_state)
            metrics = {k: _full(v) for k, v in
                       {"loss": loss, **metrics, **stats}.items()}
        return params, opt_state, metrics

    return train_step


def opt_init_for(tcfg: TrainConfig):
    return opt.init_8bit if tcfg.opt_8bit else opt.init


def make_prefill_step(cfg: ModelConfig):
    """Inference prefill: full-context forward, last-token logits."""
    @torch.no_grad()
    def prefill_step(params, batch):
        memory = (lm.encode(params, cfg, batch["src_embeddings"])
                  if cfg.encoder_layers else None)
        hidden, _ = lm.forward_hidden(params, cfg, batch["tokens"],
                                      prefix=batch.get("prefix"),
                                      memory=memory)
        return lm.logits_fn(params, cfg, hidden[:, -1])
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One-token decode against the standing cache."""
    def serve_step(params, states, tokens, position, memory=None):
        return lm.decode_step(params, cfg, states, tokens, position, memory)
    return serve_step
