"""Public model API: init / loss / forward / decode for every config.

``train_step``-facing: ``loss_fn(params, cfg, batch)`` where batch is
  {"tokens": (B,T) int, "labels": (B,T) int (-1 = ignore)}
plus, per family:
  vlm/audio prefix stubs:  "prefix": (B,P,D) precomputed embeddings
  encoder-decoder:         "src_embeddings": (B,S,D) frame embeddings
Gradients come from autograd (`repro_torch.train.train_step`); with
``cfg.remat`` the blocks and each cross-entropy chunk are recomputed in
the backward pass instead of kept.

``serve_step``-facing: ``decode_step(params, cfg, states, tokens,
position[, memory])`` — one token against a standing KV-cache/SSM
state.  Decode and prefill run under ``torch.no_grad``.

Cross-entropy is chunked over tokens (``cfg.vocab_chunk`` per block),
so a large-vocabulary readout never materializes a full (tokens, V)
fp32 tensor.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import common as cm, transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import pin, settle, shard


class LM(cm.Params):
    """A model's parameters: ``embed``, ``final_norm``, ``layers`` (a
    `transformer.Stack` of `transformer.Block` in layer order), and, per
    config, ``lm_head``, ``encoder`` and ``enc_norm``."""

    @property
    def device(self) -> torch.device:
        return self["embed"]["emb"].device


def init_params(cfg: ModelConfig, generator, device=DEFAULT_DEVICE) -> LM:
    """Random weights from ``generator`` (a `torch.Generator` on
    ``device``, or an int seed), stored in ``cfg.param_dtype``.
    ``device="meta"`` gives shapes and dtypes only, with no storage
    (`launch.inputs.params_specs`), at any size."""
    dev = torch.device("meta") if str(device) == "meta" \
        else resolve_device(device)
    gen = cm.make_generator(generator, dev)
    pd = cm.torch_dtype(cfg.param_dtype)

    def cast(tree):
        return cm.cast_floats(cm.Params(tree), pd)

    p = LM()
    p["embed"] = cast(cm.embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                        dev))
    p["final_norm"] = cast(cm.rmsnorm_init(cfg.d_model, dev))
    p["layers"] = tf.stack_init(gen, cfg, cfg.n_layers, dev, param_dtype=pd)
    if not cfg.tie_embeddings:
        p["lm_head"] = cast(cm.embedding_init(gen, cfg.vocab_size,
                                              cfg.d_model, dev))
    if cfg.encoder_layers:
        p["encoder"] = tf.stack_init(gen, cfg, cfg.encoder_layers, dev,
                                     encoder=True, param_dtype=pd)
        p["enc_norm"] = cast(cm.rmsnorm_init(cfg.d_model, dev))
    return p


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return cm.torch_dtype(cfg.dtype)


def _positions(x):
    """(B, T) positions 0..T-1 of ``x`` (B, T, ...)."""
    return torch.arange(x.shape[1], dtype=torch.int32,
                        device=x.device)[None].expand(x.shape[0], -1)


def encode(params, cfg: ModelConfig, src_embeddings):
    """Encoder stack over stub frontend embeddings (B,S,D)."""
    x = src_embeddings.to(_dtype(cfg))
    x, _ = tf.stack_seq(params["encoder"], cfg, x, _positions(x),
                        causal=False)
    return cm.rmsnorm_apply(params["enc_norm"], x, cfg.norm_eps)


def _embed(params, cfg: ModelConfig, tokens, prefix):
    x = cm.embedding_lookup(params["embed"], tokens, _dtype(cfg))
    if prefix is not None:
        x = torch.cat([prefix.to(x.dtype), x], dim=1)
    return x


def forward_hidden(params, cfg: ModelConfig, tokens, prefix=None,
                   memory=None):
    """(B,T[,+P]) -> (hidden (B,T_total,D), aux)."""
    # the lookup of a vocab-cut table is a masked partial sum, reduced
    # here; its gradient, a plain partial sum where the blocks reduce
    # their norms' inputs, is reduced before it reaches the lookup
    x = pin(shard(_embed(params, cfg, tokens, prefix), "data", None, None))
    x, aux = tf.stack_seq(params["layers"], cfg, x, _positions(x), memory)
    return cm.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps), aux


def _readout_table(params):
    return params.get("lm_head", params["embed"])["emb"]


def logits_fn(params, cfg: ModelConfig, hidden):
    """fp32 logits: both sides cast to fp32, as the reference does."""
    out = hidden.float() @ _readout_table(params).float().T
    return shard(out, "data", None, "model")


def _ce_chunk(hc, lc, table):
    """Summed cross entropy of one token chunk (labels < 0 count 0).  On
    a mesh each rank computes its (tokens / data, vocab / model) block of
    the logits."""
    logits = shard(hc.float() @ table.T, "data", "model")
    lse = torch.logsumexp(logits, dim=-1)
    # a vocab-sharded gather's partial sum is reduced while it is 2-D
    gold = settle(torch.gather(logits, 1, lc.clamp(min=0)[:, None]))[:, 0]
    return torch.where(lc >= 0, lse - gold, 0.0).sum()


def chunked_ce(params, cfg: ModelConfig, hidden, labels):
    """Token-chunked cross entropy; labels < 0 are masked.  Under
    ``cfg.remat`` each chunk's fp32 logits are recomputed in the backward
    pass (the reference's ``jax.checkpoint`` of its chunk).

    A chunk is a run of time steps of every batch row (``vocab_chunk``
    tokens, or one step of each row when the batch is wider), not the
    reference's run of flattened tokens: on a mesh the batch dim is cut
    over data, and a slice of it would gather the hidden states onto
    every rank, while a slice of the time dim leaves each rank its rows.
    The sum is the reference's up to the order of its terms."""
    b, t, d = hidden.shape
    steps = max(1, min(cfg.vocab_chunk, b * t) // b)
    table = _readout_table(params).float()
    remat = cfg.remat and torch.is_grad_enabled()
    total = hidden.new_zeros((), dtype=torch.float32)
    for j in range(0, t, steps):
        hc = hidden[:, j:j + steps].reshape(-1, d)
        lc = labels[:, j:j + steps].reshape(-1)
        if remat:
            total = total + checkpoint(_ce_chunk, hc, lc, table,
                                       use_reentrant=False)
        else:
            total = total + _ce_chunk(hc, lc, table)
    n_valid = torch.clamp((labels >= 0).sum(), min=1)
    return total / n_valid


LB_COEF = 1e-2
Z_COEF = 1e-4


def loss_fn(params, cfg: ModelConfig, batch):
    """Scalar training loss + metrics."""
    memory = None
    if cfg.encoder_layers:
        memory = encode(params, cfg, batch["src_embeddings"])
    hidden, aux = forward_hidden(params, cfg, batch["tokens"],
                                 prefix=batch.get("prefix"),
                                 memory=memory)
    if cfg.prefix_len:
        hidden = hidden[:, cfg.prefix_len:]
    ce = chunked_ce(params, cfg, hidden, batch["labels"])
    loss = ce + LB_COEF * aux["lb_loss"] + Z_COEF * aux["z_loss"]
    return loss, {"ce": ce, **aux}


# ---------------------------------------------------------------------------
# Decode (serve_step)
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_decode_state(params, cfg: ModelConfig, batch: int,
                      cache_len: int) -> list:
    """Per-layer KV caches / SSM / WKV states, in layer order, on the
    parameters' device."""
    return tf.stack_state0(params["layers"], cfg, batch, cache_len,
                           _dtype(cfg))


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, states, tokens, position,
                memory=None):
    """One-token serve step.

    tokens: (B,) int; position: (B,) int absolute positions.
    Returns (states', logits (B,V)); ``states`` is left as it was.
    """
    # a vocab-cut table's gather is a masked partial sum: reduced here,
    # once, as the training path's cut point does (torch 2.11 drops its
    # mask after the first of the residual stream's two reads)
    x = settle(cm.embedding_lookup(params["embed"], tokens[:, None],
                                   _dtype(cfg)))
    states, x = tf.stack_decode(params["layers"], cfg, states, x,
                                position, memory)
    h = cm.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    return states, logits_fn(params, cfg, h[:, 0])


@torch.no_grad()
def prefill(params, cfg: ModelConfig, tokens, prefix=None, memory=None):
    """Sequential prefill via the decode path (exactness over speed).
    Returns (states, logits of the last position (B,V))."""
    b = tokens.shape[0]
    x = _embed(params, cfg, tokens, prefix)
    total = x.shape[1]
    states = init_decode_state(params, cfg, b, total)
    for i in range(total):
        pos = torch.full((b,), i, dtype=torch.int32, device=x.device)
        states, xi = tf.stack_decode(params["layers"], cfg, states,
                                     x[:, i][:, None], pos, memory)
    h = cm.rmsnorm_apply(params["final_norm"], xi, cfg.norm_eps)
    return states, logits_fn(params, cfg, h[:, 0])
