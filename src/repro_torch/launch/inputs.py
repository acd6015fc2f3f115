"""Input specs: meta-device stand-ins for every model input.

The reference's `launch/inputs.py` on torch: a tensor on the ``meta``
device carries a shape and a dtype and allocates nothing, the
counterpart of ``jax.ShapeDtypeStruct``, so every arch's specs are made
at full size.  ``concrete_batch`` materializes small real batches for
smoke tests and examples.

Conventions per family:
  dense/moe/ssm : tokens + labels (train) / token + standing state
  vlm           : + "prefix" (B, prefix_len, D) SigLIP-stub patch
                  embeddings
  audio enc-dec : + "src_embeddings" (B, S/4, D) frame embeddings
                  (4x acoustic downsampling convention, stubbed)
"""
from __future__ import annotations

import torch

from repro_torch.configs.registry import Shape
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import common as cm, lm
from repro_torch.models.config import ModelConfig

META = torch.device("meta")


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _frames(seq_len: int) -> int:
    return max(seq_len // 4, 8)


def train_batch_specs(cfg: ModelConfig, shape: Shape) -> dict:
    b, t = shape.global_batch, shape.seq_len
    batch = {"tokens": _spec((b, t), torch.int32),
             "labels": _spec((b, t), torch.int32)}
    if cfg.prefix_len:
        batch["prefix"] = _spec((b, cfg.prefix_len, cfg.d_model),
                                torch.float32)
    if cfg.encoder_layers:
        batch["src_embeddings"] = _spec((b, _frames(t), cfg.d_model),
                                        torch.float32)
    return batch


def params_specs(cfg: ModelConfig) -> lm.LM:
    """The model's parameters on the meta device."""
    return lm.init_params(cfg, 0, device=META)


def decode_input_specs(cfg: ModelConfig, shape: Shape) -> dict:
    """serve_step inputs: one new token + the standing cache/state.

    The cache covers ``shape.seq_len`` already-generated context (the
    ring buffer truncates to the SWA window when the arch has one); the
    states are the port's per-layer list.
    """
    b = shape.global_batch
    d = {"tokens": _spec((b,), torch.int32),
         "position": _spec((b,), torch.int32),
         "states": lm.init_decode_state(params_specs(cfg), cfg, b,
                                        shape.seq_len)}
    if cfg.encoder_layers:
        d["memory"] = _spec((b, _frames(min(shape.seq_len, 16_384)),
                             cfg.d_model), torch.float32)
    return d


# ---------------------------------------------------------------------------
# Concrete batches (smoke tests, examples)
# ---------------------------------------------------------------------------

def concrete_batch(cfg: ModelConfig, seed_or_gen, batch: int, seq: int,
                   device=DEFAULT_DEVICE) -> dict:
    """A random batch on ``device`` (the card by default, as every entry
    point), drawn from ``seed_or_gen`` (an int seed, or a
    `torch.Generator` on ``device``): tokens uniform in [0, vocab),
    labels the tokens shifted by one, stub embeddings 0.02 * N(0, 1).
    The draws are torch's, not the reference's ``jax.random`` ones; the
    contract is the same."""
    dev = resolve_device(device)
    gen = cm.make_generator(seed_or_gen, dev)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                           generator=gen, device=dev, dtype=torch.int32)
    out = {"tokens": tokens[:, :-1].contiguous(),
           "labels": tokens[:, 1:].contiguous()}
    if cfg.prefix_len:
        out["prefix"] = 0.02 * torch.randn(
            (batch, cfg.prefix_len, cfg.d_model), generator=gen, device=dev)
    if cfg.encoder_layers:
        out["src_embeddings"] = 0.02 * torch.randn(
            (batch, _frames(seq), cfg.d_model), generator=gen, device=dev)
    return out
