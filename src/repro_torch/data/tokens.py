"""Synthetic token data pipeline.

Deterministic, host-sharded, restart-safe: batch ``step`` on host
``host_id`` is a pure function of (seed, step, host), so a restarted job
regenerates exactly the stream it would have seen — the data-side half
of fault-tolerant training (`runtime.fault`).

The "corpus" is a Zipf(1.1) marginal with a bigram rule, so losses fall
during a run: with p = 0.5 token t is ``(base[t-1] * 31 + 7) % V`` of the
previous *base* draw (``roll``'s wrap at t = 0 included), else
``base[t]``; ``labels`` are the tokens shifted by one.

The reference draws from ``jax.random``, which torch cannot reproduce.
The port draws from a CPU `torch.Generator` seeded from (seed, step,
host) and nothing else, then moves the batch to ``device``: the same
contract, other draws, and the same batch on every device.  Parity
tests feed the reference's batches to both packages.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    batch_size: int = 8          # per-host batch
    seq_len: int = 128
    n_hosts: int = 1
    host_id: int = 0


def _generator(dcfg: DataConfig, step: int) -> torch.Generator:
    entropy = np.random.SeedSequence([dcfg.seed, step, dcfg.host_id])
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(entropy.generate_state(1, np.uint64)[0] >> 1))
    return gen


def _zipf_weights(vocab: int) -> torch.Tensor:
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64)
    return ranks ** -1.1


def _draws(cfg: ModelConfig, dcfg: DataConfig, step: int):
    """(base (B, T+1) Zipf draws, coin (B, T+1) bool, generator)."""
    gen = _generator(dcfg, step)
    b, t = dcfg.batch_size, dcfg.seq_len
    base = torch.multinomial(_zipf_weights(cfg.vocab_size), b * (t + 1),
                             replacement=True, generator=gen)
    coin = torch.rand((b, t + 1), generator=gen) < 0.5
    return base.reshape(b, t + 1), coin, gen


def batch_at(cfg: ModelConfig, dcfg: DataConfig, step: int,
             device=DEFAULT_DEVICE) -> dict:
    """The (host, step)-indexed batch. Pure function — restart safe."""
    dev = resolve_device(device)
    base, coin, gen = _draws(cfg, dcfg, step)
    b, t = dcfg.batch_size, dcfg.seq_len
    follow = (base * 31 + 7) % cfg.vocab_size
    toks = torch.where(coin, torch.roll(follow, 1, dims=1), base) \
        .to(torch.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.prefix_len:
        out["prefix"] = 0.02 * torch.randn(
            (b, cfg.prefix_len, cfg.d_model), generator=gen)
    if cfg.encoder_layers:
        out["src_embeddings"] = 0.02 * torch.randn(
            (b, max(t // 4, 8), cfg.d_model), generator=gen)
    return {k: v.contiguous().to(dev) for k, v in out.items()}


def stream(cfg: ModelConfig, dcfg: DataConfig, start_step: int = 0,
           device=DEFAULT_DEVICE):
    """Infinite restartable iterator of (step, batch)."""
    step = start_step
    while True:
        yield step, batch_at(cfg, dcfg, step, device)
        step += 1
