"""The LM substrate on the card against the port's own CPU run.

Every reduced arch in float32: the same weights on ``cuda`` and on the
CPU give the same forward logits, prefill logits and 3 decode steps
within ``TOL``, TF32 off.  This file imports no jax, so its ``cuda``
tests run on a GPU machine with the port alone; here they skip.
"""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.models import lm

#: float32 on the card (cuBLAS, no TF32) against the CPU's float32
TOL = 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda")


def _outputs(params, cfg, inputs: dict, device) -> list:
    x = {k: torch.from_numpy(v).to(device) for k, v in inputs.items()}
    memory = (lm.encode(params, cfg, x["src_embeddings"])
              if cfg.encoder_layers else None)
    with torch.no_grad():
        hidden, _ = lm.forward_hidden(params, cfg, x["tokens"],
                                      prefix=x.get("prefix"), memory=memory)
        out = [lm.logits_fn(params, cfg, hidden),
               lm.prefill(params, cfg, x["tokens"][:, :8],
                          prefix=x.get("prefix"))[1]]
    b = x["tokens"].shape[0]
    states = lm.init_decode_state(params, cfg, b, 64)
    for i in range(3):
        pos = torch.full((b,), i, dtype=torch.int32, device=device)
        states, logits = lm.decode_step(params, cfg, states, x["decode"][i],
                                        pos, memory)
        out.append(logits)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(registry.ARCHS))
def test_gpu_matches_cpu(cuda_device, name):
    cfg = registry.get(name, reduced=True).with_(dtype="float32")
    cpu = lm.init_params(cfg, 0, device="cpu")
    gpu = copy.deepcopy(cpu).to(cuda_device)
    rng = np.random.default_rng(1)
    inputs = {"tokens": rng.integers(0, cfg.vocab_size, (2, 32),
                                     dtype=np.int32),
              "decode": rng.integers(0, cfg.vocab_size, (3, 2),
                                     dtype=np.int32)}
    if cfg.prefix_len:
        inputs["prefix"] = (0.02 * rng.standard_normal(
            (2, cfg.prefix_len, cfg.d_model))).astype(np.float32)
    if cfg.encoder_layers:
        inputs["src_embeddings"] = (0.02 * rng.standard_normal(
            (2, 8, cfg.d_model))).astype(np.float32)
    for got, want in zip(_outputs(gpu, cfg, inputs, cuda_device),
                         _outputs(cpu, cfg, inputs, "cpu"), strict=True):
        assert got.is_cuda
        torch.testing.assert_close(got.cpu(), want, rtol=TOL, atol=TOL)
