"""Gated MLPs: SwiGLU (llama-family) and GeGLU (gemma/paligemma)."""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.models import common as cm
from repro_torch.models.sharding import shard


def init(gen, d_model: int, d_ff: int, device):
    return {
        "w_gate": cm.dense_init(gen, d_model, d_ff, device),
        "w_up": cm.dense_init(gen, d_model, d_ff, device),
        "w_down": cm.dense_init(gen, d_ff, d_model, device),
    }


def apply(params, x, kind: str = "swiglu"):
    act = F.silu if kind == "swiglu" else cm.gelu
    gate = cm.dense_apply(params["w_gate"], x, x.dtype)
    up = cm.dense_apply(params["w_up"], x, x.dtype)
    hidden = shard(act(gate) * up, "data", None, "model")
    return cm.dense_apply(params["w_down"], hidden, x.dtype)
