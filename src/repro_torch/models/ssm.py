"""Mamba-style selective SSM head (hymba's parallel-SSM path).

Diagonal selective state space: per channel c and state dim n,
  h_t = exp(dt_t * A)[c,n] * h_{t-1} + (dt_t * B_t)[n] * u_t[c]
  y_t = C_t . h_t + D[c] * u_t[c]
with dt, B, C data-dependent (the "selective" part) and a causal
depthwise conv in front.  The full sequence runs the recurrence step by
step over time (the reference's ``associative_scan`` composes the same
affine maps in another order, so the two agree to rounding); decode is
the single-step recurrence.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import shard


def init(gen, cfg: ModelConfig, device):
    d = cfg.d_model
    d_in = d                       # inner width == d_model (parallel head)
    n = cfg.ssm_state
    a = torch.arange(1, n + 1, dtype=torch.float32, device=device)
    return {
        "in_proj": cm.dense_init(gen, d, 2 * d_in, device),
        "conv": {"w": cm.truncated_normal(gen, (cfg.ssm_conv, d_in),
                                          cfg.ssm_conv ** -0.5, device)},
        "dt_proj": cm.dense_init(gen, d_in, d_in, device, std=0.01),
        "bc_proj": cm.dense_init(gen, d_in, 2 * n, device),
        "a_log": torch.log(a).expand(d_in, n).clone(),
        "d_skip": torch.ones((d_in,), dtype=torch.float32, device=device),
        "out_proj": cm.dense_init(gen, d_in, d, device),
    }


def _conv_causal(w, u, init_state=None):
    """Depthwise causal conv. u: (B,T,C); w: (K,C)."""
    k = w.shape[0]
    if init_state is None:
        init_state = u.new_zeros((u.shape[0], k - 1, u.shape[2]))
    padded = torch.cat([init_state, u], dim=1)
    out = sum(padded[:, i:i + u.shape[1]] * w[i] for i in range(k))
    return out, padded[:, -(k - 1):] if k > 1 else init_state


def _ssm_inputs(params, cfg: ModelConfig, x, conv_state=None):
    u, z = cm.dense_apply(params["in_proj"], x, x.dtype).chunk(2, dim=-1)
    u = shard(u, "data", None, "model")
    u, conv_state = _conv_causal(params["conv"]["w"].to(x.dtype), u,
                                 conv_state)
    u = F.silu(u)
    dt = F.softplus(cm.dense_apply(params["dt_proj"], u, torch.float32))
    bc = cm.dense_apply(params["bc_proj"], u, torch.float32)
    b, c = bc.chunk(2, dim=-1)                         # (B,T,N) each
    a = -torch.exp(params["a_log"].float())            # (C,N)
    decay = torch.exp(dt[..., None] * a)               # (B,T,C,N)
    drive = (dt * u.float())[..., None] * b[..., None, :]   # (B,T,C,N)
    return u, z, c, decay, drive, conv_state


def _gate(params, y, u, z, x):
    y = y + params["d_skip"].to(x.dtype) * u
    return y * F.silu(z)


def apply_seq(params, cfg: ModelConfig, x):
    """Full-sequence SSM (training/prefill). x: (B,T,D)."""
    u, z, c, decay, drive, _ = _ssm_inputs(params, cfg, x)
    h = torch.zeros_like(drive[:, 0])
    hs = []
    for t in range(x.shape[1]):
        h = decay[:, t] * h + drive[:, t]
        hs.append(h)
    h = torch.stack(hs, dim=1)                          # (B,T,C,N)
    y = torch.einsum("btcn,btn->btc", h, c).to(x.dtype)
    y = shard(_gate(params, y, u, z, x), "data", None, "model")
    return cm.dense_apply(params["out_proj"], y, x.dtype)


def init_state(params, cfg: ModelConfig, batch: int, dtype):
    d_in = params["d_skip"].shape[0]
    dev = params["d_skip"].device
    return {
        "h": torch.zeros((batch, d_in, cfg.ssm_state), dtype=torch.float32,
                         device=dev),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, d_in), dtype=dtype,
                            device=dev),
    }


def apply_step(params, cfg: ModelConfig, state, x):
    """One-token decode. x: (B,1,D)."""
    u, z, c, decay, drive, conv_state = _ssm_inputs(
        params, cfg, x, state["conv"])
    h = state["h"] * decay[:, 0] + drive[:, 0]         # (B,C,N)
    y = torch.einsum("bcn,bn->bc", h, c[:, 0])[:, None].to(x.dtype)
    y = _gate(params, y, u, z, x)
    out = cm.dense_apply(params["out_proj"], y, x.dtype)
    return {"h": h, "conv": conv_state}, out
