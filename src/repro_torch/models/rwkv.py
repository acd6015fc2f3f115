"""RWKV-6 "Finch" block: data-dependent per-channel decay linear
attention (time-mix) + squared-ReLU channel-mix.

Per head (key dim dk = value dim dv = 64):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T          (state (dk, dv))
    o_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
with w_t in (0,1) *data-dependent per channel* via a two-layer LoRA on
the token-shifted input.

Training/prefill runs the sub-chunked parallel form: time is cut into
chunks of 16; within a chunk the exact decay tensor
exp(cw[t-1] - cw[s]) is materialized (all exponents <= 0, so no
overflow), across chunks a (dk, dv) state is carried.  Decode is the
O(1) recurrence.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import shard

CHUNK = 16
HEAD_DIM = 64
DECAY_LORA = 64


def n_heads(cfg: ModelConfig) -> int:
    return cfg.d_model // HEAD_DIM


def init(gen, cfg: ModelConfig, device):
    d = cfg.d_model
    h = n_heads(cfg)

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    tm = {
        "mu": full((5, d), 0.5),                    # r,k,v,w,g shifts
        "w_r": cm.dense_init(gen, d, d, device),
        "w_k": cm.dense_init(gen, d, d, device),
        "w_v": cm.dense_init(gen, d, d, device),
        "w_g": cm.dense_init(gen, d, d, device),
        "w_o": cm.dense_init(gen, d, d, device),
        "decay_base": full((d,), -6.0),
        "decay_lora_a": cm.dense_init(gen, d, DECAY_LORA, device, std=0.01),
        "decay_lora_b": cm.dense_init(gen, DECAY_LORA, d, device, std=0.01),
        "bonus_u": full((h, HEAD_DIM), 0.0),
        "ln_x": cm.rmsnorm_init(d, device),
    }
    cmix = {
        "mu": full((2, d), 0.5),
        "w_k": cm.dense_init(gen, d, cfg.d_ff, device),
        "w_v": cm.dense_init(gen, cfg.d_ff, d, device),
        "w_r": cm.dense_init(gen, d, d, device),
    }
    return {"time_mix": tm, "channel_mix": cmix}


def _token_shift(x, prev):
    """x_{t-1} with ``prev`` as the t=0 predecessor. x: (B,T,D)."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _mix(x, x_prev, mu):
    return x + (x_prev - x) * mu.to(x.dtype)


def _decays(tm, xw):
    """Per-channel log-decay lw <= 0 (data-dependent, Finch)."""
    lora = cm.dense_apply(
        tm["decay_lora_b"],
        torch.tanh(cm.dense_apply(tm["decay_lora_a"], xw, torch.float32)),
        torch.float32)
    return -torch.exp(tm["decay_base"].float() + lora)  # (B,T,D) in (-inf,0)


def _heads(t, b: int, n: int, h: int):
    """(B, n, D) -> (B, H, n, HEAD_DIM)."""
    return t.reshape(b, n, h, HEAD_DIM).transpose(1, 2)


def time_mix_seq(tm, cfg: ModelConfig, x, shift_prev, state):
    """Chunked-parallel WKV. x: (B,T,D), T % CHUNK == 0.

    state: (B,H,dk,dv) float32 carried across calls (prefill chunks).
    Returns (out, new_shift, new_state).
    """
    b, t, d = x.shape
    h = n_heads(cfg)
    xp = _token_shift(x, shift_prev)
    xr, xk, xv, xw, xg = (_mix(x, xp, tm["mu"][i]) for i in range(5))
    r = _heads(cm.dense_apply(tm["w_r"], xr, x.dtype), b, t, h).float()
    k = _heads(cm.dense_apply(tm["w_k"], xk, x.dtype), b, t, h).float()
    v = _heads(cm.dense_apply(tm["w_v"], xv, x.dtype), b, t, h).float()
    g = F.silu(cm.dense_apply(tm["w_g"], xg, x.dtype))
    lw = _heads(_decays(tm, xw), b, t, h)               # (B,H,T,dk)
    u = tm["bonus_u"].float()                           # (H,dk)
    tri = torch.tril(torch.ones((CHUNK, CHUNK), dtype=torch.bool,
                                device=x.device), diagonal=-1)

    s = state
    outs = []
    for i in range(t // CHUNK):
        cs = slice(i * CHUNK, (i + 1) * CHUNK)
        rr, kk, vv, ww = r[:, :, cs], k[:, :, cs], v[:, :, cs], lw[:, :, cs]
        cw = torch.cumsum(ww, dim=2)                    # (B,H,C,dk)
        cw_prev = cw - ww                               # cw[t-1], cw[-1]=0
        # intra-chunk: exact decay tensor, exponents <= 0 by masking
        diff = cw_prev[:, :, :, None, :] - cw[:, :, None, :, :]
        decay_ts = torch.where(tri[None, None, :, :, None], diff, -1e30)
        a = torch.einsum("bhtd,bhtsd,bhsd->bhts", rr, torch.exp(decay_ts),
                         kk)
        a_diag = torch.einsum("bhtd,hd,bhtd->bht", rr, u, kk)
        out = a @ vv + a_diag[..., None] * vv
        # cross-chunk: state contribution decayed to each t
        out = out + (rr * torch.exp(cw_prev)) @ s
        # state update: decay to chunk end, absorb chunk keys
        k_dec = kk * torch.exp(cw[:, :, -1:, :] - cw)
        s = s * torch.exp(cw[:, :, -1, :])[..., None] \
            + k_dec.transpose(-1, -2) @ vv
        outs.append(out)
    out = torch.cat(outs, dim=2).transpose(1, 2).reshape(b, t, d).to(x.dtype)
    out = cm.rmsnorm_apply(tm["ln_x"], out, cfg.norm_eps) * g
    out = cm.dense_apply(tm["w_o"], out, x.dtype)
    return out, x[:, -1], s


def time_mix_step(tm, cfg: ModelConfig, x, shift_prev, state):
    """O(1) decode step. x: (B,1,D)."""
    b, _, d = x.shape
    h = n_heads(cfg)
    xp = shift_prev[:, None]
    xr, xk, xv, xw, xg = (_mix(x, xp, tm["mu"][i]) for i in range(5))
    r = cm.dense_apply(tm["w_r"], xr, torch.float32).reshape(b, h, HEAD_DIM)
    k = cm.dense_apply(tm["w_k"], xk, torch.float32).reshape(b, h, HEAD_DIM)
    v = cm.dense_apply(tm["w_v"], xv, torch.float32).reshape(b, h, HEAD_DIM)
    g = F.silu(cm.dense_apply(tm["w_g"], xg, x.dtype))
    w = torch.exp(_decays(tm, xw)[:, 0].reshape(b, h, HEAD_DIM))
    u = tm["bonus_u"].float()
    kv = k[..., :, None] * v[..., None, :]              # (B,H,dk,dv)
    out = torch.einsum("bhd,bhdv->bhv", r, state + u[None, :, :, None] * kv)
    state = state * w[..., None] + kv
    out = out.reshape(b, 1, d).to(x.dtype)
    out = cm.rmsnorm_apply(tm["ln_x"], out, cfg.norm_eps) * g
    return cm.dense_apply(tm["w_o"], out, x.dtype), x[:, -1], state


def channel_mix(cmix, x, shift_prev):
    """Squared-ReLU FFN with token shift. Returns (out, new_shift)."""
    xp = _token_shift(x, shift_prev)
    xk = _mix(x, xp, cmix["mu"][0])
    xr = _mix(x, xp, cmix["mu"][1])
    kk = torch.relu(cm.dense_apply(cmix["w_k"], xk, x.dtype)).square()
    kk = shard(kk, "data", None, "model")
    rr = torch.sigmoid(cm.dense_apply(cmix["w_r"], xr, x.dtype))
    return rr * cm.dense_apply(cmix["w_v"], kk, x.dtype), x[:, -1]


def init_block_state(cfg: ModelConfig, batch: int, dtype, device):
    h = n_heads(cfg)
    return {
        "wkv": torch.zeros((batch, h, HEAD_DIM, HEAD_DIM),
                           dtype=torch.float32, device=device),
        "shift_t": torch.zeros((batch, cfg.d_model), dtype=dtype,
                               device=device),
        "shift_c": torch.zeros((batch, cfg.d_model), dtype=dtype,
                               device=device),
    }
