"""GQA attention with memory-efficient (flash-style) chunking.

Features driven by ModelConfig: grouped-query/multi-query KV heads,
qk-norm (qwen3), sliding-window (h2o-danube), RoPE, cross-attention
(seamless decoder), KV-cache decode.  The chunked running softmax keeps
scores at (B, H, q_chunk, kv_chunk).  Products take bf16 inputs to an
fp32 result where the reference asks for ``preferred_element_type=
float32``: the inputs are cast to fp32 first, which is exact for bf16.
"""
from __future__ import annotations

import torch

from repro_torch.models import common as cm
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import map_local, pin, shard

#: finite, so a row with every key masked stays finite (its softmax is
#: uniform, and later chunks or the caller discard it)
NEG_INF = -1e30


def init(gen, cfg: ModelConfig, device):
    d, hd = cfg.d_model, cfg.resolved_head_dim()
    h, k = cfg.n_heads, cfg.n_kv_heads
    params = {
        "wq": cm.dense_init(gen, d, (h, hd), device),
        "wk": cm.dense_init(gen, d, (k, hd), device),
        "wv": cm.dense_init(gen, d, (k, hd), device),
        "wo": {"w": cm.truncated_normal(gen, (h, hd, d), (h * hd) ** -0.5,
                                        device)},
    }
    if cfg.qk_norm:
        params["q_norm"] = cm.rmsnorm_init(hd, device)
        params["k_norm"] = cm.rmsnorm_init(hd, device)
    return params


def _project_qkv(params, cfg: ModelConfig, x, positions, rope: bool = True):
    dt = x.dtype
    q = cm.dense_apply(params["wq"], x, dt)           # (B,T,H,hd)
    k = cm.dense_apply(params["wk"], x, dt)           # (B,T,K,hd)
    v = cm.dense_apply(params["wv"], x, dt)
    if cfg.qk_norm:
        q = cm.rmsnorm_apply(params["q_norm"], q, cfg.norm_eps)
        k = cm.rmsnorm_apply(params["k_norm"], k, cfg.norm_eps)
    if rope:
        q = cm.apply_rope(q, positions, cfg.rope_theta)
        k = cm.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _repeat_kv(k, n_heads: int):
    """(B,S,K,hd) -> (B,S,H,hd) by group broadcast."""
    b, s, kh, hd = k.shape
    reps = n_heads // kh
    return pin(k[:, :, :, None, :].expand(b, s, kh, reps, hd)
               .reshape(b, s, n_heads, hd))


def _pad_t(x, n: int, fill=0):
    """Pad axis 1 of ``x`` to length ``n`` with ``fill``."""
    padlen = n - x.shape[1]
    if padlen == 0:
        return x
    pad = x.new_full((x.shape[0], padlen, *x.shape[2:]), fill)
    return torch.cat([x, pad], dim=1)


def _chunked_attention(q, k, v, q_pos, kv_pos, *, causal: bool,
                       window: int | None, q_chunk: int, kv_chunk: int):
    """Running-softmax attention. q: (B,Tq,H,D); k,v: (B,Tk,H,D)."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    scale = d ** -0.5
    q_chunk = min(q_chunk, tq)
    kv_chunk = min(kv_chunk, tk)
    nq = -(-tq // q_chunk)
    nk = -(-tk // kv_chunk)
    # pad to chunk multiples (masked out via positions)
    q = _pad_t(q, nq * q_chunk)
    k = _pad_t(k, nk * kv_chunk)
    v = _pad_t(v, nk * kv_chunk)
    q_pos = _pad_t(q_pos, nq * q_chunk, fill=-1)       # padded q: masked rows
    kv_pos = _pad_t(kv_pos, nk * kv_chunk, fill=2**30)  # padded kv: future

    outs = []
    for i in range(nq):
        qs = slice(i * q_chunk, (i + 1) * q_chunk)
        qi = q[:, qs].transpose(1, 2).float()           # (B,H,Cq,D)
        qpi = q_pos[:, qs]                              # (B,Cq)
        m = q.new_full((b, h, q_chunk), NEG_INF, dtype=torch.float32)
        l = q.new_zeros((b, h, q_chunk), dtype=torch.float32)
        acc = q.new_zeros((b, h, q_chunk, d), dtype=torch.float32)
        for j in range(nk):
            ks = slice(j * kv_chunk, (j + 1) * kv_chunk)
            ki = k[:, ks].transpose(1, 2)
            vi = v[:, ks].transpose(1, 2)
            kpi = kv_pos[:, ks]
            s = (qi @ ki.float().transpose(-1, -2)) * scale
            mask = torch.ones_like(s, dtype=torch.bool)
            if causal:
                mask &= qpi[:, None, :, None] >= kpi[:, None, None, :]
            if window is not None:
                mask &= (qpi[:, None, :, None] - kpi[:, None, None, :]
                         < window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] \
                + p.to(vi.dtype).float() @ vi.float()
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.cat(outs, dim=2).transpose(1, 2)        # (B,Tq_pad,H,D)
    return out[:, :tq].to(v.dtype)


_HEADS = ("data", None, "model", None)
_POSITIONS = ("data", None)


def _attend(q, k, v, q_pos, kv_pos, **kw):
    """`_chunked_attention`; on DTensors, on each rank's batch and heads
    (`sharding.map_local`)."""
    return map_local(_chunked_attention, (q, k, v, q_pos, kv_pos),
                     (_HEADS, _HEADS, _HEADS, _POSITIONS, _POSITIONS), **kw)


def apply(params, cfg: ModelConfig, x, positions, *, causal: bool = True):
    """Full-sequence attention (training / prefill). x: (B,T,D)."""
    q, k, v = _project_qkv(params, cfg, x, positions)
    q = shard(q, "data", None, "model", None)
    k = shard(k, "data", None, "model", None)
    h = cfg.n_heads
    k, v = _repeat_kv(k, h), _repeat_kv(v, h)
    out = _attend(q, k, v, positions, positions, causal=causal,
                  window=cfg.sliding_window, q_chunk=cfg.attn_q_chunk,
                  kv_chunk=cfg.attn_kv_chunk)
    out = shard(out, "data", None, "model", None)
    return cm.dense_apply_out(params["wo"], out, x.dtype)


def cross_apply(params, cfg: ModelConfig, x, memory, positions):
    """Cross-attention: queries from x, KV from encoder memory."""
    dt = x.dtype
    memory = memory.to(dt)   # frontend stubs may feed fp32
    q = cm.dense_apply(params["wq"], x, dt)
    k = cm.dense_apply(params["wk"], memory, dt)
    v = cm.dense_apply(params["wv"], memory, dt)
    k, v = _repeat_kv(k, cfg.n_heads), _repeat_kv(v, cfg.n_heads)
    mem_pos = torch.arange(memory.shape[1], dtype=torch.int32,
                           device=memory.device)[None] \
        .expand(memory.shape[0], -1)
    out = _attend(q, k, v, positions, mem_pos, causal=False, window=None,
                  q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk)
    return cm.dense_apply_out(params["wo"], out, dt)


# Decode path ----------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device):
    """Ring-buffer KV cache; SWA caps it at the window size."""
    length = min(max_len, cfg.sliding_window or max_len)
    kd = (batch, length, cfg.n_kv_heads, cfg.resolved_head_dim())
    return {"k": torch.zeros(kd, dtype=dtype, device=device),
            "v": torch.zeros(kd, dtype=dtype, device=device),
            "pos": torch.full((batch, length), -1, dtype=torch.int32,
                              device=device)}


def decode_step(params, cfg: ModelConfig, cache, x, position):
    """One-token decode. x: (B,1,D); position: (B,) absolute index.

    Returns (cache', out (B,1,D)); ``cache`` is left as it was.  The
    cache is a ring buffer indexed by position % length, so
    sliding-window archs hold only the window.
    """
    q, k_new, v_new = _project_qkv(params, cfg, x, position[:, None])
    length = cache["k"].shape[1]
    slot = (position % length).long()                   # (B,)
    b_idx = torch.arange(x.shape[0], device=x.device)
    cache = {
        "k": cache["k"].index_put((b_idx, slot), k_new[:, 0]),
        "v": cache["v"].index_put((b_idx, slot), v_new[:, 0]),
        "pos": cache["pos"].index_put((b_idx, slot),
                                      position.to(torch.int32)),
    }
    h = cfg.n_heads
    k = _repeat_kv(cache["k"], h)                       # (B,S,H,hd)
    v = _repeat_kv(cache["v"], h)
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float()) * scale
    pos = cache["pos"][:, None, None, :]
    here = position[:, None, None, None]
    mask = (pos >= 0) & (pos <= here)
    if cfg.sliding_window is not None:
        mask &= here - pos < cfg.sliding_window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bhqs,bshd->bqhd", p, v)
    return cache, cm.dense_apply_out(params["wo"], out, x.dtype)
