"""Mixture-of-Experts layer (GShard-style) with grouped dispatch.

Covers llama4-maverick (128e top-1) and arctic (128e top-2 + parallel
dense residual MLP).  Tokens are processed in *groups* (GShard's trick)
so the dispatch tensor is (g, n, E, c) with n = moe_group_size instead
of the full token count.

Routing is a scatter with collisions (many tokens -> one expert slot
range) and a capacity limit, resolved as the BFS restoration pass
resolves bitmap races: a deterministic position by prefix sum (cumsum
over the group) instead of atomics.  Tokens overflowing capacity are
dropped (their combine weight is zero), the standard GShard behaviour.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm, mlp
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import shard


def init(gen, cfg: ModelConfig, device):
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    params = {
        "router": cm.dense_init(gen, d, e, device, std=0.02),
        "w_gate": {"w": cm.truncated_normal(gen, (e, d, ff), d ** -0.5,
                                            device)},
        "w_up": {"w": cm.truncated_normal(gen, (e, d, ff), d ** -0.5,
                                          device)},
        "w_down": {"w": cm.truncated_normal(gen, (e, ff, d), ff ** -0.5,
                                            device)},
    }
    if cfg.dense_residual:
        params["dense"] = mlp.init(gen, d, cfg.dense_residual_ff or cfg.d_ff,
                                   device)
    return params


def _capacity(n: int, n_experts: int, top_k: int, factor: float) -> int:
    c = int(n * top_k / n_experts * factor) + 1
    return max(4, -(-c // 4) * 4)  # align to 4


def _top_k(probs, k: int):
    """``jax.lax.top_k``: the k largest, ties to the lower index (a
    stable descending sort keeps equal values in index order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _aux(probs, logits, ce, e: int) -> dict:
    """Load-balance (Switch) and router z-loss."""
    me = probs.mean(dim=1)                               # (g,e)
    lb_loss = e * (me * ce).sum(-1).mean()
    z_loss = torch.logsumexp(logits, dim=-1).square().mean()
    return {"lb_loss": lb_loss, "z_loss": z_loss}


def apply(params, cfg: ModelConfig, x):
    """x: (B, T, D) -> (out (B,T,D), aux losses dict).

    Two dispatch modes (cfg.moe_dispatch):
      "einsum" — GShard-faithful one-hot dispatch/combine einsums;
      "sort"   — gather/scatter routing: tokens ordered by expert with a
        stable argsort, slotted by a prefix sum, gathered into (E,c,D)
        expert buffers and combined back through the inverse
        permutation.  Both modes drop the same overflow tokens.
    """
    b, t, d = x.shape
    total = b * t
    n = min(cfg.moe_group_size, total)
    g = max(total // n, 1)
    assert g * n == total, (
        f"token count {total} not divisible by moe_group_size {n}")
    e, k = cfg.n_experts, cfg.top_k
    c = _capacity(n, e, k, cfg.capacity_factor)

    tokens = shard(x.reshape(g, n, d), "data", None, None)
    logits = tokens.float() @ params["router"]["w"].float()
    probs = torch.softmax(logits, dim=-1)

    gate_vals, gate_idx = _top_k(probs, k)              # (g,n,k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)       # renormalize

    if cfg.moe_dispatch == "sort":
        out, ce = _apply_sorted(params, tokens, gate_vals, gate_idx,
                                g, n, e, k, c)
    else:
        out, ce = _apply_einsum(params, tokens, gate_vals, gate_idx,
                                g, n, e, k, c)
    out = out.reshape(b, t, d)
    if cfg.dense_residual:                               # arctic
        out = out + mlp.apply(params["dense"], x, cfg.mlp)
    return out, _aux(probs, logits, ce, e)


def _expert_ffn(params, expert_in, dtype):
    """(E, g, c, D) -> (E, g, c, D) through the expert GLU stacks."""
    wg = params["w_gate"]["w"].to(dtype)
    wu = params["w_up"]["w"].to(dtype)
    wd = params["w_down"]["w"].to(dtype)
    hidden = F.silu(torch.einsum("egcd,edf->egcf", expert_in, wg)) \
        * torch.einsum("egcd,edf->egcf", expert_in, wu)
    hidden = shard(hidden, "model", None, None, None)
    return torch.einsum("egcf,efd->egcd", hidden, wd)


def _apply_einsum(params, tokens, gate_vals, gate_idx, g, n, e, k, c):
    """One-hot dispatch and combine.  Returns (out (g,n,d), ce (g,e))."""
    dt = tokens.dtype
    dispatch = tokens.new_zeros((g, n, e, c))
    combine = tokens.new_zeros((g, n, e, c), dtype=torch.float32)
    count_so_far = torch.zeros((g, 1, e), dtype=torch.int64,
                               device=tokens.device)
    for kk in range(k):
        mask_k = F.one_hot(gate_idx[..., kk], e)
        pos = torch.cumsum(mask_k, dim=1) - 1 + count_so_far   # (g,n,e)
        keep = (mask_k == 1) & (pos < c)
        # class c is the reference's out-of-range one-hot: an all-zero row
        slot = F.one_hot(torch.where(keep, pos, c), c + 1)[..., :c].to(dt)
        slot = slot * keep[..., None].to(dt)
        dispatch = dispatch + slot
        combine = combine + slot.float() * gate_vals[..., kk][..., None, None]
        count_so_far = count_so_far + mask_k.sum(dim=1, keepdim=True)

    # dispatch: tokens -> expert-major (E, g, c, D); E cut over "model"
    expert_in = shard(torch.einsum("gnec,gnd->egcd", dispatch, tokens),
                      "model", None, None, None)
    expert_out = _expert_ffn(params, expert_in, dt)
    # the combine ("gnec,egcd->gnd") as one batched product over (e, c)
    # flattened with e leading, so a cut of E stays a cut of the
    # flattened dim: torch 2.11's einsum flattens (c, e) here, which
    # DTensor refuses when E is cut
    eo = expert_out.permute(1, 0, 2, 3).reshape(g, e * c, -1)
    out = torch.bmm(combine.to(dt).reshape(g, n, e * c), eo)
    ce = (dispatch.sum(-1) > 0).float().mean(dim=1)
    return out, ce


def _apply_sorted(params, tokens, gate_vals, gate_idx, g, n, e, k, c):
    """Sort-based gather/scatter dispatch.  Returns (out, ce (g,e))."""
    d = tokens.shape[-1]
    dev = tokens.device
    nk = n * k
    eid = gate_idx.reshape(g, nk)                       # expert per entry
    src = torch.arange(n, device=dev).repeat_interleave(k)  # token per entry
    order = torch.argsort(eid, dim=-1, stable=True)     # tokens grouped
    e_sorted = torch.gather(eid, 1, order)
    src_sorted = src[order]                             # (g,nk)
    # slot via prefix sum (restoration-style collision resolution)
    experts = torch.arange(e, device=dev).expand(g, e).contiguous()
    start = torch.searchsorted(e_sorted, experts, side="left")
    pos = torch.arange(nk, device=dev) - torch.gather(start, 1, e_sorted)
    keep = pos < c
    slot = torch.where(keep, e_sorted * c + pos, e * c)
    # gather tokens into (e*c, d) expert buffers; unique slots by
    # construction, and row e*c takes the dropped entries
    g_idx = torch.arange(g, device=dev)[:, None]
    buf = tokens.new_zeros((g, e * c + 1, d))
    buf[g_idx, slot] = tokens[g_idx, src_sorted]
    expert_in = shard(buf[:, :e * c].reshape(g, e, c, d).transpose(0, 1),
                      "model", None, None, None)
    expert_out = _expert_ffn(params, expert_in, tokens.dtype)
    out_buf = expert_out.transpose(0, 1).reshape(g, e * c, d)

    picked = out_buf[g_idx, torch.clamp(slot, max=e * c - 1)] \
        * keep[..., None].to(out_buf.dtype)             # (g,nk,d)
    # entry j came from (token src_sorted[j], choice order[j] % k)
    weights = torch.gather(gate_vals.reshape(g, nk), 1, order) \
        .to(out_buf.dtype)
    out = out_buf.new_zeros((g, n, d)).index_put_(
        (g_idx.expand(g, nk), src_sorted), picked * weights[..., None],
        accumulate=True)
    counts = F.one_hot(e_sorted, e).sum(dim=1)          # (g,e)
    return out, counts.float() / nk
