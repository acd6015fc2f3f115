"""Block composition and layer stacks for every pool family.

One decoder block covers: dense GQA (qwen3/phi3/danube/granite/
paligemma), MoE (llama4/arctic), hybrid parallel attn+SSM (hymba),
attention-free RWKV6, and cross-attention decoders (seamless).  Each
layer is a `Block` with the reference's three entry points:

  seq    : (cfg, x, positions[, memory])  -> (x', aux)
  decode : (cfg, state, x, position[, memory]) -> (state', x')
  state0 : initial per-layer decode state

A stack is a `Stack` (an `nn.ModuleList`) of blocks in layer order, and
its decode state a list of per-layer state dicts.  The reference stacks
layers as a tuple over stride positions (`repro_torch.interop.
unstack_layers` reads that layout, `stack_layers` writes it): with
moe_stride == s, layer i holds an MoE block when i % s == s - 1
(llama4's dense/MoE alternation).  A `Stack` keeps ``stride``, so code
that must see the reference's stacked leaves (the 8-bit optimizer's
scale groups) can find them.

With ``cfg.remat`` and gradients on, `stack_seq` runs each block under
`torch.utils.checkpoint` (the reference's ``jax.checkpoint`` of its scan
body): only the blocks' inputs are kept for the backward pass.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention, common as cm, mlp, moe, rwkv, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import shard


#: the reference's module-level zero aux losses (on the CPU); blocks use
#: `zero_aux` on their own device
ZERO_AUX = {"lb_loss": torch.tensor(0.0), "z_loss": torch.tensor(0.0)}


def zero_aux(device) -> dict:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"lb_loss": z, "z_loss": z}


# ---------------------------------------------------------------------------
# Single blocks
# ---------------------------------------------------------------------------

class Block(cm.Params):
    """One layer's parameters and its entry points."""

    def seq(self, cfg: ModelConfig, x, positions, memory=None, *,
            causal: bool = True):
        return block_seq(self, cfg, x, positions, memory, causal=causal)

    def decode(self, cfg: ModelConfig, st, x, position, memory=None):
        return block_decode(self, cfg, st, x, position, memory)

    def state0(self, cfg: ModelConfig, batch: int, max_len: int, dtype):
        return block_state0(self, cfg, batch, max_len, dtype)


def block_init(gen, cfg: ModelConfig, device, *, encoder: bool = False,
               use_moe: bool | None = None) -> Block:
    d = cfg.d_model
    use_moe = (cfg.moe if use_moe is None else use_moe) and not encoder
    if cfg.attn_free and not encoder:
        return Block({"ln1": cm.rmsnorm_init(d, device),
                      "ln2": cm.rmsnorm_init(d, device),
                      "rwkv": rwkv.init(gen, cfg, device)})
    p = {"ln1": cm.rmsnorm_init(d, device),
         "attn": attention.init(gen, cfg, device),
         "ln2": cm.rmsnorm_init(d, device)}
    if cfg.ssm and not encoder:
        p["ssm"] = ssm.init(gen, cfg, device)
        p["ln_attn_out"] = cm.rmsnorm_init(d, device)
        p["ln_ssm_out"] = cm.rmsnorm_init(d, device)
    if cfg.cross_attention and not encoder:
        p["ln_cross"] = cm.rmsnorm_init(d, device)
        p["cross"] = attention.init(gen, cfg, device)
    if use_moe:
        p["moe"] = moe.init(gen, cfg, device)
    else:
        p["ffn"] = mlp.init(gen, d, cfg.d_ff, device)
    return Block(p)


def _fuse_ssm(p, cfg: ModelConfig, a, s):
    """Hymba's parallel heads: the mean of the re-normed outputs."""
    return 0.5 * (cm.rmsnorm_apply(p["ln_attn_out"], a, cfg.norm_eps)
                  + cm.rmsnorm_apply(p["ln_ssm_out"], s, cfg.norm_eps))


def _mixer_seq(p, cfg: ModelConfig, x, positions, *, causal):
    """Self-attention (+ parallel SSM for hymba) on normed input."""
    xn = cm.rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
    a = attention.apply(p["attn"], cfg, xn, positions, causal=causal)
    if "ssm" in p:
        a = _fuse_ssm(p, cfg, a, ssm.apply_seq(p["ssm"], cfg, xn))
    return a


def block_seq(p, cfg: ModelConfig, x, positions, memory=None, *,
              causal: bool = True):
    """Full-sequence block. Returns (x, aux)."""
    if cfg.seq_parallel:
        # Megatron-style sequence parallelism: the residual stream is
        # seq-sharded over "model" between blocks, so each TP boundary
        # becomes a reduce-scatter (+ all-gather where attention needs
        # the full sequence)
        x = shard(x, "data", "model", None)
    if "rwkv" in p:
        st = rwkv.init_block_state(cfg, x.shape[0], x.dtype, x.device)
        tm_out, _, _ = rwkv.time_mix_seq(
            p["rwkv"]["time_mix"], cfg,
            cm.rmsnorm_apply(p["ln1"], x, cfg.norm_eps),
            st["shift_t"], st["wkv"])
        x = x + tm_out
        cm_out, _ = rwkv.channel_mix(
            p["rwkv"]["channel_mix"],
            cm.rmsnorm_apply(p["ln2"], x, cfg.norm_eps), st["shift_c"])
        return x + cm_out, zero_aux(x.device)

    x = x + _mixer_seq(p, cfg, x, positions, causal=causal)
    if cfg.seq_parallel:
        x = shard(x, "data", "model", None)   # RS after attn residual
    if "cross" in p and memory is not None:
        xn = cm.rmsnorm_apply(p["ln_cross"], x, cfg.norm_eps)
        x = x + attention.cross_apply(p["cross"], cfg, xn, memory,
                                      positions)
    xn = cm.rmsnorm_apply(p["ln2"], x, cfg.norm_eps)
    if "moe" in p:
        f, aux = moe.apply(p["moe"], cfg, xn)
    else:
        f, aux = mlp.apply(p["ffn"], xn, cfg.mlp), zero_aux(x.device)
    return x + f, aux


def block_state0(p, cfg: ModelConfig, batch: int, max_len: int, dtype):
    """Initial decode state matching this block's structure."""
    device = p["ln1"]["scale"].device
    if "rwkv" in p:
        return {"rwkv": rwkv.init_block_state(cfg, batch, dtype, device)}
    st = {"kv": attention.init_cache(cfg, batch, max_len, dtype, device)}
    if "ssm" in p:
        st["ssm"] = ssm.init_state(p["ssm"], cfg, batch, dtype)
    return st


def block_decode(p, cfg: ModelConfig, st, x, position, memory=None):
    """One-token block step. x: (B,1,D). Returns (st', x')."""
    if "rwkv" in p:
        r = st["rwkv"]
        tm_out, sh_t, wkv = rwkv.time_mix_step(
            p["rwkv"]["time_mix"], cfg,
            cm.rmsnorm_apply(p["ln1"], x, cfg.norm_eps),
            r["shift_t"], r["wkv"])
        x = x + tm_out
        cm_in = cm.rmsnorm_apply(p["ln2"], x, cfg.norm_eps)
        cm_out, sh_c = rwkv.channel_mix(p["rwkv"]["channel_mix"], cm_in,
                                        r["shift_c"])
        # token-shift states carry the *normed* inputs, matching seq
        st = {"rwkv": {"wkv": wkv, "shift_t": sh_t, "shift_c": sh_c}}
        return st, x + cm_out

    xn = cm.rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
    kv, a = attention.decode_step(p["attn"], cfg, st["kv"], xn, position)
    new_st = {"kv": kv}
    if "ssm" in p:
        s_st, s = ssm.apply_step(p["ssm"], cfg, st["ssm"], xn)
        new_st["ssm"] = s_st
        a = _fuse_ssm(p, cfg, a, s)
    x = x + a
    # no memory (the serve engine's case): the cross-attention is skipped
    if "cross" in p and memory is not None:
        xc = cm.rmsnorm_apply(p["ln_cross"], x, cfg.norm_eps)
        x = x + attention.cross_apply(p["cross"], cfg, xc, memory,
                                      position[:, None])
    xn = cm.rmsnorm_apply(p["ln2"], x, cfg.norm_eps)
    if "moe" in p:
        f, _ = moe.apply(p["moe"], cfg, xn)
    else:
        f = mlp.apply(p["ffn"], xn, cfg.mlp)
    return new_st, x + f


# ---------------------------------------------------------------------------
# Stacks
# ---------------------------------------------------------------------------

def _stride(cfg: ModelConfig, encoder: bool) -> int:
    return cfg.moe_stride if (cfg.moe and cfg.moe_stride > 1
                              and not encoder) else 1


class Stack(nn.ModuleList):
    """Blocks in layer order; layer i sits at stride position
    i % ``stride`` of the reference's stacked layout."""

    def __init__(self, blocks=(), stride: int = 1):
        super().__init__(blocks)
        self.stride = stride


def stack_init(gen, cfg: ModelConfig, n_layers: int, device, *,
               encoder: bool = False,
               param_dtype: torch.dtype = torch.float32) -> Stack:
    """``n_layers`` blocks in layer order, each cast to ``param_dtype`` as
    it is made (a full-width stack never exists in float32)."""
    stride = _stride(cfg, encoder)
    assert n_layers % stride == 0
    return Stack((cm.cast_floats(block_init(gen, cfg, device,
                                            encoder=encoder,
                                            use_moe=cfg.moe
                                            and i % stride == stride - 1),
                                 param_dtype)
                  for i in range(n_layers)), stride)


def stack_seq(blocks, cfg: ModelConfig, x, positions, memory=None, *,
              causal: bool = True):
    """The blocks in layer order; aux summed. Returns (x, aux)."""
    lb = zl = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for block in blocks:
        if remat:
            x, aux = checkpoint(block_seq, block, cfg, x, positions, memory,
                                causal=causal, use_reentrant=False)
        else:
            x, aux = block.seq(cfg, x, positions, memory, causal=causal)
        lb = lb + aux["lb_loss"]
        zl = zl + aux["z_loss"]
    return x, {"lb_loss": lb, "z_loss": zl}


def stack_state0(blocks, cfg: ModelConfig, batch: int, max_len: int,
                 dtype) -> list:
    return [block.state0(cfg, batch, max_len, dtype) for block in blocks]


def stack_decode(blocks, cfg: ModelConfig, states, x, position,
                 memory=None):
    """One token through every layer. Returns (states', x')."""
    new_states = []
    for block, st in zip(blocks, states, strict=True):
        st, x = block.decode(cfg, st, x, position, memory)
        new_states.append(st)
    return new_states, x
