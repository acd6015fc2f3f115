"""The LM substrate's modules in the port against the JAX reference.

Each module gets the reference's weights (crossed as numpy arrays) and
the same numpy-seeded inputs; outputs, aux losses and decode states
must agree to float32 rounding (`_torch_lm.RTOL`/`ATOL`).  Covered:
attention (full, causal, windowed with padded chunks, cross, and the
decode ring buffer past the window), both MLPs, the MoE layer (both
dispatches at a capacity that drops tokens), the selective SSM and
RWKV-6 (sequence and step), and one block of every family.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as r_attn, mlp as r_mlp, moe as r_moe
from repro.models import rwkv as r_rwkv, ssm as r_ssm
from repro.models import transformer as r_tf

from repro_torch.models import attention, mlp, moe, rwkv, ssm, transformer

from _torch_lm import close, close_trees, cross, normal, reduced, to_np


def _positions(b: int, t: int):
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t)).copy()
    return jnp.asarray(pos), torch.from_numpy(pos)


def _x(seed: int, shape, scale: float = 1.0):
    x = normal(np.random.default_rng(seed), shape, scale)
    return jnp.asarray(x), torch.from_numpy(x)


# attention --------------------------------------------------------------

@pytest.mark.parametrize("arch,causal,t", [
    ("qwen3", False, 24),        # full, qk-norm, a padded q/kv chunk
    ("qwen3", True, 40),         # causal over three chunks, padded
    ("danube", True, 72),        # sliding window 32 across 5 chunks
    ("granite", True, 16),       # MQA (one kv head)
])
def test_attention_apply(arch, causal, t):
    rcfg, tcfg = reduced(arch)
    rp = r_attn.init(jax.random.PRNGKey(0), rcfg)
    jx, tx = _x(1, (2, t, rcfg.d_model))
    jpos, tpos = _positions(2, t)
    want = jax.jit(lambda p, x, pos: r_attn.apply(
        p, rcfg, x, pos, causal=causal))(rp, jx, jpos)
    got = attention.apply(cross(rp), tcfg, tx, tpos, causal=causal)
    close(got, want, f"{arch} attention causal={causal} T={t}")


def test_attention_cross():
    rcfg, tcfg = reduced("seamless")
    rp = r_attn.init(jax.random.PRNGKey(2), rcfg)
    jx, tx = _x(3, (2, 20, rcfg.d_model))
    jm, tm = _x(4, (2, 12, rcfg.d_model), 0.5)
    jpos, tpos = _positions(2, 20)
    want = jax.jit(lambda *a: r_attn.cross_apply(a[0], rcfg, *a[1:]))(
        rp, jx, jm, jpos)
    got = attention.cross_apply(cross(rp), tcfg, tx, tm, tpos)
    close(got, want, "cross attention")


@pytest.mark.parametrize("arch,cache_len,steps", [
    ("danube", 64, 48),   # window 32: the ring wraps after 32 tokens
    ("qwen3", 16, 24),    # no window, a cache shorter than the stream
])
def test_attention_decode_ring(arch, cache_len, steps):
    rcfg, tcfg = reduced(arch)
    rp = r_attn.init(jax.random.PRNGKey(5), rcfg)
    tp = cross(rp)
    b = 2
    r_cache = r_attn.init_cache(rcfg, b, cache_len, jnp.float32)
    t_cache = attention.init_cache(tcfg, b, cache_len, torch.float32, "cpu")
    close_trees(t_cache, r_cache, "initial cache")
    r_step = jax.jit(lambda c, x, p: r_attn.decode_step(rp, rcfg, c, x, p))
    jx, tx = _x(6, (steps, b, 1, rcfg.d_model))
    for i in range(steps):
        # the two rows at different positions, as serve slots are
        pos = np.array([i, i + 3], np.int32)
        r_cache, want = r_step(r_cache, jx[i], jnp.asarray(pos))
        before = {k: v.clone() for k, v in t_cache.items()}
        new_cache, got = attention.decode_step(tp, tcfg, t_cache, tx[i],
                                               torch.from_numpy(pos))
        for k in before:   # the step leaves its input cache as it was
            assert torch.equal(t_cache[k], before[k]), k
        t_cache = new_cache
        close(got, want, f"{arch} decode step {i}")
    close_trees(t_cache, r_cache, f"{arch} cache after {steps} steps")
    if rcfg.sliding_window:
        assert t_cache["k"].shape[1] == rcfg.sliding_window


# mlp / moe ----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["swiglu", "geglu"])
def test_mlp(kind):
    rp = r_mlp.init(jax.random.PRNGKey(7), 64, 128)
    jx, tx = _x(8, (2, 16, 64))
    want = jax.jit(lambda p, x: r_mlp.apply(p, x, kind))(rp, jx)
    close(mlp.apply(cross(rp), tx, kind), want, f"mlp {kind}")


@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
@pytest.mark.parametrize("arch,capacity_factor", [
    ("llama4", 0.5),     # top-1, tight: tokens drop
    ("arctic", 0.5),     # top-2 + dense residual, tight
    ("arctic", 8.0),     # generous: nothing drops
])
def test_moe(arch, capacity_factor, dispatch):
    rcfg, tcfg = reduced(arch, moe_dispatch=dispatch,
                         capacity_factor=capacity_factor)
    rp = r_moe.init(jax.random.PRNGKey(9), rcfg)
    jx, tx = _x(10, (2, 64, 64), 0.1)   # 128 tokens: two groups of 64
    want, want_aux = jax.jit(lambda p, x: r_moe.apply(p, rcfg, x))(rp, jx)
    got, got_aux = moe.apply(cross(rp), tcfg, tx)
    close(got, want, f"{arch} moe {dispatch}")
    for key in ("lb_loss", "z_loss"):
        close(got_aux[key], want_aux[key], f"{arch} moe {dispatch} {key}")
    if capacity_factor < 1:
        c = moe._capacity(64, tcfg.n_experts, tcfg.top_k, capacity_factor)
        logits = tx.reshape(2, 64, 64) @ cross(rp)["router"]["w"]
        _, idx = moe._top_k(torch.softmax(logits, -1), tcfg.top_k)
        per_expert = torch.nn.functional.one_hot(
            idx.reshape(2, -1), tcfg.n_experts).sum(1)
        assert int(per_expert.max()) > c, "no token overflowed capacity"


def test_moe_sort_drops_same_overflow():
    """The port's two dispatches drop the same tokens (port alone)."""
    _, cfg_e = reduced("llama4", moe_dispatch="einsum", capacity_factor=0.5)
    cfg_s = cfg_e.with_(moe_dispatch="sort")
    p = cross(r_moe.init(jax.random.PRNGKey(2), reduced("llama4")[0]))
    _, tx = _x(3, (2, 64, 64), 0.1)
    close(moe.apply(p, cfg_s, tx)[0], moe.apply(p, cfg_e, tx)[0],
          "sort vs einsum", rtol=2e-4, atol=2e-5)


def test_moe_top_k_ties_to_lower_index():
    probs = torch.tensor([[0.25, 0.25, 0.1, 0.25, 0.15]])
    vals, idx = moe._top_k(probs, 3)
    assert idx.tolist() == [[0, 1, 3]]
    want_vals, want_idx = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    assert idx.tolist() == np.asarray(want_idx).tolist()


# ssm / rwkv -----------------------------------------------------------------

def test_ssm_seq_and_step():
    rcfg, tcfg = reduced("hymba")
    rp = r_ssm.init(jax.random.PRNGKey(11), rcfg)
    tp = cross(rp)
    t = 12
    jx, tx = _x(12, (2, t, rcfg.d_model))
    want = jax.jit(lambda p, x: r_ssm.apply_seq(p, rcfg, x))(rp, jx)
    close(ssm.apply_seq(tp, tcfg, tx), want, "ssm apply_seq")
    r_st = r_ssm.init_state(rp, rcfg, 2, jnp.float32)
    t_st = ssm.init_state(tp, tcfg, 2, torch.float32)
    close_trees(t_st, r_st, "ssm init_state")
    r_step = jax.jit(lambda st, x: r_ssm.apply_step(rp, rcfg, st, x))
    for i in range(t):
        r_st, r_out = r_step(r_st, jx[:, i:i + 1])
        t_st, t_out = ssm.apply_step(tp, tcfg, t_st, tx[:, i:i + 1])
        close(t_out, r_out, f"ssm step {i}")
        close(t_out[:, 0], want[:, i], f"ssm step {i} vs the sequence")
    close_trees(t_st, r_st, "ssm state")


def test_rwkv_seq_and_step():
    rcfg, tcfg = reduced("rwkv6")
    rp = r_rwkv.init(jax.random.PRNGKey(13), rcfg)
    # non-trivial bonus and state, so every term of the WKV is exercised
    rp["time_mix"]["bonus_u"] = 0.3 * jax.random.normal(
        jax.random.PRNGKey(14), rp["time_mix"]["bonus_u"].shape)
    tp = cross(rp)
    b, t, d = 2, 32, rcfg.d_model
    h = r_rwkv.n_heads(rcfg)
    jx, tx = _x(15, (b, t, d))
    jsh, tsh = _x(16, (b, d))
    jst, tst = _x(17, (b, h, 64, 64), 0.1)
    r_out, r_shift, r_state = jax.jit(
        lambda p, *a: r_rwkv.time_mix_seq(p, rcfg, *a))(rp["time_mix"], jx,
                                                         jsh, jst)
    t_out, t_shift, t_state = rwkv.time_mix_seq(tp["time_mix"], tcfg, tx,
                                                tsh, tst)
    close(t_out, r_out, "time_mix_seq out")
    close(t_shift, r_shift, "time_mix_seq shift")
    close(t_state, r_state, "time_mix_seq state")
    r_st, t_sh, t_st = jst, tsh, tst
    r_sh = jsh
    r_step = jax.jit(lambda *a: r_rwkv.time_mix_step(rp["time_mix"], rcfg,
                                                     *a))
    for i in range(t):
        r_o, r_sh, r_st = r_step(jx[:, i:i + 1], r_sh, r_st)
        t_o, t_sh, t_st = rwkv.time_mix_step(tp["time_mix"], tcfg,
                                             tx[:, i:i + 1], t_sh, t_st)
        close(t_o, r_o, f"time_mix_step {i}")
        close(t_o[:, 0], r_out[:, i], f"time_mix_step {i} vs the sequence")
    close(t_st, r_state, "step state vs the sequence's")
    r_c, r_csh = jax.jit(r_rwkv.channel_mix)(rp["channel_mix"], jx, jsh)
    t_c, t_csh = rwkv.channel_mix(tp["channel_mix"], tx, tsh)
    close(t_c, r_c, "channel_mix")
    close(t_csh, r_csh, "channel_mix shift")
    close_trees(rwkv.init_block_state(tcfg, b, torch.float32, "cpu"),
                r_rwkv.init_block_state(rcfg, b, jnp.float32),
                "init_block_state")


# blocks -------------------------------------------------------------------

@pytest.mark.parametrize("arch,kind", [
    ("qwen3", "dense"), ("llama4", "moe"), ("arctic", "moe"),
    ("hymba", "hybrid"), ("rwkv6", "rwkv"), ("seamless", "cross"),
    ("seamless", "encoder"), ("paligemma", "dense"),
])
def test_block(arch, kind):
    rcfg, tcfg = reduced(arch)
    encoder = kind == "encoder"
    rp = r_tf.block_init(jax.random.PRNGKey(18), rcfg, encoder=encoder,
                         use_moe=kind == "moe")
    tp = cross(rp, transformer.Block)
    assert ("moe" in tp) == (kind == "moe")
    b, t = 2, 32
    jx, tx = _x(19, (b, t, rcfg.d_model))
    jpos, tpos = _positions(b, t)
    jm = tm = None
    if kind == "cross":
        jm, tm = _x(20, (b, 8, rcfg.d_model), 0.5)
    want, want_aux = jax.jit(lambda p, x, pos, m: r_tf.block_seq(
        p, rcfg, x, pos, m, causal=not encoder))(rp, jx, jpos, jm)
    got, got_aux = tp.seq(tcfg, tx, tpos, tm, causal=not encoder)
    close(got, want, f"{arch} {kind} block seq")
    close_trees(got_aux, want_aux, f"{arch} {kind} block aux")
    if encoder:
        return
    r_st = r_tf.block_state0(rp, rcfg, b, 16, jnp.float32)
    t_st = tp.state0(tcfg, b, 16, torch.float32)
    close_trees(t_st, r_st, f"{arch} {kind} state0")
    r_step = jax.jit(lambda st, x, pos: r_tf.block_decode(rp, rcfg, st, x,
                                                          pos, jm))
    for i in range(3):
        pos = np.full((b,), i, np.int32)
        r_st, r_y = r_step(r_st, jx[:, i:i + 1], jnp.asarray(pos))
        t_st, t_y = tp.decode(tcfg, t_st, tx[:, i:i + 1],
                              torch.from_numpy(pos), tm)
        close(t_y, r_y, f"{arch} {kind} decode {i}")
    close_trees(t_st, r_st, f"{arch} {kind} decode state")
    assert np.all(np.isfinite(to_np(t_y)))
