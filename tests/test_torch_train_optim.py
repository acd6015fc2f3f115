"""The port's AdamW (`repro_torch.train.optimizer`) against the
reference's `repro.train.optimizer`.

Both get the same parameters and gradients, drawn with numpy from a
seed: `schedule`, `global_norm`, one `update` on the reduced qwen3 tree,
`_quantize`/`_dequantize` on blocked and fallback leaves (q bitwise, s
to one float32 ulp), and `update_8bit` on the reduced qwen3 and llama4
trees, whose per-layer leaves the reference quantises as stacked
fallback leaves with one scale each.  Then the port alone: slicing big
leaves changes nothing, the scale groups follow the stride, and copies
of the reference's own optimizer tests (`test_train_substrate.py`,
`test_optimizer_8bit.py`).
"""
from __future__ import annotations

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as ref_opt

from repro_torch import interop
from repro_torch.train import optimizer as opt

from _torch_lm import close, models, tree_np
from _torch_train import (close_8bit_m, close_named, close_qs, leaves,
                          one_thread)  # noqa: F401

ACFG = dict(lr=1e-2, warmup_steps=3, total_steps=20)


def _pair(**kw):
    return ref_opt.AdamWConfig(**kw), opt.AdamWConfig(**kw)


@functools.lru_cache(maxsize=None)
def _tree(name: str):
    """(ref params, port LM, ref grads) of a reduced arch; grads from a
    numpy seed at the scale of a real step's."""
    _, rp, _, tp = models(name)
    rng = np.random.default_rng(5)
    rg = jax.tree.map(lambda p: jnp.asarray(
        0.05 * rng.standard_normal(p.shape).astype(np.float32)), rp)
    return rp, tp, rg


def _port_grads(tp, rg) -> dict:
    return interop.named_from_numpy(tp, tree_np(rg), "cpu")


@pytest.mark.parametrize("kw", [
    dict(lr=1.0, warmup_steps=10, total_steps=100),
    dict(lr=3e-4, warmup_steps=0, total_steps=5),
    dict(lr=3e-4, warmup_steps=1, total_steps=5, min_lr_frac=0.0),
])
def test_schedule_matches_reference(kw):
    rcfg, pcfg = _pair(**kw)
    for step in (0, 1, 2, 5, 9, 10, 11, 55, 100, 120):
        close(opt.schedule(pcfg, torch.tensor(step, dtype=torch.int32)),
              ref_opt.schedule(rcfg, jnp.int32(step)), f"{kw} step {step}",
              rtol=1e-6, atol=1e-9)


def test_global_norm_matches_reference():
    rp, tp, rg = _tree("qwen3-14b")
    close(opt.global_norm(_port_grads(tp, rg)), ref_opt.global_norm(rg),
          "global_norm", rtol=1e-6, atol=0)


@pytest.mark.parametrize("clip_norm", [1.0, 1e6])   # clipped, unclipped
def test_update_matches_reference(clip_norm):
    """Three fp32 AdamW steps: parameters, m, v, lr and grad norm."""
    rp, tp, rg = _tree("qwen3-14b")
    rcfg, pcfg = _pair(clip_norm=clip_norm, **ACFG)
    tp = copy.deepcopy(tp)
    rs, ps = ref_opt.init(rp), opt.init(tp)
    step = jax.jit(lambda p, g, s: ref_opt.update(rcfg, p, g, s))
    for i in range(3):
        rp, rs, rstat = step(rp, rg, rs)
        _, ps, pstat = opt.update(pcfg, tp, _port_grads(tp, rg), ps)
        close(pstat["lr"], rstat["lr"], f"lr {i}", rtol=1e-6, atol=0)
        close(pstat["grad_norm"], rstat["grad_norm"], f"norm {i}",
              rtol=1e-6, atol=0)
    assert int(ps["step"]) == int(rs["step"]) == 3
    close_named(tp, dict(tp.named_parameters()), rp, "params")
    close_named(tp, ps["m"], rs["m"], "m", rtol=1e-5, atol=1e-9)
    close_named(tp, ps["v"], rs["v"], "v", rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("shape", [(4, 256), (3, 2, 384), (128,),
                                   (7,), (2, 64, 4, 16), (5, 80), ()])
def test_quantize_matches_reference(shape):
    """q bitwise, s within one float32 ulp, dequantized equal."""
    x = np.asarray(np.random.default_rng(len(shape)).standard_normal(shape)
                   * 0.1, dtype=np.float32)
    want = tree_np(ref_opt._quantize(jnp.asarray(x)))
    got = opt._quantize(torch.from_numpy(x))
    assert got["s"].shape == want["s"].shape
    assert got["q"].dtype == torch.int8
    np.testing.assert_array_equal(got["q"].numpy(), want["q"])
    np.testing.assert_array_max_ulp(got["s"].numpy(), want["s"], maxulp=1)
    close(opt._dequantize(got, shape),
          ref_opt._dequantize(tree_np(want), shape), f"{shape} dequantize",
          rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", ["qwen3-14b", "llama4-maverick-400b-a17b"])
def test_update_8bit_matches_reference(name):
    """Two 8-bit steps from the reference's state: the port's scale groups
    are the reference's stacked leaves (llama4: two stride positions)."""
    rp, tp, rg = _tree(name)
    rcfg, pcfg = _pair(**ACFG)
    tp = copy.deepcopy(tp)
    rs = ref_opt.init_8bit(rp)
    ps = interop.opt_state_from_numpy(tp, tree_np(rs), "cpu")
    # mostly fallback leaves; those ending in d_ff 128 are blocked
    ndims = {qs["s"].ndim for qs in ps["m"].values()}
    assert 0 in ndims and len(ndims) > 1, ndims
    step = jax.jit(lambda p, g, s: ref_opt.update_8bit(rcfg, p, g, s))
    for _ in range(2):
        rp, rs, rstat = step(rp, rg, rs)
        _, ps, pstat = opt.update_8bit(pcfg, tp, _port_grads(tp, rg), ps)
    close(pstat["grad_norm"], rstat["grad_norm"], "norm", rtol=1e-6, atol=0)
    close_8bit_m(tp, ps["m"], rs["m"], f"{name} m")
    close_named(tp, ps["v"], rs["v"], f"{name} v", rtol=1e-2, atol=1e-12)
    close_named(tp, dict(tp.named_parameters()), rp, f"{name} params",
                rtol=1e-4, atol=2e-4)


def test_update_8bit_blocked_matches_reference():
    """Leaves whose last dim divides Q_BLOCK: per-block scales."""
    rng = np.random.default_rng(7)
    shapes = {"a": (2, 3, 256), "b": (128,), "c": (5, 384)}
    p = {k: (0.1 * rng.standard_normal(s)).astype(np.float32)
         for k, s in shapes.items()}
    g = {k: (0.05 * rng.standard_normal(s)).astype(np.float32)
         for k, s in shapes.items()}
    rcfg, pcfg = _pair(**ACFG)
    rp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    rs, ps = ref_opt.init_8bit(rp), opt.init_8bit(tp)
    for _ in range(2):
        rp, rs, _ = ref_opt.update_8bit(rcfg, rp, {k: jnp.asarray(v) for k, v
                                                   in g.items()}, rs)
        opt.update_8bit(pcfg, tp, {k: torch.from_numpy(v)
                                   for k, v in g.items()}, ps)
    for k in shapes:
        assert ps["m"][k]["s"].shape == rs["m"][k]["s"].shape
        close_qs([ps["m"][k]["q"].numpy(), ps["m"][k]["s"].numpy()],
                 leaves(rs["m"][k]), f"m {k}")
        close(tp[k], rp[k], f"param {k}", rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arm", ["fp32", "8bit"])
def test_sliced_update_equals_whole(monkeypatch, arm):
    """Updating a big leaf in slices of its leading dim gives the whole
    update bitwise."""
    rng = np.random.default_rng(9)
    p = {"emb": torch.from_numpy(rng.standard_normal((96, 256))
                                 .astype(np.float32)),
         "w": torch.from_numpy(rng.standard_normal((7, 5))
                               .astype(np.float32))}
    g = {k: 0.1 * torch.ones_like(v) + 0.01 * v for k, v in p.items()}
    init, update = (opt.init, opt.update) if arm == "fp32" else \
        (opt.init_8bit, opt.update_8bit)
    runs = []
    for chunk in (opt._CHUNK_ELEMS, 1000):
        monkeypatch.setattr(opt, "_CHUNK_ELEMS", chunk)
        params = {k: v.clone() for k, v in p.items()}
        state = init(params)
        for _ in range(2):
            update(opt.AdamWConfig(**ACFG), params, g, state)
        runs.append((params, state))
    assert len(list(opt._slices(p["emb"]))) > 1       # still patched
    (a, sa), (b, sb) = runs
    for k in p:
        assert torch.equal(a[k], b[k])
    assert all(torch.equal(x, y) for x, y in
               zip(jax.tree.leaves(sa["m"]), jax.tree.leaves(sb["m"])))
    assert all(torch.equal(sa["v"][k], sb["v"][k]) for k in p)


def test_scale_groups_follow_the_stride():
    *_, tp = models("llama4")                     # moe_stride 2
    groups = opt.scale_groups(tp)
    assert len({n for g in groups for n in g}) \
        == len(list(tp.named_parameters()))
    wq = [g for g in groups if g[0].endswith("attn.wq.w")]
    assert sorted(wq) == [["layers.0.attn.wq.w"], ["layers.1.attn.wq.w"]]
    *_, tp = models("qwen3")
    assert ["layers.0.attn.wq.w", "layers.1.attn.wq.w"] \
        in opt.scale_groups(tp)
    assert ["embed.emb"] in opt.scale_groups(tp)
    assert opt.scale_groups({"x": torch.zeros(3)}) == [["x"]]


# Copies of the reference's own optimizer tests -------------------------------

def test_adamw_converges_quadratic():
    acfg = opt.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                           total_steps=200)
    params = {"x": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(150):
        grads = {"x": 2 * (params["x"] - 1.0)}
        opt.update(acfg, params, grads, state)
    np.testing.assert_allclose(params["x"].numpy(), [1.0, 1.0], atol=0.05)


def test_schedule_shapes():
    acfg = opt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                           min_lr_frac=0.1)
    lrs = [float(opt.schedule(acfg, torch.tensor(s, dtype=torch.int32)))
           for s in [0, 5, 10, 55, 100]]
    assert lrs[0] == 0.0
    assert abs(lrs[1] - 0.5) < 1e-6
    assert abs(lrs[2] - 1.0) < 1e-6
    assert lrs[3] < 1.0
    assert abs(lrs[4] - 0.1) < 1e-6


def test_grad_clip_applies():
    acfg = opt.AdamWConfig(lr=1e-3, clip_norm=1.0, weight_decay=0.0)
    params = {"x": torch.zeros(4)}
    _, _, stats = opt.update(acfg, params, {"x": torch.full((4,), 100.0)},
                             opt.init(params))
    assert float(stats["grad_norm"]) > 1.0


def test_quantize_roundtrip():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 256))
                         .astype(np.float32))
    qs = opt._quantize(x)
    assert qs["q"].dtype == torch.int8
    assert qs["s"].shape == (4, 2)
    back = opt._dequantize(qs, x.shape)
    assert float((back - x).abs().max()) < float(x.abs().max()) / 100


def test_quantize_nonblock_fallback():
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(7,))
                         .astype(np.float32))
    back = opt._dequantize(opt._quantize(x), x.shape)
    assert float((back - x).abs().max()) < float(x.abs().max()) / 50


def test_8bit_tracks_fp32_adamw():
    acfg = opt.AdamWConfig(lr=0.05, weight_decay=0.0, warmup_steps=0,
                           total_steps=100)
    target = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 128))
                              .astype(np.float32))
    p32, p8 = {"x": torch.zeros(2, 128)}, {"x": torch.zeros(2, 128)}
    s32, s8 = opt.init(p32), opt.init_8bit(p8)
    loss = lambda p: float(((p["x"] - target) ** 2).sum())
    for _ in range(60):
        opt.update(acfg, p32, {"x": 2 * (p32["x"] - target)}, s32)
        opt.update_8bit(acfg, p8, {"x": 2 * (p8["x"] - target)}, s8)
    l32, l8 = loss(p32), loss(p8)
    assert l8 < 0.15 * float((target ** 2).sum()), l8
    assert l8 < max(4 * l32, 1.0), (l8, l32)


def test_8bit_state_is_small():
    s8 = opt.init_8bit({"w": torch.zeros(256, 512)})
    q_bytes = s8["m"]["w"]["q"].numel()
    s_bytes = s8["m"]["w"]["s"].numel() * 4
    assert q_bytes + s_bytes < 0.3 * 256 * 512 * 4
