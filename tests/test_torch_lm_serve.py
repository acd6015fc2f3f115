"""The port's LM serve engine, its registry and a bf16 forward.

`repro_torch.serve.engine.ServeEngine` keeps the reference engine's
three contracts (``tests/test_serve_engine.py``: every request
completes, a request served after slot reuse equals a standalone greedy
decode, EOS ends a request) and, on the reference's weights, finishes
the same requests with the same tokens as the reference's engine,
including archs whose slot reset covers SSM and RWKV state.  The
registry matches the reference's (``param_count`` of every full config,
the 40-cell matrix), and a bf16 qwen3-reduced forward stays within a
bf16 tolerance of the reference's.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models import lm as ref_lm
from repro.models.config import param_count as ref_param_count
from repro.serve import engine as ref_engine

from repro_torch import interop
from repro_torch.configs import registry
from repro_torch.models import lm
from repro_torch.models.config import param_count
from repro_torch.serve import Request, ServeEngine

from _torch_lm import ARCH_IDS, models


@pytest.fixture(scope="module")
def served():
    rcfg, rp, cfg, params = models("qwen3", n_layers=2)
    return rcfg, rp, cfg, params


def test_engine_completes_requests(served):
    *_, cfg, params = served
    eng = ServeEngine(cfg, params, batch_slots=2, cache_len=64)
    for uid in range(5):
        eng.submit(Request(uid=uid, prompt=[1 + uid, 2, 3], max_tokens=4))
    eng.run_until_done()
    assert len(eng.finished) == 5
    assert all(len(r.generated) == 4 for r in eng.finished)
    assert {r.uid for r in eng.finished} == set(range(5))


def test_engine_matches_standalone_decode(served):
    """A request served through slot reuse must produce the same tokens
    as a fresh standalone greedy decode."""
    *_, cfg, params = served
    prompt = [5, 9, 2, 7]
    n_gen = 4

    states = lm.init_decode_state(params, cfg, 1, cache_len=64)
    out = []
    for i in range(len(prompt) + n_gen - 1):
        tok = prompt[i] if i < len(prompt) else out[-1]
        states, logits = lm.decode_step(
            params, cfg, states, torch.tensor([tok], dtype=torch.int32),
            torch.tensor([i], dtype=torch.int32))
        if i >= len(prompt) - 1:
            out.append(int(logits.argmax(-1)[0]))

    # engine: warm the slot with another request first (slot reuse)
    eng = ServeEngine(cfg, params, batch_slots=1, cache_len=64)
    eng.submit(Request(uid=0, prompt=[3, 3], max_tokens=2))
    eng.submit(Request(uid=1, prompt=prompt, max_tokens=n_gen))
    eng.run_until_done()
    target = next(r for r in eng.finished if r.uid == 1)
    assert target.generated == out, (target.generated, out)


def test_engine_eos_termination(served):
    *_, cfg, params = served
    eng0 = ServeEngine(cfg, params, batch_slots=1, cache_len=64)
    eng0.submit(Request(uid=0, prompt=[1, 2], max_tokens=3))
    eng0.run_until_done()
    first = eng0.finished[0].generated[0]

    eng = ServeEngine(cfg, params, batch_slots=1, cache_len=64,
                      eos_id=first)
    eng.submit(Request(uid=0, prompt=[1, 2], max_tokens=10))
    eng.run_until_done()
    assert eng.finished[0].generated == [first]


def _requests(vocab: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [(uid, rng.integers(0, vocab, int(rng.integers(1, 7))).tolist(),
             int(rng.integers(1, 6))) for uid in range(n)]


@pytest.mark.parametrize("name,cache_len", [
    ("qwen3", 64),
    ("h2o-danube-1.8b", 64),   # the ring holds the window (32) only
    ("hymba", 16),             # SSM h/conv reset with the slot
    ("rwkv6", 16),             # WKV and token-shift states reset
])
def test_engine_matches_reference_engine(name, cache_len):
    """Same weights, same requests: the same finished tokens, in the same
    order, as the reference's engine (3 slots, refilled as they free)."""
    rcfg, rp, cfg, params = models(name, n_layers=2)
    reqs = _requests(cfg.vocab_size, 7, seed=4)
    ref = ref_engine.ServeEngine(rcfg, rp, batch_slots=3,
                                 cache_len=cache_len)
    eng = ServeEngine(cfg, params, batch_slots=3, cache_len=cache_len)
    for uid, prompt, max_tokens in reqs:
        ref.submit(ref_engine.Request(uid, list(prompt), max_tokens))
        eng.submit(Request(uid, list(prompt), max_tokens))
    assert eng.run_until_done() == ref.run_until_done()
    assert [(r.uid, r.generated) for r in eng.finished] \
        == [(r.uid, r.generated) for r in ref.finished]


def test_engine_resets_every_layer_state():
    """A refilled slot starts from the fresh state in every layer and
    every leaf; the other slots keep theirs."""
    *_, cfg, params = models("hymba", n_layers=2)
    eng = ServeEngine(cfg, params, batch_slots=2, cache_len=8)
    eng.submit(Request(0, [1, 2, 3], 1))
    eng.submit(Request(1, [4, 5, 6, 7], 6))
    eng.step()
    eng.step()
    eng.step()          # request 0 is done; the slot still holds its state
    eng.submit(Request(2, [8], 1))
    kept = [{k: {kk: vv.clone() for kk, vv in v.items()}
             for k, v in st.items()} for st in eng.states]
    eng._fill_slots()
    assert eng.slots[0].uid == 2
    for st, fresh, old in zip(eng.states, eng._fresh, kept):
        for part in st:
            for leaf in st[part]:
                assert torch.equal(st[part][leaf][0], fresh[part][leaf][0])
                assert torch.equal(st[part][leaf][1], old[part][leaf][1])
                assert not torch.equal(old[part][leaf][0],
                                       fresh[part][leaf][0]), (part, leaf)


# registry -----------------------------------------------------------------

@pytest.mark.parametrize("name", ARCH_IDS)
def test_param_count_matches_reference(name):
    cfg, ref = registry.get(name), ref_registry.get(name)
    assert cfg == registry.ARCHS[registry.ALIASES.get(name, name)]
    for active in (False, True):
        assert param_count(cfg, active) == ref_param_count(ref, active)


def test_param_count_sanity():
    """Analytic N for the full configs is in the advertised ballpark."""
    n = param_count(registry.get("qwen3-14b"))
    assert 12e9 < n < 18e9, n
    n_arctic = param_count(registry.get("arctic-480b"))
    assert 300e9 < n_arctic < 600e9, n_arctic
    assert param_count(registry.get("arctic-480b"), active_only=True) < 40e9
    n_rwkv = param_count(registry.get("rwkv6-3b"))
    assert 1.5e9 < n_rwkv < 5e9, n_rwkv


def test_all_40_cells_defined():
    cells = list(registry.all_cells())
    assert len(cells) == 40
    skips = [c for c in cells if c[2] != "run"]
    assert len(skips) == 7
    assert all(s.name == "long_500k" for _, s, _ in skips)
    assert {c.name for c, s, st in cells
            if s.name == "long_500k" and st == "run"} == {
        "h2o-danube-1.8b", "hymba-1.5b", "rwkv6-3b"}
    assert [(c.name, s.name, st) for c, s, st in cells] == [
        (c.name, s.name, st) for c, s, st in ref_registry.all_cells()]
    assert {k: (v.seq_len, v.global_batch, v.kind)
            for k, v in registry.SHAPES.items()} == {
        k: (v.seq_len, v.global_batch, v.kind)
        for k, v in ref_registry.SHAPES.items()}


def test_aliases_and_reduced():
    assert registry.ALIASES == ref_registry.ALIASES
    for alias, name in registry.ALIASES.items():
        assert registry.get(alias).name == name
        assert registry.get(alias, reduced=True).__dict__ \
            == ref_registry.get(alias, reduced=True).__dict__


def test_init_params_shapes_and_dtype():
    """The port's own init: the reference's shapes, param_dtype honoured,
    the same seed giving the same weights."""
    rcfg, rp, cfg, _ = models("llama4")
    cfg = cfg.with_(param_dtype="bfloat16")
    p1 = lm.init_params(cfg, 7, device="cpu")
    p2 = lm.init_params(cfg, 7, device="cpu")
    want = interop.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, rp), device="cpu")
    s1, s2, sw = p1.state_dict(), p2.state_dict(), want.state_dict()
    assert sorted(s1) == sorted(sw)
    for key, t in s1.items():
        assert t.shape == sw[key].shape, key
        assert t.dtype == torch.bfloat16, key
        assert torch.equal(t, s2[key]), key
    std = float(s1["layers.0.attn.wq.w"].float().std())
    assert 0.8 * 64 ** -0.5 < std < 1.0 * 64 ** -0.5, std


# bf16 ---------------------------------------------------------------------

def test_bf16_forward():
    """qwen3-reduced with bf16 activations (float32 weights): the port's
    logits stay within bf16 rounding of the reference's.  Both sides
    round to bf16 at different points (XLA fuses elementwise chains in
    fp32), which moves the logits as much as the reference's own bf16
    run differs from its fp32 one (~0.6% in norm); the bound is 2% of
    the logits' norm, and 2% of their largest magnitude per element."""
    rcfg, rp, cfg, params = models("qwen3")
    rcfg, cfg = rcfg.with_(dtype="bfloat16"), cfg.with_(dtype="bfloat16")
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)

    @jax.jit
    def ref_logits(p, t):
        return ref_lm.logits_fn(p, rcfg, ref_lm.forward_hidden(p, rcfg, t)[0])

    want = ref_logits(rp, jnp.asarray(tokens))
    with torch.no_grad():
        hidden, _ = lm.forward_hidden(params, cfg, torch.from_numpy(tokens))
        got = lm.logits_fn(params, cfg, hidden)
    assert hidden.dtype == torch.bfloat16
    got, want = got.numpy(), np.asarray(want)
    assert np.linalg.norm(got - want) < 2e-2 * np.linalg.norm(want)
    assert np.abs(got - want).max() < 2e-2 * np.abs(want).max()
