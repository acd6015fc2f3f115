"""The token stream, checkpoints and the fault-tolerant loop of the port
(`repro_torch.data.tokens`, `checkpoint.ckpt`, `runtime.fault`).

The stream draws from torch, not from ``jax.random``, so it is held to
the reference's contract, not to its draws: restart-safe and
host-unique, the bigram rule with ``roll``'s wrap at t = 0, labels
shifted by one, the Zipf(1.1) marginal (also against the reference's
own batches' histogram), the prefix and frame stubs.  Checkpoints: the
reference's layout, fp32/bf16/int8 leaves and a whole train state
bitwise, GC and LATEST, a torn save never committed, shape errors by
leaf.  The loop: restarts, give-up, stragglers, and the losses after
each restore equal to an uninterrupted run's, bitwise on the CPU.
"""
from __future__ import annotations

import copy
import json
import os

import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.data import tokens as ref_tokens

from repro_torch.checkpoint.ckpt import (CheckpointManager, latest_step,
                                         restore, save)
from repro_torch.configs import registry
from repro_torch.data import tokens
from repro_torch.data.tokens import DataConfig, batch_at, stream
from repro_torch.runtime.fault import (FailureInjector, SimulatedFailure,
                                       train_loop)
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import TrainConfig, make_train_step

from _torch_lm import models
from _torch_train import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def tiny():
    *_, cfg, params = models("qwen3", n_layers=2)
    return cfg, params


def _cfg(name="qwen3"):
    return registry.get(name, reduced=True).with_(dtype="float32")


# The token stream ------------------------------------------------------------

def test_data_pipeline_deterministic_and_host_sharded():
    cfg = _cfg()
    d0 = DataConfig(seed=1, batch_size=2, seq_len=16, host_id=0)
    d1 = DataConfig(seed=1, batch_size=2, seq_len=16, host_id=1)
    a = batch_at(cfg, d0, 5, "cpu")
    b = batch_at(cfg, d0, 5, "cpu")
    c = batch_at(cfg, d1, 5, "cpu")
    assert torch.equal(a["tokens"], b["tokens"])          # restartable
    assert not torch.equal(a["tokens"], c["tokens"])      # host-unique
    assert not torch.equal(a["tokens"], batch_at(cfg, d0, 6, "cpu")["tokens"])
    assert not torch.equal(a["tokens"], batch_at(
        cfg, DataConfig(seed=2, batch_size=2, seq_len=16), 5,
        "cpu")["tokens"])
    step, batch = next(stream(cfg, d0, start_step=5, device="cpu"))
    assert step == 5
    assert torch.equal(batch["tokens"], a["tokens"])
    assert a["tokens"].dtype == torch.int32 and a["tokens"].shape == (2, 16)


def test_bigram_rule_and_shifted_labels():
    cfg = _cfg()
    dcfg = DataConfig(seed=3, batch_size=4, seq_len=64)
    base, coin, _ = tokens._draws(cfg, dcfg, 2)
    toks = torch.cat([batch_at(cfg, dcfg, 2, "cpu")["tokens"],
                      batch_at(cfg, dcfg, 2, "cpu")["labels"][:, -1:]], 1)
    assert torch.equal(batch_at(cfg, dcfg, 2, "cpu")["labels"], toks[:, 1:])
    follow = (base * 31 + 7) % cfg.vocab_size
    for t in range(toks.shape[1]):
        prev = follow[:, t - 1]                   # t = 0 wraps to the end
        want = torch.where(coin[:, t], prev, base[:, t])
        assert torch.equal(toks[:, t], want.to(torch.int32)), t
    assert 0.4 < coin.float().mean() < 0.6


def test_zipf_marginal():
    """The base draws follow Zipf(1.1); the tokens' histogram matches the
    reference's on the same config (total variation)."""
    cfg = _cfg()
    v = cfg.vocab_size
    dcfg = DataConfig(seed=0, batch_size=64, seq_len=255)
    base, _, _ = tokens._draws(cfg, dcfg, 0)
    p = np.arange(1, v + 1, dtype=np.float64) ** -1.1
    p /= p.sum()
    freq = np.bincount(base.flatten().numpy(), minlength=v) / base.numel()
    np.testing.assert_allclose(freq[:4], p[:4], rtol=0.05)
    assert 0.5 * np.abs(freq - p).sum() < 0.05
    ours = batch_at(cfg, dcfg, 0, "cpu")["tokens"].flatten().numpy()
    theirs = np.asarray(ref_tokens.batch_at(
        ref_registry.get("qwen3", reduced=True),
        ref_tokens.DataConfig(seed=0, batch_size=64, seq_len=255),
        0)["tokens"]).flatten()
    h1 = np.bincount(ours, minlength=v) / ours.size
    h2 = np.bincount(theirs, minlength=v) / theirs.size
    assert 0.5 * np.abs(h1 - h2).sum() < 0.08


@pytest.mark.parametrize("name,key,shape", [
    ("paligemma", "prefix", (2, 8, 64)),
    ("seamless", "src_embeddings", (2, 8, 64)),
])
def test_modality_stubs(name, key, shape):
    cfg = _cfg(name)
    b = batch_at(cfg, DataConfig(batch_size=2, seq_len=16), 0, "cpu")
    ref = ref_tokens.batch_at(ref_registry.get(name, reduced=True),
                              ref_tokens.DataConfig(batch_size=2,
                                                    seq_len=16), 0)
    assert set(b) == set(ref)
    assert b[key].shape == shape == ref[key].shape
    assert b[key].dtype == torch.float32
    assert 0.01 < float(b[key].std()) < 0.03


def test_batch_asks_for_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batch_at(_cfg(), DataConfig(batch_size=1, seq_len=4), 0)


# Checkpoints -----------------------------------------------------------------

def test_checkpoint_roundtrip_dtypes(tmp_path):
    """fp32, bf16 and int8 leaves (and 0-d ones) come back bitwise."""
    g = torch.Generator().manual_seed(0)
    tree = {"f": torch.randn(3, 5, generator=g),
            "b": torch.randn(4, 6, generator=g).to(torch.bfloat16),
            "q": {"q": torch.randint(-127, 128, (7,), generator=g,
                                     dtype=torch.int8),
                  "s": torch.tensor(0.25)},
            "n": [torch.arange(4, dtype=torch.int32)]}
    save(tmp_path, 7, tree, metadata={"loss": 1.25})
    like = {"f": torch.zeros(3, 5), "b": torch.zeros(4, 6, dtype=torch.bfloat16),
            "q": {"q": torch.zeros(7, dtype=torch.int8), "s": torch.zeros(())},
            "n": [torch.zeros(4, dtype=torch.int32)]}
    out, meta, step = restore(tmp_path, like)
    assert step == 7 and meta == {"loss": 1.25}
    assert isinstance(out["n"], list)
    for key in ("f", "b"):
        assert out[key].dtype == tree[key].dtype
        assert torch.equal(out[key].view(torch.int16 if key == "b"
                                         else torch.int32),
                           tree[key].view(torch.int16 if key == "b"
                                          else torch.int32))
    assert torch.equal(out["q"]["q"], tree["q"]["q"])
    assert torch.equal(out["q"]["s"], tree["q"]["s"])
    assert torch.equal(out["n"][0], tree["n"][0])
    manifest = json.loads((tmp_path / "step_000000007" / "manifest.json")
                          .read_text())
    assert manifest["n_leaves"] == 5
    assert [e["dtype"] for e in manifest["index"]] == \
        ["bfloat16", "float32", "int32", "int8", "float32"]
    assert sorted(os.listdir(tmp_path / "step_000000007")) == \
        ["leaf_00000.npy", "leaf_00001.npy", "leaf_00002.npy",
         "leaf_00003.npy", "leaf_00004.npy", "manifest.json"]
    assert (tmp_path / "LATEST").read_text() == "7"


@pytest.mark.parametrize("eight", [False, True])
def test_checkpoint_train_state(tmp_path, tiny, eight):
    """A model and its optimizer state: the module loads in place."""
    cfg, params = tiny
    params = copy.deepcopy(params)
    state = (opt.init_8bit if eight else opt.init)(params)
    step = make_train_step(cfg, TrainConfig(opt_8bit=eight, adamw=opt.AdamWConfig(
        lr=1e-2, warmup_steps=0)))
    b = batch_at(cfg, DataConfig(batch_size=2, seq_len=16), 0, "cpu")
    step(params, state, b)
    save(tmp_path, 1, {"params": params, "opt": state})
    fresh = copy.deepcopy(params)
    with torch.no_grad():
        for p in fresh.parameters():
            p.zero_()
    ids = [id(p) for p in fresh.parameters()]
    out, _, _ = restore(tmp_path, {"params": fresh, "opt": (
        opt.init_8bit if eight else opt.init)(fresh)})
    assert out["params"] is fresh
    assert [id(p) for p in fresh.parameters()] == ids
    for a, b2 in zip(params.parameters(), fresh.parameters()):
        assert torch.equal(a, b2)
    for x, y in zip(_leaves(state), _leaves(out["opt"])):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def test_checkpoint_gc_and_latest(tmp_path):
    tree = {"x": torch.arange(4)}
    for s in (1, 2, 3, 4):
        save(tmp_path, s, tree, keep_n=2)
    dirs = sorted(p.name for p in tmp_path.glob("step_*"))
    assert dirs == ["step_000000003", "step_000000004"]
    assert latest_step(tmp_path) == 4
    _, _, step = restore(tmp_path, tree)
    assert step == 4
    _, _, step = restore(tmp_path, tree, step=3)
    assert step == 3


def test_torn_save_never_becomes_latest(tmp_path, monkeypatch):
    """A save killed while writing leaves only a .tmp_step_* directory:
    LATEST and restore still give the last committed step."""
    save(tmp_path, 2, {"a": torch.ones(3), "b": torch.ones(2)})
    real = np.save
    calls = []

    def dies(path, arr):
        calls.append(path)
        if len(calls) == 2:
            raise OSError("killed mid-save")
        real(path, arr)

    monkeypatch.setattr(np, "save", dies)
    with pytest.raises(OSError, match="killed mid-save"):
        save(tmp_path, 4, {"a": torch.zeros(3), "b": torch.zeros(2)})
    monkeypatch.setattr(np, "save", real)
    assert (tmp_path / ".tmp_step_000000004").is_dir()
    assert not (tmp_path / "step_000000004").exists()
    assert latest_step(tmp_path) == 2
    out, _, step = restore(tmp_path, {"a": torch.zeros(3),
                                      "b": torch.zeros(2)})
    assert step == 2 and torch.equal(out["a"], torch.ones(3))
    # the next save of that step clears the torn directory
    save(tmp_path, 4, {"a": torch.zeros(3), "b": torch.zeros(2)})
    assert latest_step(tmp_path) == 4
    assert not (tmp_path / ".tmp_step_000000004").exists()


def test_checkpoint_shape_mismatch_raises(tmp_path):
    save(tmp_path, 1, {"x": torch.zeros(4)})
    with pytest.raises(ValueError, match="leaf 0"):
        restore(tmp_path, {"x": torch.zeros(5)})
    with pytest.raises(ValueError, match="1 leaves, model expects 2"):
        restore(tmp_path, {"x": torch.zeros(4), "y": torch.zeros(1)})
    with pytest.raises(FileNotFoundError):
        restore(tmp_path / "empty", {"x": torch.zeros(4)})


# The fault-tolerant loop -----------------------------------------------------

def _loop(tmp_path, cfg, params, injector, total=10, every=2):
    params = copy.deepcopy(params)
    step_fn = make_train_step(cfg, TrainConfig(adamw=opt.AdamWConfig(
        lr=1e-3, warmup_steps=0)))
    dcfg = DataConfig(batch_size=2, seq_len=32)
    return train_loop(
        train_step=step_fn, params=params, opt_state=opt.init(params),
        data_stream_fn=lambda s: stream(cfg, dcfg, s, device="cpu"),
        ckpt=CheckpointManager(tmp_path, every=every, keep_n=2),
        total_steps=total, injector=injector)


def test_fault_tolerant_loop_restarts(tmp_path, tiny):
    """Killed before steps 3 and 7: the loop resumes from steps 2 and 6,
    and every loss equals the uninterrupted run's at that step."""
    cfg, params = tiny
    clean = _loop(tmp_path / "clean", cfg, params, None)
    stats = _loop(tmp_path / "faulty", cfg, params,
                  FailureInjector(at_steps=(3, 7)))
    assert clean.restarts == 0 and len(clean.losses) == 10
    assert stats.restarts == 2
    assert stats.steps == 12                 # replayed work counts
    ran = [0, 1, 2, 2, 3, 4, 5, 6, 6, 7, 8, 9]
    assert stats.losses == [clean.losses[s] for s in ran]
    assert all(np.isfinite(stats.losses))


def test_fault_loop_gives_up_after_max_restarts(tmp_path, tiny):
    cfg, params = tiny

    class AlwaysFail(FailureInjector):
        def check(self, step):
            if step == 1:
                raise SimulatedFailure("always")

    step_fn = make_train_step(cfg, TrainConfig(adamw=opt.AdamWConfig(
        lr=1e-3, warmup_steps=0)))
    params = copy.deepcopy(params)
    with pytest.raises(SimulatedFailure):
        train_loop(train_step=step_fn, params=params,
                   opt_state=opt.init(params),
                   data_stream_fn=lambda s: stream(
                       cfg, DataConfig(batch_size=2, seq_len=32), s,
                       device="cpu"),
                   ckpt=CheckpointManager(tmp_path, every=100),
                   total_steps=5, injector=AlwaysFail(), max_restarts=2)


def test_straggler_watchdog(tmp_path):
    """A step slower than 3x the running median is counted and
    reported."""
    import time

    def step_fn(params, state, batch):
        time.sleep(0.5 if batch == 8 else 0.02)
        return params, state, {"loss": torch.tensor(float(batch))}

    seen = []
    stats = train_loop(
        train_step=step_fn, params={"x": torch.zeros(1)},
        opt_state={"step": torch.zeros((), dtype=torch.int32)},
        data_stream_fn=lambda s: ((i, i) for i in range(s, 10**6)),
        ckpt=CheckpointManager(tmp_path, every=100), total_steps=10,
        on_straggler=lambda step, dt, med: seen.append(step))
    assert stats.steps == 10 and stats.losses == [float(i) for i in range(10)]
    assert stats.stragglers == 1 and seen == [8]
