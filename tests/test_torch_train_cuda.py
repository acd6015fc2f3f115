"""The training path on the card against the port's own CPU run.

Every reduced arch in float32, TF32 off: one train step under each
optimizer arm from the same weights and batch gives the same loss, grad
norm and parameters on ``cuda`` as on the CPU within ``TOL``; the token
stream gives the same batch on both devices; the fault-tolerant loop on
the card survives two injected failures with the losses of an
uninterrupted run.  This file imports no jax, so its ``cuda`` tests run
on a GPU machine with the port alone; here they skip.
"""
from __future__ import annotations

import copy

import pytest
import torch

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs import registry
from repro_torch.data.tokens import DataConfig, batch_at, stream
from repro_torch.models import lm
from repro_torch.runtime.fault import FailureInjector, train_loop
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import TrainConfig, make_train_step

#: float32 on the card (cuBLAS, no TF32) against the CPU's float32
TOL = 1e-3
#: the loop's losses: embedding and scatter backward on the card add
#: with atomics in no fixed order
LOOP_RTOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda")


def _step(cfg, params, batch, eight: bool):
    tc = TrainConfig(adamw=opt.AdamWConfig(lr=1e-5, warmup_steps=0),
                     opt_8bit=eight)
    state = (opt.init_8bit if eight else opt.init)(params)
    return make_train_step(cfg, tc)(params, state, batch)[2]


@pytest.mark.cuda
@pytest.mark.parametrize("eight", [False, True])
@pytest.mark.parametrize("name", sorted(registry.ARCHS))
def test_gpu_step_matches_cpu(cuda_device, name, eight):
    cfg = registry.get(name, reduced=True).with_(dtype="float32")
    cpu = lm.init_params(cfg, 0, device="cpu")
    gpu = copy.deepcopy(cpu).to(cuda_device)
    b = batch_at(cfg, DataConfig(seed=1, batch_size=2, seq_len=32), 0,
                 "cpu")
    want = _step(cfg, cpu, b, eight)
    got = _step(cfg, gpu, {k: v.to(cuda_device) for k, v in b.items()},
                eight)
    for key in ("loss", "grad_norm"):
        torch.testing.assert_close(got[key].cpu(), want[key], rtol=TOL,
                                   atol=TOL)
    for (n, a), c in zip(gpu.named_parameters(), cpu.parameters()):
        assert a.is_cuda
        torch.testing.assert_close(a.detach().cpu(), c.detach(), rtol=TOL,
                                   atol=TOL, msg=lambda m, n=n: f"{n}: {m}")


@pytest.mark.cuda
def test_batch_same_on_both_devices(cuda_device):
    cfg = registry.get("seamless", reduced=True)
    d = DataConfig(seed=4, batch_size=2, seq_len=32)
    a, b = batch_at(cfg, d, 3, cuda_device), batch_at(cfg, d, 3, "cpu")
    assert set(a) == set(b)
    for k in a:
        assert a[k].is_cuda and torch.equal(a[k].cpu(), b[k])


@pytest.mark.cuda
def test_fault_loop_on_gpu(cuda_device, tmp_path):
    cfg = registry.get("qwen3", reduced=True).with_(dtype="float32",
                                                     n_layers=2)
    init = lm.init_params(cfg, 0, device=cuda_device)
    dcfg = DataConfig(batch_size=2, seq_len=32)

    def run(path, injector):
        params = copy.deepcopy(init)
        return train_loop(
            train_step=make_train_step(cfg, TrainConfig(
                adamw=opt.AdamWConfig(lr=1e-3, warmup_steps=0))),
            params=params, opt_state=opt.init(params),
            data_stream_fn=lambda s: stream(cfg, dcfg, s, cuda_device),
            ckpt=CheckpointManager(path, every=2, keep_n=2),
            total_steps=10, injector=injector)

    clean = run(tmp_path / "clean", None)
    stats = run(tmp_path / "faulty", FailureInjector(at_steps=(3, 7)))
    assert stats.restarts == 2 and stats.steps == 12
    ran = [0, 1, 2, 2, 3, 4, 5, 6, 6, 7, 8, 9]
    torch.testing.assert_close(torch.tensor(stats.losses),
                               torch.tensor([clean.losses[s] for s in ran]),
                               rtol=LOOP_RTOL, atol=0)
