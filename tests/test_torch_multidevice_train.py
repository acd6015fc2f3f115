"""The two contracts of ``tests/test_multidevice_train.py`` on the port,
held to the reference.

The parent computes the reference's one-device loss trajectory (its
``init_params`` weights, ``batch_at`` batches, jitted train step) and
hands weights and batches to 8 spawned gloo ranks on the CPU
(``tests/_torch_mesh_worker.py``, which imports no jax):

1. three steps on a (2 data x 4 model) mesh of DTensors give the
   reference's losses within rtol 2e-4 and atol 2e-5, and so does the
   run with m and v under `zero1_specs`;
2. a checkpoint saved from that mesh restores bitwise onto a (4 x 2)
   mesh and one more step trains there;
3. the 8-bit arm on the (2 x 4) mesh, q and v under `zero1_specs` and
   the scales under `optimizer.qs_specs`, gives the reference's
   one-device 8-bit losses (``TrainConfig(opt_8bit=True)``) within the
   same rtol and atol, and the state of one rank's 8-bit run within
   `GATE_8BIT`.  The losses alone cannot tell the 8-bit arm from the
   fp32 arm (their step-3 losses part by less than atol + rtol * loss),
   so the state is held too, and the fp32 mesh run's state fails it.
"""
from __future__ import annotations

import json
import math
import multiprocessing as mp
import pickle
import time

import jax
import numpy as np
import pytest

from repro.data.tokens import DataConfig as RefDataConfig, batch_at
from repro.models import lm as ref_lm
from repro.train import optimizer as ref_opt
from repro.train.train_step import (TrainConfig as RefTrainConfig,
                                    make_train_step as ref_make_train_step)

import _torch_mesh_worker as worker
from _torch_lm import reduced, tree_np

WORLD = 8
RTOL, ATOL = 2e-4, 2e-5
#: the 8-bit state gate (`optimizer.gap_8bit` of the mesh run against
#: one rank's): a reduction order other than one rank's moves a value of
#: m across a rounding boundary now and then, so a few q entries may
#: differ by one level (and the parameters and v entries they move),
#: while the scales, block maxima of m, agree to fp32 rounding.  The
#: mesh measured q 1/139648 entries, s 1.4e-6, v 1/139648, p 0; the fp32
#: arm's state q 0.13, s 5.1e-3, v 0.026, p 0.54.
GATE_8BIT = {"q_levels": 1, "q_share": 1e-3, "s_rel": 1e-5,
             "v_share": 1e-3, "p_share": 1e-3}
#: the spawned group's deadline (it takes ~30 s alone on 8 cores)
JOIN_S = 240


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The reference's losses and the 8 ranks' results."""
    tmp = tmp_path_factory.mktemp("mesh")
    rcfg, tcfg = reduced("qwen3", n_layers=2, n_heads=4, n_kv_heads=2)
    dcfg = RefDataConfig(batch_size=4, seq_len=32)
    params = ref_lm.init_params(rcfg, jax.random.PRNGKey(0))
    step = jax.jit(ref_make_train_step(rcfg, RefTrainConfig(
        adamw=ref_opt.AdamWConfig(lr=1e-3, warmup_steps=0))))
    batches = [tree_np(batch_at(rcfg, dcfg, i)) for i in range(4)]
    p, s, want = params, ref_opt.init(params), []
    for b in batches[:3]:
        p, s, m = step(p, s, b)
        want.append(float(m["loss"]))
    step8 = jax.jit(ref_make_train_step(rcfg, RefTrainConfig(
        adamw=ref_opt.AdamWConfig(lr=1e-3, warmup_steps=0), opt_8bit=True)))
    p, s, want8 = params, ref_opt.init_8bit(params), []
    for b in batches[:3]:
        p, s, m = step8(p, s, b)
        want8.append(float(m["loss"]))
    job = tmp / "job.pkl"
    with open(job, "wb") as f:
        pickle.dump({"cfg": tcfg, "params": tree_np(params),
                     "batches": batches}, f)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=worker.run_rank, args=(
        rank, WORLD, str(tmp / "store"), str(job), str(tmp / "ckpt"),
        str(tmp / "out.npz"))) for rank in range(WORLD)]
    for proc in procs:
        proc.start()
    deadline = time.monotonic() + JOIN_S
    for proc in procs:
        proc.join(max(0.0, deadline - time.monotonic()))
    hung = [proc.pid for proc in procs if proc.is_alive()]
    for proc in procs:
        if proc.is_alive():
            proc.kill()
            proc.join(5)
    assert not hung, f"ranks {hung} still running after {JOIN_S} s"
    assert [proc.exitcode for proc in procs] == [0] * WORLD
    return want, dict(np.load(tmp / "out.npz")), want8


def test_mesh_losses_match_reference(run):
    want, got, _ = run
    np.testing.assert_allclose(got["mesh_losses"], want, rtol=RTOL,
                               atol=ATOL)


def test_zero1_losses_match_reference(run):
    want, got, _ = run
    np.testing.assert_allclose(got["zero1_losses"], want, rtol=RTOL,
                               atol=ATOL)
    assert int(got["zero1_sharded"]) > 0      # some moment cut over data


def test_zero1_update_gathers_only_the_parameters(run):
    """Under ZeRO-1 the update runs on each rank's slices of the moments:
    each parameter whose moments are cut over data is gathered back
    once, and no moment is gathered (the norm's sum is all-reduced once
    per mesh dim)."""
    comm = json.loads(str(run[1]["update_comm"]))
    assert comm.get("all_gather_into_tensor") == int(run[1]["zero1_sharded"])
    assert comm.get("all_reduce") == 2
    assert not comm.get("reduce_scatter_tensor")


def test_restore_onto_another_mesh_is_bitwise(run):
    assert bool(run[1]["bitwise"])


def test_training_continues_on_the_new_mesh(run):
    (loss,) = run[1]["elastic_loss"]
    assert math.isfinite(float(loss))


def test_mesh_step_issues_collectives(run):
    """The mesh run is sharded, not a replicated single-device run: its
    step all-gathers and reduces (DTensor's CommDebugMode counts)."""
    comm = json.loads(str(run[1]["comm"]))
    kinds = {k.rpartition(".")[2] for k, v in comm.items() if v}
    assert "all_gather_into_tensor" in kinds
    assert kinds & {"all_reduce", "reduce_scatter_tensor"}


def test_8bit_mesh_losses_match_reference(run):
    """The 8-bit arm on the (2 x 4) mesh against the reference's one-device
    8-bit run; some scale is cut over a mesh dim and some group's shared
    scale spans shards (its absolute maximum all-reduced)."""
    _, got, want8 = run
    np.testing.assert_allclose(got["losses_8bit"], want8, rtol=RTOL,
                               atol=ATOL)
    assert int(got["scales_cut"]) > 0


def _within_gate(gap: dict) -> dict:
    """The measures of ``gap`` over their `GATE_8BIT` limits."""
    return {k: gap[k] for k, limit in GATE_8BIT.items() if gap[k] > limit}


def test_8bit_mesh_state_matches_one_rank(run):
    """The gathered q, s, v and parameters of the 8-bit mesh run against
    one rank's 8-bit run, within `GATE_8BIT`."""
    gap = json.loads(str(run[1]["gaps_8bit"]))["mesh"]
    assert not _within_gate(gap), gap


def test_8bit_state_gate_rejects_the_fp32_arm(run):
    """The fp32 mesh run's state, quantized as the 8-bit arm stores it,
    fails `GATE_8BIT` on every share and on the scales: a mesh run that
    silently kept fp32 moments would not pass."""
    gap = json.loads(str(run[1]["gaps_8bit"]))["fp32"]
    assert set(_within_gate(gap)) == {"q_share", "s_rel", "v_share",
                                      "p_share"}, gap
