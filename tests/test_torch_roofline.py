"""The port's roofline (`repro_torch.roofline`) held against the
reference's (`repro.roofline`), case by case of ``tests/test_roofline.py``.

* `Roofline` and `model_flops_for`: the same inputs and the reference's
  constants give the same terms, bottleneck, ``useful_flops_ratio`` and
  ``mfu_bound`` (the port's own constants are the H100's, by design).
* The op analyzer against the reference's HLO analyzer on
  test_roofline's train step (phi3 reduced, float32, 2 layers, vocab
  512, b = 2, t = 64): the port's matmul flops and the reference's dot
  flops agree within `E2E_FLOPS_RTOL` (see the test).
* The synthetic cases: a loop of N matmuls counts N times one, nested
  loops compound, bytes of elementwise work and of argument trees.
* Collectives on a fake process group of 4 and 8 ranks: a redistribute
  that all-gathers, one that reduce-scatters and an all-reduce give
  the reference's ring wire bytes for their payload and group.
* Each kernel wrapper is one op to the analyzer, on the CPU as on the
  card, and `CompiledTraversal.lower` records the wrappers a search
  calls.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.models.config import param_count as ref_param_count
from repro.roofline import analysis as ref_analysis
from repro.roofline.hlo_analyze import _wire_factor as ref_wire_factor
from repro.roofline.hlo_analyze import analyze as ref_analyze

import repro_torch.bfs as tbfs
from repro_torch.kernels import ops
from repro_torch.roofline import analysis
from repro_torch.roofline.hlo_analyze import Analyzer, analyze, tensors_in

from _torch_lm import models
from _torch_parity import to_port
from _torch_parity import builtin_knobs  # noqa: F401

# the reference's pinned fused_gather depth-0 results hold the port's
# built-in knobs, not the affinity table's picks
pytestmark = pytest.mark.usefixtures("builtin_knobs")

#: the port's matmul flops against the reference's dot flops on the
#: reduced phi3 step: both count 2MNK per product, every layer and the
#: remat recompute of each block; they part on how each framework splits
#: the attention and cross-entropy chunks into products and on XLA's
#: reuse of forward products in the backward pass
E2E_FLOPS_RTOL = 0.25


# -- Roofline and model FLOPs -------------------------------------------------

@pytest.mark.parametrize("terms", [
    dict(flops=197e12, bytes_accessed=819e9 * 2, wire_bytes=50e9 * 0.5,
         n_chips=1, model_flops=100e12),
    dict(flops=3e14, bytes_accessed=1e11, wire_bytes=4e11, n_chips=256,
         model_flops=5e16),
    dict(flops=0.0, bytes_accessed=0.0, wire_bytes=0.0, n_chips=8,
         model_flops=0.0),
])
def test_roofline_matches_reference(terms):
    want = ref_analysis.Roofline(**terms)
    got = analysis.Roofline(**terms, peak_flops=ref_analysis.PEAK_FLOPS,
                            hbm_bw=ref_analysis.HBM_BW,
                            link_bw=ref_analysis.ICI_BW)
    assert got.to_dict() == want.to_dict()
    assert got.t_bound == want.t_bound


def test_roofline_h100_constants():
    r = analysis.Roofline(flops=989.4e12, bytes_accessed=3.35e12 * 2,
                          wire_bytes=450e9 * 0.5, n_chips=1,
                          model_flops=100e12)
    assert abs(r.t_compute - 1.0) < 1e-9
    assert abs(r.t_memory - 2.0) < 1e-9
    assert abs(r.t_collective - 0.5) < 1e-9
    assert r.bottleneck == "memory"
    assert abs(r.mfu_bound - 100e12 / (989.4e12 * 2.0)) < 1e-12


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_model_flops_matches_reference(kind):
    for args in ((1.8e9, 32768, 1.6e8), (14e9, 128, 0.0), (1e6, 1, 1e6)):
        assert analysis.model_flops_for(kind, *args) \
            == ref_analysis.model_flops_for(kind, *args)


@pytest.mark.parametrize("op,g", [(op, g) for op in analysis.COLLECTIVES
                                  for g in (1, 2, 16, 256)])
def test_wire_factor_matches_reference(op, g):
    assert analysis._wire_factor(op, g) == ref_wire_factor(op, g)


# -- the analyzer against the reference's -------------------------------------

def test_end_to_end_flops_vs_reference():
    """test_roofline's tiny train step: the reference's HLO dot flops and
    the port's matmul flops within `E2E_FLOPS_RTOL`; both within [1x,
    3.5x] of 6ND, as the reference's test holds its own."""
    from repro.models import lm as ref_lm
    from repro.train import optimizer as ref_opt
    from repro.train.train_step import (TrainConfig as RefTrainConfig,
                                        make_train_step as ref_make)
    from repro_torch.roofline.analysis import embedding_params
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import TrainConfig, make_train_step
    rcfg, rp, tcfg, tp = models("phi3", n_layers=2, vocab_size=512)
    b, t = 2, 64
    batch = {"tokens": jnp.ones((b, t), jnp.int32),
             "labels": jnp.ones((b, t), jnp.int32)}
    step = ref_make(rcfg, RefTrainConfig())
    hlo = jax.jit(step).lower(rp, ref_opt.init(rp), batch).compile().as_text()
    want = ref_analyze(hlo).flops
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    got = analyze(make_train_step(tcfg, TrainConfig()), tp, opt.init(tp),
                  tbatch)
    assert got.flops == pytest.approx(want, rel=E2E_FLOPS_RTOL), \
        (got.flops, want)
    expect = analysis.model_flops_for("train", ref_param_count(rcfg), b * t,
                                      embedding_params(tcfg))
    assert expect <= got.flops <= 3.5 * expect, (got.flops, expect)
    assert got.unresolved_whiles == 0 and got.ops > 0
    assert got.peak_bytes > 0


def test_dot_flops_exact():
    a, b = torch.zeros(128, 256), torch.zeros(256, 512)
    c = analyze(lambda x, y: x @ y, a, b)
    assert c.flops == 2 * 128 * 256 * 512
    assert c.bytes == (128 * 256 + 256 * 512 + 128 * 512) * 4


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_loop_multiplies_by_trip_count(device):
    a = torch.zeros(64, 64, device=device)

    def f(x):
        for _ in range(17):
            x = x @ a
        return x

    c = analyze(f, torch.ones(64, 64, device=device))
    assert c.flops == 17 * 2 * 64 * 64 * 64, c.flops
    assert c.unresolved_whiles == 0
    assert c.peak_bytes == 2 * 64 * 64 * 4    # two products alive at once


def test_nested_loops_compound():
    a = torch.zeros(32, 32)

    def f(x):
        for _ in range(5):
            for _ in range(3):
                x = x @ a
        return x

    assert analyze(f, torch.ones(32, 32)).flops == 5 * 3 * 2 * 32 ** 3


def test_batched_and_einsum_flops():
    a, b = torch.zeros(4, 8, 16), torch.zeros(4, 16, 32)
    want = 2 * 4 * 8 * 16 * 32
    assert analyze(torch.bmm, a, b).flops == want
    assert analyze(lambda x, y: torch.einsum("bmk,bkn->bmn", x, y),
                   a, b).flops == want
    assert analyze(torch.nn.functional.linear, torch.zeros(8, 16),
                   torch.zeros(32, 16), torch.zeros(32)).flops \
        == 2 * 8 * 16 * 32


def test_bytes_reasonable_for_elementwise():
    x = torch.ones(1024, 1024)                 # 4 MB
    c = analyze(lambda x: x * 2 + 1, x)
    assert 8e6 <= c.bytes < 2.5e7, c.bytes
    assert c.distinct_bytes < c.bytes


def test_argument_tree_bytes():
    """The counterpart of the reference's shape-string byte sizes: a
    tuple of (f32[10,10], bf16[4]) is 408 bytes, pred[8] 8, f32[] 4."""
    tree = (torch.zeros(10, 10), {"b": [torch.zeros(4,
                                                    dtype=torch.bfloat16)]})
    assert sum(t.numel() * t.element_size()
               for t in tensors_in(tree)) == 400 + 8
    assert analyze(torch.clone, torch.zeros(8, dtype=torch.bool)).bytes \
        == 2 * 8
    assert analyze(torch.clone, torch.zeros(())).bytes == 2 * 4


def test_views_and_detach_move_no_bytes():
    x = torch.ones(64, 64)
    c = analyze(lambda x: (x.t(), x.reshape(-1)[:10].detach()), x)
    assert c.bytes == 0 and c.ops == 0 and c.peak_bytes == 0


# -- collectives on a fake process group --------------------------------------

@pytest.fixture(params=[4, 8], ids=["world4", "world8"])
def fake_world(request):
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=request.param)
    yield request.param
    dist.destroy_process_group()
    assert not dist.is_initialized()


def test_redistributes_give_reference_wire_bytes(fake_world):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)
    g = fake_world
    mesh = init_device_mesh("cpu", (g,), mesh_dim_names=("x",))
    local = torch.zeros(64, 16)
    full = local.numel() * 4 * g

    def redistribute(placement, to):
        d = DTensor.from_local(local, mesh, [placement], run_check=False)
        return analyze(lambda: d.redistribute(mesh, [to]),
                       default_group=1)

    gather = redistribute(Shard(0), Replicate())
    assert gather.coll_ops == {"all-gather": 1}
    assert gather.coll_payload == full
    assert gather.wire_bytes == pytest.approx(
        full * ref_wire_factor("all-gather", g))
    scatter = redistribute(Partial(), Shard(0))
    assert scatter.coll_ops == {"reduce-scatter": 1}
    # a partial sum of the full shape, each rank keeping its 1/g of it
    assert scatter.coll_payload == full // g // g
    assert scatter.wire_bytes == pytest.approx(
        full // g // g * ref_wire_factor("reduce-scatter", g))
    reduce = redistribute(Partial(), Replicate())
    assert reduce.coll_ops == {"all-reduce": 1}
    assert reduce.wire_bytes == pytest.approx(
        local.numel() * 4 * ref_wire_factor("all-reduce", g))


def test_c10d_collectives_give_reference_wire_bytes(fake_world):
    """The collectives ``torch.distributed`` issues itself (the
    distributed BFS's merges), on a subgroup of half the ranks."""
    g = fake_world // 2
    group = dist.new_group(list(range(g)))
    x = torch.zeros(256, dtype=torch.int32)

    def collectives():
        dist.all_reduce(x, op=dist.ReduceOp.MIN, group=group)
        out = torch.empty(256 * g, dtype=torch.int32)
        dist.all_gather_into_tensor(out, x, group=group)

    c = analyze(collectives)
    assert c.coll_ops == {"all-reduce": 1, "all-gather": 1}
    assert c.wire_bytes == pytest.approx(
        1024 * ref_wire_factor("all-reduce", g)
        + 1024 * g * ref_wire_factor("all-gather", g))


# -- kernels: one op per wrapper ----------------------------------------------

def test_kernel_wrapper_is_one_op():
    parent = torch.full((2, 64), 3, dtype=torch.int32)
    with Analyzer() as an:
        fixed, delta = ops.restore(parent, n_vertices=60)
    assert an.cost.launches == {"restore": 1} and an.cost.ops == 1
    assert an.cost.bytes == sum(t.numel() * 4 for t in (parent, fixed,
                                                        delta))
    assert ops.ANALYZER[0] is None                 # gone with the block


def test_lower_records_the_launches(g_small):
    """`CompiledTraversal.lower`'s cost analysis: every wrapper call of
    the search; without the measure kernel's (charged to no layer), they
    sum to the stats buffer's launches column."""
    ct = tbfs.plan(g_small, tbfs.TraversalSpec(), device="cpu")
    low = ct.lower([0, 5])
    assert low.fmt is ct.fmt and low.executable is ct.executable
    assert low.roots.tolist() == [0, 5]
    ca = low.cost_analysis()
    assert set(ca) == {"bytes accessed", "flops", "launches"}
    assert ca["flops"] == 0.0 and ca["bytes accessed"] > 0
    stats = ct.stats(ct.run_batched([0, 5]))
    launches = dict(ca["launches"])
    assert launches.pop("measure") == len(stats) + 1
    assert sum(launches.values()) == sum(s.launches for s in stats)
    assert ct.lower().roots.tolist() == [0]


def test_lower_mesh_bound_raises_as_reference(g_small, tmp_path):
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("x",))
        ct = tbfs.plan(g_small, tbfs.TraversalSpec(), device="cpu",
                       mesh=mesh)
        with pytest.raises(NotImplementedError,
                           match="mesh-bound plans lower through "
                                 "launch/dryrun.py's shard_map path"):
            ct.lower()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def g_small():
    from repro.core import csr as ref_csr
    from repro.core import rmat as ref_rmat
    return to_port(ref_csr.from_edges(ref_rmat.generate(
        jax.random.PRNGKey(3), scale=9, edgefactor=8)))

