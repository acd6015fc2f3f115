"""The SELL-C-σ format end to end: every pipeline of
``plan(SellFormat, spec)`` on the CPU against the reference's SELL
``fused_gather`` path at ``prefetch_depth=0`` (which its own tests pin
equal to its SELL megakernel and persistent paths), at the reference's
resolved tile, under the four policies.

Visited, frontier, depths, layers and the direction log are bitwise
equal on every path; the stats buffer too — all 8 columns for
``fused_gather`` at any depth (the union planner, charged no launch, +
K8 + K1: 2 launches per layer), columns
0-6 for ``megakernel`` (1 launch per layer) and ``persistent`` (1 per
traversal).  Parents (racy tie-breaks) pass both validators, with depths
equal to ``bfs_serial``.  Every comparison is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import plan as ref_plan
from repro.api.spec import TraversalSpec as RefSpec
from repro.core import bfs_serial as ref_serial
from repro.core import engine as ref_engine
from repro.core.validate import validate as ref_validate
from repro.formats.sell import SellFormat as RefSell

from _torch_parity import (FORMAT_BUILDERS, FORMAT_ROOTS, POLICY_IDS,
                           POLICY_PAIRS, rmat_graph, to_port, words_np)
import repro_torch.bfs as tbfs
from repro_torch import formats
from repro_torch.core.validate import validate as t_validate
from repro_torch.kernels import ops
from repro_torch.obs.metrics import clear_degrade_log, degrade_log
from _torch_parity import builtin_knobs  # noqa: F401

# the reference's pinned fused_gather depth-0 results hold the port's
# built-in knobs, not the affinity table's picks
pytestmark = pytest.mark.usefixtures("builtin_knobs")

SIGMA = 1024       # the built-in auto σ, passed explicitly to both

#: port pipeline variants (id -> TraversalSpec fields)
VARIANTS = {
    "fused_gather": dict(),
    "prefetch2": dict(prefetch_depth=2),
    "megakernel": dict(pipeline="megakernel"),
    "megakernel_d2": dict(pipeline="megakernel", prefetch_depth=2),
    "persistent": dict(pipeline="persistent"),
}
CASES = [("rmat9", v, p) for v in VARIANTS for p in range(4)] + [
    (g, v, p) for g in ("star", "path", "disconnected", "isolated")
    for v in ("fused_gather", "megakernel", "persistent") for p in (1, 3)]

_REFERENCE = {}


@pytest.fixture(scope="module")
def graphs():
    return {name: build() for name, build in FORMAT_BUILDERS.items()}


def _reference(graphs, graph_name, policy_index, algorithm="simd"):
    """(compiled traversal, result) of the reference's SELL fused_gather
    path on the graph's batch of roots."""
    key = (graph_name, policy_index, algorithm)
    if key not in _REFERENCE:
        fmt = RefSell.from_csr(graphs[graph_name], sigma=SIGMA)
        ct = ref_plan.plan(fmt, RefSpec(
            policy=POLICY_PAIRS[policy_index][0], algorithm=algorithm,
            pipeline="fused_gather", prefetch_depth=0, packed=True,
            max_layers=128))
        _REFERENCE[key] = ct, ct.run_batched(
            np.asarray(FORMAT_ROOTS[graph_name][1], np.int32))
    return _REFERENCE[key]


def _port_sell(graphs, graph_name):
    return formats.SellFormat.from_csr(to_port(graphs[graph_name]),
                                       sigma=SIGMA)


def _check_trees(g, got, roots):
    parents = tbfs.parents_graph500(got.state, g.n_vertices).numpy()
    rows, cs = np.asarray(g.rows), np.asarray(g.colstarts)
    gt = to_port(g)
    for b, root in enumerate(roots):
        _, depth = ref_serial.bfs_serial(rows, cs, g.n_vertices, root)
        assert t_validate(gt, torch.from_numpy(parents[b]), root,
                          reference_depth=depth).ok
        assert ref_validate(g, jnp.asarray(parents[b]), root,
                            reference_depth=depth).ok


def _check_state(got, ref):
    np.testing.assert_array_equal(words_np(got.state.visited),
                                  np.asarray(ref.state.visited))
    np.testing.assert_array_equal(words_np(got.state.frontier),
                                  np.asarray(ref.state.frontier))
    np.testing.assert_array_equal(got.depths.numpy(), np.asarray(ref.depths))
    assert int(got.state.layer) == int(ref.state.layer)
    assert tbfs.direction_log(got) == ref_engine.direction_log(ref)


@pytest.mark.parametrize("graph_name,variant,policy_index", CASES,
                         ids=[f"{g}-{v}-{POLICY_IDS[p]}"
                              for g, v, p in CASES])
def test_sell_path_matches_reference(graphs, graph_name, variant,
                                     policy_index):
    g = graphs[graph_name]
    roots = FORMAT_ROOTS[graph_name][1]
    ct, ref = _reference(graphs, graph_name, policy_index)
    spec = tbfs.TraversalSpec(policy=POLICY_PAIRS[policy_index][1],
                              tile=ct.resolved.tile, max_layers=128,
                              **VARIANTS[variant])
    clear_degrade_log()
    got = tbfs.plan(_port_sell(graphs, graph_name), spec,
                    device="cpu").run_batched(roots)
    assert not degrade_log()
    st_t, st_r = got.stats.numpy(), np.asarray(ref.stats)
    _check_state(got, ref)
    if variant in ("fused_gather", "prefetch2"):
        np.testing.assert_array_equal(st_t, st_r)
    else:
        np.testing.assert_array_equal(st_t[:, :7], st_r[:, :7])
        n_layers = int(ref.state.layer)
        want = ([1] + [0] * (n_layers - 1) if variant == "persistent"
                else [1] * n_layers)
        assert st_t[:n_layers, 7].tolist() == want
    _check_trees(g, got, roots)


@pytest.mark.parametrize("policy_index", [0, 1], ids=POLICY_IDS[:2])
def test_sell_nonsimd_matches_reference(graphs, policy_index):
    """algorithm="nonsimd": scalar layers run the plain dense sweep
    (Algorithm 2, exact updates); every stats column equals the
    reference's."""
    ct, ref = _reference(graphs, "rmat9", policy_index, "nonsimd")
    spec = tbfs.TraversalSpec(policy=POLICY_PAIRS[policy_index][1],
                              algorithm="nonsimd", tile=ct.resolved.tile,
                              max_layers=128)
    roots = FORMAT_ROOTS["rmat9"][1]
    got = tbfs.plan(_port_sell(graphs, "rmat9"), spec,
                    device="cpu").run_batched(roots)
    np.testing.assert_array_equal(got.stats.numpy(), np.asarray(ref.stats))
    _check_state(got, ref)
    _check_trees(graphs["rmat9"], got, roots)


@pytest.mark.parametrize("pipeline", ["fused_gather", "megakernel",
                                      "persistent"])
def test_sell_single_root_run_is_unbatched(graphs, pipeline):
    fmt = _port_sell(graphs, "rmat9")
    one = tbfs.plan(fmt, tbfs.TraversalSpec(policy="beamer",
                                            pipeline=pipeline),
                    device="cpu").run(17)
    assert one.state.parent.ndim == 1 and one.depths.ndim == 0
    csr = tbfs.plan(to_port(graphs["rmat9"]),
                    tbfs.TraversalSpec(policy="beamer"), device="cpu").run(17)
    assert torch.equal(one.state.visited, csr.state.visited)
    assert int(one.depths) == int(csr.depths)


@pytest.mark.parametrize("pipeline", ["fused_gather", "megakernel",
                                      "persistent"])
def test_auto_format_runs_every_pipeline(pipeline):
    """formats.build(csr, "auto") gives SELL on R-MAT SCALE 10; its
    traversal equals the CSR one on visited, depths and stats columns
    0-4 and 6, and launches the SELL kernels' wrappers."""
    gt = to_port(rmat_graph(10))
    fmt = formats.build(gt, "auto")
    assert isinstance(fmt, formats.SellFormat)
    roots = [1, 5, 9, 300]
    spec = tbfs.TraversalSpec(pipeline=pipeline)
    ct = tbfs.plan(fmt, spec, device="cpu")
    assert ct.resolved.tile == 2 and isinstance(ct.resolved.policy,
                                                tbfs.BeamerHybrid)
    got = ct.run_batched(roots)
    base = tbfs.plan(gt, tbfs.TraversalSpec(), device="cpu") \
        .run_batched(roots)
    assert torch.equal(got.state.visited, base.state.visited)
    assert torch.equal(got.depths, base.depths)
    assert torch.equal(got.stats[:, :5], base.stats[:, :5])
    assert torch.equal(got.stats[:, 6], base.stats[:, 6])
    assert tbfs.direction_log(got) == tbfs.direction_log(base)


def test_sell_plan_cache_keys_on_the_format_arrays(graphs):
    tbfs.clear_plan_cache()
    fmt = _port_sell(graphs, "rmat9")
    spec = tbfs.TraversalSpec(policy="beamer")
    a = tbfs.plan(fmt, spec, device="cpu")
    assert tbfs.plan(fmt, spec, device="cpu").executable is a.executable
    other = _port_sell(graphs, "rmat9")            # equal geometry
    assert tbfs.plan(other, spec, device="cpu").executable \
        is a.executable                            # keyed by geometry
    csr = tbfs.plan(to_port(graphs["rmat9"]), spec, device="cpu")
    assert csr.executable is not a.executable
    assert tbfs.plan_cache_info()["size"] == 2
    tbfs.clear_plan_cache()


def test_sell_steps_launch_what_the_reference_charges(graphs):
    """The launches column charges wrapper calls on either device: K8 +
    K1 per fused_gather layer, K9 per megakernel layer, K10 once per
    persistent traversal; KERNEL_LAUNCHES counts CUDA launches only, so
    CPU runs leave it at zero."""
    fmt = _port_sell(graphs, "rmat9")
    roots = FORMAT_ROOTS["rmat9"][1]
    ops.reset_kernel_launches()
    for pipeline, per_layer in (("fused_gather", 2), ("megakernel", 1),
                                ("persistent", 0)):
        res = tbfs.plan(fmt, tbfs.TraversalSpec(policy="beamer",
                                                pipeline=pipeline),
                        device="cpu").run_batched(roots)
        n = int(res.state.layer)
        want = [1] + [0] * (n - 1) if per_layer == 0 else [per_layer] * n
        assert res.stats[:n, 7].tolist() == want
    assert not any(ops.KERNEL_LAUNCHES.values())


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("policy_index", range(4), ids=POLICY_IDS)
def test_sell_fused_gather_plans_with_the_union_planner(graphs, monkeypatch,
                                                        policy_index, depth):
    """SELL fused_gather plans every layer with `ops.plan_union` (the planner's SELL arm, charged no launch) and
    calls `plan_slabs_plain` only inside it (its CPU arm); K8 takes the
    plan; the stats stay bitwise the reference's in all 8 columns (2
    launches per layer)."""
    from repro_torch.kernels import sell_expand as se
    ct, ref = _reference(graphs, "rmat9", policy_index)
    calls = dict(plan_union=0, plain_outside=0, planned_sweeps=0)
    inside = [0]
    plan_union, plain, sweep = ops.plan_union, se.plan_slabs_plain, \
        ops.sell_batched

    def spy_plan(*a, **kw):
        calls["plan_union"] += 1
        inside[0] += 1
        try:
            return plan_union(*a, **kw)
        finally:
            inside[0] -= 1

    def spy_plain(*a, **kw):
        calls["plain_outside"] += inside[0] == 0
        return plain(*a, **kw)

    def spy_sweep(*a, plan=None, **kw):
        calls["planned_sweeps"] += plan is not None
        return sweep(*a, plan=plan, **kw)

    monkeypatch.setattr(ops, "plan_union", spy_plan)
    monkeypatch.setattr(se, "plan_slabs_plain", spy_plain)
    monkeypatch.setattr(ops, "sell_batched", spy_sweep)
    spec = tbfs.TraversalSpec(policy=POLICY_PAIRS[policy_index][1],
                              tile=ct.resolved.tile, max_layers=128,
                              prefetch_depth=depth)
    got = tbfs.plan(_port_sell(graphs, "rmat9"), spec, device="cpu") \
        .run_batched(FORMAT_ROOTS["rmat9"][1])
    n_layers = int(ref.state.layer)     # simd: every layer runs K8
    assert calls == dict(plan_union=n_layers, plain_outside=0,
                         planned_sweeps=n_layers)
    np.testing.assert_array_equal(got.stats.numpy(), np.asarray(ref.stats))
    assert got.stats[:n_layers, 7].tolist() == [2] * n_layers
    _check_state(got, ref)


def test_sell_engine_uses_the_persistent_run_of_the_format(graphs,
                                                           monkeypatch):
    fmt = _port_sell(graphs, "rmat9")
    calls = []
    orig = fmt.persistent_run

    def run(*args):
        calls.append(args[-1].pipeline)
        return orig(*args)

    monkeypatch.setattr(fmt, "persistent_run", run)
    tbfs.plan(fmt, tbfs.TraversalSpec(pipeline="persistent"),
              device="cpu").run_batched([3])
    assert calls == ["persistent"]
