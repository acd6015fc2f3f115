"""The dense-mask arm (``packed=False``) of the port against the
reference's.

End to end: the port's ``packed=False`` on CSR ``fused_gather`` and
``materialized`` equals the reference's ``packed=False`` run of the same
pipeline (visited, frontier, depths, layers, the whole stats buffer —
launches included: K3 + K1, or K7 + K1, per SIMD or bottom-up layer,
none per scalar layer — and the direction log) bitwise; on every
pipeline and format it equals the port's own ``packed=True`` run but
for the launches column.  The reference's ``megakernel`` and
``persistent`` kernels cannot run on this jax, so those are held to its
``fused_gather`` ``packed=False`` run, which its own tests pin equal.
The pieces: the single-root and batched planners in both arms, the
dense queue, and (``cuda``) the dense planning's union against the
union planner's, with K3 on both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import plan as ref_plan
from repro.api.spec import TraversalSpec as RefSpec
from repro.core import bitmap as ref_bm
from repro.core import engine as ref_engine

from _torch_parity import (BUILDERS, POLICY_IDS, POLICY_PAIRS, ROOTS,
                           cuda_device, rmat_graph, to_port,  # noqa: F401
                           words_np)
import repro_torch.bfs as tbfs
from repro_torch import formats, interop
from repro_torch.core import bitmap as t_bm
from repro_torch.core import engine as t_engine
from repro_torch.kernels import compact as t_ck
from repro_torch.kernels import gather_expand as t_ge
from repro_torch.kernels import ops
from repro_torch.obs.metrics import clear_degrade_log, degrade_log
from _torch_parity import builtin_knobs  # noqa: F401

# the reference's pinned fused_gather depth-0 results hold the port's
# built-in knobs, not the affinity table's picks
pytestmark = pytest.mark.usefixtures("builtin_knobs")

LAUNCH = t_engine._ST_LAUNCH
SIGMA = 1024


@pytest.fixture(scope="module")
def graphs():
    return {name: BUILDERS[name]() for name in ("rmat9", "star", "path")}


_REFERENCE = {}


def _reference(g, name, pipeline, policy_index, roots):
    """The reference's packed=False run (memoized per case)."""
    key = (name, pipeline, policy_index)
    if key not in _REFERENCE:
        ct = ref_plan.plan(g, RefSpec(
            policy=POLICY_PAIRS[policy_index][0], algorithm="simd",
            pipeline=pipeline, prefetch_depth=0, packed=False,
            max_layers=128))
        _REFERENCE[key] = ct, ct.run_batched(np.asarray(roots, np.int32))
    return _REFERENCE[key]


def _same_traversal(got, ref, cols=range(8)):
    cols = list(cols)
    np.testing.assert_array_equal(got.stats.cpu().numpy()[:, cols],
                                  np.asarray(ref.stats)[:, cols])
    np.testing.assert_array_equal(words_np(got.state.visited),
                                  np.asarray(ref.state.visited))
    np.testing.assert_array_equal(words_np(got.state.frontier),
                                  np.asarray(ref.state.frontier))
    np.testing.assert_array_equal(got.depths.cpu().numpy(),
                                  np.asarray(ref.depths))
    assert int(got.state.layer) == int(ref.state.layer)
    assert tbfs.direction_log(got) == ref_engine.direction_log(ref)


CASES = [("rmat9", p, i) for p in ("fused_gather", "materialized")
         for i in range(4)] + [
    (g, p, i) for g in ("star", "path")
    for p in ("fused_gather", "materialized") for i in (1, 3)]


@pytest.mark.parametrize("graph_name,pipeline,policy_index", CASES,
                         ids=[f"{g}-{p}-{POLICY_IDS[i]}"
                              for g, p, i in CASES])
def test_dense_arm_matches_reference(graphs, graph_name, pipeline,
                                     policy_index):
    g = graphs[graph_name]
    roots = ROOTS[graph_name][1]
    ct, ref = _reference(g, graph_name, pipeline, policy_index, roots)
    clear_degrade_log()
    got = tbfs.plan(to_port(g), tbfs.TraversalSpec(
        policy=POLICY_PAIRS[policy_index][1], pipeline=pipeline,
        packed=False, tile=ct.resolved.tile, max_layers=128),
        device="cpu").run_batched(roots)
    assert not degrade_log()
    _same_traversal(got, ref)
    stats = got.stats.numpy()
    active = stats[:, 4] == 1
    want = np.where(stats[:, 3] == t_engine.MODE_SCALAR, 0, 2)
    np.testing.assert_array_equal(stats[active, LAUNCH], want[active])


@pytest.mark.parametrize("pipeline", ["megakernel", "persistent"])
@pytest.mark.parametrize("policy_index", [1, 3],
                         ids=[POLICY_IDS[1], POLICY_IDS[3]])
def test_fused_levels_ignore_packed(graphs, pipeline, policy_index):
    """K5 and K6 ignore ``packed`` (the scalar layers' queue does not):
    the reference's fused_gather packed=False run, but for the launches
    column, and the packed run's launches on every layer that is not
    scalar."""
    g = graphs["rmat9"]
    roots = ROOTS["rmat9"][1]
    ct, ref = _reference(g, "rmat9", "fused_gather", policy_index, roots)
    spec = tbfs.TraversalSpec(policy=POLICY_PAIRS[policy_index][1],
                              pipeline=pipeline, packed=False,
                              tile=ct.resolved.tile, max_layers=128)
    gt = to_port(g)
    got = tbfs.plan(gt, spec, device="cpu").run_batched(roots)
    packed = tbfs.plan(gt, spec.replace(packed=True),
                       device="cpu").run_batched(roots)
    scalar = np.asarray(ref.stats)[:, 3] == t_engine.MODE_SCALAR
    np.testing.assert_array_equal(got.stats.numpy()[~scalar],
                                  packed.stats.numpy()[~scalar])
    cols = [c for c in range(8)
            if c != LAUNCH and not (pipeline == "persistent" and c == 5)]
    _same_traversal(got, ref, cols)
    if pipeline == "persistent":      # K6 plans its scalar layers' tiles
        np.testing.assert_array_equal(got.stats.numpy()[~scalar, 5],
                                      np.asarray(ref.stats)[~scalar, 5])


#: CSR's megakernel and persistent arms are `test_fused_levels_ignore_packed`'s
FORMAT_CASES = [("csr", "fused_gather"), ("csr", "materialized")] + [
    ("sell", p) for p in ("fused_gather", "materialized", "megakernel",
                          "persistent")] + [("bitmap", "fused_gather")]


@pytest.mark.parametrize("fmt_name,pipeline", FORMAT_CASES,
                         ids=[f"{f}-{p}" for f, p in FORMAT_CASES])
def test_dense_arm_equals_packed_arm(graphs, fmt_name, pipeline):
    """Every column but the launches equals the packed arm's; on SELL
    and bitmap, which ignore ``packed``, the launches too."""
    gt = to_port(graphs["rmat9"])
    fmt = {"csr": lambda: gt,
           "sell": lambda: formats.SellFormat.from_csr(gt, sigma=SIGMA),
           "bitmap": lambda: formats.build(gt, "bitmap")}[fmt_name]()
    roots = ROOTS["rmat9"][1]
    runs = []
    for packed in (True, False):
        spec = tbfs.TraversalSpec(policy=tbfs.BeamerHybrid(),
                                  pipeline=pipeline, packed=packed)
        ct = tbfs.plan(fmt, spec, device="cpu")
        assert ct.resolved.packed is packed
        runs.append(ct.run_batched(roots))
    a, b = runs
    cols = list(range(8)) if fmt_name != "csr" else \
        [c for c in range(8) if c != LAUNCH]
    assert torch.equal(a.stats[:, cols], b.stats[:, cols])
    n = gt.n_vertices
    assert torch.equal(a.state.visited, b.state.visited)
    assert torch.equal(a.state.frontier, b.state.frontier)
    assert torch.equal(a.state.parent < n, b.state.parent < n)
    assert torch.equal(a.depths, b.depths)


def test_dense_arm_corner_graphs_single_root(graphs):
    """The star (hub frontier) and the path (1-vertex layers), one root:
    the reference's ``test_packed_parity_hostpath_edge_graphs``."""
    for name in ("star", "path"):
        g = graphs[name]
        gt = to_port(g)
        root = ROOTS[name][0]
        spec = tbfs.TraversalSpec(policy=tbfs.ThresholdSimd(0),
                                  max_layers=128)
        a = tbfs.plan(gt, spec, device="cpu").run(root)
        b = tbfs.plan(gt, spec.replace(packed=False), device="cpu").run(root)
        assert torch.equal(a.state.visited, b.state.visited)
        assert torch.equal(a.stats[:, :LAUNCH], b.stats[:, :LAUNCH])


# ---------------------------------------------------------------------------
# The pieces
# ---------------------------------------------------------------------------

def _random_words(seed, n_batch, n_vertices, n_words, density):
    rng = np.random.default_rng(seed)
    dense = np.zeros((n_batch, n_words * 32), bool)
    dense[:, :n_vertices] = rng.random((n_batch, n_vertices)) < density
    return (dense.reshape(n_batch, n_words, 32).astype(np.uint64)
            << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)


@pytest.fixture(scope="module")
def rmat8():
    g = rmat_graph(8)
    return g, to_port(g)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("density", [0.0, 0.02, 0.4])
def test_planners_match_reference(rmat8, packed, density):
    """The single-root planner and the batched one, both arms."""
    g, gt = rmat8
    n, tile = g.n_vertices, 128
    n_words = g.n_vertices_padded // 32
    words = _random_words(int(density * 100), 3, n, n_words, density)
    n_blocks = -(-g.n_edges_padded // tile)
    wl_r, na_r = ref_engine.plan_active_tiles_batched(
        g.colstarts, jnp.asarray(words), n, tile, n_blocks, packed=packed)
    wl_t, na_t = t_engine.plan_active_tiles_batched(
        gt.colstarts, interop.words_to_torch(words, "cpu"), n, tile,
        n_blocks, packed=packed)
    np.testing.assert_array_equal(wl_t.numpy(), np.asarray(wl_r))
    np.testing.assert_array_equal(na_t.numpy(), np.asarray(na_r))
    wl1_r, na1_r = ref_engine.plan_active_tiles(
        g.colstarts, jnp.asarray(words[1]), n, tile, n_blocks,
        packed=packed)
    wl1_t, na1_t = t_engine.plan_active_tiles(
        gt.colstarts, interop.words_to_torch(words[1], "cpu"), n, tile,
        n_blocks, packed=packed)
    np.testing.assert_array_equal(wl1_t.numpy(), np.asarray(wl1_r))
    assert int(na1_t) == int(na1_r)


@pytest.mark.parametrize("density", [0.0, 0.05, 0.7])
@pytest.mark.parametrize("size", [None, 17])
def test_dense_queue_matches_reference(rmat8, density, size):
    """The queue equals the reference's `bitmap.compact` of each row
    (truncation and fill included); its degree prefix, total and
    truncated edges equal those of its `apportion`; queue, counts (the
    set bits, not capped), totals and truncated edges equal K2's stream
    arm, and so does the prefix on each root's entries."""
    g, gt = rmat8
    n = g.n_vertices
    n_words = g.n_vertices_padded // 32
    size = size or n_words * 32
    words = _random_words(7, 3, n, n_words, density)
    q = t_engine.dense_queue(gt.colstarts, interop.words_to_torch(
        words, "cpu"), size, n, 300)
    want = np.stack([np.asarray(ref_bm.compact(jnp.asarray(w), size, n))
                     for w in words])
    np.testing.assert_array_equal(q.queue.numpy(), want)
    cs = np.asarray(g.colstarts)
    real = want < n
    deg = np.where(real, cs[np.minimum(want, n - 1) + 1]
                   - cs[np.minimum(want, n - 1)], 0)
    np.testing.assert_array_equal(q.cum.numpy(), np.cumsum(deg, axis=1))
    np.testing.assert_array_equal(q.total.numpy(), deg.sum(axis=1))
    np.testing.assert_array_equal(
        q.count.numpy(), np.unpackbits(words.view(np.uint8), axis=1)
        .sum(axis=1))
    tw = interop.words_to_torch(words, "cpu")
    k2 = t_ck.queue_plain(tw, size, n, t_bm.degree_matrix(
        gt.colstarts[1:] - gt.colstarts[:-1], n_words * 32).reshape(-1),
        n, 300)
    for name in ("queue", "count", "total", "truncated"):
        assert torch.equal(getattr(q, name), getattr(k2, name)), name
    for b in range(words.shape[0]):
        k = min(int(k2.count[b]), size)
        assert torch.equal(q.cum[b, :k], k2.cum[b, :k])
    _, _, _, trunc = jax.vmap(lambda l: ref_engine.apportion(
        g.colstarts, g.rows, l, n, 300))(jnp.asarray(want))
    np.testing.assert_array_equal(q.truncated.numpy(), np.asarray(trunc))


def _layer_states(gt, roots, bottom_up):
    """(frontier, visited, parent) of every layer of a BeamerHybrid run,
    captured from the steps' arguments."""
    states = []
    orig = t_engine._make_fused_step

    def capturing(graph, bu, depth=0, packed=True):
        step = orig(graph, bu, depth, packed)

        def wrapped(f, v, p):
            if bu == bottom_up:
                states.append((f.clone(), v.clone(), p.clone()))
            return step(f, v, p)
        return wrapped

    t_engine._make_fused_step = capturing
    tbfs.clear_plan_cache()
    try:
        tbfs.plan(gt, tbfs.TraversalSpec(policy=tbfs.BeamerHybrid(),
                                         tile=128, max_layers=64),
                  device="cpu").run_batched(roots)
    finally:
        t_engine._make_fused_step = orig
    return states


@pytest.mark.parametrize("bottom_up", [False, True],
                         ids=["topdown", "bottomup"])
def test_dense_planning_union_equals_the_planner(graphs, bottom_up):
    """On every layer of a run, the dense planning folded into a
    `UnionPlan` equals the union planner's plan (list, count, root
    masks, per-root counts)."""
    gt = to_port(graphs["rmat9"])
    fmt = formats.CsrFormat.from_csr(gt)
    graph = fmt.fused_graph(tbfs.TraversalSpec(tile=128))
    states = _layer_states(gt, ROOTS["rmat9"][1], bottom_up)
    assert states
    for f, v, _ in states:
        active = ~v if bottom_up else f
        wl, na = t_engine._plan_dense(gt.colstarts, active, gt.n_vertices,
                                      128, graph.n_blocks)
        dense = t_ge.UnionPlan.of_lists(wl, na, graph.n_blocks)
        planned = ops.plan_union(graph, v if bottom_up else f,
                                 complement=bottom_up)
        for x, y in zip(dense, planned):
            assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("bottom_up", [False, True],
                         ids=["topdown", "bottomup"])
def test_cuda_dense_planning_union_and_k3(cuda_device, graphs, bottom_up):
    """On the card: the dense planning's union equals the union
    planner's, and K3 on either plan repairs to the same ``out``,
    ``visited`` and marked set."""
    gt = to_port(graphs["rmat9"])
    fmt = formats.CsrFormat.from_csr(gt).to(cuda_device)
    graph = fmt.fused_graph(tbfs.TraversalSpec(tile=128))
    for f, v, p in _layer_states(gt, ROOTS["rmat9"][1], bottom_up):
        f, v, p = (t.to(cuda_device) for t in (f, v, p))
        wl, na = t_engine._plan_dense(graph.colstarts, ~v if bottom_up
                                      else f, gt.n_vertices, 128,
                                      graph.n_blocks)
        dense = t_ge.UnionPlan.of_lists(wl, na, graph.n_blocks)
        planned = ops.plan_union(graph, v if bottom_up else f,
                                 complement=bottom_up)
        for x, y in zip(dense, planned):
            assert torch.equal(x, y)
        results = []
        for plan in (dense, planned):
            out, pr = ops.gather_expand_batched(
                plan, graph.rows, graph.colstarts, f, v,
                torch.zeros_like(f), p.clone(), n_vertices=gt.n_vertices,
                tile=128, bottom_up=bottom_up)
            fixed, delta = ops.restore(pr, n_vertices=gt.n_vertices)
            results.append((out | delta, v | delta, fixed != p))
        for x, y in zip(*results):
            assert torch.equal(x, y)
