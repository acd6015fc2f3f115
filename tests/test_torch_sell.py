"""The SELL-C-σ kernels of the port — K8 (slab sweep), K9 (one SELL layer
per launch), K10 (one SELL traversal per launch) — and K13 (popcount)
against the reference.

K8's plain version, on the `UnionPlan` of the reference planner's
work-lists, is held against the reference's Pallas
``sell_expand_batched`` (interpret mode, depth 0) over those lists; the
plan that lists every group is the full sweep's; its races are held to
what restoration makes exact: ``out|delta``, ``visited|delta`` and the
marked set, with every marked parent a frontier neighbour.  The slab
plan's work-list and ``n_active`` are bitwise equal to the reference's
``_plan_slab_steps`` and ``_plan_slabs_in_kernel``.  The reference's
fused SELL kernels cannot run on this jax (they reach
``pltpu.TPUMemorySpace``), so K9 is held against the reference's K8 +
restoration on the same layer.  The ``cuda`` twins compare each CUDA
kernel with its plain version and skip without a card.  Every
comparison is exact.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.csr import padding_premarked_visited as ref_premarked
from repro.formats.sell import SellFormat as RefSell
from repro.kernels import bitmap_kernels as ref_bk
from repro.kernels import ops as ref_ops
from repro.kernels import sell_expand as ref_se
from repro.kernels import traversal_fused as ref_tf

from _torch_parity import (POLICY_IDS, POLICY_PAIRS, ROOTS,  # noqa: F401
                           cuda_device, rmat_graph, to_port, words_np)
from test_torch_kernels import _check_repaired
import repro_torch.bfs as tbfs
from repro_torch import formats, interop
from repro_torch.kernels import bitmap_kernels as t_bk
from repro_torch.kernels import gather_expand as ge
from repro_torch.kernels import ops
from repro_torch.kernels import plan as t_plan
from repro_torch.kernels import restoration as t_rest
from repro_torch.kernels import sell_expand as t_se
from repro_torch.kernels import traversal_fused as t_tf
from repro_torch.obs.metrics import clear_degrade_log, degrade_log
from _torch_parity import builtin_knobs  # noqa: F401

# the reference's pinned fused_gather depth-0 results hold the port's
# built-in knobs, not the affinity table's picks
pytestmark = pytest.mark.usefixtures("builtin_knobs")


@pytest.fixture(scope="module")
def rmat():
    return rmat_graph(9)


def _pack(dense):
    n_batch = dense.shape[0]
    return (dense.reshape(n_batch, -1, 32).astype(np.uint64)
            << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)


def _sell_case(seed, bottom_up, spp=2, n_batch=3, sigma=128,
               f_density=0.05, v_density=0.3):
    """A mid-traversal state on a SCALE-9 R-MAT graph, both layouts of it
    and the reference's work-lists for it."""
    g = rmat_graph(9)
    n = g.n_vertices
    ref_fmt = RefSell.from_csr(g, sigma=sigma)
    fmt = formats.SellFormat.from_csr(to_port(g), sigma=sigma)
    rng = np.random.default_rng(seed)
    base = np.asarray(ref_premarked(n))
    dense_f = rng.random((n_batch, n)) < f_density
    dense_v = dense_f | (rng.random((n_batch, n)) < v_density)
    pad = np.zeros((n_batch, base.shape[0] * 32 - n), bool)
    frontier = _pack(np.concatenate([dense_f, pad], 1))
    visited = _pack(np.concatenate([dense_v, pad], 1)) | base
    n_steps = -(-ref_fmt.n_slabs // spp)
    active = ~visited if bottom_up else frontier
    wl, na = jax.vmap(lambda a: ref_fmt._plan_slab_steps(a, spp, n_steps))(
        jnp.asarray(active))
    p0 = np.full((n_batch, base.shape[0] * 32), n, np.int32)
    return dict(g=g, n=n, spp=spp, ref_fmt=ref_fmt, fmt=fmt,
                graph=fmt.sell_graph(spp), cs=np.asarray(g.colstarts),
                frontier=frontier, visited=visited, wl=np.array(wl),
                na=np.array(na), p0=p0, n_steps=n_steps)


def _ref_sweep(c, bottom_up):
    out0 = np.zeros_like(c["frontier"])
    out, p = ref_ops.sell_batched(
        c["ref_fmt"].cols, c["ref_fmt"].slab_rows,
        jnp.asarray(c["frontier"]), jnp.asarray(c["visited"]),
        jnp.asarray(out0), jnp.asarray(c["p0"]), n_vertices=c["n"],
        slabs_per_step=c["spp"], worklist=jnp.asarray(c["wl"]),
        n_active=jnp.asarray(c["na"]), bottom_up=bottom_up,
        interpret=True)
    return np.asarray(out), np.asarray(p)


def _port_state(c, device="cpu"):
    w = lambda a: interop.words_to_torch(a, device)
    return (w(c["frontier"]), w(c["visited"]),
            torch.from_numpy(c["p0"].copy()).to(device))


# ---------------------------------------------------------------------------
# The slab plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bottom_up", [False, True],
                         ids=["topdown", "bottomup"])
@pytest.mark.parametrize("density", [0.0, 0.01, 0.2, 0.9])
@pytest.mark.parametrize("spp", [1, 3])
def test_plan_matches_reference(bottom_up, density, spp):
    """Work-list and n_active equal the reference's host planner
    (`_plan_slab_steps`) and its in-kernel one (`_plan_slabs_in_kernel`),
    the clamped tail included."""
    c = _sell_case(int(density * 100) + spp, bottom_up, spp=spp,
                   f_density=density, v_density=density)
    frontier, visited, _ = _port_state(c)
    wl, na = c["fmt"]._plan_slab_steps(~visited if bottom_up else frontier,
                                       spp)
    np.testing.assert_array_equal(wl.numpy(), c["wl"])
    np.testing.assert_array_equal(na.numpy(), c["na"])
    _, padded_rows = ref_ops._pad_slabs(c["ref_fmt"].cols,
                                        c["ref_fmt"].slab_rows, c["n"], spp)
    for b in range(3):
        words = ~c["visited"][b] if bottom_up else c["frontier"][b]
        wl_k, na_k = ref_se._plan_slabs_in_kernel(
            c["n"], spp, c["n_steps"], jnp.asarray(words), padded_rows)
        assert int(na_k) == int(na[b])
        np.testing.assert_array_equal(np.asarray(wl_k), wl[b].numpy())


def test_plan_of_an_empty_frontier_costs_nothing():
    c = _sell_case(0, False, f_density=0.0)
    frontier, visited, p = _port_state(c)
    wl, na = t_se.plan_slabs_plain(c["graph"], frontier)
    assert na.tolist() == [0, 0, 0] and int(wl.abs().sum()) == 0
    plan = ops.plan_union(c["graph"], frontier)
    assert int(plan.ucount) == 0 and plan.na.tolist() == [0, 0, 0]
    out = torch.zeros_like(frontier)
    ops.sell_batched(c["graph"], frontier, visited, out, p, plan=plan)
    assert int(out.abs().sum()) == 0 and bool((p == c["n"]).all())


# ---------------------------------------------------------------------------
# K8: the slab sweep
# ---------------------------------------------------------------------------

def _plan(c, batch=None):
    """The port's `UnionPlan` of the reference planner's lists (rows
    ``batch`` of them, all by default)."""
    wl, na = c["wl"], c["na"]
    if batch is not None:
        wl, na = wl[batch], na[batch]
    return ge.UnionPlan.of_lists(torch.from_numpy(np.ascontiguousarray(wl)),
                                 torch.from_numpy(np.ascontiguousarray(na)),
                                 c["n_steps"])


@pytest.mark.parametrize("spp", [1, 2])
@pytest.mark.parametrize("bottom_up", [False, True],
                         ids=["topdown", "bottomup"])
@pytest.mark.parametrize("seed", [0, 1])
def test_sell_expand_plain_matches_reference(seed, bottom_up, spp):
    """After restoration: out, visited and the marked set equal the
    reference's Pallas sweep over its work-lists, which the port takes
    as a `UnionPlan`; every marked parent is a frontier neighbour (in
    the symmetric adjacency)."""
    c = _sell_case(seed, bottom_up, spp=spp)
    frontier, visited, p = _port_state(c)
    out = torch.zeros_like(frontier)
    got = ops.sell_batched(c["graph"], frontier, visited, out, p,
                           plan=_plan(c), bottom_up=bottom_up)
    assert got[0] is out and got[1] is p
    _check_repaired(c, _ref_sweep(c, bottom_up),
                    (words_np(out), p.numpy()))


def test_sell_full_sweep_without_a_worklist():
    """No plan: every root sweeps every group (the reference's identity
    work-list)."""
    c = _sell_case(3, False)
    n_batch = c["frontier"].shape[0]
    c["wl"] = np.tile(np.arange(c["n_steps"], dtype=np.int32), (n_batch, 1))
    c["na"] = np.full((n_batch,), c["n_steps"], np.int32)
    frontier, visited, p = _port_state(c)
    out = torch.zeros_like(frontier)
    ops.sell_batched(c["graph"], frontier, visited, out, p)
    _check_repaired(c, _ref_sweep(c, False), (words_np(out), p.numpy()))


@pytest.mark.parametrize("n_batch", [1, 3, 32, 33])
def test_sell_dense_plan_is_the_full_sweep(n_batch):
    """The dense plan equals the plan of the identity work-lists (every
    group for every root), the last mask word's unused bits clear; made
    once per (steps, batch, device); K8 on it and on the old full
    sweep's lists gives the same out and P."""
    c = _sell_case(5, True)
    n_steps = c["n_steps"]
    plan = t_se.dense_plan(n_steps, n_batch, torch.device("cpu"))
    assert plan is t_se.dense_plan(n_steps, n_batch, torch.device("cpu"))
    wl = torch.arange(n_steps, dtype=torch.int32).expand(n_batch, -1)
    na = torch.full((n_batch,), n_steps, dtype=torch.int32)
    want = ge.UnionPlan.of_lists(wl.contiguous(), na, n_steps)
    for name, a, b in zip(ge.UnionPlan._fields, plan, want):
        assert a.dtype == torch.int32 and torch.equal(a, b), name
    frontier, visited, p = _port_state(c)
    rows = torch.arange(n_batch) % frontier.shape[0]
    frontier, visited = frontier[rows].contiguous(), visited[rows]
    outs = []
    for pl_ in (plan, want):
        out, p_b = torch.zeros_like(frontier), p[rows].clone()
        t_se.sell_expand_plain(c["graph"], pl_, frontier, visited, out, p_b,
                               bottom_up=True)
        outs.append((out, p_b))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_sell_single_root_is_batched_at_b1():
    c = _sell_case(2, False, n_batch=1)
    frontier, visited, p = _port_state(c)
    out1, p1 = torch.zeros_like(frontier[0]), p[0].clone()
    ops.sell(c["graph"], frontier[0], visited[0], out1, p1, plan=_plan(c))
    out_b = torch.zeros_like(frontier)
    ops.sell_batched(c["graph"], frontier, visited, out_b, p, plan=_plan(c))
    assert torch.equal(out1, out_b[0]) and torch.equal(p1, p[0])


def test_sell_graph_pads_slabs_like_the_reference():
    c = _sell_case(0, False, spp=3)
    cols_r, rows_r = ref_ops._pad_slabs(c["ref_fmt"].cols,
                                        c["ref_fmt"].slab_rows, c["n"], 3)
    g = c["graph"]
    np.testing.assert_array_equal(g.cols.numpy(), np.asarray(cols_r))
    np.testing.assert_array_equal(g.slab_rows.numpy(), np.asarray(rows_r))
    assert g.n_steps == c["n_steps"] and g.n_words * 32 == g.deg.shape[0]


# ---------------------------------------------------------------------------
# K9: one SELL layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bottom_up", [False, True],
                         ids=["topdown", "bottomup"])
@pytest.mark.parametrize("seed", [0, 1])
def test_sell_layer_fused_plain_matches_reference_layer(seed, bottom_up):
    """n_active is the reference planner's; after its restoration, out,
    visited and the marked set equal the reference's sweep +
    restoration on the same state."""
    c = _sell_case(seed + 10, bottom_up)
    frontier, visited, p = _port_state(c)
    out, p_got, na = ops.sell_layer_fused_batched(
        c["graph"], frontier, visited, p, bottom_up=bottom_up)
    assert p_got is p and int(p.min()) >= 0
    np.testing.assert_array_equal(na.numpy(), c["na"])
    out_r, p_r = _ref_sweep(c, bottom_up)
    np.testing.assert_array_equal(p.numpy() != c["p0"], p_r < 0)
    _, d_r = t_rest.restoration_plain(torch.from_numpy(p_r.copy()), c["n"])
    np.testing.assert_array_equal(words_np(out), out_r | words_np(d_r))


def test_sell_layer_fused_single_root_is_batched_at_b1():
    c = _sell_case(4, True, n_batch=1)
    frontier, visited, p = _port_state(c)
    one = ops.sell_layer_fused(c["graph"], frontier[0], visited[0],
                               p[0].clone(), bottom_up=True)
    many = ops.sell_layer_fused_batched(c["graph"], frontier, visited, p,
                                        bottom_up=True)
    assert torch.equal(one[0], many[0][0]) and torch.equal(one[1],
                                                           many[1][0])
    assert one[2].tolist() == many[2].tolist() == c["na"].tolist()


# ---------------------------------------------------------------------------
# K10's counters, budgets and degrades
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("density", [0.0, 0.05, 0.6])
def test_sell_counters_come_from_deg(density):
    """The whole-traversal counters from SELL's own degree array equal
    the reference's in-kernel `_layer_counters` on it."""
    c = _sell_case(7, False, f_density=density)
    frontier, _, _ = _port_state(c)
    c_r, e_r = ref_tf._layer_counters(c["n"], jnp.asarray(c["frontier"]),
                                      c["ref_fmt"].deg)
    c_t, e_t = t_tf.layer_counters(frontier, c["graph"].deg)
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_r))
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_r))


def test_sell_traversal_plain_matches_the_host_loop(rmat):
    """K10's plain version (its layer loop on the host) equals the
    engine's megakernel steps on the same batch."""
    fmt = formats.SellFormat.from_csr(to_port(rmat), sigma=128)
    roots = ROOTS["rmat9"][1]
    spec = tbfs.TraversalSpec(policy="beamer", pipeline="megakernel")
    host = tbfs.plan(fmt, spec, device="cpu").run_batched(roots)
    ct = tbfs.plan(fmt, spec.replace(pipeline="persistent"), device="cpu")
    one = ct.run_batched(roots)
    for name in ("frontier", "visited"):
        assert torch.equal(getattr(one.state, name),
                           getattr(host.state, name))
    assert torch.equal(one.depths, host.depths)
    assert torch.equal(one.stats[:, :7], host.stats[:, :7])


def test_sell_budgets_clamp_depth_to_the_step_count():
    assert ops.sell_megakernel_budget(2, 50, 3) \
        == ops.sell_megakernel_budget(2, 3, 3)
    assert t_se.stage_bytes(2, 3) == 4 * 2 * 1152 * 4
    assert t_se.stage_bytes(2, 0) == 0
    assert ops.sell_stage_fits(2, 4, 100) \
        and not ops.sell_stage_fits(8, 8, 100)
    assert ops.sell_persistent_fits(2, 4, 100) \
        == ops.sell_megakernel_fits(2, 4, 100)


def test_sell_prefetch_ring_past_shared_memory_is_refused(rmat):
    fmt = formats.SellFormat.from_csr(to_port(rmat), sigma=128)
    for pipeline in ("fused_gather", "persistent"):
        with pytest.raises(ValueError, match="slab ring"):
            tbfs.plan(fmt, tbfs.TraversalSpec(pipeline=pipeline, tile=16,
                                              prefetch_depth=8),
                      device="cpu")


def test_sell_budget_miss_degrades_observably(rmat, monkeypatch, caplog):
    """A shared-memory limit between K8's ring and K9's budget: the SELL
    megakernel degrades to fused_gather, the persistent kernel to the
    megakernel and on to fused_gather, each recorded and warned, with
    the answer unchanged."""
    fmt = formats.SellFormat.from_csr(to_port(rmat), sigma=128)
    roots = [3, 7]
    spec = dict(policy="beamer", tile=2, prefetch_depth=2)
    base = tbfs.plan(fmt, tbfs.TraversalSpec(**spec),
                     device="cpu").run_batched(roots)
    monkeypatch.setattr(ops, "SMEM_OPTIN_BYTES", t_se.stage_bytes(2, 2) + 1)
    assert ops.sell_stage_fits(2, 2, 100)
    assert not ops.sell_megakernel_fits(2, 2, 100)
    for pipeline, n_events in (("megakernel", 1), ("persistent", 2)):
        clear_degrade_log()
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="repro_torch.serve"):
            got = tbfs.plan(fmt, tbfs.TraversalSpec(pipeline=pipeline,
                                                    **spec),
                            device="cpu").run_batched(roots)
        assert any("degrade[smem_fallback]" in r.getMessage()
                   for r in caplog.records)
        assert len(degrade_log()) == n_events
        assert "fused_gather" in degrade_log()[-1].fallback
        assert torch.equal(got.state.visited, base.state.visited)
        assert torch.equal(got.stats, base.stats)
    clear_degrade_log()


@pytest.mark.parametrize("tile,want", [(None, 2), (1, 1), (5, 5), (0, 1)])
def test_sell_tile_rule(rmat, tile, want):
    fmt = formats.SellFormat.from_csr(to_port(rmat), sigma=128)
    assert fmt.resolve_tile(tile) == want


# ---------------------------------------------------------------------------
# K13: popcount
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_words", [1, 7, 4096, 10_000])
def test_popcount_matches_reference(n_words):
    rng = np.random.default_rng(n_words)
    words = rng.integers(0, 2**32, (n_words,), dtype=np.uint64) \
        .astype(np.uint32)
    ref = ref_bk.popcount(jnp.asarray(words), interpret=True)
    got = ops.popcount(interop.words_to_torch(words, "cpu"))
    assert got.dtype == torch.int32 and got.shape == ()
    assert int(got) == int(ref)


def test_popcount_is_the_engines_termination_test(rmat):
    """The host loop reads its loop condition from K13, now the measure
    kernel (one call per layer, and the one that finds every frontier
    empty); the launches column does not count it (the reference's
    engine counts with jnp)."""
    calls = []
    orig = ops.measure

    def counting(words, *args, **kw):
        calls.append(words.shape)
        return orig(words, *args, **kw)

    ops.measure = counting
    try:
        res = tbfs.plan(to_port(rmat), tbfs.TraversalSpec(policy="beamer"),
                        device="cpu").run_batched([3, 7])
    finally:
        ops.measure = orig
    n_layers = int(res.state.layer)
    assert len(calls) == n_layers + 1 and calls[0] == (2, res.state
                                                       .frontier.shape[1])
    assert res.stats[:n_layers, 7].tolist() == [3] * n_layers


# ---------------------------------------------------------------------------
# CUDA kernels vs plain versions (need the card)
# ---------------------------------------------------------------------------

def _on(graph, device):
    return t_se.SellGraph(graph.cols.to(device), graph.slab_rows.to(device),
                          graph.deg.to(device), graph.n_vertices, graph.spp)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [0, 1, 2, 4])
@pytest.mark.parametrize("bottom_up", [False, True],
                         ids=["topdown", "bottomup"])
def test_cuda_sell_expand_matches_plain(cuda_device, bottom_up, depth):
    c = _sell_case(6, bottom_up)
    frontier, visited, p = _port_state(c, cuda_device)
    out = torch.zeros_like(frontier)
    t_se.sell_expand_cuda(_on(c["graph"], cuda_device),
                          ge.UnionPlan(*(t.to(cuda_device) for t in _plan(c))),
                          frontier, visited, out, p, bottom_up=bottom_up,
                          prefetch_depth=depth)
    _check_repaired(c, _ref_sweep(c, bottom_up),
                    (words_np(out), p.cpu().numpy()))


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("bottom_up", [False, True],
                         ids=["topdown", "bottomup"])
def test_cuda_sell_expand_at_33_roots_matches_plain(cuda_device, bottom_up,
                                                    depth):
    """K8 at two root-mask words, on the union planner's plan: after
    restoration out, visited and the marked set equal its plain
    version's."""
    c = _sell_case(8, bottom_up, n_batch=33)
    f_c, v_c, p_c = _port_state(c)
    plan = t_plan.plan_union_plain(c["graph"], v_c if bottom_up else f_c,
                                   complement=bottom_up)
    out_p = torch.zeros_like(f_c)
    t_se.sell_expand_plain(c["graph"], plan, f_c, v_c, out_p, p_c,
                           bottom_up=bottom_up)
    frontier, visited, p = _port_state(c, cuda_device)
    out = torch.zeros_like(frontier)
    t_se.sell_expand_cuda(_on(c["graph"], cuda_device),
                          ge.UnionPlan(*(t.to(cuda_device) for t in plan)),
                          frontier, visited, out, p, bottom_up=bottom_up,
                          prefetch_depth=depth)
    p, out = p.cpu(), out.cpu()
    _, d_k = t_rest.restoration_plain(p, c["n"])
    _, d_p = t_rest.restoration_plain(p_c, c["n"])
    assert torch.equal(p < 0, p_c < 0)
    assert torch.equal(out | d_k, out_p | d_p)
    assert torch.equal(v_c | d_k, v_c | d_p)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("bottom_up", [False, True],
                         ids=["topdown", "bottomup"])
def test_cuda_sell_layer_fused_matches_plain(cuda_device, bottom_up, depth):
    c = _sell_case(7, bottom_up)
    frontier, visited, p = _port_state(c, cuda_device)
    out_k, p_k, na_k = t_se.sell_layer_fused_cuda(
        _on(c["graph"], cuda_device), frontier, visited, p,
        bottom_up=bottom_up, prefetch_depth=depth)
    f_c, v_c, p_c = _port_state(c)
    out_p, p_p, na_p = t_se.sell_layer_fused_plain(c["graph"], f_c, v_c,
                                                   p_c, bottom_up=bottom_up)
    assert torch.equal(na_k.cpu(), na_p)
    assert torch.equal(out_k.cpu(), out_p)
    p0 = torch.from_numpy(c["p0"])
    assert torch.equal(p_k.cpu() != p0, p_p != p0)


@pytest.mark.cuda
@pytest.mark.parametrize("policy_index", range(4), ids=POLICY_IDS)
def test_cuda_sell_traversal_fused_matches_plain(cuda_device, rmat,
                                                 policy_index):
    fmt = formats.SellFormat.from_csr(to_port(rmat), sigma=128)
    roots = ROOTS["rmat9"][1]
    spec = tbfs.TraversalSpec(policy=POLICY_PAIRS[policy_index][1],
                              pipeline="persistent")
    cpu = tbfs.plan(fmt, spec, device="cpu").run_batched(roots)
    ops.reset_kernel_launches()
    gpu = tbfs.plan(fmt, spec, device=cuda_device).run_batched(roots)
    assert ops.KERNEL_LAUNCHES["sell_traversal_fused_batched"] == 1
    for name in ("frontier", "visited"):
        assert torch.equal(getattr(gpu.state, name).cpu(),
                           getattr(cpu.state, name))
    assert torch.equal(gpu.depths.cpu(), cpu.depths)
    assert torch.equal(gpu.stats.cpu(), cpu.stats)


@pytest.mark.cuda
@pytest.mark.parametrize("n_words", [1, 7, 10_000, 1 << 20])
def test_cuda_popcount_matches_plain(cuda_device, n_words):
    words = torch.randint(-2**31, 2**31 - 1, (n_words,), dtype=torch.int32)
    got = t_bk.popcount_cuda(words.to(cuda_device))
    assert int(got) == int(t_bk.popcount_plain(words))
