"""The union planner (`kernels.plan`), which every fused_gather layer and
every semiring portfolio layer runs in place of the reference's per-root
planning, and K12 on its union.

On the CPU: `plan_union_plain` against the reference's planners folded
by `gather_expand.union_worklist` — the CSR arm against
``plan_active_tiles_batched`` (its K2 in interpret mode), the SELL arm
against ``SellFormat._plan_slab_steps`` — and against the port's own
per-root planners, on R-MAT SCALE 9, star, path and disconnected
graphs, at 1, 8 and 33 roots, top-down and bottom-up (``complement``),
with and without a dense root: list, count, root masks and per-root
counts bitwise.  Stats columns 5 (listed items) and 7 (launches) of
traversals that plan through it equal the reference's.  On the card
(tests marked ``cuda``): the planner's kernel equals its plain version
on both arms, and K12 over the union equals `sell_relax_plain`, at
B = 1, 8 and 33, int32 and float32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.core.csr import padding_premarked_visited as ref_premarked
from repro.formats.sell import SellFormat as RefSell

from _torch_parity import (BUILDERS, ROOTS, cuda_device,  # noqa: F401
                           run_reference, run_port as run_port_bfs,
                           to_port)
from _torch_semiring import reference as ref_semiring
from _torch_semiring import run_port as run_port_semiring
import repro_torch.bfs as tbfs
from repro_torch import formats, interop
from repro_torch.core import engine as t_engine
from repro_torch.kernels import gather_expand as ge
from repro_torch.kernels import layer_fused as lf
from repro_torch.kernels import ops
from repro_torch.kernels import plan as pl
from repro_torch.kernels import sell_expand as se

GRAPHS = ("rmat9", "star", "path", "disconnected")
BATCHES = (1, 8, 33)
TILE = 128            # CSR rows per block: several blocks on every graph
SPP = 2               # SELL slabs per group (the port's auto tile)
SIGMA = 128
DENSE = ("none", "one_dense")
CASES = [(g, b, bu, d) for g in GRAPHS for b in BATCHES
         for bu in (False, True) for d in DENSE]
IDS = [f"{g}-b{b}-{'bottomup' if bu else 'topdown'}-{d}"
       for g, b, bu, d in CASES]


@pytest.fixture(scope="module")
def graphs():
    return {name: BUILDERS[name]() for name in GRAPHS}


def _pack(dense):
    d = dense.reshape(dense.shape[0], -1, 32)
    return (d.astype(np.uint64) << np.arange(32, dtype=np.uint64)) \
        .sum(-1).astype(np.uint32)


def _state(g, n_batch, seed):
    """(frontier, visited) uint32 words of ``n_batch`` roots mid-traversal
    on ``g``: padding premarked visited."""
    n = g.n_vertices
    base = np.asarray(ref_premarked(n))
    v_pad = base.shape[0] * 32
    rng = np.random.default_rng(seed)
    f = np.zeros((n_batch, v_pad), bool)
    f[:, :n] = rng.random((n_batch, n)) < 0.05
    f[0, :n] |= rng.random(n) < 0.3         # one wide frontier
    v = f.copy()
    v[:, :n] |= rng.random((n_batch, n)) < 0.3
    return _pack(f), _pack(v) | base


def _dense(n_batch, kind):
    d = np.zeros(n_batch, bool)
    if kind == "one_dense":
        d[n_batch // 2] = True
    return d


def _want(wl, na, dense, n_items):
    """The reference's lists with the dense override, folded."""
    wl, na = torch.from_numpy(np.array(wl)), torch.from_numpy(np.array(na))
    dense = torch.from_numpy(dense)
    full = torch.arange(n_items, dtype=torch.int32)
    wl = torch.where(dense[:, None], full[None], wl)
    na = torch.where(dense, n_items, na).to(torch.int32)
    return ge.UnionPlan.of_lists(wl, na, n_items)


def _assert_plans_equal(got, want):
    for name, a, b in zip(ge.UnionPlan._fields, got, want):
        assert a.dtype == torch.int32, name
        assert torch.equal(a, b), f"plan.{name} differs"


def _csr_graph(g):
    gt = to_port(g)
    rows_t = t_engine._pad_rows_to_tile(gt.rows, g.n_vertices, TILE)
    return lf.fused_csr(gt.colstarts.contiguous(), rows_t, g.n_vertices,
                        TILE, g.n_vertices_padded)


def _sell_pair(g):
    ref = RefSell.from_csr(g, sigma=SIGMA)
    port = formats.SellFormat.from_csr(to_port(g), sigma=SIGMA)
    return ref, port.sell_graph(SPP)


# ---------------------------------------------------------------------------
# The plain planner against the reference's planners
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("graph,n_batch,bottom_up,dense", CASES, ids=IDS)
def test_csr_plan_matches_the_reference_planner(graphs, graph, n_batch,
                                                bottom_up, dense):
    g = graphs[graph]
    fg = _csr_graph(g)
    frontier, visited = _state(g, n_batch, n_batch + 7 * bottom_up)
    active = ~visited if bottom_up else frontier
    wl_r, na_r = ref_engine.plan_active_tiles_batched(
        g.colstarts, jnp.asarray(active), g.n_vertices, TILE, fg.n_blocks,
        packed=True)
    d = _dense(n_batch, dense)
    want = _want(wl_r, na_r, d, fg.n_blocks)
    words = interop.words_to_torch(visited if bottom_up else frontier,
                                   "cpu")
    got = pl.plan_union_plain(fg, words, complement=bottom_up,
                              dense=torch.from_numpy(d))
    _assert_plans_equal(got, want)
    assert int(got.ucount) > 0
    # the port's own per-root planner (K2's plain version + the block
    # marking), folded the same way
    wl_t, na_t = t_engine.plan_active_tiles_batched(
        fg.colstarts, interop.words_to_torch(active, "cpu"), g.n_vertices,
        TILE, fg.n_blocks)
    _assert_plans_equal(got, _want(wl_t, na_t, d, fg.n_blocks))


@pytest.mark.parametrize("graph,n_batch,bottom_up,dense", CASES, ids=IDS)
def test_sell_plan_matches_the_reference_planner(graphs, graph, n_batch,
                                                 bottom_up, dense):
    g = graphs[graph]
    ref, sg = _sell_pair(g)
    frontier, visited = _state(g, n_batch, 100 + n_batch + 7 * bottom_up)
    active = ~visited if bottom_up else frontier
    lists = [ref._plan_slab_steps(jnp.asarray(active[b]), SPP, sg.n_steps)
             for b in range(n_batch)]
    wl_r = np.stack([np.asarray(w) for w, _ in lists])
    na_r = np.asarray([int(n) for _, n in lists], np.int32)
    d = _dense(n_batch, dense)
    want = _want(wl_r, na_r, d, sg.n_steps)
    words = interop.words_to_torch(visited if bottom_up else frontier,
                                   "cpu")
    got = pl.plan_union_plain(sg, words, complement=bottom_up,
                              dense=torch.from_numpy(d))
    _assert_plans_equal(got, want)
    assert int(got.ucount) > 0
    wl_t, na_t = se.plan_slabs_plain(sg, interop.words_to_torch(active,
                                                                "cpu"))
    _assert_plans_equal(got, _want(wl_t, na_t, d, sg.n_steps))


def test_plan_walks_each_roots_own_list(graphs):
    """`UnionPlan.items_of` and `listed` give back each root's list."""
    g = graphs["rmat9"]
    fg = _csr_graph(g)
    frontier, _ = _state(g, 33, 5)
    words = interop.words_to_torch(frontier, "cpu")
    wl, na = lf.plan_blocks_plain(fg, words, False)
    plan = pl.plan_union_plain(fg, words)
    listed = plan.listed()
    for b in range(33):
        want = wl[b, :int(na[b])].to(torch.int64)
        assert torch.equal(plan.items_of(b), want)
        assert torch.equal(torch.nonzero(listed[b]).flatten(), want)
    assert torch.equal(plan.na, na)


def test_plan_union_charges_the_references_launches(graphs):
    """One launch on CSR (the reference's K2 planning call), none on
    SELL (the reference plans in jnp); no CUDA launch on the CPU."""
    g = graphs["rmat9"]
    fg = _csr_graph(g)
    _, sg = _sell_pair(g)
    frontier, _ = _state(g, 8, 3)
    words = interop.words_to_torch(frontier, "cpu")
    before = dict(ops.KERNEL_LAUNCHES)
    for graph, charged in ((fg, 1), (sg, 0)):
        with ops.count_launches() as c:
            got = ops.plan_union(graph, words)
        assert c.count == charged
        _assert_plans_equal(got, pl.plan_union_plain(graph, words))
    assert ops.KERNEL_LAUNCHES == before


def test_plan_union_cuda_refuses_bad_arguments(graphs):
    """The checks run before anything touches the card."""
    g = graphs["rmat9"]
    fg = _csr_graph(g)
    frontier, _ = _state(g, 8, 3)
    words = interop.words_to_torch(frontier, "cpu")
    with pytest.raises(ValueError, match="words must be"):
        pl.plan_union_cuda(fg, words[:, :-1].contiguous())
    with pytest.raises(ValueError, match="words must be"):
        pl.plan_union_cuda(fg, words.to(torch.int64))
    with pytest.raises(ValueError, match="dense must be"):
        pl.plan_union_cuda(fg, words, dense=torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError, match="dense must be"):
        pl.plan_union_cuda(fg, words, dense=torch.zeros(7, dtype=torch.bool))


# ---------------------------------------------------------------------------
# Stats columns 5 and 7 of traversals that plan through it
# ---------------------------------------------------------------------------

STATS_CASES = ("fused_gather", "ksource_bfs-csr", "ksource_bfs-sell")


@pytest.mark.parametrize("case", STATS_CASES)
def test_listed_items_and_launches_match_the_reference(graphs, case):
    roots = ROOTS["rmat9"][1]
    if case == "fused_gather":
        ref_pol = ref_engine.BeamerHybrid()
        ct, ref = run_reference(graphs["rmat9"], ref_pol, roots)
        got = run_port_bfs(to_port(graphs["rmat9"]), tbfs.BeamerHybrid(),
                           roots, ct.resolved.tile)
        per_layer = 3
    else:
        alg, fmt_name = case.split("-")
        ct, ref = ref_semiring(graphs, "rmat9", fmt_name, alg)
        got = run_port_semiring(graphs, "rmat9", fmt_name, alg,
                                ct.resolved.tile, roots)
        per_layer = 2 if fmt_name == "csr" else 1
    want = np.asarray(ref.stats)[:, [5, 7]]
    np.testing.assert_array_equal(got.stats[:, [5, 7]].numpy(), want)
    n_layers = int(got.state.layer)
    assert n_layers > 1 and bool((got.stats[:n_layers, 5] > 0).all())
    assert got.stats[:n_layers, 7].tolist() == [per_layer] * n_layers


# ---------------------------------------------------------------------------
# The CUDA kernels against their plain versions (need the card)
# ---------------------------------------------------------------------------

ARM_CASES = [(a, b, v) for a in ("csr", "sell") for b in BATCHES
             for v in ("topdown", "bottomup", "dense")]


@pytest.mark.cuda
@pytest.mark.parametrize("arm,n_batch,variant", ARM_CASES,
                         ids=[f"{a}-b{b}-{v}" for a, b, v in ARM_CASES])
def test_cuda_plan_union_matches_plain(cuda_device, graphs, arm, n_batch,
                                       variant):
    g = graphs["rmat9"]
    graph = _csr_graph(g) if arm == "csr" else _sell_pair(g)[1]
    frontier, visited = _state(g, n_batch, 11)
    bottom_up = variant == "bottomup"
    words = interop.words_to_torch(visited if bottom_up else frontier,
                                   "cpu")
    dense = torch.from_numpy(_dense(n_batch, "one_dense")) \
        if variant == "dense" else None
    want = pl.plan_union_plain(graph, words, complement=bottom_up,
                               dense=dense)
    on = type(graph)(*(x.to(cuda_device) if torch.is_tensor(x) else x
                       for x in graph))
    got = pl.plan_union_cuda(
        on, words.to(cuda_device), complement=bottom_up,
        dense=None if dense is None else dense.to(cuda_device))
    _assert_plans_equal(ge.UnionPlan(*(x.cpu() for x in got)), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("n_batch", BATCHES)
def test_cuda_sell_relax_union_matches_plain(cuda_device, graphs, n_batch,
                                             dtype):
    g = graphs["rmat9"]
    _, sg = _sell_pair(g)
    frontier, _ = _state(g, n_batch, 12)
    words = interop.words_to_torch(frontier, "cpu")
    v_pad = int(sg.deg.shape[0])
    rng = np.random.default_rng(n_batch)
    if dtype == "int32":
        vals = rng.integers(0, 6, (n_batch, v_pad)).astype(np.int32)
        kw = dict(unit=1, weighted=False)
    else:
        vals = (rng.random((n_batch, v_pad)) * 8).astype(np.float32)
        vals[rng.random(vals.shape) < 0.3] = np.inf
        kw = dict(unit=0, weighted=True)
    vals = torch.from_numpy(vals)
    plan = pl.plan_union_plain(sg, words)
    want = se.sell_relax_plain(sg, plan, words, vals, **kw)
    on = se.SellGraph(*(x.to(cuda_device) if torch.is_tensor(x) else x
                        for x in sg))
    got = se.sell_relax_cuda(on, ge.UnionPlan(*(x.to(cuda_device)
                                                for x in plan)),
                             words.to(cuda_device), vals.to(cuda_device),
                             **kw)
    assert got[0].dtype == vals.dtype
    assert torch.equal(got[0].cpu().view(torch.int32),
                       want[0].view(torch.int32))
    assert torch.equal(got[1].cpu(), want[1])
    assert bool((got[0].cpu() != vals).any())
