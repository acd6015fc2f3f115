"""The CSR fusion levels of the port — K4 (prefetch ring), K5 (one launch
per layer) and K6 (one launch per traversal) — against the reference.

The reference's own fused kernels cannot run on this jax (their Pallas
calls reach ``pltpu.TPUMemorySpace``), so the plain versions are held
against the reference's pure-jnp pieces (`_plan_in_kernel`,
`_restore_in_kernel`, `_layer_counters`, `_decide`) and, end to end,
against the reference's ``fused_gather`` path at ``prefetch_depth=0``,
which its own tests pin equal to all three fused paths.  Every check is
exact.  The ``cuda`` twins compare each CUDA kernel with its plain
version and skip without a card.
"""
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bfs_serial as ref_serial
from repro.core import engine as ref_engine
from repro.core.validate import validate as ref_validate
from repro.kernels import layer_fused as ref_lf
from repro.kernels import traversal_fused as ref_tf

from _torch_parity import (BUILDERS, POLICY_IDS, POLICY_PAIRS, ROOTS,
                           cuda_device, run_reference, to_port,  # noqa: F401
                           words_np)
from test_torch_kernels import _check_repaired, _layer_case, _run_reference
import repro_torch.bfs as tbfs
from repro_torch import interop
from repro_torch.core import engine as t_engine
from repro_torch.core.validate import validate as t_validate
from repro_torch.kernels import gather_expand as t_ge
from repro_torch.kernels import layer_fused as t_lf
from repro_torch.kernels import ops
from repro_torch.kernels import traversal_fused as t_tf
from repro_torch.obs.metrics import clear_degrade_log, degrade_log
from _torch_parity import builtin_knobs  # noqa: F401

# the reference's pinned fused_gather depth-0 results hold the port's
# built-in knobs, not the affinity table's picks
pytestmark = pytest.mark.usefixtures("builtin_knobs")


@pytest.fixture(scope="module")
def graphs():
    return {name: build() for name, build in BUILDERS.items()}


def _fused(g, tile):
    """The port's loop constants for a reference graph."""
    gt = to_port(g)
    rows_t = t_engine._pad_rows_to_tile(gt.rows, g.n_vertices, tile)
    return t_lf.fused_csr(gt.colstarts, rows_t, g.n_vertices, tile,
                          g.n_vertices_padded)


def _words(seed, n_batch, n_vertices, n_words, density):
    rng = np.random.default_rng(seed)
    dense = np.zeros((n_batch, n_words * 32), bool)
    dense[:, :n_vertices] = rng.random((n_batch, n_vertices)) < density
    return (dense.reshape(n_batch, n_words, 32).astype(np.uint64)
            << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)


# ---------------------------------------------------------------------------
# K5's pieces against the reference's in-kernel transcriptions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bottom_up", [False, True],
                         ids=["topdown", "bottomup"])
@pytest.mark.parametrize("density", [0.0, 0.01, 0.2, 0.9])
@pytest.mark.parametrize("tile", [128, 1024])
def test_plan_matches_plan_in_kernel(graphs, bottom_up, density, tile):
    """Work-list and n_active of the owner-range plan equal the
    reference's difference-scatter plan, exactly."""
    g = graphs["rmat9"]
    fg = _fused(g, tile)
    words = _words(int(density * 100) + tile, 3, g.n_vertices,
                   int(fg.nz.shape[0]), density)
    if bottom_up:   # the unvisited complement: padding premarked visited
        from repro.core.csr import padding_premarked_visited
        words = words | np.asarray(padding_premarked_visited(g.n_vertices))
    wl_t, na_t = t_lf.plan_blocks_plain(
        fg, interop.words_to_torch(words, "cpu"), bottom_up)
    for b in range(3):
        wl_r, na_r = ref_lf._plan_in_kernel(
            g.n_vertices, tile, fg.n_blocks, bottom_up,
            jnp.asarray(words[b]), g.colstarts)
        assert int(na_t[b]) == int(na_r)
        np.testing.assert_array_equal(wl_t[b].numpy(), np.asarray(wl_r))


def test_restore_matches_restore_in_kernel():
    rng = np.random.default_rng(4)
    n, v_pad = 1000, 1024
    p = rng.integers(0, n + 1, (v_pad,), dtype=np.int32)
    marked = rng.random(v_pad) < 0.2
    p[marked] -= n
    out = _words(5, 1, n, v_pad // 32, 0.1)[0]
    out_r, p_r = ref_lf._restore_in_kernel(n, jnp.asarray(out),
                                           jnp.asarray(p))
    fixed, delta = t_lf.restoration_plain(torch.from_numpy(p[None]), n)
    np.testing.assert_array_equal(fixed[0].numpy(), np.asarray(p_r))
    np.testing.assert_array_equal(
        words_np(interop.words_to_torch(out[None], "cpu") | delta)[0],
        np.asarray(out_r))


@pytest.mark.parametrize("bottom_up", [False, True],
                         ids=["topdown", "bottomup"])
@pytest.mark.parametrize("seed", [0, 1])
def test_layer_fused_plain_matches_reference_layer(bottom_up, seed):
    """One K5 layer: its n_active is the reference planner's, and after
    its in-kernel restoration out, visited and the marked set equal the
    reference's gather-expand + restoration on the same state."""
    c = _layer_case(seed, bottom_up)
    fg = _fused(c["g"], c["tile"])
    frontier = interop.words_to_torch(c["frontier"], "cpu")
    visited = interop.words_to_torch(c["visited"], "cpu")
    parent = torch.from_numpy(c["p0"].copy())
    out, p, na = ops.layer_fused_batched(fg, frontier, visited, parent,
                                         bottom_up=bottom_up)
    np.testing.assert_array_equal(na.numpy(), c["na"])
    assert p is parent and int(p.min()) >= 0
    out_r, p_r = _run_reference(c, bottom_up)
    marked_r = p_r < 0
    np.testing.assert_array_equal((p.numpy() != c["p0"]), marked_r)
    _, d_r = t_lf.restoration_plain(torch.from_numpy(p_r.copy()), c["n"])
    np.testing.assert_array_equal(words_np(out), out_r | words_np(d_r))


def test_layer_fused_single_root_is_batched_at_b1():
    c = _layer_case(2, False, n_batch=1)
    fg = _fused(c["g"], c["tile"])
    f = interop.words_to_torch(c["frontier"][0], "cpu")
    v = interop.words_to_torch(c["visited"][0], "cpu")
    one = ops.layer_fused(fg, f, v, torch.from_numpy(c["p0"][0].copy()))
    many = ops.layer_fused_batched(fg, f[None], v[None],
                                   torch.from_numpy(c["p0"].copy()))
    assert torch.equal(one[0], many[0][0]) and torch.equal(one[1],
                                                           many[1][0])
    assert one[2].tolist() == many[2].tolist() == c["na"].tolist()


# ---------------------------------------------------------------------------
# K6's counters and decision against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("density", [0.0, 0.05, 0.6])
def test_layer_counters_match_reference(graphs, density):
    g = graphs["rmat9"]
    fg = _fused(g, 256)
    words = _words(7, 4, g.n_vertices, int(fg.nz.shape[0]), density)
    deg = np.asarray(g.colstarts[1:] - g.colstarts[:-1])
    c_r, e_r = ref_tf._layer_counters(g.n_vertices, jnp.asarray(words),
                                      jnp.asarray(deg))
    c_t, e_t = t_tf.layer_counters(interop.words_to_torch(words, "cpu"),
                                   fg.deg)
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_r))
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_r))


@pytest.mark.parametrize("bottom_up", [False, True])
@pytest.mark.parametrize("layer", [0, 1, 2, 5])
@pytest.mark.parametrize("policy_index", range(4), ids=POLICY_IDS)
def test_decide_matches_reference(graphs, policy_index, layer, bottom_up):
    """The kernel's encoded decision equals the reference's `_decide`
    with the policy object, over frontiers from tiny to most of V."""
    g = graphs["rmat9"]
    n = g.n_vertices
    fg = _fused(g, 256)
    ref_pol, t_pol = POLICY_PAIRS[policy_index]
    deg = jnp.asarray(np.asarray(g.colstarts[1:] - g.colstarts[:-1]))
    code = t_engine.encode_policy(t_pol, n, 4, 64)
    for k, density in enumerate((0.001, 0.02, 0.2, 0.7)):
        f = _words(10 * k + layer, 4, n, int(fg.nz.shape[0]), density)
        vis = f | _words(10 * k + layer + 1, 4, n, int(fg.nz.shape[0]),
                         min(1.0, 2 * density))
        from repro.core.csr import padding_premarked_visited
        vis = vis | np.asarray(padding_premarked_visited(n))
        fc_r, fe_r = ref_tf._layer_counters(n, jnp.asarray(f), deg)
        mode_r, bu_r = ref_tf._decide(ref_pol, jnp.int32(layer), fc_r,
                                      fe_r, jnp.asarray(vis), deg, n, 4,
                                      jnp.asarray(bottom_up))
        fc, fe = t_tf.layer_counters(interop.words_to_torch(f, "cpu"),
                                     fg.deg)
        uc, ue = t_tf.layer_counters(~interop.words_to_torch(vis, "cpu"),
                                     fg.deg)
        got = t_tf.decide(code, layer, int(fc.sum()), int(fe.sum()),
                          int(uc.sum()), int(ue.sum()), bottom_up)
        assert got == (int(mode_r), bool(bu_r)), (density, got)


def test_mode_constants_match_the_engines():
    assert (t_tf.MODE_SCALAR, t_tf.MODE_SIMD, t_tf.MODE_BOTTOMUP) == \
        (t_engine.MODE_SCALAR, t_engine.MODE_SIMD, t_engine.MODE_BOTTOMUP) \
        == (ref_tf.MODE_SCALAR, ref_tf.MODE_SIMD, ref_tf.MODE_BOTTOMUP)
    assert t_tf.N_STATS == t_engine._N_ST == ref_tf._N_ST


# ---------------------------------------------------------------------------
# The fusion paths end to end against the reference's fused_gather
# ---------------------------------------------------------------------------

#: port pipeline variants (id -> TraversalSpec fields)
VARIANTS = {
    "megakernel": dict(pipeline="megakernel"),
    "megakernel_d2": dict(pipeline="megakernel", prefetch_depth=2),
    "persistent": dict(pipeline="persistent"),
    "prefetch1": dict(prefetch_depth=1),
    "prefetch3": dict(prefetch_depth=3),
}
CASES = [("rmat9", v, p) for v in VARIANTS for p in range(4)] + [
    (g, v, p) for g in ("star", "path", "disconnected")
    for v in ("megakernel", "persistent", "prefetch1") for p in (1, 3)]

_REFERENCE = {}


def _reference(graphs, graph_name, policy_index):
    key = (graph_name, policy_index)
    if key not in _REFERENCE:
        _REFERENCE[key] = run_reference(graphs[graph_name],
                                        POLICY_PAIRS[policy_index][0],
                                        ROOTS[graph_name][1])
    return _REFERENCE[key]


@pytest.mark.parametrize("graph_name,variant,policy_index", CASES,
                         ids=[f"{g}-{v}-{POLICY_IDS[p]}"
                              for g, v, p in CASES])
def test_fusion_path_matches_reference(graphs, graph_name, variant,
                                       policy_index):
    """Visited, frontier, depths, layers, stats columns 0-4 and 6 and the
    direction log equal the reference's fused_gather run.  Column 5
    (tiles) too, except on a persistent scalar layer, where K6 reports
    its planned tiles and fused_gather the full stream's; column 7
    (launches) per path.  Trees pass both validators against
    bfs_serial."""
    g = graphs[graph_name]
    roots = ROOTS[graph_name][1]
    ct, ref = _reference(graphs, graph_name, policy_index)
    t_pol = POLICY_PAIRS[policy_index][1]
    spec = tbfs.TraversalSpec(policy=t_pol, tile=ct.resolved.tile,
                              max_layers=128, **VARIANTS[variant])
    clear_degrade_log()
    got = tbfs.plan(to_port(g), spec, device="cpu").run_batched(roots)
    assert not degrade_log()
    st_t, st_r = got.stats.numpy(), np.asarray(ref.stats)
    np.testing.assert_array_equal(st_t[:, :5], st_r[:, :5])
    np.testing.assert_array_equal(st_t[:, 6], st_r[:, 6])
    scalar = st_r[:, 3] == t_engine.MODE_SCALAR
    if variant == "persistent":
        np.testing.assert_array_equal(st_t[~scalar, 5], st_r[~scalar, 5])
        n_layers = int(ref.state.layer)
        assert st_t[:n_layers, 7].tolist() == [1] + [0] * (n_layers - 1)
    else:
        np.testing.assert_array_equal(st_t[:, 5], st_r[:, 5])
        fused = 1 if variant.startswith("megakernel") else 3
        np.testing.assert_array_equal(
            st_t[:, 7], np.where(st_r[:, 4] == 0, 0,
                                 np.where(scalar, 1, fused)))
    np.testing.assert_array_equal(words_np(got.state.visited),
                                  np.asarray(ref.state.visited))
    np.testing.assert_array_equal(words_np(got.state.frontier),
                                  np.asarray(ref.state.frontier))
    np.testing.assert_array_equal(got.depths.numpy(), np.asarray(ref.depths))
    assert int(got.state.layer) == int(ref.state.layer)
    assert tbfs.direction_log(got) == ref_engine.direction_log(ref)
    parents = tbfs.parents_graph500(got.state, g.n_vertices).numpy()
    rows, cs = np.asarray(g.rows), np.asarray(g.colstarts)
    gt = to_port(g)
    for b, root in enumerate(roots):
        _, depth = ref_serial.bfs_serial(rows, cs, g.n_vertices, root)
        assert t_validate(gt, torch.from_numpy(parents[b]), root,
                          reference_depth=depth).ok
        assert ref_validate(g, jnp.asarray(parents[b]), root,
                            reference_depth=depth).ok


@pytest.mark.parametrize("pipeline", ["megakernel", "persistent"])
def test_single_root_run_is_unbatched(graphs, pipeline):
    gt = to_port(graphs["rmat9"])
    ct = tbfs.plan(gt, tbfs.TraversalSpec(policy="beamer",
                                          pipeline=pipeline), device="cpu")
    one = ct.run(17)
    assert one.state.parent.ndim == 1 and one.depths.ndim == 0
    ref = tbfs.plan(gt, tbfs.TraversalSpec(policy="beamer"),
                    device="cpu").run(17)
    assert torch.equal(one.state.visited, ref.state.visited)
    assert int(one.depths) == int(ref.depths)


# ---------------------------------------------------------------------------
# Budgets and degrades
# ---------------------------------------------------------------------------

def test_budget_miss_degrades_observably(graphs, monkeypatch, caplog):
    """A shared-memory limit between K4's ring and K5's budget: the
    megakernel degrades to fused_gather, the persistent kernel to the
    megakernel and on to fused_gather; each degrade is recorded in the
    degrade log and logged, and the answer is unchanged."""
    gt = to_port(graphs["rmat9"])
    roots = [3, 7]
    spec = dict(policy="beamer", tile=128, prefetch_depth=2)
    base = tbfs.plan(gt, tbfs.TraversalSpec(**spec),
                     device="cpu").run_batched(roots)
    assert ops.gather_stage_fits(128, 2, 100)
    monkeypatch.setattr(ops, "SMEM_OPTIN_BYTES",
                        t_ge.stage_bytes(128, 2) + 1)
    assert not ops.megakernel_fits(128, 2, 100)
    for pipeline, n_events in (("megakernel", 1), ("persistent", 2)):
        clear_degrade_log()
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="repro_torch.serve"):
            got = tbfs.plan(gt, tbfs.TraversalSpec(pipeline=pipeline, **spec),
                            device="cpu").run_batched(roots)
        assert any("degrade[smem_fallback]" in r.getMessage()
                   for r in caplog.records)
        assert len(degrade_log()) == n_events
        assert all(e.site == "smem_fallback" for e in degrade_log())
        assert "fused_gather" in degrade_log()[-1].fallback
        assert torch.equal(got.state.visited, base.state.visited)
        assert torch.equal(got.stats, base.stats)
    clear_degrade_log()


def test_prefetch_ring_past_shared_memory_is_refused(graphs):
    gt = to_port(graphs["rmat9"])
    for pipeline in ("fused_gather", "persistent"):
        with pytest.raises(ValueError, match="shared memory"):
            tbfs.plan(gt, tbfs.TraversalSpec(pipeline=pipeline,
                                             tile=1 << 16,
                                             prefetch_depth=64),
                      device="cpu")


def test_persistent_degrades_an_unregistered_policy(graphs, caplog):
    """A policy the whole-traversal kernel cannot encode runs the
    megakernel steps with exactly one recorded ``pipeline_unsupported``
    degrade: the megakernel's result (columns 0-6 as contracted), and
    the registered policy's persistent run's but for the launches and,
    on scalar layers, K6's planned tiles."""
    class Custom(t_engine.ThresholdSimd):
        pass
    gt = to_port(graphs["rmat9"])
    roots = [3, 7, 11]
    clear_degrade_log()
    with caplog.at_level(logging.WARNING, logger="repro_torch.serve"):
        got = tbfs.plan(gt, tbfs.TraversalSpec(
            policy=Custom(), pipeline="persistent"),
            device="cpu").run_batched(roots)
    assert [r.getMessage().split(":")[0] for r in caplog.records
            if r.name == "repro_torch.serve"] == \
        ["degrade[pipeline_unsupported]"]
    assert [e.site for e in degrade_log()] == ["pipeline_unsupported"]
    assert "megakernel" in degrade_log()[0].fallback
    clear_degrade_log()
    mega = tbfs.plan(gt, tbfs.TraversalSpec(policy=Custom(),
                                            pipeline="megakernel"),
                     device="cpu").run_batched(roots)
    persistent = tbfs.plan(gt, tbfs.TraversalSpec(
        policy=t_engine.ThresholdSimd(), pipeline="persistent"),
        device="cpu").run_batched(roots)
    assert not degrade_log()
    assert torch.equal(got.stats, mega.stats)
    assert torch.equal(got.stats[:, :7], mega.stats[:, :7])
    scalar = got.stats[:, 3] == t_engine.MODE_SCALAR
    for col in range(7):
        rows = ~scalar if col == 5 else slice(None)
        assert torch.equal(got.stats[rows, col],
                           persistent.stats[rows, col])
    for res in (mega, persistent):
        assert torch.equal(got.state.visited, res.state.visited)
        assert torch.equal(got.depths, res.depths)


def test_budgets_clamp_depth_to_the_block_count():
    assert ops.megakernel_budget(1024, 50, 2) \
        == ops.megakernel_budget(1024, 2, 2)
    assert ops.megakernel_budget(1024, 3, 10) \
        == t_ge.stage_bytes(1024, 3) + t_lf.FUSED_STATIC_SMEM
    assert ops.persistent_fits(1024, 3, 10) \
        and not ops.persistent_fits(1024, 100, 200)


# ---------------------------------------------------------------------------
# CUDA kernels vs plain versions (need the card)
# ---------------------------------------------------------------------------

def _to(c, device):
    t = lambda a: torch.from_numpy(np.array(a)).to(device)
    w = lambda a: interop.words_to_torch(a, device)
    plan = t_ge.UnionPlan.of_lists(t(c["wl"]), t(c["na"]),
                                   int(c["wl"].shape[1]))
    return dict(plan=plan, rows=t(c["rows_t"]), cs=t(c["cs"]),
                frontier=w(c["frontier"]), visited=w(c["visited"]),
                p=t(c["p0"]))


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("bottom_up", [False, True],
                         ids=["topdown", "bottomup"])
def test_cuda_prefetch_matches_plain(cuda_device, bottom_up, depth):
    c = _layer_case(6, bottom_up)
    d = _to(c, cuda_device)
    out = torch.zeros_like(d["frontier"])
    t_ge.gather_expand_cuda(d["plan"], d["rows"], d["cs"],
                            d["frontier"], d["visited"], out, d["p"],
                            n_vertices=c["n"], tile=c["tile"],
                            bottom_up=bottom_up, prefetch_depth=depth)
    _check_repaired(c, _run_reference(c, bottom_up),
                    (words_np(out), d["p"].cpu().numpy()))


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("bottom_up", [False, True],
                         ids=["topdown", "bottomup"])
def test_cuda_layer_fused_matches_plain(cuda_device, bottom_up, depth):
    c = _layer_case(7, bottom_up)
    fg = _fused(c["g"], c["tile"])
    fg_d = t_lf.FusedCsr(*(x.to(cuda_device) for x in fg[:6]),
                         fg.n_vertices, fg.tile)
    d = _to(c, cuda_device)
    out_k, p_k, na_k = t_lf.layer_fused_cuda(
        fg_d, d["frontier"], d["visited"], d["p"], bottom_up=bottom_up,
        prefetch_depth=depth)
    out_p, p_p, na_p = t_lf.layer_fused_plain(
        fg, d["frontier"].cpu(), d["visited"].cpu(),
        torch.from_numpy(c["p0"].copy()), bottom_up=bottom_up)
    assert torch.equal(na_k.cpu(), na_p)
    assert torch.equal(out_k.cpu(), out_p)
    assert torch.equal(p_k.cpu() != torch.from_numpy(c["p0"]),
                       p_p != torch.from_numpy(c["p0"]))


@pytest.mark.cuda
@pytest.mark.parametrize("policy_index", range(4), ids=POLICY_IDS)
def test_cuda_traversal_fused_matches_plain(cuda_device, graphs,
                                            policy_index):
    g = graphs["rmat9"]
    roots = ROOTS["rmat9"][1]
    t_pol = POLICY_PAIRS[policy_index][1]
    gt = to_port(g)
    spec = tbfs.TraversalSpec(policy=t_pol, pipeline="persistent")
    cpu = tbfs.plan(gt, spec, device="cpu").run_batched(roots)
    ops.reset_kernel_launches()
    gpu = tbfs.plan(gt, spec, device=cuda_device).run_batched(roots)
    assert ops.KERNEL_LAUNCHES["traversal_fused_batched"] == 1
    for name in ("frontier", "visited"):
        assert torch.equal(getattr(gpu.state, name).cpu(),
                           getattr(cpu.state, name))
    assert torch.equal(gpu.depths.cpu(), cpu.depths)
    assert torch.equal(gpu.stats.cpu(), cpu.stats)
