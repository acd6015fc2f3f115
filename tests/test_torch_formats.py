"""The port's format layer against the reference's ``repro.formats``:
the SELL-C-σ and bitmap layouts (bitwise), the autotuner (statistics,
choice and reason strings), the registry (names and error messages),
the byte accounting, the capability checks of spec validation, and the
bitmap format end to end (parents bitwise: its lowest-id parent rule is
deterministic).  Every comparison is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import plan as ref_plan
from repro.api.spec import TraversalSpec as RefSpec
from repro.core import engine as ref_engine
from repro.core.rmat import EdgeList as RefEdgeList
from repro.formats import autotune as ref_autotune
from repro.formats import registry as ref_registry
from repro.formats.base import traversal_bytes as ref_traversal_bytes
from repro.formats.base import membership_bytes as ref_membership_bytes
from repro.formats.bitmap_format import BitmapCompressedFormat as RefBitmap
from repro.formats.csr_format import CsrFormat as RefCsr
from repro.formats.sell import SellFormat as RefSell

from _torch_parity import (FORMAT_BUILDERS, FORMAT_ROOTS, POLICY_IDS,
                           POLICY_PAIRS, csr_from_pairs, rmat_graph,
                           to_port, words_np)
import repro_torch.bfs as tbfs
from repro_torch import formats
from repro_torch.core import engine as t_engine
from repro_torch.formats import autotune, registry
from repro_torch.formats.base import membership_bytes, traversal_bytes
from _torch_parity import builtin_knobs  # noqa: F401

# the reference's pinned fused_gather depth-0 results hold the port's
# built-in knobs, not the affinity table's picks
pytestmark = pytest.mark.usefixtures("builtin_knobs")

GRAPHS = list(FORMAT_BUILDERS)


@pytest.fixture(scope="module")
def graphs():
    return {name: build() for name, build in FORMAT_BUILDERS.items()}


def edgeless_graph(n=50):
    return csr_from_pairs([], n)


def complete_graph(n=64):
    return csr_from_pairs([(a, b) for a in range(n)
                           for b in range(a + 1, n)], n)


# ---------------------------------------------------------------------------
# SELL-C-σ layout
# ---------------------------------------------------------------------------

def _assert_same_sell(ref, got):
    for name in ("cols", "slab_rows", "deg"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert got.n_slabs == ref.n_slabs
    assert got.nnz_stored == ref.nnz_stored
    assert got.sigma == ref.sigma
    assert (got.n_vertices, got.n_edges) == (ref.n_vertices, ref.n_edges)
    assert got.fill_ratio == ref.fill_ratio


@pytest.mark.parametrize("max_width", [32, 64])
@pytest.mark.parametrize("sigma", [128, 1024])
@pytest.mark.parametrize("graph_name", GRAPHS)
def test_sell_layout_matches_reference(graphs, graph_name, sigma,
                                       max_width):
    """cols, slab_rows, deg, n_slabs, nnz_stored and σ bitwise equal to
    the reference's per-window argsort build."""
    g = graphs[graph_name]
    ref = RefSell.from_csr(g, sigma=sigma, max_width=max_width)
    got = formats.SellFormat.from_csr(to_port(g), sigma=sigma,
                                      max_width=max_width)
    _assert_same_sell(ref, got)


@pytest.mark.parametrize("sigma", [128, 1024])
def test_sell_edgeless_graph_is_one_sentinel_slab(sigma):
    g = edgeless_graph()
    ref = RefSell.from_csr(g, sigma=sigma)
    got = formats.SellFormat.from_csr(to_port(g), sigma=sigma)
    _assert_same_sell(ref, got)
    assert got.n_slabs == 1 and int(got.cols.min()) == g.n_vertices


def test_sell_auto_sigma_is_the_builtin_default(graphs):
    """Auto σ is DEFAULT_SIGMA (1024) capped at the row count; no
    benchmark table is read."""
    g = graphs["rmat9"]
    got = formats.SellFormat.from_csr(to_port(g))
    ref = RefSell.from_csr(g, sigma=RefSell.DEFAULT_SIGMA)
    assert formats.SellFormat.DEFAULT_SIGMA == RefSell.DEFAULT_SIGMA == 1024
    _assert_same_sell(ref, got)


def test_sell_builds_from_edges_and_from_graph(graphs):
    g = graphs["star"]
    gt = to_port(g)
    a = formats.SellFormat.from_csr(gt, sigma=128)
    edges = formats.csr_to_edges(gt)
    b = formats.SellFormat.from_graph(edges, sigma=128)
    c = formats.SellFormat.from_graph(formats.CsrFormat.from_csr(gt),
                                      sigma=128)
    for other in (b, c):
        assert torch.equal(a.cols, other.cols)
        assert torch.equal(a.slab_rows, other.slab_rows)
    assert formats.SellFormat.from_graph(a) is a
    with pytest.raises(TypeError, match="cannot re-lay-out"):
        formats.CsrFormat.from_graph(a)


def test_from_graph_rejects_what_it_cannot_build():
    with pytest.raises(TypeError, match="cannot build SellFormat from list"):
        formats.SellFormat.from_graph([(0, 1)])


def test_make_steps_needs_a_resolved_spec(graphs):
    fmt = formats.SellFormat.from_csr(to_port(graphs["star"]), sigma=128)
    with pytest.raises(ValueError, match="needs a \\*resolved\\*"):
        fmt.make_steps(tbfs.TraversalSpec())
    spec = tbfs.TraversalSpec(policy="beamer").resolve(fmt)
    steps = fmt.make_steps(spec)
    assert sorted(steps) == [t_engine.MODE_SCALAR, t_engine.MODE_SIMD,
                             t_engine.MODE_BOTTOMUP]


def test_sell_rejects_a_bad_max_width(graphs):
    with pytest.raises(ValueError, match="multiple of 8"):
        formats.SellFormat.from_csr(to_port(graphs["star"]), max_width=12)


def test_csr_to_edges_matches_reference(graphs):
    from repro.formats.base import csr_to_edges as ref_csr_to_edges
    g = graphs["rmat9"]
    ref = ref_csr_to_edges(g)
    got = formats.csr_to_edges(to_port(g))
    np.testing.assert_array_equal(got.src.numpy(), np.asarray(ref.src))
    np.testing.assert_array_equal(got.dst.numpy(), np.asarray(ref.dst))


# ---------------------------------------------------------------------------
# Bitmap layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("graph_name", GRAPHS)
def test_bitmap_adjacency_matches_reference(graphs, graph_name):
    g = graphs[graph_name]
    ref = RefBitmap.from_csr(g)
    got = formats.BitmapCompressedFormat.from_csr(to_port(g))
    np.testing.assert_array_equal(words_np(got.adj), np.asarray(ref.adj))
    np.testing.assert_array_equal(got.deg.numpy(), np.asarray(ref.deg))


def test_bitmap_adjacency_ors_duplicate_edges():
    """Duplicate edges (R-MAT keeps them) set one bit, as the
    reference's bitwise_or.at does."""
    g = csr_from_pairs([(0, 1), (0, 1), (1, 2), (0, 33)], 40)
    ref = RefBitmap.from_csr(g)
    got = formats.BitmapCompressedFormat.from_csr(to_port(g))
    np.testing.assert_array_equal(words_np(got.adj), np.asarray(ref.adj))


# ---------------------------------------------------------------------------
# Autotuner and registry
# ---------------------------------------------------------------------------

AUTOTUNE_GRAPHS = GRAPHS + ["rmat10", "complete", "edgeless"]


def _autotune_graph(graphs, name):
    extra = {"rmat10": lambda: rmat_graph(10), "complete": complete_graph,
             "edgeless": edgeless_graph}
    return graphs[name] if name in graphs else extra[name]()


@pytest.mark.parametrize("graph_name", AUTOTUNE_GRAPHS)
def test_autotune_matches_reference(graphs, graph_name):
    """measure and choose equal the reference's: statistics, format and
    reason string, from a Csr and from a built format."""
    g = _autotune_graph(graphs, graph_name)
    gt = to_port(g)
    ref = ref_autotune.choose(g)
    got = autotune.choose(gt)
    assert tuple(got.stats) == tuple(ref.stats)
    assert (got.format, got.reason) == (ref.format, ref.reason)
    fmt = formats.CsrFormat.from_csr(gt)
    assert autotune.measure(fmt) == autotune.measure(gt)


@pytest.mark.parametrize("graph_name", ["rmat9", "rmat10", "star", "path"])
def test_autotune_build_builds_the_choice(graphs, graph_name):
    gt = to_port(_autotune_graph(graphs, graph_name))
    fmt = formats.build(gt, "auto")
    assert fmt.name == autotune.choose(gt).format
    assert type(fmt) is registry.get(fmt.name)
    assert formats.build(fmt, "auto") is fmt
    assert formats.build(fmt, fmt.name) is fmt


def test_autotune_picks_sell_for_rmat_and_the_thresholds_match():
    gt = to_port(rmat_graph(10))
    assert isinstance(formats.build(gt, "auto"), formats.SellFormat)
    assert (autotune.BITMAP_BUDGET_BYTES, autotune.DENSITY_THRESHOLD,
            autotune.SKEW_THRESHOLD) == (
        ref_autotune.BITMAP_BUDGET_BYTES, ref_autotune.DENSITY_THRESHOLD,
        ref_autotune.SKEW_THRESHOLD)


def test_autotune_measures_an_edge_list(graphs):
    g = graphs["star"]
    gt = to_port(g)
    edges = formats.csr_to_edges(gt)
    ref_edges = RefEdgeList(jnp.asarray(edges.src.numpy()),
                            jnp.asarray(edges.dst.numpy()), g.n_vertices)
    assert tuple(autotune.measure(edges)) == \
        tuple(ref_autotune.measure(ref_edges))
    with pytest.raises(TypeError, match="cannot autotune over"):
        autotune.measure([1, 2])


def test_registry_matches_reference():
    assert formats.available() == ref_registry.available() \
        == ("bitmap", "csr", "sell")
    for name in formats.available():
        assert registry.get(name).name == name
    assert registry.get("sell") is formats.SellFormat
    with pytest.raises(KeyError) as got:
        registry.get("coo")
    with pytest.raises(KeyError) as ref:
        ref_registry.get("coo")
    assert str(got.value) == str(ref.value)


def test_registry_register_errors():
    class Nameless(formats.CsrFormat):
        name = ""

    class Clash(formats.CsrFormat):
        name = "csr"

    with pytest.raises(ValueError, match="needs a non-empty `name`"):
        registry.register(Nameless)
    with pytest.raises(ValueError, match="already registered"):
        registry.register(Clash)
    assert registry.register(formats.CsrFormat) is formats.CsrFormat


def test_registry_build_by_name(graphs):
    gt = to_port(graphs["star"])
    for name in formats.available():
        fmt = formats.build(gt, name)
        assert type(fmt) is registry.get(name)
    with pytest.raises(KeyError, match="unknown graph format"):
        formats.build(gt, "coo")


# ---------------------------------------------------------------------------
# Accounting
# ---------------------------------------------------------------------------

def _pair(name, g):
    gt = to_port(g)
    if name == "csr":
        return RefCsr.from_csr(g), formats.CsrFormat.from_csr(gt)
    if name == "sell":
        return (RefSell.from_csr(g, sigma=128),
                formats.SellFormat.from_csr(gt, sigma=128))
    return RefBitmap.from_csr(g), formats.BitmapCompressedFormat.from_csr(gt)


@pytest.mark.parametrize("fmt_name", ["csr", "sell", "bitmap"])
def test_accounting_matches_reference(graphs, fmt_name):
    """Footprint, stream slots and the bytes-moved model equal the
    reference's, per layer and summed over a traversal's stats."""
    ref, got = _pair(fmt_name, graphs["rmat9"])
    assert got.footprint() == ref.footprint()
    assert got.footprint().summary() == ref.footprint().summary()
    assert got.edge_slots == ref.edge_slots
    assert got.layer_bytes() == ref.layer_bytes()
    assert got.n_vertices_padded == ref.n_vertices_padded
    assert got.sentinel == ref.sentinel
    for packed in (True, False):
        assert got.mask_bytes(packed) == ref.mask_bytes(packed)
        assert got.plan_mask_bytes(packed) == ref.plan_mask_bytes(packed)
        for tile in (1, 3, 128, 1024):
            assert got.tile_bytes(tile) == ref.tile_bytes(tile)
            assert got.plan_bytes(tile, packed) == ref.plan_bytes(tile,
                                                                  packed)
    stats = [t_engine.LayerStats(i, 1, 2, 3, active_tiles=5 * i + 1)
             for i in range(4)]
    ref_stats = [ref_engine.LayerStats(*s) for s in stats]
    for pipeline in ("fused_gather", "materialized"):
        assert traversal_bytes(got, stats, tile=2, pipeline=pipeline) == \
            ref_traversal_bytes(ref, ref_stats, tile=2, pipeline=pipeline)
    assert membership_bytes(got, stats) == ref_membership_bytes(ref,
                                                                ref_stats)


def test_formats_are_graph_formats_with_the_reference_flags(graphs):
    for name in formats.available():
        cls, ref_cls = registry.get(name), ref_registry.get(name)
        assert issubclass(cls, formats.GraphFormat)
        for flag in ("supports_prefetch", "supports_megakernel",
                     "supports_persistent", "persistent_algorithms"):
            assert getattr(cls, flag) == getattr(ref_cls, flag), (name, flag)


def test_sell_validate_structure_rejects_out_of_range_ids(graphs):
    from repro_torch.errors import GraphValidationError
    fmt = formats.SellFormat.from_csr(to_port(graphs["star"]), sigma=128)
    assert fmt.validate_structure() is fmt
    bad = formats.SellFormat(fmt.cols.clone(), fmt.slab_rows, fmt.deg,
                             fmt.n_vertices, fmt.n_edges, fmt.sigma,
                             fmt.nnz_stored)
    bad.cols[0, 0, 0] = fmt.n_vertices + 1
    with pytest.raises(GraphValidationError, match="SELL cols"):
        bad.validate_structure()


# ---------------------------------------------------------------------------
# Spec validation reads the format's flags (the reference's messages)
# ---------------------------------------------------------------------------

def _messages(ref_fmt, got_fmt, **fields):
    with pytest.raises(ValueError) as ref:
        RefSpec(**fields).validate(ref_fmt)
    with pytest.raises(ValueError) as got:
        tbfs.plan(got_fmt, tbfs.TraversalSpec(**fields), device="cpu")
    return str(ref.value), str(got.value)


@pytest.mark.parametrize("fields", [
    dict(prefetch_depth=2), dict(pipeline="megakernel"),
    dict(pipeline="persistent")], ids=["prefetch", "megakernel",
                                       "persistent"])
def test_bitmap_rejects_what_it_cannot_run(graphs, fields):
    ref_fmt, got_fmt = _pair("bitmap", graphs["rmat9"])
    ref_msg, got_msg = _messages(ref_fmt, got_fmt, **fields)
    assert got_msg == ref_msg


def test_sell_persistent_rejects_nonsimd(graphs):
    ref_fmt, got_fmt = _pair("sell", graphs["rmat9"])
    ref_msg, got_msg = _messages(ref_fmt, got_fmt, pipeline="persistent",
                                 algorithm="nonsimd")
    assert got_msg == ref_msg
    assert "honors algorithm in ('simd',)" in got_msg


def test_unported_values_name_the_formats(graphs):
    """``packed=False``, the last value that was not ported, now
    validates, resolves and runs on each of the three formats, with the
    packed arm's visited sets and depths."""
    tbfs.TraversalSpec(packed=False).validate()
    roots = FORMAT_ROOTS["rmat9"][1]
    for name in ("csr", "sell", "bitmap"):
        _, fmt = _pair(name, graphs["rmat9"])
        ct = tbfs.plan(fmt, tbfs.TraversalSpec(packed=False), device="cpu")
        assert ct.resolved.packed is False
        got = ct.run_batched(roots)
        want = tbfs.plan(fmt, tbfs.TraversalSpec(),
                         device="cpu").run_batched(roots)
        assert torch.equal(got.state.visited, want.state.visited)
        assert torch.equal(got.depths, want.depths)


# ---------------------------------------------------------------------------
# The bitmap format end to end: parents bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy_index", range(4), ids=POLICY_IDS)
@pytest.mark.parametrize("graph_name", GRAPHS)
def test_bitmap_format_matches_reference(graphs, graph_name, policy_index):
    """Visited, frontier, depths, layers, the whole stats buffer, the
    direction log and P itself bitwise equal to the reference's bitmap
    traversal (its lowest-id parents are deterministic)."""
    g = graphs[graph_name]
    roots = FORMAT_ROOTS[graph_name][1]
    ref_pol, t_pol = POLICY_PAIRS[policy_index]
    ref_fmt, got_fmt = _pair("bitmap", g)
    ct = ref_plan.plan(ref_fmt, RefSpec(policy=ref_pol, algorithm="simd",
                                        pipeline="fused_gather",
                                        prefetch_depth=0, packed=True,
                                        max_layers=128))
    ref = ct.run_batched(np.asarray(roots, np.int32))
    got = tbfs.plan(got_fmt, tbfs.TraversalSpec(
        policy=t_pol, tile=ct.resolved.tile, max_layers=128),
        device="cpu").run_batched(roots)
    np.testing.assert_array_equal(got.stats.numpy(), np.asarray(ref.stats))
    np.testing.assert_array_equal(got.state.parent.numpy(),
                                  np.asarray(ref.state.parent))
    np.testing.assert_array_equal(words_np(got.state.visited),
                                  np.asarray(ref.state.visited))
    np.testing.assert_array_equal(words_np(got.state.frontier),
                                  np.asarray(ref.state.frontier))
    np.testing.assert_array_equal(got.depths.numpy(), np.asarray(ref.depths))
    assert int(got.state.layer) == int(ref.state.layer)
    assert tbfs.direction_log(got) == ref_engine.direction_log(ref)
