"""The port's observability (`repro_torch.obs`) held against the
reference's (`repro.obs`), case by case of ``tests/test_obs.py``: the
span tracer, the metrics registry (the same operations give the same
snapshot and Prometheus text, wall times masked), the degrade record,
`trace_run` on each of its three branches (LayerStats rows, depths and
spans equal to the reference's, durations masked), the analytic bytes
model and `measure_drift`'s rows."""
import json
import logging
import math
import re

import jax
import numpy as np
import pytest
import torch

from repro.api import plan as ref_plan
from repro.api.spec import TraversalSpec as RefSpec
from repro.core import csr as ref_csr
from repro.core import rmat as ref_rmat
from repro.formats import build as ref_build
from repro.obs import cost_drift as ref_cd
from repro.obs import metrics as ref_metrics
from repro.obs import trace as ref_trace

from _torch_parity import (POLICY_IDS, POLICY_PAIRS, cuda_device,  # noqa: F401
                           ref_spec, to_port)
import repro_torch.bfs as tbfs
from repro_torch import formats, obs
from repro_torch.core.bfs_serial import bfs_serial
from repro_torch.core.validate import validate
from repro_torch.kernels import ops
from repro_torch.obs import cost_drift, metrics, trace
from _torch_parity import builtin_knobs  # noqa: F401

# the reference's pinned fused_gather depth-0 results hold the port's
# built-in knobs, not the affinity table's picks
pytestmark = pytest.mark.usefixtures("builtin_knobs")

ROOTS = [0, 5, 17]


@pytest.fixture(scope="module")
def g8():
    return ref_csr.from_edges(
        ref_rmat.generate(jax.random.PRNGKey(7), scale=8, edgefactor=8))


# -- SpanTracer ---------------------------------------------------------------

def _spans(tracer):
    """(name, args) of each span in closing order, durations masked."""
    return [(s.name, s.args) for s in tracer.spans]


def test_span_nesting_and_order():
    got = {}
    for name, mod in (("ref", ref_trace), ("port", trace)):
        tr = mod.SpanTracer()
        with tr.span("outer", kind="o") as o:
            with tr.span("inner"):
                pass
            o.args["amended"] = 1
        assert len(tr) == 2
        inner, outer = tr.spans            # closed innermost-first
        assert outer.ts_us <= inner.ts_us
        assert inner.ts_us + inner.dur_us <= outer.ts_us + outer.dur_us + 1
        got[name] = _spans(tr)
    assert got["port"] == got["ref"] == [
        ("inner", {}), ("outer", {"kind": "o", "amended": 1})]


def test_chrome_export_parses(tmp_path):
    docs = {}
    for name, mod in (("ref", ref_trace), ("port", trace)):
        tr = mod.SpanTracer()
        with tr.span("a", x=1):
            pass
        path = tr.export(str(tmp_path / f"{name}.json"))
        doc = json.loads(open(path).read())
        for ev in doc["traceEvents"][1:]:
            ev["ts"] = ev["dur"] = None
        docs[name] = doc
    assert docs["port"] == docs["ref"]
    meta, ev = docs["port"]["traceEvents"]
    assert meta["ph"] == "M" and meta["args"]["name"] == "repro.bfs"
    assert ev["name"] == "a" and ev["ph"] == "X" and ev["args"] == {"x": 1}


def test_device_sync_modes():
    x = torch.ones(4)
    trace.SpanTracer(sync=True).device_sync(x)     # CPU: nothing to wait
    trace.SpanTracer(sync=False).device_sync(x)    # no-op


def test_torch_profiler_noop_without_logdir(tmp_path):
    with trace.torch_profiler(None) as ld:
        assert ld is None
    with trace.torch_profiler(str(tmp_path)) as ld:
        torch.ones(8).sum()
    assert ld == str(tmp_path)
    (path,) = tmp_path.glob("bfs_trace_*.json")
    assert "traceEvents" in json.loads(path.read_text())


# -- metrics ------------------------------------------------------------------

def test_counter_gauge_histogram_match_reference():
    for mod in (ref_metrics, metrics):
        c = mod.Counter("c")
        c.inc()
        c.inc(2.5)
        assert c.value == 3.5
        with pytest.raises(ValueError):
            c.inc(-1)
        g = mod.Gauge("g")
        g.set(5)
        g.dec(2)
        g.inc(0.5)
        assert g.value == 3.5
    hists = []
    for mod in (ref_metrics, metrics):
        h = mod.Histogram("h")
        assert math.isnan(h.percentile(0.5))
        for v in [5, 1, 3, 2, 4]:
            h.observe(v)
        assert (h.count, h.sum, h.min, h.max) == (5, 15.0, 1.0, 5.0)
        hists.append((h.summary(), h.percentile(0.5), h.percentile(0.99)))
    assert hists[0] == hists[1]
    assert hists[1][1:] == (3.0, 5.0)


def test_histogram_reservoir_and_timer_match_reference():
    got = []
    for mod in (ref_metrics, metrics):
        h = mod.Histogram("h", reservoir=4)
        for v in range(10):
            h.observe(v)
        t = mod.Histogram("t")
        with t.time():
            pass
        assert t.count == 1 and t.sum >= 0
        got.append((h.count, h.min, h.max, h.percentile(0.5), h.summary()))
    assert got[0] == got[1]
    assert got[1][3] >= 6                    # window holds 6..9 only


def _registry_ops(mod):
    """One fixed sequence of registry operations; returns the registry
    and the names of its wall-time metrics."""
    reg = mod.MetricsRegistry()
    assert reg.counter("x") is reg.counter("x")
    with pytest.raises(TypeError):
        reg.gauge("x")
    assert "x" in reg and "y" not in reg
    reg.clear()
    assert "x" not in reg
    reg.counter("a.b", "help").inc(2)
    reg.gauge("c-d").set(1.5)
    reg.gauge("c-d").dec(0.25)
    for v in (0.25, 0.5, 0.125):
        reg.histogram("lat").observe(v)
    reg.histogram("never")
    with reg.histogram("wall_s").time():
        sum(range(100))
    return reg, ("wall_s",)


def test_registry_snapshot_and_prometheus_match_reference():
    (ref, wall), (got, _) = _registry_ops(ref_metrics), \
        _registry_ops(metrics)
    snaps = []
    for reg in (ref, got):
        snap = reg.snapshot()
        assert snap == json.loads(json.dumps(snap))
        for name in wall:
            h = snap["histograms"][name]
            snap["histograms"][name] = {k: (v if k == "count" else None)
                                        for k, v in h.items()}
        snaps.append(snap)
    assert snaps[0] == snaps[1]
    assert snaps[1]["counters"]["a.b"] == 2.0
    assert snaps[1]["histograms"]["never"]["min"] is None
    assert snaps[1]["histograms"]["never"]["p99"] is None

    def masked(text):
        return re.sub(r"^(wall_s\S*) \S+$", r"\1 <t>", text, flags=re.M)
    assert masked(got.to_prometheus()) == masked(ref.to_prometheus())
    prom = got.to_prometheus()
    assert "# TYPE a_b counter" in prom and "a_b 2" in prom
    assert 'lat{quantile="0.5"} 0.25' in prom and "lat_count 3" in prom


def test_default_registry_is_shared():
    assert metrics.get_registry() is metrics.get_registry()
    assert obs.get_registry() is metrics.get_registry()


def test_degrade_record_matches_reference(caplog):
    events = []
    for name, mod in (("repro.serve", ref_metrics),
                      ("repro_torch.serve", metrics)):
        mod.clear_degrade_log()
        reg = mod.MetricsRegistry()
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger=name):
            for _ in range(3):
                mod.record_degrade("smem_fallback", "budget 10 > 8",
                                   "fused_gather", detail="tile=128",
                                   registry=reg)
            mod.record_degrade("pipeline_unsupported", "no encoding",
                               "megakernel", registry=reg)
        logged = [r.getMessage() for r in caplog.records if r.name == name]
        events.append((mod.degrade_log(), reg.snapshot(), logged))
        mod.clear_degrade_log()
        assert mod.degrade_log() == ()
    (r_log, r_snap, r_msgs), (t_log, t_snap, t_msgs) = events
    assert [tuple(vars(e).values()) for e in t_log] \
        == [tuple(vars(e).values()) for e in r_log]
    assert t_snap == r_snap
    assert t_snap["counters"]["serve.degrade.smem_fallback"] == 3
    assert t_msgs == r_msgs and len(t_msgs) == 2      # warn-once


# -- trace_run ----------------------------------------------------------------

def _ref_trace(g, roots, **spec):
    return ref_trace.trace_run(g, roots, spec=RefSpec(
        pipeline="fused_gather", prefetch_depth=0, **spec))


@pytest.mark.parametrize("roots", [ROOTS[1], ROOTS],
                         ids=["single", "batch"])
def test_trace_run_matches_reference(g8, roots):
    """Host-stepped branch: LayerStats rows, depths and every span's
    name and args equal the reference's; the trees are valid with
    bfs_serial's depths; the measure kernel's plain version counted the
    layers (one call per layer and one before the first)."""
    ref = _ref_trace(g8, roots)
    gt = to_port(g8)
    calls = []
    measure = ops.measure

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return measure(*a, **kw)
    ops.measure = counted
    try:
        got = trace.trace_run(gt, roots, device="cpu")
    finally:
        ops.measure = measure
    assert got.stats == ref.stats
    assert got.depths.tolist() == np.asarray(ref.depths).tolist()
    assert len(calls) == len(got.stats) + 1
    assert _spans(got.tracer) == _spans(ref.tracer)
    names = [s.name for s in got.tracer.spans]
    assert names.count(trace.TRAVERSAL_SPAN) == 1
    assert names.count(trace.LAYER_SPAN) == len(got.stats)
    assert names.count(trace.STEP_SPAN) == len(got.stats)
    assert len(got.layer_seconds) == len(got.stats)
    assert all(s >= 0 for s in got.layer_seconds)
    parents = tbfs.parents_graph500(got.state, gt.n_vertices)
    rows, cs = np.asarray(g8.rows), np.asarray(g8.colstarts)
    for b, root in enumerate(np.atleast_1d(roots)):
        p = parents if np.ndim(roots) == 0 else parents[b]
        _, depth = bfs_serial(rows, cs, g8.n_vertices, int(root))
        assert validate(gt, p, int(root), reference_depth=depth).ok
    doc = json.loads(json.dumps(got.tracer.to_chrome()))
    assert len(doc["traceEvents"]) == len(got.tracer) + 1


def test_trace_run_matches_fused_engine(g8):
    """The layer tick's counters equal the ThresholdSimd(0) traversal's
    stats columns 0-2 (the SIMD step on every layer)."""
    gt = to_port(g8)
    tr = tbfs.trace_run(gt, ROOTS, device="cpu")
    res = tbfs.plan(gt, tbfs.TraversalSpec(policy=tbfs.ThresholdSimd(0)),
                    device="cpu").run_batched(ROOTS)
    want = [tuple(s[:4]) for s in tbfs.layer_stats(res)]
    assert [tuple(s[:4]) for s in tr.stats] == want
    assert torch.equal(tr.state.visited, res.state.visited)
    assert torch.equal(tr.depths, res.depths)


def test_trace_run_persistent_is_one_span(g8):
    """The persistent branch: one span, counters from the kernel's stats
    buffer, equal to run_batched's and to the reference's fused_gather
    traversal (frontier, edges, discovered per layer)."""
    gt = to_port(g8)
    pol = POLICY_PAIRS[POLICY_IDS.index("BeamerHybrid")]
    ct_ref = ref_plan.plan(g8, ref_spec(pol[0]))
    ref = ct_ref.run_batched(np.asarray(ROOTS, np.int32))
    ct = tbfs.plan(gt, tbfs.TraversalSpec(policy=pol[1],
                                          pipeline="persistent",
                                          tile=ct_ref.resolved.tile,
                                          max_layers=128), device="cpu")
    tr = ct.trace_run(ROOTS)
    assert [s.name for s in tr.tracer.spans] == [trace.PERSISTENT_SPAN]
    res = ct.run_batched(ROOTS)
    assert tr.stats == tbfs.layer_stats(res)
    assert [tuple(s[:4]) for s in tr.stats] == \
        [tuple(s[:4]) for s in ct_ref.stats(ref)]
    top = tr.tracer.spans[0]
    assert top.args["n_layers"] == len(tr.stats) == len(tr.layer_seconds)
    assert top.args["launches"] == 1
    assert [d["discovered"] for d in top.args["layers"]] == \
        [s.discovered for s in tr.stats]
    assert tr.depths.tolist() == np.asarray(ref.depths).tolist()


def test_trace_run_semiring_is_one_span(g8):
    """The semiring branch: one span whose stats and args equal the
    reference's trace_run of the same ksource_bfs spec."""
    spec = dict(algorithm="ksource_bfs", policy="topdown", max_layers=128)
    ref = _ref_trace(g8, ROOTS, **spec)
    tile = ref_plan.plan(g8, RefSpec(pipeline="fused_gather",
                                     prefetch_depth=0, **spec)) \
        .resolved.tile
    ct = tbfs.plan(to_port(g8), tbfs.TraversalSpec(tile=tile, **spec),
                   device="cpu")
    got = trace.trace_run(ct, ROOTS)
    assert got.stats == ref.stats
    assert _spans(got.tracer) == _spans(ref.tracer)
    assert [s.name for s in got.tracer.spans] == [trace.SEMIRING_SPAN]
    assert got.depths.tolist() == np.asarray(ref.depths).tolist()


def test_trace_run_reuses_plan_and_tracer(g8):
    ct = tbfs.plan(to_port(g8), device="cpu")
    tracer = tbfs.SpanTracer()
    info = tbfs.plan_cache_info()
    tr = ct.trace_run(0, tracer=tracer)
    assert tr.tracer is tracer and len(tracer) > 0
    assert tbfs.plan_cache_info()["misses"] == info["misses"]
    assert tr.depths.ndim == 0


# -- cost drift (the analytic half) -------------------------------------------

def _ref_tile_count(ref_fmt, name: str, tile: int) -> int:
    """Tiles of one full sweep in the format's own unit: the reference
    counts ``ceil(edge_slots / tile)``, CSR's unit, for every format."""
    if name == "sell":
        return -(-ref_fmt.n_slabs // tile)
    if name == "bitmap":
        return 1
    return -(-ref_fmt.edge_slots // tile)


@pytest.mark.parametrize("name", ["csr", "sell", "bitmap"])
def test_analytic_layer_bytes_matches_reference(g8, name):
    """The reference's model, from the reference format's own
    ``tile_bytes`` and ``plan_bytes``, with the fused pipelines' tiles
    counted in the format's unit: the reference's figure itself for CSR
    and for ``materialized``; for SELL (a tile is slabs) and the bitmap
    (one tile, the matrix) the reference multiplies by a count in edge
    slots, which the port does not."""
    ref_fmt = ref_build(g8, name)
    fmt = formats.build(to_port(g8), name)
    for pipeline, tile in (("materialized", None), ("fused_gather", 256),
                           ("fused_gather", 1024), ("megakernel", 256)):
        want = ref_cd.analytic_layer_bytes(ref_fmt, pipeline=pipeline,
                                           tile=tile)
        got = cost_drift.analytic_layer_bytes(fmt, pipeline=pipeline,
                                              tile=tile)
        if pipeline != "materialized":
            slots = -(-ref_fmt.edge_slots // tile)
            assert want == ref_fmt.tile_bytes(tile) * slots \
                + ref_fmt.plan_bytes(tile, True)
            want = ref_fmt.tile_bytes(tile) \
                * _ref_tile_count(ref_fmt, name, tile) \
                + ref_fmt.plan_bytes(tile, True)
        assert got == want > 0, (pipeline, tile)
    with pytest.raises(ValueError):
        cost_drift.analytic_layer_bytes(fmt, pipeline="nope", tile=256)


def test_drift_rows_match_reference():
    rows = []
    for mod in (ref_cd, cost_drift):
        d = mod.Drift(format="csr", pipeline="fused_gather",
                      analytic_bytes=100, compiled_bytes=250.0,
                      hlo_bytes=120.0, tile=256)
        assert d.ratio == 2.5 and d.hlo_ratio == 1.2
        rows.append(mod.drift_rows([d]))
    assert rows[0] == rows[1]
    assert list(rows[1]) == ["obs.cost_drift.csr.fused_gather"]


@pytest.mark.parametrize("pipeline", ["fused_gather", "materialized"])
def test_measure_drift_matches_reference(g8, pipeline):
    """The port's rows carry the reference's keys, format, pipeline, tile
    and analytic bytes; its two measured counts are the analyzer's, every
    op's bytes above the distinct storages' (both > 0)."""
    (want,) = ref_cd.measure_drift(
        g8, RefSpec(prefetch_depth=0), pipelines=(pipeline,))
    (got,) = cost_drift.measure_drift(
        to_port(g8), tbfs.TraversalSpec(prefetch_depth=0, tile=want.tile),
        pipelines=(pipeline,), device="cpu")
    assert got._fields == want._fields
    assert (got.format, got.pipeline, got.tile, got.analytic_bytes) \
        == (want.format, want.pipeline, want.tile, want.analytic_bytes)
    assert got.compiled_bytes > got.hlo_bytes > 0
    assert got.ratio == got.compiled_bytes / got.analytic_bytes
    row = cost_drift.drift_rows([got])[f"obs.cost_drift.csr.{pipeline}"]
    assert set(row) == set(ref_cd.drift_rows([want])[
        f"obs.cost_drift.csr.{pipeline}"])
    assert cost_drift.measure_drift(
        to_port(g8), tbfs.TraversalSpec(prefetch_depth=0, tile=want.tile),
        pipelines=(pipeline,), device="cpu") == [got]     # deterministic


def test_measure_drift_counts_sell_tiles_in_slabs(g8):
    """SELL's fused row: the analytic figure counts slab groups, so the
    counted bytes sit within a small factor of it, as CSR's do (the
    reference's unit would put the ratio near 1/1024)."""
    sell = formats.SellFormat.from_csr(to_port(g8))
    (got,) = cost_drift.measure_drift(
        sell, tbfs.TraversalSpec(prefetch_depth=0),
        pipelines=("fused_gather",), device="cpu")
    assert got.format == "sell"
    assert got.analytic_bytes == sell.tile_bytes(got.tile) \
        * sell.tile_count(got.tile) + sell.plan_bytes(got.tile)
    assert got.compiled_bytes > got.hlo_bytes > 0
    assert 0.1 < got.ratio < 10, got


def test_obs_surface_matches_reference():
    import repro.obs as ref_obs
    want = set(ref_obs.__all__) - {"xla_profiler"}
    assert set(obs.__all__) == want | {"torch_profiler"}
    for name in obs.__all__:
        assert hasattr(obs, name)


# -- on the card ----------------------------------------------------------------

@pytest.mark.cuda
def test_trace_run_on_the_card(g8, cuda_device):
    """trace_run on the card equals the CPU run; its counters come from
    the measure kernel (no plain counter)."""
    from repro_torch.kernels import bitmap_kernels as bk
    gt = to_port(g8)
    want = tbfs.trace_run(gt, ROOTS, device="cpu")
    plain = bk.measure_plain
    bk.measure_plain = None           # any plain call fails
    try:
        got = tbfs.trace_run(gt, ROOTS, device=cuda_device)
    finally:
        bk.measure_plain = plain
    assert got.stats == want.stats
    assert torch.equal(got.state.visited.cpu(), want.state.visited)
    assert _spans(got.tracer) == _spans(want.tracer)
