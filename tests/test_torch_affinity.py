"""The geometry-keyed affinity table (`repro_torch.formats.affinity`)
against the reference's (`repro.formats.affinity`), on the CPU.

One temporary table JSON is handed to both packages (each module's own
`_table_path`, monkeypatched here; the reference is not edited).  Held
equal: `key_for` over every knob kind; `geometry_class` on R-MAT graphs
at SCALE 8 and 10, a path, the 64 x 64 torus of the sweep, a star and a
dense graph; `resolve` for every knob through each precedence tier
(``REPRO_BFS_TILE`` valid, below 128 and not an integer; geometry rows;
flat rows only; a missing table; malformed rows and a malformed file);
`TraversalSpec().resolve` field by field with the same degrade events
under tables that pick each pipeline and depth (the reference only
resolves here, so its ``TPUMemorySpace`` paths are never reached); σ
and ``nnz_stored`` of ``SellFormat.from_csr`` under a σ row; a graph on
``meta`` tensors (the port) and a traced graph (the reference), which
classify as None and fall through to the flat and default tiers.  Last,
the serve tier and the Graph500 harness on an all-auto spec under a
table that picks ``persistent``, held to `bfs_serial`.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.spec import TraversalSpec as RefSpec
from repro.core import bfs_serial as ref_serial
from repro.core import csr as ref_csr
from repro.core.rmat import EdgeList
from repro.formats import affinity as ref_aff
from repro.formats.bitmap_format import BitmapCompressedFormat as RefBitmap
from repro.formats.csr_format import CsrFormat as RefCsrFormat
from repro.formats.sell import SellFormat as RefSell
from repro.obs import metrics as ref_metrics

from _torch_parity import (csr_from_pairs, path_graph, rmat_graph,
                           star_graph, to_port)
import repro_torch.bfs as tbfs
from repro_torch.core.stats import run_harness
from repro_torch.core.validate import validate
from repro_torch.formats import affinity as t_aff
from repro_torch.formats.bitmap_format import BitmapCompressedFormat
from repro_torch.formats.csr_format import CsrFormat
from repro_torch.formats.sell import SellFormat
from repro_torch.obs import metrics as t_metrics
from repro_torch.serve import graph_engine as t_ge

TORUS_SIDE = 64


def torus_graph(side=TORUS_SIDE):
    """The reference sweep's 4-regular 2-D torus (class skew1)."""
    v = side * side
    idx = np.arange(v, dtype=np.int32)
    x, y = idx % side, idx // side
    right = (x + 1) % side + y * side
    down = x + (y + 1) % side * side
    src = np.concatenate([idx, idx])
    dst = np.concatenate([right, down])
    return ref_csr.from_edges(EdgeList(
        src=jnp.asarray(np.concatenate([src, dst])),
        dst=jnp.asarray(np.concatenate([dst, src])), n_vertices=v))


def dense_graph(n=48):
    """Every pair joined: density ~1 (class dense)."""
    return csr_from_pairs([(a, b) for a in range(n)
                           for b in range(a + 1, n)], n)


BUILDERS = {
    "rmat8": lambda: rmat_graph(scale=8),
    "rmat10": lambda: rmat_graph(scale=10),
    "path": path_graph,
    "torus": torus_graph,
    "star": star_graph,
    "dense": dense_graph,
}


@pytest.fixture(scope="module")
def graphs():
    """Reference Csrs, built once, with their port counterparts."""
    out = {}
    for name, build in BUILDERS.items():
        g = build()
        out[name] = (g, to_port(g))
    return out


@pytest.fixture
def table(tmp_path, monkeypatch):
    """``table(rows)`` writes ``rows`` (a dict, a string, or None for no
    file) and points both packages at it; the caches are cleared."""
    monkeypatch.delenv("REPRO_BFS_TILE", raising=False)
    path = tmp_path / "affinity_table.json"
    monkeypatch.setattr(ref_aff, "_table_path", lambda: path)
    monkeypatch.setattr(t_aff, "_table_path", lambda: path)

    def write(rows):
        if path.exists():
            path.unlink()
        if rows is not None:
            path.write_text(rows if isinstance(rows, str)
                            else json.dumps(rows))
        ref_aff.clear_cache()
        t_aff.clear_cache()
    write(None)
    yield write
    ref_aff.clear_cache()
    t_aff.clear_cache()


def row(us):
    return {"us_per_call": us, "derived": "test"}


# -- key_for ------------------------------------------------------------------

@pytest.mark.parametrize("fmt,geom,knob,value", [
    ("csr", "skew64", "tile", 4096),
    ("csr", "skew1", "prefetch_depth", 2),
    ("csr", "skew16", "pipeline", "persistent"),
    ("csr", "skew4", "persistent_prefetch", 1),
    ("sell", "skew64", "sigma", 1024),
    ("sell", "dense", "policy", "beamer"),
    ("bitmap", "dense", "algorithm", "nonsimd"),
    ("csr", "skew64", "packed", 0),
    ("csr", "skew64", "max_layers", 128),
    ("csr", "skew64", "merge", "owner"),
])
def test_key_for_matches_reference(fmt, geom, knob, value):
    assert t_aff.key_for(fmt, geom, knob, value) \
        == ref_aff.key_for(fmt, geom, knob, value)


# -- geometry_class -----------------------------------------------------------

@pytest.mark.parametrize("name,want", [
    ("rmat8", None), ("rmat10", "skew64"), ("path", "skew1"),
    ("torus", "skew1"), ("star", None), ("dense", "dense")])
def test_geometry_class_matches_reference(graphs, table, name, want):
    g, gt = graphs[name]
    got = {}
    for label, ref_graph, port_graph in (
            ("csr", g, gt),
            ("csr_format", RefCsrFormat.from_csr(g), CsrFormat.from_csr(gt)),
            ("sell", RefSell.from_csr(g, sigma=1024),
             SellFormat.from_csr(gt, sigma=1024))):
        ref_aff.clear_cache()
        t_aff.clear_cache()
        ref_geom = ref_aff.geometry_class(ref_graph)
        assert t_aff.geometry_class(port_graph) == ref_geom, label
        got[label] = ref_geom
    if want is not None:
        assert got["csr"] == want


# -- resolve: every knob, every tier ------------------------------------------

#: knob -> (default, the rows' values, lowest first)
KNOBS = {
    "tile": (1024, (4096, 512)),
    "prefetch_depth": (0, (2, 1)),
    "pipeline": ("fused_gather", ("persistent", "megakernel")),
    "sigma": (1024, (4096, 256)),
    "policy": (None, ("beamer", "topdown")),
    "algorithm": ("simd", ("nonsimd", "simd")),
    "packed": (True, (0, 1)),
    "max_layers": (64, (128, 96)),
    "merge": ("packed", ("owner", "allreduce")),
}
TIERS = ("geometry", "flat_only", "missing_table", "malformed_rows",
         "malformed_file", "other_class")


def _rows_for(tier, geom, knob, values):
    if tier == "missing_table":
        return None
    if tier == "malformed_file":
        return "{not json"
    flat = {f"affinity.tile{v}": row(10.0 + i)
            for i, v in enumerate((2048, 256))}
    if tier == "flat_only":
        return flat
    klass = geom if tier != "other_class" else "skew4"
    rows = dict(flat)
    for i, v in enumerate(values):
        rows[ref_aff.key_for("csr", klass, knob, v)] = row(1.0 + i)
    if tier == "malformed_rows":
        token = ref_aff.key_for("csr", klass, knob, "")
        rows[token + "notanumber"] = row(0.1)
        rows[ref_aff.key_for("csr", klass, knob, values[1])] = \
            {"us_per_call": "fast"}
        rows[token[:-1] + "x"] = row(0.2)
        rows[ref_aff.key_for("csr", klass, knob, 7)] = {"derived": "x"}
        rows["affinity.csr"] = [1, 2]
    return rows


@pytest.mark.parametrize("knob", list(KNOBS))
@pytest.mark.parametrize("tier", TIERS)
def test_resolve_matches_reference(graphs, table, knob, tier):
    g, gt = graphs["rmat10"]
    ref_fmt, t_fmt = RefCsrFormat.from_csr(g), CsrFormat.from_csr(gt)
    geom = ref_aff.geometry_class(ref_fmt)
    default, values = KNOBS[knob]
    table(_rows_for(tier, geom, knob, values))
    want = ref_aff.resolve(ref_fmt, knob, default)
    assert t_aff.resolve(t_fmt, knob, default) == want
    # the same with a format name given for a Csr, and with no graph
    assert t_aff.resolve(gt, knob, default, fmt_name="csr") \
        == ref_aff.resolve(g, knob, default, fmt_name="csr") == want
    assert t_aff.resolve(None, knob, default) \
        == ref_aff.resolve(None, knob, default)
    if tier == "geometry":
        assert want == values[0]


@pytest.mark.parametrize("env,want", [("4096", 4096), ("64", 128),
                                      ("2048 ", 2048), ("abc", None)])
def test_resolve_tile_env_matches_reference(graphs, table, monkeypatch,
                                            env, want):
    g, gt = graphs["rmat10"]
    ref_fmt, t_fmt = RefCsrFormat.from_csr(g), CsrFormat.from_csr(gt)
    table({ref_aff.key_for("csr", ref_aff.geometry_class(ref_fmt), "tile",
                           512): row(1.0), "affinity.tile256": row(1.0)})
    monkeypatch.setenv("REPRO_BFS_TILE", env)
    if want is None:
        with pytest.raises(ValueError) as ref_err:
            ref_aff.resolve(ref_fmt, "tile", 1024)
        with pytest.raises(ValueError) as t_err:
            t_aff.resolve(t_fmt, "tile", 1024)
        assert str(t_err.value) == str(ref_err.value)
        return
    assert t_aff.resolve(t_fmt, "tile", 1024) \
        == ref_aff.resolve(ref_fmt, "tile", 1024) == want
    # the env var is the tile's lever only
    assert t_aff.resolve(t_fmt, "sigma", 1024) \
        == ref_aff.resolve(ref_fmt, "sigma", 1024)


# -- TraversalSpec.resolve ----------------------------------------------------

def _formats(g, gt, name):
    if name == "csr":
        return RefCsrFormat.from_csr(g), CsrFormat.from_csr(gt)
    if name == "sell":
        return RefSell.from_csr(g), SellFormat.from_csr(gt)
    return RefBitmap.from_csr(g), BitmapCompressedFormat.from_csr(gt)


def _fields(spec):
    d = {f: getattr(spec, f) for f in spec.field_names()}
    p = d.pop("policy")
    d["policy"] = (type(p).__name__, tuple(sorted(
        (k, v) for k, v in vars(p).items())))
    return d


def _events(log):
    return [(e.site, e.reason, e.fallback) for e in log()]


@pytest.mark.parametrize("fmt_name", ["csr", "sell", "bitmap"])
@pytest.mark.parametrize("pipeline,depth", [
    ("fused_gather", 0), ("megakernel", 1), ("persistent", 2),
    ("materialized", 0), (None, 2)])
@pytest.mark.parametrize("algorithm", ["auto", "nonsimd", "sssp"])
def test_spec_resolve_matches_reference(graphs, table, fmt_name, pipeline,
                                        depth, algorithm):
    g, gt = graphs["rmat8"]
    ref_fmt, t_fmt = _formats(g, gt, fmt_name)
    geom = ref_aff.geometry_class(ref_fmt)
    rows = {ref_aff.key_for(fmt_name, geom, "prefetch_depth", depth):
            row(1.0),
            ref_aff.key_for(fmt_name, geom, "tile", 512): row(1.0),
            ref_aff.key_for(fmt_name, geom, "max_layers", 96): row(1.0)}
    if pipeline is not None:
        rows[ref_aff.key_for(fmt_name, geom, "pipeline", pipeline)] = \
            row(1.0)
    table(rows)
    kw = {} if algorithm == "auto" else {"algorithm": algorithm}
    outcome = []
    for spec_cls, fmt, log, clear in (
            (RefSpec, ref_fmt, ref_metrics.degrade_log,
             ref_metrics.clear_degrade_log),
            (tbfs.TraversalSpec, t_fmt, t_metrics.degrade_log,
             t_metrics.clear_degrade_log)):
        clear()
        try:
            got = _fields(spec_cls(**kw).resolve(fmt))
            if fmt_name != "csr":
                # SELL's tile (slabs per group) is the port's own rule,
                # not a table knob (`SellFormat.resolve_tile`)
                got.pop("tile")
        except ValueError as e:
            got = ("ValueError", str(e))
        outcome.append((got, _events(log)))
        clear()
    assert outcome[1] == outcome[0]


@pytest.mark.parametrize("fmt_name", ["csr", "sell"])
def test_spec_resolve_policy_row_matches_reference(graphs, table,
                                                   fmt_name):
    g, gt = graphs["torus"]
    ref_fmt, t_fmt = _formats(g, gt, fmt_name)
    geom = ref_aff.geometry_class(ref_fmt)
    def fields(spec, fmt):
        d = _fields(spec.resolve(fmt))
        if fmt_name != "csr":
            d.pop("tile")           # the port's own SELL rule
        return d

    want = fields(RefSpec(), ref_fmt)
    assert fields(tbfs.TraversalSpec(), t_fmt) == want
    assert want["policy"][0] == "ThresholdSimd"      # skew1: no skew
    table({ref_aff.key_for(fmt_name, geom, "policy", "topdown"): row(1.0),
           ref_aff.key_for(fmt_name, geom, "merge", "owner"): row(1.0),
           ref_aff.key_for(fmt_name, geom, "packed", 0): row(1.0)})
    want = fields(RefSpec(), ref_fmt)
    assert fields(tbfs.TraversalSpec(), t_fmt) == want
    assert want["policy"][0] == "TopDown" and want["merge"] == "owner" \
        and want["packed"] is False


# -- SELL's auto σ ------------------------------------------------------------

@pytest.mark.parametrize("sigmas", [(256, 4096), (4096, 256), (1024,), ()])
def test_sell_sigma_from_table_matches_reference(graphs, table, sigmas):
    g, gt = graphs["rmat10"]
    geom = ref_aff.geometry_class(g)
    table({ref_aff.key_for("sell", geom, "sigma", s): row(1.0 + i)
           for i, s in enumerate(sigmas)})
    ref_fmt, t_fmt = RefSell.from_csr(g), SellFormat.from_csr(gt)
    assert (t_fmt.sigma, t_fmt.nnz_stored) \
        == (ref_fmt.sigma, ref_fmt.nnz_stored)
    np.testing.assert_array_equal(t_fmt.cols.numpy(),
                                  np.asarray(ref_fmt.cols))


# -- graphs with no degrees to read -------------------------------------------

@pytest.mark.parametrize("rows", ["flat", "none"])
def test_meta_graph_falls_through(graphs, table, rows):
    """A port graph on meta tensors classifies as None, as a traced
    reference graph does, and resolves from the flat and default tiers;
    once a real graph of the same shapes has been classified, both hit
    the class memo (classes are memoized by shape)."""
    g, gt = graphs["rmat10"]
    geom = ref_aff.geometry_class(g)
    flat = {"affinity.tile256": row(1.0),
            ref_aff.key_for("csr", geom, "tile", 4096): row(1.0)}
    table(flat if rows == "flat" else None)
    meta = CsrFormat(gt.colstarts.to("meta"), gt.rows.to("meta"),
                     gt.n_vertices, gt.n_edges)
    seen = {}

    def trace():
        def traced(rows_, colstarts):   # a new function: traced anew
            fmt = RefCsrFormat(colstarts, rows_, g.n_vertices, g.n_edges)
            seen["geom"] = ref_aff.geometry_class(fmt)
            seen["tile"] = ref_aff.resolve(fmt, "tile", 1024)
            return rows_
        jax.jit(traced)(g.rows, g.colstarts)

    ref_aff.clear_cache()
    t_aff.clear_cache()
    trace()
    assert t_aff.geometry_class(meta) is seen["geom"] is None
    assert t_aff.resolve(meta, "tile", 1024) == seen["tile"] \
        == (256 if rows == "flat" else 1024)
    # the memo by shape: a real graph of these shapes classified first
    t_aff.geometry_class(CsrFormat.from_csr(gt))
    ref_aff.geometry_class(RefCsrFormat.from_csr(g))
    trace()
    assert t_aff.geometry_class(meta) == seen["geom"] == geom
    assert t_aff.resolve(meta, "tile", 1024) == seen["tile"] \
        == (4096 if rows == "flat" else 1024)


# -- the serve tier and the harness on a table that picks persistent ----------

def test_serve_and_harness_on_a_persistent_row(graphs, table):
    g, gt = graphs["rmat10"]
    geom = t_aff.geometry_class(CsrFormat.from_csr(gt))
    table({t_aff.key_for("csr", geom, "pipeline", "persistent"): row(1.0),
           t_aff.key_for("csr", geom, "pipeline", "fused_gather"):
           row(2.0),
           t_aff.key_for("csr", geom, "prefetch_depth", 1): row(1.0)})
    assert tbfs.plan(gt, device="cpu").resolved.pipeline == "persistent"
    rows, cs = np.asarray(g.rows), np.asarray(g.colstarts)

    def oracle(root):
        return ref_serial.bfs_serial(rows, cs, g.n_vertices, root)[1]

    roots = [1, 17, 300, 1000]
    eng = t_ge.GraphEngine(gt, batch_slots=2, graph_format="csr",
                           spec=tbfs.TraversalSpec(), device="cpu")
    assert eng.compiled.resolved.pipeline == "persistent"
    for i, r in enumerate(roots):
        eng.submit(t_ge.BfsQuery(uid=i, root=r))
    eng.run_until_done()
    assert sorted(q.uid for q in eng.finished) == list(range(len(roots)))
    for q in eng.finished:
        assert q.done and q.error is None
        assert validate(gt, torch.from_numpy(q.parent), q.root,
                        reference_depth=oracle(q.root)).ok, q.root
    res = run_harness(
        gt, lambda c, r: tbfs.plan(c, device="cpu").run(r).state,
        roots=roots, validate_runs=True, reference_depths_fn=oracle)
    assert [run.valid for run in res.runs] == [True] * len(roots)
    assert [run.reached for run in res.runs] \
        == [int((oracle(r) >= 0).sum()) for r in roots]
