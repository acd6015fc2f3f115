"""The port's public surface: spec dicts shared with the reference, every
reference value ported, the device rule, auto resolution, the plan
cache, the run() contracts, an `EdgeList` graph and import hygiene."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.bfs as ref_bfs
from repro.api.plan import check_roots as ref_check_roots
from repro.api.spec import TraversalSpec as RefSpec
from repro.core import engine as ref_engine
from repro.errors import GraphValidationError as RefGraphValidationError

from _torch_parity import path_graph, rmat_graph, to_port
import repro_torch.bfs as bfs
from repro_torch import interop
from repro_torch.api.plan import check_roots
from repro_torch.errors import GraphValidationError
from _torch_parity import builtin_knobs  # noqa: F401

# the reference's pinned fused_gather depth-0 results hold the port's
# built-in knobs, not the affinity table's picks
pytestmark = pytest.mark.usefixtures("builtin_knobs")

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def rmat():
    return to_port(rmat_graph(9))


SPECS = {
    "auto": lambda m: m.TraversalSpec(),
    "beamer_obj": lambda m: m.TraversalSpec(
        policy=m.BeamerHybrid(alpha=10.0, beta=20.0), algorithm="simd",
        pipeline="fused_gather", packed=True, tile=512, prefetch_depth=0,
        max_layers=32, merge="owner"),
    "paper_layers": lambda m: m.TraversalSpec(
        policy=m.PaperLiteralLayers((1, 3)), algorithm="nonsimd"),
    "threshold": lambda m: m.TraversalSpec(
        policy=m.ThresholdSimd(99), tile=128),
    "named": lambda m: m.TraversalSpec(policy="topdown", max_layers=7),
}


def _fields(spec):
    d = spec.to_dict()
    return {k: d[k] for k in sorted(d)}


@pytest.mark.parametrize("name", list(SPECS))
def test_spec_dict_round_trips_between_packages(name):
    t_spec = SPECS[name](bfs)
    r_spec = SPECS[name](ref_bfs)
    assert _fields(t_spec) == _fields(r_spec)
    assert bfs.TraversalSpec.from_dict(t_spec.to_dict()) == t_spec
    assert interop.spec_from_dict(r_spec.to_dict()) == t_spec
    assert _fields(RefSpec.from_dict(t_spec.to_dict())) == _fields(r_spec)


def test_resolved_spec_dict_loads_in_reference(rmat):
    resolved = bfs.plan(rmat, bfs.TraversalSpec(), device="cpu").resolved
    assert resolved.is_resolved
    back = RefSpec.from_dict(resolved.to_dict())
    assert back.is_resolved and back.pipeline == "fused_gather"
    assert type(back.policy).__name__ == type(resolved.policy).__name__


#: values ported since the parametrization below was written: they now
#: resolve and run (the fusion levels, K4-K6; the materialized pipeline,
#: K7; the semiring portfolio, K11-K12; the dense-mask arm) — all of them
PORTED = {("pipeline", "megakernel"), ("pipeline", "persistent"),
          ("prefetch_depth", 2), ("pipeline", "materialized"),
          ("algorithm", "sssp"), ("algorithm", "cc"),
          ("algorithm", "ksource_bfs"), ("packed", False)}


@pytest.mark.parametrize("field,value", [
    ("pipeline", "materialized"), ("pipeline", "megakernel"),
    ("pipeline", "persistent"), ("packed", False), ("prefetch_depth", 2),
    ("algorithm", "sssp"), ("algorithm", "cc"),
    ("algorithm", "ksource_bfs"),
])
def test_unported_values_raise_not_implemented(rmat, field, value):
    """Every value the reference accepts is ported (`PORTED`): it
    resolves, loads from a reference dict and runs on the CPU: the BFS
    pipelines and arms like the default pipeline, the portfolio with
    values and, but for cc (which labels every vertex), the default's
    reached set."""
    assert (field, value) in PORTED
    spec = bfs.TraversalSpec(**{field: value})
    ct = bfs.plan(rmat, spec, device="cpu")
    assert getattr(ct.resolved, field) == value
    assert bfs.TraversalSpec.from_dict(
        RefSpec(**{field: value}).to_dict()) == spec
    got = ct.run_batched([17, 3])
    base = bfs.plan(rmat, bfs.TraversalSpec(), device="cpu") \
        .run_batched([17, 3])
    if field == "algorithm":
        assert got.values is not None
        if value != "cc":
            assert torch.equal(got.state.visited, base.state.visited)
        return
    assert torch.equal(got.state.visited, base.state.visited)
    assert torch.equal(got.depths, base.depths)


@pytest.mark.parametrize("field,value", [
    ("policy", "bogus"), ("algorithm", "fast"), ("pipeline", "fused"),
    ("merge", "gossip"), ("packed", "yes"), ("tile", 0),
    ("tile", True), ("prefetch_depth", -1), ("max_layers", 0),
])
def test_invalid_values_raise_the_reference_message(field, value):
    with pytest.raises(ValueError) as ref_err:
        RefSpec(**{field: value}).validate()
    with pytest.raises(ValueError) as got_err:
        bfs.TraversalSpec(**{field: value}).validate()
    assert str(got_err.value) == str(ref_err.value)


def test_plan_default_device_needs_cuda(rmat):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bfs.plan(rmat)


def test_auto_resolution_uses_builtin_defaults(rmat):
    r = bfs.plan(rmat, device="cpu").resolved
    assert isinstance(r.policy, bfs.BeamerHybrid)      # skewed R-MAT
    assert (r.algorithm, r.pipeline, r.packed, r.prefetch_depth,
            r.max_layers, r.merge) == ("simd", "fused_gather", True, 0,
                                       64, "packed")
    path = bfs.plan(to_port(path_graph()), device="cpu").resolved
    assert isinstance(path.policy, bfs.ThresholdSimd)  # uniform degrees


@pytest.mark.parametrize("e_pad,tile,want", [
    (16384, "auto", 1024), (2048, "auto", 256), (256, "auto", 128),
    (128, "auto", 128), (16384, 64, 128), (16384, 4096, 4096),
])
def test_tile_rule(e_pad, tile, want):
    """1024 capped at e_pad/8, floored at 128 (the reference's rule off
    its affinity table and interpret floor)."""
    from repro_torch.formats.csr_format import CsrFormat
    fmt = CsrFormat(torch.zeros(2, dtype=torch.int32),
                    torch.zeros(e_pad, dtype=torch.int32), 1, 0)
    assert fmt.resolve_tile(None if tile == "auto" else tile) == want


def test_plan_cache_reuses_its_entry(rmat):
    bfs.clear_plan_cache()
    spec = bfs.TraversalSpec(policy="beamer", tile=256)
    a = bfs.plan(rmat, spec, device="cpu")
    b = bfs.plan(rmat, spec, device="cpu")
    assert a.executable is b.executable
    assert bfs.plan_cache_info() == {"size": 1, "hits": 1, "misses": 1}
    c = bfs.plan(rmat, spec.replace(merge="owner"), device="cpu")
    assert c.executable is a.executable           # merge is mesh-only
    other = to_port(rmat_graph(9))                # equal geometry, new arrays
    assert bfs.plan(other, spec, device="cpu").executable \
        is a.executable                           # keyed by geometry
    assert bfs.plan_cache_info() == {"size": 1, "hits": 3, "misses": 1}
    bfs.clear_plan_cache()
    assert bfs.plan_cache_info()["size"] == 0


def test_run_single_root_is_unbatched(rmat):
    ct = bfs.plan(rmat, bfs.TraversalSpec(policy="beamer"), device="cpu")
    one = ct.run(17)
    assert one.state.parent.ndim == 1 and one.depths.ndim == 0
    many = ct.run([17, 3])
    assert many.state.parent.shape[0] == 2
    assert torch.equal(many.state.visited[0], one.state.visited)
    assert ct.stats(one) == bfs.layer_stats(one)
    assert ct.direction_log(one)[0] == "topdown"


def test_fixed_batch_pads_and_slices(rmat):
    ct = bfs.plan(rmat, bfs.TraversalSpec(policy="beamer"), batch=4,
                  device="cpu")
    res = ct.run_batched([17, 3])
    assert res.state.parent.shape[0] == 2 and res.depths.shape == (2,)
    exact = bfs.plan(rmat, bfs.TraversalSpec(policy="beamer"),
                     device="cpu").run_batched([17, 3])
    assert torch.equal(res.state.visited, exact.state.visited)
    with pytest.raises(ValueError, match="batch=4"):
        ct.run_batched([1, 2, 3, 4, 5])


@pytest.mark.parametrize("roots", [[-1], [512], [1.5], np.array([np.nan]),
                                   np.array(["a"])])
def test_check_roots_matches_reference(roots):
    with pytest.raises(RefGraphValidationError) as ref_err:
        ref_check_roots(roots, 512)
    with pytest.raises(GraphValidationError) as got_err:
        check_roots(roots, 512)
    assert str(got_err.value) == str(ref_err.value)


def test_plan_takes_an_edge_list():
    """An `EdgeList` is built into a CSR on the plan's device, as the
    reference wraps one: the reference's result (stats, visited,
    depths, direction log)."""
    from repro.core import rmat as ref_rmat
    import jax
    from _torch_parity import ref_spec
    from repro_torch.core.rmat import EdgeList
    edges = ref_rmat.generate(jax.random.PRNGKey(5), scale=8,
                              edgefactor=8)
    ct = ref_bfs.plan(edges, ref_spec(ref_engine.BeamerHybrid()))
    ref = ct.run_batched(np.asarray([3, 9], np.int32))
    t_edges = EdgeList(torch.from_numpy(np.asarray(edges.src)),
                       torch.from_numpy(np.asarray(edges.dst)),
                       edges.n_vertices)
    got = bfs.plan(t_edges, bfs.TraversalSpec(
        policy=bfs.BeamerHybrid(), tile=ct.resolved.tile, max_layers=128),
        device="cpu").run_batched([3, 9])
    np.testing.assert_array_equal(got.stats.numpy(), np.asarray(ref.stats))
    np.testing.assert_array_equal(interop.words_to_numpy(got.state.visited),
                                  np.asarray(ref.state.visited))
    np.testing.assert_array_equal(got.depths.numpy(), np.asarray(ref.depths))
    assert bfs.direction_log(got) == ref_engine.direction_log(ref)


def test_plan_rejects_a_broken_graph():
    g = to_port(rmat_graph(8))
    bad = g._replace(colstarts=g.colstarts.flip(0))
    with pytest.raises(GraphValidationError):
        bfs.plan(bad, device="cpu")


def test_public_surface_is_a_subset_of_the_reference():
    assert bfs.__all__ == ref_bfs.__all__
    for name in bfs.__all__:
        assert hasattr(bfs, name)
    assert set(bfs.POLICIES) == set(ref_bfs.POLICIES)
    from repro_torch.core import engine as t_engine
    assert t_engine.MODE_NAMES == ref_engine.MODE_NAMES


def test_imports_without_jax_or_the_reference():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch, repro_torch.bfs, repro_torch.interop\n"
        "import repro_torch.kernels.ops, repro_torch.kernels._build\n"
        "import repro_torch.algorithms, repro_torch.algorithms.traversal\n"
        "bad = [m for m in sys.modules if m == 'repro' "
        "or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "from repro_torch.kernels import _build\n"
        "assert _build._LIB is None, 'import must not build kernels'\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code],
                         env={**os.environ,
                              "PYTHONPATH": str(REPO / "src")},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
