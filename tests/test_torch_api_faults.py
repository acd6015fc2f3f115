"""The public API held to the reference where the two packages had
differed: `TraversalSpec.resolve` of a graph, `TraversalSpec.validate`
with a format, `CompiledTraversal.traces`, a plan cache keyed by
geometry that holds no graph, and the LM names ``ServeEngine(greedy=)``,
``common.embedding_logits`` and ``transformer.ZERO_AUX``."""
from __future__ import annotations

import gc
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

import repro.bfs as ref_bfs
from repro.api import plan as ref_plan_mod
from repro.api.spec import TraversalSpec as RefSpec
from repro.core.rmat import EdgeList as RefEdgeList
from repro.formats import build as ref_build
from repro.formats.csr_format import CsrFormat as RefCsrFormat
from repro.models import common as ref_cm, transformer as ref_tf

from _torch_lm import models
from _torch_parity import csr_from_pairs, path_graph, rmat_graph, to_port
import repro_torch.bfs as bfs
from repro_torch import interop
from repro_torch.api import plan as plan_mod
from repro_torch.api.spec import TraversalSpec, as_format
from repro_torch.core.rmat import EdgeList
from repro_torch.formats import build
from repro_torch.formats.csr_format import CsrFormat
from repro_torch.models import common as cm, transformer as tf
from repro_torch.serve.engine import Request, ServeEngine
from _torch_parity import builtin_knobs  # noqa: F401

# the reference's pinned fused_gather depth-0 results hold the port's
# built-in knobs, not the affinity table's picks
pytestmark = pytest.mark.usefixtures("builtin_knobs")

#: the reference's auto pipeline reaches ``pltpu.TPUMemorySpace``, which
#: jax 0.9 lacks, so it runs the fused_gather arm at depth 0
REF_FIXED = dict(pipeline="fused_gather", prefetch_depth=0)


@pytest.fixture(scope="module")
def rmat():
    return rmat_graph(9)


# -- 1. resolve(graph) -----------------------------------------------------

@pytest.mark.parametrize("policy", ["auto", "topdown", "beamer"])
def test_resolve_takes_a_csr(rmat, policy):
    """Equal resolved specs.  The tile is given to both: the reference's
    auto tile reads its committed affinity rows, which the port does not
    (its tile is the format's rule)."""
    want = RefSpec(policy=policy, tile=512, **REF_FIXED).resolve(rmat)
    got = TraversalSpec(policy=policy, tile=512).resolve(to_port(rmat))
    assert got.to_dict() == want.to_dict()
    auto = TraversalSpec(policy=policy).resolve(to_port(rmat))
    assert auto.tile == as_format(to_port(rmat)).resolve_tile(None)
    assert auto.replace(tile=512) == got


def test_resolve_takes_an_edge_list():
    src = np.array([0, 1, 1, 2, 2, 3], np.int32)
    dst = np.array([1, 0, 2, 1, 3, 2], np.int32)
    ref_edges = RefEdgeList(jnp.asarray(src), jnp.asarray(dst), 4)
    edges = EdgeList(torch.from_numpy(src), torch.from_numpy(dst), 4)
    want = RefSpec(tile=128, **REF_FIXED).resolve(ref_edges).to_dict()
    assert TraversalSpec(tile=128).resolve(edges).to_dict() == want
    assert isinstance(as_format(edges), CsrFormat)


def test_as_format_is_where_the_reference_keeps_it(rmat):
    g = to_port(rmat)
    assert plan_mod.as_format is as_format
    assert as_format(g) is as_format(g)             # one view per Csr
    fmt = build(g, "csr")
    assert as_format(fmt) is fmt
    with pytest.raises(TypeError, match="cannot plan"):
        as_format(np.zeros(3))


# -- 2. validate(fmt) ------------------------------------------------------

class _NoMegaCsr(CsrFormat):
    supports_megakernel = False


class _NoPersistCsr(CsrFormat):
    supports_persistent = False


class _RefNoMegaCsr(RefCsrFormat):
    supports_megakernel = False


class _RefNoPersistCsr(RefCsrFormat):
    supports_persistent = False


#: (spec fields, layout, substring of the error or None): the reference's
#: cases in test_megakernel.py, test_persistent.py and test_algorithms.py
VALIDATE_CASES = [
    (dict(pipeline="megakernel"), "csr", None),
    (dict(pipeline="megakernel"), "sell", None),
    (dict(pipeline="megakernel"), "bitmap", "megakernel"),
    (dict(pipeline="megakernel"), "nomega", "supports_megakernel"),
    (dict(pipeline="persistent"), "csr", None),
    (dict(pipeline="persistent"), "sell", None),
    (dict(pipeline="persistent"), "bitmap", "supports_persistent"),
    (dict(pipeline="persistent"), "nopersist", "supports_persistent"),
    (dict(pipeline="persistent", algorithm="nonsimd"), "sell",
     "persistent_algorithms|honors algorithm"),
    (dict(pipeline="persistent", algorithm="nonsimd"), "csr", None),
    (dict(algorithm="sssp"), "bitmap", "supported_semirings"),
    (dict(algorithm="sssp"), "csr", None),
    (dict(prefetch_depth=2), "bitmap", "supports_prefetch"),
]


def _layouts(ref_g, g, name):
    if name == "nomega":
        return _RefNoMegaCsr.from_csr(ref_g), _NoMegaCsr.from_csr(g)
    if name == "nopersist":
        return _RefNoPersistCsr.from_csr(ref_g), _NoPersistCsr.from_csr(g)
    return ref_build(ref_g, name), build(g, name)


@pytest.mark.parametrize("fields,layout,match", VALIDATE_CASES)
def test_validate_with_a_format(rmat, fields, layout, match):
    ref_fmt, fmt = _layouts(rmat, to_port(rmat), layout)
    if match is None:
        RefSpec(**fields).validate(ref_fmt)
        assert TraversalSpec(**fields).validate(fmt).pipeline \
            == fields.get("pipeline", "auto")
        return
    with pytest.raises(ValueError, match=match) as want:
        RefSpec(**fields).validate(ref_fmt)
    with pytest.raises(ValueError, match=match) as got:
        TraversalSpec(**fields).validate(fmt)
    assert str(got.value) == str(want.value)


def test_validate_without_a_format_checks_values_only(rmat):
    spec = TraversalSpec(pipeline="megakernel")
    assert spec.validate() is spec
    bitmap = build(to_port(rmat), "bitmap")
    with pytest.raises(ValueError, match="megakernel"):
        spec.validate(bitmap)
    with pytest.raises(ValueError, match="unknown pipeline"):
        TraversalSpec(pipeline="warp").validate(bitmap)


# -- 3. traces ------------------------------------------------------------

def test_traces_one_across_many_runs(rmat):
    g = to_port(rmat)
    bfs.clear_plan_cache()
    spec = TraversalSpec(policy="topdown")
    ct = bfs.plan(g, spec, device="cpu")
    for root in range(4):
        ct.run(root)
    assert ct.traces == 1, "re-running one plan must build nothing"
    ct2 = bfs.plan(g, spec, device="cpu")
    assert ct2.executable is ct.executable
    ct2.run(11)
    assert ct.traces == ct2.traces == 1
    assert ct.executable.traces == 1          # one Csr: one view, bound once
    assert bfs.plan_cache_info() == {"size": 1, "hits": 1, "misses": 1}


def test_traces_with_a_padded_batch(rmat):
    bfs.clear_plan_cache()
    ref_plan_mod.clear_cache()
    ct = bfs.plan(to_port(rmat), TraversalSpec(policy="topdown"), batch=4,
                  device="cpu")
    ref = ref_bfs.plan(rmat, RefSpec(policy="topdown", **REF_FIXED),
                       batch=4)
    for roots in ([3, 7], [3, 7, 17, 100]):
        got, want = ct.run_batched(roots), ref.run_batched(roots)
        np.testing.assert_array_equal(got.depths.numpy(),
                                      np.asarray(want.depths))
    assert ct.traces == ref.traces == 1


def test_traces_zero_on_a_mesh_bound_plan(rmat, tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("x",))
        ct = bfs.plan(to_port(rmat), TraversalSpec(merge="owner"),
                      device="cpu", mesh=mesh)
        ct.run(3)
        assert ct.executable is None and ct.traces == 0
    finally:
        dist.destroy_process_group()


# -- 4. a graph-free plan cache -------------------------------------------

def _relabelled_path(n=96):
    """The path graph with its vertices shuffled: another graph of the
    same geometry."""
    perm = np.random.default_rng(0).permutation(n).tolist()
    return csr_from_pairs([(perm[i], perm[i + 1]) for i in range(n - 1)], n)


def test_cache_keys_on_geometry(rmat):
    a_ref, b_ref = path_graph(96), _relabelled_path(96)
    bfs.clear_plan_cache()
    spec = TraversalSpec(policy="topdown")
    roots = [0, 5, 47, 95]
    results = []
    for g_ref in (a_ref, b_ref):
        ct = bfs.plan(to_port(g_ref), spec, device="cpu")
        got = ct.run_batched(roots)
        want = ref_bfs.plan(g_ref, RefSpec(policy="topdown", **REF_FIXED)) \
            .run_batched(roots)
        np.testing.assert_array_equal(got.depths.numpy(),
                                      np.asarray(want.depths))
        np.testing.assert_array_equal(
            interop.to_numpy(got.state.visited),
            np.asarray(want.state.visited).view(np.int32))
        results.append((ct, got))
    assert results[0][0].executable is results[1][0].executable
    assert bfs.plan_cache_info() == {"size": 1, "hits": 1, "misses": 1}
    assert plan_mod.geometry_key(results[0][0].fmt) \
        == plan_mod.geometry_key(results[1][0].fmt)
    assert not torch.equal(results[0][1].state.visited,
                           results[1][1].state.visited)   # two graphs


def test_cache_holds_no_graph(rmat):
    bfs.clear_plan_cache()
    fmt = build(to_port(rmat), "csr")
    ct = bfs.plan(fmt, TraversalSpec(policy="beamer"), device="cpu")
    ct.run_batched([3, 7])
    probe = weakref.ref(fmt.tensors()[0])
    ex = ct.executable
    del fmt, ct
    gc.collect()
    assert probe() is None, "the plan cache keeps a deleted graph alive"
    assert bfs.plan_cache_info()["size"] == 1 and ex.traces == 1
    for attr in vars(ex).values():
        assert not isinstance(attr, (torch.Tensor, CsrFormat))


# -- 5. the LM names --------------------------------------------------------

def test_serve_engine_accepts_greedy():
    _, _, cfg, params = models("qwen3", n_layers=2)
    outs = []
    for greedy in (True, False):
        eng = ServeEngine(cfg, params, batch_slots=2, cache_len=32,
                          greedy=greedy)
        eng.submit(Request(0, [1, 2, 3], max_tokens=4))
        eng.run_until_done()
        outs.append(eng.finished[0].generated)
    assert outs[0] == outs[1] and len(outs[0]) == 4


def test_embedding_logits_matches_reference():
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((50, 16)).astype(np.float32)
    h = rng.standard_normal((3, 5, 16)).astype(np.float32)
    want = ref_cm.embedding_logits({"emb": jnp.asarray(emb)},
                                   jnp.asarray(h).astype(jnp.bfloat16))
    got = cm.embedding_logits({"emb": torch.from_numpy(emb)},
                              torch.from_numpy(h).to(torch.bfloat16))
    assert got.dtype == torch.float32 and got.shape == (3, 5, 50)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_zero_aux_matches_reference():
    assert sorted(tf.ZERO_AUX) == sorted(ref_tf.ZERO_AUX)
    for k, v in ref_tf.ZERO_AUX.items():
        assert tf.ZERO_AUX[k].dtype == torch.float32
        assert float(tf.ZERO_AUX[k]) == float(v) == 0.0
    assert {k: float(v) for k, v in tf.zero_aux("cpu").items()} \
        == {k: float(v) for k, v in tf.ZERO_AUX.items()}
