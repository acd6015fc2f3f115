"""The semiring portfolio (sssp, cc, ksource_bfs) end to end on the CPU.

``plan(fmt, TraversalSpec(algorithm=...)).run_batched(roots)`` on the
``csr`` and ``sell`` formats against the reference's same plan (its
``fused_gather`` relax arm, at its resolved tile), on rmat9 (the
small families of the reference's algorithm tests are in
``test_torch_semiring_graphs.py``): values, parents, layers, depths,
visited, frontier and the whole stats buffer bitwise.  The relax is a
scatter-min and its parents a min-id resolve, so nothing races and
every comparison is exact.  The port's own oracles (Dijkstra over the
hash weights, union-find, `bfs_serial`) check the values too.  Also:
the edge-weight hash bit for bit, the registry and the reference's
rejections word for word.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.algorithms import semiring as ref_sr
from repro.api.spec import TraversalSpec as RefSpec
from repro.formats import registry as ref_registry

from _torch_parity import BUILDERS, ROOTS, to_port
from _torch_semiring import (ALGORITHMS, FORMATS, MAX_LAYERS,
                             check_portfolio, reference)
import repro_torch.bfs as tbfs
from repro_torch import formats
from repro_torch.algorithms import semiring as sr
from _torch_parity import builtin_knobs  # noqa: F401

# the reference's pinned fused_gather depth-0 results hold the port's
# built-in knobs, not the affinity table's picks
pytestmark = pytest.mark.usefixtures("builtin_knobs")

FAMILIES = ("rmat9",)
CASES = [(g, f, a) for g in FAMILIES for f in FORMATS for a in ALGORITHMS]


@pytest.fixture(scope="module")
def graphs():
    return {name: build() for name, build in BUILDERS.items()}


# -- end to end ------------------------------------------------------------

@pytest.mark.parametrize("graph_name,fmt_name,algorithm", CASES,
                         ids=[f"{g}-{f}-{a}" for g, f, a in CASES])
def test_portfolio_matches_reference(graphs, graph_name, fmt_name,
                                     algorithm):
    check_portfolio(graphs, graph_name, fmt_name, algorithm)


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_single_root_run_carries_values(graphs, algorithm):
    """``run(root)`` returns the unbatched value row, equal to the
    batch's row for that root."""
    root = ROOTS["rmat9"][1][1]
    ct, ref = reference(graphs, "rmat9", "csr", algorithm)
    spec = tbfs.TraversalSpec(algorithm=algorithm, policy="topdown",
                              tile=ct.resolved.tile, max_layers=MAX_LAYERS)
    one = tbfs.plan(to_port(graphs["rmat9"]), spec, device="cpu").run(root)
    assert one.values.shape == (graphs["rmat9"].n_vertices_padded,)
    if algorithm != "cc":      # cc's layers do not depend on the roots
        np.testing.assert_array_equal(
            one.values.numpy().view(np.int32),
            np.asarray(ref.values[1]).view(np.int32))
    np.testing.assert_array_equal(one.state.parent.numpy(),
                                  np.asarray(ref.state.parent[1]))


# -- the semiring layer ----------------------------------------------------

def test_edge_weight_is_the_reference_hash_bitwise():
    rng = np.random.default_rng(14)
    n = 100_000
    u = rng.integers(0, 2**31 - 1, n, dtype=np.int64).astype(np.int32)
    v = rng.integers(0, 2**31 - 1, n, dtype=np.int64).astype(np.int32)
    u[:2000] = 2**31 - 1 - rng.integers(0, 64, 2000)   # ids near 2**31
    v[1000:3000] = 2**31 - 1 - rng.integers(0, 64, 2000)
    v[5000:6000] = u[5000:6000]                         # u == v
    want = np.asarray(ref_sr.edge_weight_np(u, v))
    got = sr.edge_weight(torch.from_numpy(u), torch.from_numpy(v)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(sr.edge_weight_np(u, v).view(np.int32),
                                  want.view(np.int32))
    np.testing.assert_array_equal(
        np.asarray(ref_sr.edge_weight(jnp.asarray(u), jnp.asarray(v)))
        .view(np.int32), want.view(np.int32))
    # symmetric, in [1, 2)
    np.testing.assert_array_equal(
        sr.edge_weight(torch.from_numpy(v), torch.from_numpy(u)).numpy(),
        got)
    assert (got >= 1.0).all() and (got < 2.0).all()


def test_registry_matches_the_reference():
    assert sr.INT_INF == ref_sr.INT_INF == 2**30 - 1
    assert sr.SSSP_DELTA == ref_sr.SSSP_DELTA
    assert sr.SEMIRING_ALGORITHMS == ref_sr.SEMIRING_ALGORITHMS
    assert set(sr.SEMIRINGS) == set(ref_sr.SEMIRINGS)
    roots = np.asarray([3, 0, 77], np.int32)
    for name, ref in ref_sr.SEMIRINGS.items():
        got = sr.get(name)
        for field in ("name", "dtype", "identity", "annihilator", "unit",
                      "weighted", "all_vertices_frontier"):
            assert getattr(got, field) == getattr(ref, field), (name, field)
        want = np.asarray(ref.init_vals(jnp.asarray(roots), 100, 128))
        have = got.init_vals(torch.from_numpy(roots), 100, 128).numpy()
        assert have.dtype == want.dtype
        np.testing.assert_array_equal(have.view(np.int32),
                                      want.view(np.int32))
    with pytest.raises(KeyError, match="registered"):
        sr.get("bellman_ford")


# -- rejections: the reference's type and message --------------------------

def _refusals(ref_call, port_call):
    with pytest.raises(ValueError) as ref:
        ref_call()
    with pytest.raises(ValueError) as got:
        port_call()
    return str(ref.value), str(got.value)


@pytest.mark.parametrize("fields", [
    dict(pipeline="megakernel"), dict(pipeline="persistent"),
    dict(pipeline="materialized"), dict(prefetch_depth=1)],
    ids=["megakernel", "persistent", "materialized", "prefetch1"])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_semiring_rejects_bfs_only_knobs(graphs, algorithm, fields):
    ref_msg, got_msg = _refusals(
        lambda: RefSpec(algorithm=algorithm, **fields).validate(),
        lambda: tbfs.plan(to_port(graphs["path"]), tbfs.TraversalSpec(
            algorithm=algorithm, **fields), device="cpu"))
    assert got_msg == ref_msg


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_bitmap_format_rejects_the_portfolio(graphs, algorithm):
    g = graphs["rmat9"]
    ref_fmt = ref_registry.get("bitmap").from_graph(g)
    got_fmt = formats.registry.get("bitmap").from_graph(to_port(g))
    ref_msg, got_msg = _refusals(
        lambda: RefSpec(algorithm=algorithm).validate(ref_fmt),
        lambda: tbfs.plan(got_fmt, tbfs.TraversalSpec(algorithm=algorithm),
                          device="cpu"))
    assert got_msg == ref_msg
    assert "supported_semirings=()" in got_msg


def test_formats_declare_the_reference_semirings():
    for name in formats.available():
        assert formats.registry.get(name).supported_semirings == \
            ref_registry.get(name).supported_semirings, name


def test_semiring_spec_resolves_to_the_relax_arm(graphs):
    fmt = to_port(graphs["path"])
    for algorithm in ALGORITHMS:
        r = tbfs.plan(fmt, tbfs.TraversalSpec(algorithm=algorithm),
                      device="cpu").resolved
        assert r.is_semiring and r.algorithm == algorithm
        assert (r.pipeline, r.prefetch_depth) == ("fused_gather", 0)
        assert tbfs.TraversalSpec.from_dict(
            RefSpec(algorithm=algorithm).to_dict()).algorithm == algorithm
    assert not tbfs.TraversalSpec().is_semiring

