"""The distributed 1-D BFS (`repro_torch.core.bfs_distributed`) against
the reference's `repro.core.bfs_distributed`.

The merge takes the least discovering parent, so the tree does not
depend on the shard count (the reference's own multi-device tests pin
that).  Every port run — one in-process gloo rank, and spawned groups of
2 and 4 gloo ranks on meshes (2,), (4,), (2, 2), and (2, 2) searched
over one axis and over both in the other order — is held bitwise
(parents and layer counts) to the reference's in-process run on a
one-device mesh, for each merge.  The partition
arrays, the plain rowsweep and the per-shard step are held bitwise to
the reference's too.  Spawned ranks import only torch and
``repro_torch`` (`_torch_dist_worker.py`) and meet through a file store
under ``tmp_path``, so parallel test workers cannot collide.
"""
import multiprocessing as mp
import time
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro import compat as ref_compat
from repro.api.spec import TraversalSpec as RefSpec
from repro.core import bfs_distributed as ref_bd
from repro.core import engine as ref_engine
from jax.sharding import PartitionSpec as P

import _torch_dist_worker as worker
from _torch_parity import (csr_from_pairs, disconnected_graph, path_graph,
                           rmat_graph, to_port)
import repro_torch.bfs as tbfs
from repro_torch import interop
from repro_torch.core import bfs_distributed as bd
from repro_torch.core import engine as t_engine
from repro_torch.errors import GraphValidationError
from repro_torch.kernels import ops
from _torch_parity import builtin_knobs  # noqa: F401

# the reference's pinned fused_gather depth-0 results hold the port's
# built-in knobs, not the affinity table's picks
pytestmark = pytest.mark.usefixtures("builtin_knobs")

MERGES = ("allreduce", "owner", "packed")
JOIN_S = 120.0


def two_shard_graph(n=512):
    """A star on [0, 300), across the shard boundary at D = 2 (v_loc
    256); a path on [370, 400), inside shard 1 at D = 2 and across the
    boundary at 384 at D = 4; isolated vertices [400, 512)."""
    pairs = [(0, i) for i in range(1, 300)]
    pairs += [(i, i + 1) for i in range(370, 399)]
    return csr_from_pairs(pairs, n)


#: graph -> (function making it, roots searched); the path only
#: partitions
GRAPHS = {
    "rmat9": (lambda: rmat_graph(9, 3), (11, 17)),
    "path": (lambda: path_graph(200), ()),
    "disconnected": (disconnected_graph, (0, 96)),
    "two_shard": (two_shard_graph, (0, 385, 450)),
}


@pytest.fixture(scope="module")
def graphs():
    built = {}

    def get(name):
        if name not in built:
            g = GRAPHS[name][0]()
            built[name] = (g, to_port(g))
        return built[name]
    return get


@pytest.fixture(scope="module")
def ref_mesh():
    return jax.make_mesh((1,), ("x",))


@pytest.fixture(scope="module")
def reference(graphs, ref_mesh):
    """The reference's (parent, layers) per (graph, merge, root)."""
    cache = {}

    def get(name, merge, root):
        key = (name, merge, root)
        if key not in cache:
            p, layers = ref_bd.run_bfs_distributed(graphs(name)[0], root,
                                                   ref_mesh, merge=merge)
            cache[key] = (np.asarray(p), int(layers))
        return cache[key]
    return get


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """One in-process gloo rank and a (1,) CPU mesh."""
    store = tmp_path_factory.mktemp("gloo") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("x",))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Partition, rowsweep and the per-shard step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_devices", [1, 2, 3, 4])
@pytest.mark.parametrize("name", ["rmat9", "path"])
def test_partition_matches_reference(graphs, name, n_devices):
    """Equal arrays; the 200-vertex path does not divide (a short last
    shard at D = 2) and leaves an empty tail shard at D = 3 and 4."""
    g, gt = graphs(name)
    want = ref_bd.partition_csr(g, n_devices)
    got = bd.partition_csr(gt, n_devices)
    for w, x in zip(want, got):
        assert x.dtype == torch.int32
        np.testing.assert_array_equal(x.numpy(), np.asarray(w))
    assert bd.partition_sizes(g.n_vertices, g.n_edges, n_devices) \
        == ref_bd.partition_sizes(g.n_vertices, g.n_edges, n_devices)
    if name == "path" and n_devices >= 3:
        assert int(got[1][-1, -1]) == 0          # the empty tail shard


def _random_words(rng, n_words, density=0.3):
    bits = rng.random((n_words, 32)) < density
    return (bits * (1 << np.arange(32, dtype=np.uint64))).sum(1) \
        .astype(np.uint32)


@pytest.mark.parametrize("nbr_limit", [None, 300])
def test_rowsweep_stream_matches_reference(graphs, nbr_limit):
    g, gt = graphs("rmat9")
    rng = np.random.default_rng(5)
    words = _random_words(rng, g.n_vertices // 32)
    want = jax.jit(ref_engine.rowsweep_stream, static_argnums=(3, 4))(
        g.colstarts, g.rows, jnp.asarray(words), g.n_vertices, nbr_limit)
    got = t_engine.rowsweep_stream(gt.colstarts, gt.rows,
                                   interop.words_to_torch(words, "cpu"),
                                   g.n_vertices, nbr_limit=nbr_limit)
    for w, x in zip(want, got):
        np.testing.assert_array_equal(x.numpy(), np.asarray(w))


@pytest.mark.parametrize("name,n_devices", [
    ("rmat9", 1), ("rmat9", 4), ("two_shard", 2)])
def test_local_step_matches_reference(graphs, name, n_devices):
    """`ops.rowsweep_candidates` (the plain arm) on every shard equals
    the reference's `_local_step`, rebased shards (base > 0) included."""
    g, gt = graphs(name)
    rows_sh, cs_sh = bd.partition_csr(gt, n_devices)
    v_loc = cs_sh.shape[1] - 1
    v_cap = v_loc * n_devices
    rng = np.random.default_rng(n_devices)
    frontier = _random_words(rng, v_cap // 32)
    visited = frontier | _random_words(rng, v_cap // 32)
    ref_step = jax.jit(ref_bd._local_step, static_argnums=(4, 5, 6))
    before = dict(ops.KERNEL_LAUNCHES)
    for d in range(n_devices):
        want = ref_step(
            jnp.asarray(rows_sh[d].numpy()), jnp.asarray(cs_sh[d].numpy()),
            jnp.asarray(frontier), jnp.asarray(visited), v_loc,
            g.n_vertices, v_cap, jnp.int32(d * v_loc))
        got = bd._local_step(rows_sh[d], cs_sh[d],
                             interop.words_to_torch(frontier, "cpu"),
                             interop.words_to_torch(visited, "cpu"), v_loc,
                             g.n_vertices, v_cap, d * v_loc)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ops.KERNEL_LAUNCHES == before      # no CUDA launch on the CPU


def test_rowsweep_rejects_misaligned_shard(graphs):
    _, gt = graphs("rmat9")
    words = torch.zeros((gt.n_vertices // 32,), dtype=torch.int32)
    with pytest.raises(ValueError, match="word-aligned"):
        ops.rowsweep_candidates(gt.rows, gt.colstarts[:101], words, words,
                                base=0, n_vertices=gt.n_vertices)
    with pytest.raises(ValueError, match="int32"):
        ops.rowsweep_candidates(gt.rows.long(), gt.colstarts, words, words,
                                base=0, n_vertices=gt.n_vertices)


# ---------------------------------------------------------------------------
# One rank, in process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("merge", MERGES)
@pytest.mark.parametrize("name", ["rmat9", "disconnected", "two_shard"])
def test_world1_matches_reference(mesh, graphs, reference, name, merge):
    _, gt = graphs(name)
    for root in GRAPHS[name][1]:
        parent, layers = bd.run_bfs_distributed(gt, root, mesh, merge=merge)
        want, want_layers = reference(name, merge, root)
        np.testing.assert_array_equal(parent.numpy(), want)
        assert layers == want_layers, (root, layers, want_layers)


@pytest.mark.parametrize("merge", MERGES)
def test_single_layer_matches_reference(mesh, graphs, ref_mesh, merge):
    g, gt = graphs("rmat9")
    rows_sh, cs_sh = ref_bd.partition_csr(g, 1)
    v_loc = int(cs_sh.shape[1]) - 1
    program = ref_bd.make_bfs_program(v_loc, g.n_vertices, 1, ("x",),
                                      merge=merge, single_layer=True)
    run = jax.jit(ref_compat.shard_map(
        program, ref_mesh, in_specs=(P(("x",)), P(("x",)), P()),
        out_specs=(P(("x",)) if merge == "owner" else P(), P())))
    want, want_layers = run(rows_sh, cs_sh, jnp.int32(11))
    port = bd.make_bfs_program(v_loc, g.n_vertices, 1, ("x",), merge=merge,
                               single_layer=True)
    rows_l, cs_l = bd.partition_csr(gt, 1)
    parent, layers = port(mesh, rows_l[0], cs_l[0], 11)
    np.testing.assert_array_equal(parent.numpy(), np.asarray(want))
    assert layers == int(want_layers) == 1


def test_deterministic_tree(mesh, graphs):
    _, gt = graphs("rmat9")
    p1, _ = bd.run_bfs_distributed(gt, 7, mesh)
    p2, _ = bd.run_bfs_distributed(gt, 7, mesh)
    assert torch.equal(p1, p2)


def test_unknown_merge_raises():
    with pytest.raises(ValueError, match="unknown merge 'ring'"):
        bd.make_bfs_program(128, 100, 1, ("x",), merge="ring")


def test_spec_path_matches_loose_knobs(mesh, graphs, reference):
    """``spec=`` resolves merge="auto" to "packed"; mixing spec= with the
    loose knobs raises; explicitly set fields the program ignores warn,
    a resolved spec does not."""
    g, gt = graphs("rmat9")
    p_spec, l_spec = bd.run_bfs_distributed(gt, 11, mesh,
                                            spec=tbfs.TraversalSpec())
    p_ref, l_ref = ref_bd.run_bfs_distributed(
        g, 11, jax.make_mesh((1,), ("x",)), spec=RefSpec())
    np.testing.assert_array_equal(p_spec.numpy(), np.asarray(p_ref))
    assert l_spec == int(l_ref) == reference("rmat9", "packed", 11)[1]
    with pytest.raises(ValueError, match="not both"):
        bd.run_bfs_distributed(gt, 11, mesh, merge="owner",
                               spec=tbfs.TraversalSpec())
    with pytest.raises(ValueError, match="not both"):
        bd.run_bfs_distributed(gt, 11, mesh, max_layers=3,
                               spec=tbfs.TraversalSpec())
    with pytest.warns(UserWarning, match=r"\['packed'\] are ignored"):
        bd.run_bfs_distributed(gt, 11, mesh,
                               spec=tbfs.TraversalSpec(packed=False))
    p_cut, l_cut = bd.run_bfs_distributed(
        gt, 11, mesh, spec=tbfs.TraversalSpec(max_layers=2, merge="owner"))
    want_cut, want_l = ref_bd.run_bfs_distributed(
        g, 11, jax.make_mesh((1,), ("x",)), max_layers=2, merge="owner")
    np.testing.assert_array_equal(p_cut.numpy(), np.asarray(want_cut))
    assert l_cut == int(want_l) == 2
    resolved = tbfs.plan(gt, device="cpu").resolved
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        bd.run_bfs_distributed(gt, 11, mesh, spec=resolved)
    with pytest.raises(ValueError, match="unknown merge"):
        bd.run_bfs_distributed(gt, 11, mesh,
                               spec=tbfs.TraversalSpec(merge="ring"))


def test_mesh_ignored_fields_warning_matches_reference():
    from repro.api.spec import MESH_IGNORED_FIELDS as REF_FIELDS
    from repro_torch.api.spec import (MESH_IGNORED_FIELDS,
                                      warn_mesh_ignored_fields)
    assert MESH_IGNORED_FIELDS == REF_FIELDS
    with pytest.warns(UserWarning, match=r"entry: the distributed per-chip "
                      r"program is a fixed top-down rowsweep; spec fields "
                      r"\['policy', 'tile'\] are ignored"):
        warn_mesh_ignored_fields(
            tbfs.TraversalSpec(policy="beamer", tile=256), "entry")
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        warn_mesh_ignored_fields(tbfs.TraversalSpec(merge="owner",
                                                    max_layers=9), "entry")


# ---------------------------------------------------------------------------
# The mesh-bound plan
# ---------------------------------------------------------------------------

def test_mesh_plan_matches_run_bfs_distributed(mesh, graphs, reference,
                                               monkeypatch):
    _, gt = graphs("rmat9")
    calls = []
    real = bd.partition_csr
    monkeypatch.setattr(bd, "partition_csr",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    ct = tbfs.plan(gt, tbfs.TraversalSpec(merge="allreduce"), device="cpu",
                   mesh=mesh)
    assert ct.executable is None and ct._partition is None
    assert ct.resolved.merge == "allreduce" and ct.resolved.is_resolved
    for root in GRAPHS["rmat9"][1]:
        parent, layers = ct.run(root)
        want, want_layers = reference("rmat9", "allreduce", root)
        np.testing.assert_array_equal(parent.numpy(), want)
        assert layers == want_layers
    assert len(calls) == 1                       # partitioned once
    parent, _ = ct.run(torch.tensor(17))        # a 0-d tensor root
    np.testing.assert_array_equal(parent.numpy(),
                                  reference("rmat9", "allreduce", 17)[0])
    assert len(calls) == 1


def test_mesh_plan_rejects_single_chip_surfaces(mesh, graphs):
    _, gt = graphs("rmat9")
    ct = tbfs.plan(gt, device="cpu", mesh=mesh)
    assert ct.resolved.merge == "packed"
    with pytest.raises(ValueError, match="scalar root"):
        ct.run([3, 7])
    with pytest.raises(NotImplementedError, match="one root per launch"):
        ct.run_batched([3, 7])
    state = t_engine.BfsState(*t_engine._init_batched(
        torch.tensor([3], dtype=torch.int32), gt.n_vertices,
        ct.fmt.n_vertices_padded), 0)
    with pytest.raises(NotImplementedError, match="single-layer tick"):
        ct.layer_step(state)
    with pytest.raises(NotImplementedError, match="mesh-bound"):
        ct.trace_run(3)
    with pytest.raises(GraphValidationError):
        ct.run(gt.n_vertices)
    with pytest.warns(UserWarning, match="mesh-bound plan"):
        tbfs.plan(gt, tbfs.TraversalSpec(pipeline="materialized"),
                  device="cpu", mesh=mesh)
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        tbfs.plan(gt, tbfs.plan(gt, device="cpu").resolved, device="cpu",
                  mesh=mesh)


def test_mesh_device_rules(graphs):
    """A device= that disagrees with the mesh's type raises; a CUDA mesh
    without CUDA raises instead of falling back to the CPU."""
    _, gt = graphs("rmat9")
    cuda_mesh = types.SimpleNamespace(device_type="cuda")
    with pytest.raises(ValueError, match="disagrees with the mesh"):
        tbfs.plan(gt, device="cpu", mesh=cuda_mesh)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            bd.mesh_device(cuda_mesh)


# ---------------------------------------------------------------------------
# Spawned gloo groups
# ---------------------------------------------------------------------------

def _spawn(tmp_path, groups, names, graphs):
    """Start every group of ranks at once (their start-up overlaps), wait
    for all under one deadline and return each group's per-rank results.
    ``groups``: (world, cases)."""
    jobs = []
    for name in names:
        g = graphs(name)[0]
        path = tmp_path / f"{name}.npz"
        np.savez(path, rows=np.asarray(g.rows),
                 colstarts=np.asarray(g.colstarts),
                 n_vertices=g.n_vertices, n_edges=g.n_edges)
        jobs.append((str(path), list(GRAPHS[name][1])))
    ctx = mp.get_context("spawn")
    procs = []
    for k, (world, cases) in enumerate(groups):
        procs.append([ctx.Process(
            target=worker.run_rank,
            args=(rank, world, str(tmp_path / f"store{k}"), cases, jobs,
                  str(tmp_path / f"out{k}")))
            for rank in range(world)])
    flat = [p for group in procs for p in group]
    for p in flat:
        p.start()
    deadline = time.monotonic() + JOIN_S
    for p in flat:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p.pid for p in flat if p.is_alive()]
    for p in flat:
        if p.is_alive():
            p.kill()
            p.join(5)
    assert not hung, f"ranks {hung} still running after {JOIN_S} s"
    assert [p.exitcode for p in flat] == [0] * len(flat)
    return [[dict(np.load(tmp_path / f"out{k}.{rank}.npz"))
             for rank in range(world)]
            for k, (world, _) in enumerate(groups)]


def _check_ranks(got, cases, names, reference):
    for rank, res in enumerate(got):
        for j, name in enumerate(names):
            for i, case in enumerate(cases):
                merges = MERGES + (("plan",) if case[2] is None else ())
                for merge in merges:
                    for root in GRAPHS[name][1]:
                        key = worker.case_key(j, i, merge, root)
                        want, want_layers = reference(
                            name, "owner" if merge == "plan" else merge,
                            root)
                        np.testing.assert_array_equal(
                            res[key], want,
                            err_msg=f"rank {rank} {name} {case} {merge}")
                        assert int(res[key + "/layers"]) == want_layers


def test_spawned_ranks_match_reference(tmp_path, graphs, reference):
    """2 gloo ranks on a (2,) mesh, and 4 on (4,), (2, 2), (2, 2)
    searched over axis "b" (two replica groups of 2 shards) and (2, 2)
    over ("b", "a") (shard order unlike the group's rank order): every
    rank holds the reference's trees and layer counts for every merge,
    and the mesh-bound plan's."""
    groups = [(2, [((2,), ("x",), None)]),
              (4, [((4,), ("x",), None), ((2, 2), ("a", "b"), None),
                   ((2, 2), ("a", "b"), ("b",)),
                   ((2, 2), ("a", "b"), ("b", "a"))])]
    names = ("rmat9", "two_shard")
    got = _spawn(tmp_path, groups, names, graphs)
    for (_, cases), ranks in zip(groups, got):
        _check_ranks(ranks, cases, names, reference)
