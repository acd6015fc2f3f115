"""The legacy engine surface of the port against the reference's: the
single-root building blocks (`edge_stream` in both arms,
`scalar_expand`, `candidate_scatter`, the semiring `expand_candidates`,
`compact_worklist`, the tile rules), the shims over ``plan`` (`traverse`,
`traverse_arrays`, `traverse_format`, `layer_step`, `layer_step_format`),
`CompiledTraversal.layer_step`, `traverse_hostloop` and the runners
(`bfs_parallel.run_bfs*`, `run_bfs_vectorized`, `run_bfs_hybrid`).

Integer outputs are compared bitwise.  Parents, whose racy tie-breaks
are unspecified in both frameworks, are held by the set of vertices
they mark and by both validators with depths equal to `bfs_serial`.
The reference runs its ``fused_gather`` path at ``prefetch_depth=0``
(its auto pipeline reaches kernels this jax cannot run).
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.algorithms import semiring as ref_semiring
from repro.api import plan as ref_plan
from repro.core import bfs_hybrid as ref_hybrid
from repro.core import bitmap as ref_bm
from repro.core import bfs_parallel as ref_parallel
from repro.core import bfs_serial as ref_serial
from repro.core import bfs_vectorized as ref_vectorized
from repro.core import engine as ref_engine
from repro.core.validate import validate as ref_validate
from repro.formats.csr_format import CsrFormat as RefCsrFormat

from _torch_parity import (POLICY_IDS, POLICY_PAIRS, path_graph, ref_spec,
                           rmat_graph, star_graph, to_port, words_np)
import repro_torch.bfs as tbfs
from repro_torch import interop
from repro_torch.algorithms import semiring as t_semiring
from repro_torch.core import bfs_hybrid as t_hybrid
from repro_torch.core import bfs_parallel as t_parallel
from repro_torch.core import bfs_vectorized as t_vectorized
from repro_torch.core import engine as t_engine
from repro_torch.core.validate import validate as t_validate
from repro_torch.formats import csr_format
from repro_torch.formats.csr_format import CsrFormat
from _torch_parity import builtin_knobs  # noqa: F401

# the reference's pinned fused_gather depth-0 results hold the port's
# built-in knobs, not the affinity table's picks
pytestmark = pytest.mark.usefixtures("builtin_knobs")

CPU = "cpu"


@pytest.fixture(scope="module")
def rmat9():
    g = rmat_graph(9)
    return g, to_port(g)


@pytest.fixture(scope="module")
def rmat8():
    g = rmat_graph(8)
    return g, to_port(g)


def _words(w):
    return interop.words_to_torch(np.asarray(w), CPU)


def _tensor(a):
    return torch.from_numpy(np.array(a))


def _check_tree(g, gt, parent, root):
    """Both validators, depths equal to `bfs_serial`."""
    p = np.asarray(parent.cpu())[:g.n_vertices]
    p = np.where(p >= g.n_vertices, -1, p)
    _, depth = ref_serial.bfs_serial(np.asarray(g.rows),
                                     np.asarray(g.colstarts),
                                     g.n_vertices, root)
    assert t_validate(gt, torch.from_numpy(p), root,
                      reference_depth=depth).ok
    assert ref_validate(g, jnp.asarray(p), root, reference_depth=depth).ok


def _layer1_state(g, root):
    """The reference's single-root state after its first scalar layer."""
    st = ref_parallel.init_state(g, root)
    return ref_parallel.expand_simd_semantics(
        g.colstarts, g.rows, g.n_vertices, st, g.n_vertices_padded,
        g.n_edges_padded)


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
@pytest.mark.parametrize("sizes", ["full", "bucket"])
@pytest.mark.parametrize("bottom_up", [False, True],
                         ids=["frontier", "unvisited"])
def test_edge_stream_matches_reference(rmat8, packed, sizes, bottom_up):
    """(u, v, valid, truncated) bitwise, the invalid slots included; the
    bucket is a list of 64 and 300 slots (the stream truncates)."""
    g, gt = rmat8
    st = _layer1_state(g, 3)
    words = ~st.visited if bottom_up else st.frontier
    f_size, e_size = ((g.n_vertices_padded, g.n_edges_padded)
                      if sizes == "full" else (64, 300))
    ref = ref_engine.edge_stream(g.colstarts, g.rows, words, f_size,
                                 g.n_vertices, e_size, packed=packed)
    got = t_engine.edge_stream(gt.colstarts, gt.rows, _words(words),
                               f_size, g.n_vertices, e_size, packed=packed)
    for r, t in zip(ref, got):
        np.testing.assert_array_equal(t.numpy(), np.asarray(r))


@pytest.mark.parametrize("algorithm", ["simd", "nonsimd"])
def test_scalar_expand_matches_reference(rmat8, algorithm):
    g, gt = rmat8
    st = _layer1_state(g, 3)
    f_size, e_size = 64, 1024
    ref = ref_engine.scalar_expand(g.colstarts, g.rows, g.n_vertices,
                                   st.frontier, st.visited, st.parent,
                                   f_size, e_size, algorithm)
    p0 = np.asarray(st.parent)
    got = t_engine.scalar_expand(gt.colstarts, gt.rows, g.n_vertices,
                                 _words(st.frontier), _words(st.visited),
                                 _tensor(p0), f_size, e_size, algorithm)
    np.testing.assert_array_equal(words_np(got[0]), np.asarray(ref[0]))
    np.testing.assert_array_equal(words_np(got[1]), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy() != p0,
                                  np.asarray(ref[2]) != p0)
    assert int(got[3]) == int(ref[3])


def test_candidate_scatter_matches_reference(rmat8):
    g, gt = rmat8
    st = _layer1_state(g, 3)
    v_pad = g.n_vertices_padded
    u, v, valid, _ = ref_engine.edge_stream(
        g.colstarts, g.rows, st.frontier, v_pad, g.n_vertices,
        g.n_edges_padded)
    for v_cap in (v_pad, g.n_vertices):
        ref = ref_engine.candidate_scatter(u, v, valid, st.visited,
                                           g.n_vertices, v_cap)
        got = t_engine.candidate_scatter(_tensor(u), _tensor(v),
                                         _tensor(valid), _words(st.visited),
                                         g.n_vertices, v_cap)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _semiring_state(g, name, steps):
    """The reference's (frontier, vals, parent) of one root after
    ``steps`` relaxations over the whole edge stream."""
    sr = ref_semiring.get(name)
    n, v_pad = g.n_vertices, g.n_vertices_padded
    vals = sr.init_vals(jnp.asarray([5], jnp.int32), n, v_pad)[0]
    ids = jnp.arange(v_pad, dtype=jnp.int32)
    frontier = ref_bm.pack_bool(ids < n if sr.all_vertices_frontier
                                else ids == 5)
    parent = jnp.full((v_pad,), n, jnp.int32)
    u, v, valid = ref_engine.rowsweep_stream(
        g.colstarts, g.rows, ref_bm.pack_bool(ids < n), n)
    for _ in range(steps):
        frontier, vals, parent = ref_engine.expand_candidates(
            u, v, valid, frontier, None, parent, n, "simd", semiring=sr,
            vals=vals)
    return (u, v, valid), (frontier, vals, parent)


@pytest.mark.parametrize("name", ["sssp", "cc", "ksource_bfs"])
def test_semiring_expand_candidates_matches_reference(rmat8, name):
    """Two relaxations from the reference's state after one: improved
    words, values (by their bits) and min-id parents bitwise."""
    g, gt = rmat8
    (u, v, valid), state = _semiring_state(g, name, 1)
    frontier, vals, parent = state
    sr = ref_semiring.get(name)
    t_sr = t_semiring.get(name)
    stream = [_tensor(x)[None] for x in (u, v, valid)]
    t_state = (_words(frontier)[None], _tensor(vals)[None],
               _tensor(parent)[None])
    for _ in range(2):
        frontier, vals, parent = ref_engine.expand_candidates(
            u, v, valid, frontier, None, parent, g.n_vertices, "simd",
            semiring=sr, vals=vals)
        f_t, vals_t, p_t = t_engine.expand_candidates(
            *stream, t_state[0], None, t_state[2], g.n_vertices, "simd",
            semiring=t_sr, vals=t_state[1])
        t_state = (f_t, vals_t, p_t)
        np.testing.assert_array_equal(words_np(f_t[0]), np.asarray(frontier))
        np.testing.assert_array_equal(
            vals_t[0].numpy().view(np.int32),
            np.asarray(vals).view(np.int32))
        np.testing.assert_array_equal(p_t[0].numpy(), np.asarray(parent))


@pytest.mark.parametrize("density", [0.0, 0.1, 1.0])
def test_compact_worklist_single_root(density):
    rng = np.random.default_rng(int(density * 10))
    active = rng.random(53) < density
    wl_r, na_r = ref_engine.compact_worklist(jnp.asarray(active), 53)
    wl_t, na_t = t_engine.compact_worklist(torch.from_numpy(active), 53)
    np.testing.assert_array_equal(wl_t.numpy(), np.asarray(wl_r))
    assert na_t.ndim == 0 and int(na_t) == int(na_r)


def test_tile_rules():
    """`_next_pow2` as the reference's; `default_tile_csr` is the
    card's 1024, `csr_format.DEFAULT_TILE`, with no table row;
    `_resolve_tile_csr` is the CSR format's rule, given the format or
    not."""
    for n in (0, 1, 127, 128, 129, 1000, 4096, 70_000):
        assert t_engine._next_pow2(n) == ref_engine._next_pow2(n)
    assert t_engine.default_tile_csr() == csr_format.DEFAULT_TILE == 1024
    for e_pad in (128, 2048, 16384, 1 << 20):
        fmt = CsrFormat(torch.zeros(2, dtype=torch.int32),
                        torch.zeros(e_pad, dtype=torch.int32), 1, 0)
        assert t_engine.default_tile_csr(fmt) == 1024
        for tile in (None, 64, 512, 4096):
            assert t_engine._resolve_tile_csr(tile, e_pad) == \
                t_engine._resolve_tile_csr(tile, e_pad, fmt=fmt) == \
                fmt.resolve_tile(tile)


# ---------------------------------------------------------------------------
# The shims over plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("entry", ["traverse", "traverse_arrays",
                                   "traverse_format"])
def test_traverse_shims_match_reference(rmat9, entry):
    """Each shim with ``spec=`` equals the reference's same shim: the
    stats buffer, visited, depths and the direction log."""
    g, gt = rmat9
    roots = [3, 7, 11]
    rspec = ref_spec(ref_engine.BeamerHybrid())
    ct = ref_plan.plan(g, rspec)
    tspec = tbfs.TraversalSpec(policy=tbfs.BeamerHybrid(), max_layers=128,
                               tile=ct.resolved.tile)
    if entry == "traverse":
        ref = ref_engine.traverse(g, roots, spec=rspec)
        got = t_engine.traverse(gt, roots, spec=tspec, device=CPU)
    elif entry == "traverse_arrays":
        ref = ref_engine.traverse_arrays(
            g.colstarts, g.rows, jnp.asarray(roots, jnp.int32),
            n_vertices=g.n_vertices, spec=rspec)
        got = t_engine.traverse_arrays(gt.colstarts, gt.rows, roots,
                                       n_vertices=g.n_vertices, spec=tspec,
                                       device=CPU)
    else:
        ref = ref_engine.traverse_format(
            RefCsrFormat.from_csr(g), jnp.asarray(roots, jnp.int32),
            spec=rspec)
        got = t_engine.traverse_format(CsrFormat.from_csr(gt), roots,
                                       spec=tspec, device=CPU)
    np.testing.assert_array_equal(got.stats.numpy(), np.asarray(ref.stats))
    np.testing.assert_array_equal(words_np(got.state.visited),
                                  np.asarray(ref.state.visited))
    np.testing.assert_array_equal(got.depths.numpy(), np.asarray(ref.depths))
    assert tbfs.direction_log(got) == ref_engine.direction_log(ref)
    for b, root in enumerate(roots):
        _check_tree(g, gt, got.state.parent[b], root)


def test_traverse_single_root_is_unbatched(rmat9):
    g, gt = rmat9
    res = tbfs.traverse(gt, 17, spec=tbfs.TraversalSpec(), device=CPU)
    assert res.state.parent.ndim == 1 and res.depths.ndim == 0
    _check_tree(g, gt, res.state.parent, 17)


def test_loose_knob_form_warns(rmat9):
    """Loose knobs warn (DeprecationWarning) and equal the spec they map
    to; ``spec=`` with a loose knob raises ValueError, as in the
    reference."""
    g, gt = rmat9
    with pytest.warns(DeprecationWarning, match="loose-knob"):
        loose = t_engine.traverse(gt, 17, policy=t_engine.TopDown(),
                                  tile=256, device=CPU)
    spec = t_engine.make_spec(tile=256)
    assert spec == tbfs.TraversalSpec(
        policy=t_engine.TopDown(), algorithm="simd",
        pipeline="fused_gather", packed=True, tile=256, prefetch_depth=0,
        max_layers=64)
    want = tbfs.plan(gt, spec, device=CPU).run(17)
    assert torch.equal(loose.stats, want.stats)
    assert torch.equal(loose.state.visited, want.state.visited)
    for entry, call in (
            ("traverse", lambda: t_engine.traverse(
                gt, 17, tile=256, spec=spec, device=CPU)),
            ("traverse_format", lambda: t_engine.traverse_format(
                CsrFormat.from_csr(gt), [17], packed=False, spec=spec,
                device=CPU)),
            ("layer_step_format", lambda: t_engine.layer_step_format(
                CsrFormat.from_csr(gt), None, None, None,
                algorithm="simd", spec=spec))):
        with pytest.raises(ValueError, match="not both"):
            call()
    with pytest.raises(ValueError, match="not both"):
        ref_engine.traverse(g, 17, tile=256,
                            spec=ref_spec(ref_engine.TopDown()))


def _batched_layer1(g, roots):
    """The reference's batched state after one SIMD layer."""
    ct = ref_plan.plan(g, ref_spec(ref_engine.TopDown()))
    f, v, p = ref_engine._init_batched(jnp.asarray(roots, jnp.int32),
                                       g.n_vertices, g.n_vertices_padded)
    return ct.layer_step(f, v, p)


def _torch_state(f, v, p):
    return _words(f), _words(v), _tensor(p)


def _same_layer(got, ref, p0):
    np.testing.assert_array_equal(words_np(got[0]), np.asarray(ref[0]))
    np.testing.assert_array_equal(words_np(got[1]), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy() != p0,
                                  np.asarray(ref[2]) != p0)


@pytest.mark.parametrize("algorithm", ["simd", "nonsimd"])
def test_raw_layer_step_matches_reference(rmat9, algorithm):
    """`engine.layer_step` on raw arrays: one scalar layer of a batch."""
    g, gt = rmat9
    f, v, p = _batched_layer1(g, [3, 7, 11])
    ref = ref_engine.layer_step(g.colstarts, g.rows, f, v, p,
                                n_vertices=g.n_vertices,
                                algorithm=algorithm)
    p0 = np.asarray(p)
    got = t_engine.layer_step(gt.colstarts, gt.rows, *_torch_state(f, v, p),
                              n_vertices=g.n_vertices, algorithm=algorithm)
    _same_layer(got, ref, p0)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
@pytest.mark.parametrize("algorithm", ["simd", "nonsimd"])
def test_layer_step_format_matches_reference(rmat9, algorithm, packed):
    g, gt = rmat9
    f, v, p = _batched_layer1(g, [3, 7, 11])
    rspec = ref_spec(ref_engine.TopDown(), algorithm=algorithm) \
        .replace(packed=packed)
    ct = ref_plan.plan(g, rspec)
    ref = ref_engine.layer_step_format(RefCsrFormat.from_csr(g), f, v, p,
                                       spec=rspec)
    p0 = np.asarray(p)
    got = t_engine.layer_step_format(
        CsrFormat.from_csr(gt), *_torch_state(f, v, p),
        spec=tbfs.TraversalSpec(policy=tbfs.TopDown(), algorithm=algorithm,
                                packed=packed, tile=ct.resolved.tile))
    _same_layer(got, ref, p0)


@pytest.mark.parametrize("form", ["state", "triple"])
@pytest.mark.parametrize("pipeline", ["fused_gather", "megakernel",
                                      "persistent", "materialized"])
def test_compiled_layer_step_matches_reference(rmat9, pipeline, form):
    """One tick of `CompiledTraversal.layer_step` in both forms equals
    the reference's fused_gather tick (every pipeline runs the same SIMD
    layer)."""
    g, gt = rmat9
    f, v, p = _batched_layer1(g, [3, 7, 11])
    ct_r = ref_plan.plan(g, ref_spec(ref_engine.TopDown()))
    ref = ct_r.layer_step(f, v, p)
    p0 = np.asarray(p)
    ct = tbfs.plan(gt, tbfs.TraversalSpec(policy=tbfs.TopDown(),
                                          pipeline=pipeline,
                                          tile=ct_r.resolved.tile),
                   device=CPU)
    state = _torch_state(f, v, p)
    if form == "state":
        st = ct.layer_step(tbfs.BfsState(*state, torch.tensor(1)))
        assert isinstance(st, tbfs.BfsState) and int(st.layer) == 2
        got = st[:3]
    else:
        got = ct.layer_step(*state)
        assert len(got) == 3
    _same_layer(got, ref, p0)


@pytest.mark.parametrize("pipeline", ["fused_gather", "megakernel",
                                      "persistent"])
def test_layer_step_ticks_to_the_traversal(rmat9, pipeline):
    """Ticking from the initial state until every frontier is empty
    gives the visited and frontier sets and the layer count of the
    traversal that runs the SIMD step on every layer; the trees are
    valid (the reference's ``test_compiled_layer_step_advances_one_layer``)."""
    g, gt = rmat9
    roots = [3, 7, 17]
    ct = tbfs.plan(gt, tbfs.TraversalSpec(pipeline=pipeline), device=CPU)
    f, v, p = t_engine._init_batched(torch.tensor(roots, dtype=torch.int32),
                                     g.n_vertices, g.n_vertices_padded)
    st = tbfs.BfsState(f, v, p, torch.tensor(0, dtype=torch.int32))
    while int(st.frontier.ne(0).sum()):
        st = ct.layer_step(st)
    want = tbfs.plan(gt, tbfs.TraversalSpec(policy=tbfs.ThresholdSimd(0),
                                            pipeline=pipeline),
                     device=CPU).run_batched(roots)
    assert torch.equal(st.visited, want.state.visited)
    assert torch.equal(st.frontier, want.state.frontier)
    assert int(st.layer) == int(want.state.layer)
    for b, root in enumerate(roots):
        _check_tree(g, gt, st.parent[b], root)


def test_layer_step_refuses_a_semiring_spec(rmat9):
    _, gt = rmat9
    ct = tbfs.plan(gt, tbfs.TraversalSpec(algorithm="sssp"), device=CPU)
    f, v, p = t_engine._init_batched(torch.tensor([3], dtype=torch.int32),
                                     gt.n_vertices, gt.n_vertices_padded)
    with pytest.raises(NotImplementedError, match="single-layer tick"):
        ct.layer_step(f, v, p)


# ---------------------------------------------------------------------------
# The host loop and the runners
# ---------------------------------------------------------------------------

HOSTLOOP_POLICIES = [0, 1, 3]


@pytest.mark.parametrize("policy_index", HOSTLOOP_POLICIES,
                         ids=[POLICY_IDS[i] for i in HOSTLOOP_POLICIES])
def test_hostloop_matches_reference(rmat9, policy_index):
    """The direction log, visited and each layer's Table-1 counters and
    truncated edges equal the reference's hostloop; the counters also
    equal the whole traversal's stats columns 0-2."""
    g, gt = rmat9
    ref_pol, t_pol = POLICY_PAIRS[policy_index]
    ref_st, ref_stats, ref_log = ref_engine.traverse_hostloop(
        g, 17, policy=ref_pol, collect_stats=True)
    st, stats, log = t_engine.traverse_hostloop(
        gt, 17, policy=t_pol, collect_stats=True, device=CPU)
    assert log == ref_log
    assert [s[:4] + (s.truncated_edges,) for s in stats] == \
        [s[:4] + (s.truncated_edges,) for s in ref_stats]
    np.testing.assert_array_equal(words_np(st.visited),
                                  np.asarray(ref_st.visited))
    assert int(st.layer) == int(ref_st.layer) == len(log)
    _check_tree(g, gt, st.parent, 17)
    fused = tbfs.plan(gt, tbfs.TraversalSpec(policy=t_pol, max_layers=128),
                      device=CPU).run(17)
    assert [s[:4] for s in stats] == [s[:4] for s in
                                      tbfs.layer_stats(fused)]
    assert log == tbfs.direction_log(fused)


def test_hostloop_corner_graphs():
    """The star (one fat layer) and the path (96 one-vertex layers)."""
    for g, root in ((star_graph(), 0), (path_graph(), 0)):
        gt = to_port(g)
        st, stats, log = t_engine.traverse_hostloop(
            gt, root, policy=t_engine.ThresholdSimd(0), collect_stats=True,
            device=CPU)
        _, ref_stats, ref_log = ref_engine.traverse_hostloop(
            g, root, policy=ref_engine.ThresholdSimd(0), collect_stats=True)
        assert log == ref_log
        assert [s[:4] for s in stats] == [s[:4] for s in ref_stats]
        _check_tree(g, gt, st.parent, root)


@pytest.mark.parametrize("algorithm", ["simd", "nonsimd"])
@pytest.mark.parametrize("root", [0, 17, 300])
def test_run_bfs_matches_reference(rmat9, algorithm, root):
    g, gt = rmat9
    ref_st, ref_stats = ref_parallel.run_bfs(g, root, algorithm=algorithm,
                                             collect_stats=True)
    st, stats = t_parallel.run_bfs(gt, root, algorithm=algorithm,
                                   collect_stats=True, device=CPU)
    np.testing.assert_array_equal(words_np(st.visited),
                                  np.asarray(ref_st.visited))
    assert [s[:4] for s in stats] == [s[:4] for s in ref_stats]
    _check_tree(g, gt, st.parent, root)
    p = t_parallel.parents_graph500(st, g.n_vertices).numpy()
    r = np.asarray(ref_parallel.parents_graph500(ref_st, g.n_vertices))
    np.testing.assert_array_equal(p >= 0, r >= 0)


@pytest.mark.parametrize("algorithm", ["simd", "nonsimd"])
def test_run_bfs_jit_matches_reference(rmat9, algorithm):
    g, gt = rmat9
    ref = ref_parallel.run_bfs_jit(g.colstarts, g.rows, 5, g.n_vertices,
                                   algorithm)
    got = t_parallel.run_bfs_jit(gt.colstarts, gt.rows, 5, g.n_vertices,
                                 algorithm, device=CPU)
    np.testing.assert_array_equal(words_np(got.visited),
                                  np.asarray(ref.visited))
    assert int(got.layer) == int(ref.layer)
    _check_tree(g, gt, got.parent, 5)


def test_init_state_and_expand_match_reference(rmat9):
    """`init_state`, then one `expand_simd_semantics` and one
    `expand_nonsimd` layer each."""
    g, gt = rmat9
    ref = ref_parallel.init_state(g, 17)
    got = t_parallel.init_state(gt, 17)
    for r, t in zip(ref[:3], got[:3]):
        np.testing.assert_array_equal(t.numpy(),
                                      np.asarray(r).view(t.numpy().dtype))
    assert int(got.layer) == 0
    for ref_fn, t_fn in ((ref_parallel.expand_simd_semantics,
                          t_parallel.expand_simd_semantics),
                         (ref_parallel.expand_nonsimd,
                          t_parallel.expand_nonsimd)):
        args = (g.n_vertices_padded, g.n_edges_padded)
        r1 = ref_fn(g.colstarts, g.rows, g.n_vertices, ref, *args)
        t1 = t_fn(gt.colstarts, gt.rows, g.n_vertices,
                  t_parallel.init_state(gt, 17), *args)
        _same_layer(t1[:3], r1[:3], np.asarray(ref.parent))
        assert int(t1.layer) == int(r1.layer) == 1


@pytest.mark.parametrize("mode", ["threshold", "simd_layers"])
def test_run_bfs_vectorized_matches_reference(rmat9, mode):
    g, gt = rmat9
    kw = dict(simd_threshold=2048) if mode == "threshold" \
        else dict(simd_layers=(1, 2))
    ref_st, ref_stats = ref_vectorized.run_bfs_vectorized(
        g, 17, collect_stats=True, **kw)
    st, stats = t_vectorized.run_bfs_vectorized(
        gt, 17, collect_stats=True, device=CPU, **kw)
    np.testing.assert_array_equal(words_np(st.visited),
                                  np.asarray(ref_st.visited))
    assert [s[:4] for s in stats] == [s[:4] for s in ref_stats]
    _check_tree(g, gt, st.parent, 17)


@pytest.mark.parametrize("alpha,beta", [(14.0, 24.0), (2.0, 1000.0)],
                         ids=["beamer", "aggressive"])
def test_run_bfs_hybrid_matches_reference(rmat9, alpha, beta):
    """The direction log equals the reference's and the `BeamerHybrid`
    plan's."""
    g, gt = rmat9
    ref_st, ref_log = ref_hybrid.run_bfs_hybrid(g, 17, alpha=alpha,
                                                beta=beta,
                                                collect_stats=True)
    st, log = t_hybrid.run_bfs_hybrid(gt, 17, alpha=alpha, beta=beta,
                                      collect_stats=True, device=CPU)
    assert log == ref_log
    plan_log = tbfs.direction_log(tbfs.plan(gt, tbfs.TraversalSpec(
        policy=tbfs.BeamerHybrid(alpha, beta), max_layers=1024),
        device=CPU).run(17))
    assert log == plan_log
    np.testing.assert_array_equal(words_np(st.visited),
                                  np.asarray(ref_st.visited))
    _check_tree(g, gt, st.parent, 17)


def test_isolated_root_terminates(rmat9):
    """A degree-0 root: a one-vertex tree, no layer run."""
    g, gt = rmat9
    isolated = np.where(np.asarray(g.degrees()) == 0)[0]
    if not len(isolated):
        pytest.skip("no isolated vertex at this seed")
    root = int(isolated[0])
    st = t_parallel.run_bfs(gt, root, device=CPU)
    p = t_parallel.parents_graph500(st, g.n_vertices).numpy()
    assert p[root] == root
    assert (p[np.arange(g.n_vertices) != root] == -1).all()
    state, stats, log = t_engine.traverse_hostloop(gt, root, device=CPU)
    assert int(state.layer) == 1 and log == ["topdown"] and stats == []


def test_entry_points_default_to_the_card(rmat9):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    _, gt = rmat9
    for call in (lambda: t_parallel.run_bfs(gt, 3),
                 lambda: t_engine.traverse(gt, 3),
                 lambda: t_engine.traverse_hostloop(gt, 3)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", DeprecationWarning)
                call()
