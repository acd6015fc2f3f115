"""Parity of the port's engine with the reference's fused_gather path:
its building blocks one by one, then the slice end to end on the R-MAT
graph (the star, path and disconnected graphs are in
``test_torch_engine_graphs.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.core.csr import padding_premarked_visited as ref_premarked

from _torch_parity import (BUILDERS, POLICY_IDS, check_slice, rmat_graph,
                           run_port, run_reference, to_port, words_np)
from repro_torch import interop
from repro_torch.core import csr as t_csr
from repro_torch.core import engine as t_engine


@pytest.fixture(scope="module")
def graphs():
    return {"rmat9": BUILDERS["rmat9"]()}


@pytest.fixture(scope="module")
def rmat8():
    g = rmat_graph(8)
    return g, to_port(g)


def _random_words(seed, n_batch, n_vertices, density):
    rng = np.random.default_rng(seed)
    n_words = -(-(n_vertices + 1) // 128) * 4
    dense = np.zeros((n_batch, n_words * 32), bool)
    dense[:, :n_vertices] = rng.random((n_batch, n_vertices)) < density
    return (dense.reshape(n_batch, n_words, 32).astype(np.uint64)
            << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_slots", [None, 300], ids=["full", "truncated"])
def test_apportion_matches_reference(rmat8, n_slots):
    g, gt = rmat8
    n = g.n_vertices
    rng = np.random.default_rng(1)
    lists = np.full((3, 64), n, np.int32)
    for b in range(3):
        k = rng.integers(1, 60)
        lists[b, :k] = np.sort(rng.choice(n, k, replace=False))
    n_slots = n_slots or g.n_edges_padded
    ref = jax.vmap(lambda l: ref_engine.apportion(
        g.colstarts, g.rows, l, n, n_slots))(jnp.asarray(lists))
    got = t_engine.apportion(gt.colstarts, gt.rows,
                             torch.from_numpy(lists), n, n_slots)
    for r, t in zip(ref, got):
        np.testing.assert_array_equal(t.numpy(), np.asarray(r))


@pytest.mark.parametrize("density", [0.0, 0.02, 0.5, 1.0])
def test_compact_worklist_matches_reference(density):
    rng = np.random.default_rng(int(density * 100))
    active = rng.random((4, 37)) < density
    wl_r, na_r = jax.vmap(lambda a: ref_engine.compact_worklist(a, 37))(
        jnp.asarray(active))
    wl_t, na_t = t_engine.compact_worklist(torch.from_numpy(active), 37)
    np.testing.assert_array_equal(wl_t.numpy(), np.asarray(wl_r))
    np.testing.assert_array_equal(na_t.numpy(), np.asarray(na_r))


@pytest.mark.parametrize("tile", [128, 1024])
@pytest.mark.parametrize("density", [0.01, 0.3])
def test_plan_active_tiles_matches_reference(rmat8, tile, density):
    g, gt = rmat8
    n = g.n_vertices
    words = _random_words(int(density * 100) + tile, 3, n, density)
    rows_t = ref_engine._pad_rows_to_tile(g.rows, n, tile)
    n_blocks = int(rows_t.shape[0]) // tile
    wl_r, na_r = ref_engine.plan_active_tiles_batched(
        g.colstarts, jnp.asarray(words), n, tile, n_blocks, packed=True)
    wl_t, na_t = t_engine.plan_active_tiles_batched(
        gt.colstarts, interop.words_to_torch(words, "cpu"), n, tile,
        n_blocks)
    np.testing.assert_array_equal(wl_t.numpy(), np.asarray(wl_r))
    np.testing.assert_array_equal(na_t.numpy(), np.asarray(na_r))


@pytest.mark.parametrize("algorithm", ["simd", "nonsimd"])
def test_scalar_step_matches_reference(rmat8, algorithm):
    """One scalar layer: same out/visited; parents differ only in which
    frontier neighbour won a duplicate write."""
    g, gt = rmat8
    n, v_pad, e_pad = g.n_vertices, g.n_vertices_padded, g.n_edges_padded
    roots = jnp.asarray([3, 9], jnp.int32)
    f, vis, p = ref_engine._init_batched(roots, n, v_pad)
    ref_step = ref_engine._make_scalar_step(g.colstarts, g.rows, n, v_pad,
                                            e_pad, algorithm, 256)
    f, vis, p, _ = ref_step(f, vis, p)         # advance to layer 1
    out_r, vis_r, p_r, aux_r = ref_step(f, vis, p)
    t_step = t_engine._make_scalar_step(gt.colstarts, gt.rows, n, v_pad,
                                        e_pad, algorithm, 256)
    out_t, vis_t, p_t, aux_t = t_step(
        interop.words_to_torch(np.asarray(f), "cpu"),
        interop.words_to_torch(np.asarray(vis), "cpu"),
        torch.from_numpy(np.asarray(p).copy()))
    np.testing.assert_array_equal(words_np(out_t), np.asarray(out_r))
    np.testing.assert_array_equal(words_np(vis_t), np.asarray(vis_r))
    np.testing.assert_array_equal(p_t.numpy() != np.asarray(p),
                                  np.asarray(p_r) != np.asarray(p))
    assert (int(aux_t.tiles), int(aux_t.truncated), aux_t.launches) == \
        (int(aux_r.tiles), int(aux_r.truncated), int(aux_r.launches))


def test_init_batched_matches_reference():
    roots = [0, 31, 32, 500]
    ref = ref_engine._init_batched(jnp.asarray(roots, jnp.int32), 600, 640)
    got = t_engine._init_batched(torch.tensor(roots, dtype=torch.int32),
                                 600, 640)
    for r, t in zip(ref, got):
        np.testing.assert_array_equal(t.numpy(),
                                      np.asarray(r).view(t.numpy().dtype))
    one_r = ref_engine.init_root_state(jnp.int32(31), ref_premarked(600),
                                       600)
    one_t = t_engine.init_root_state(
        31, t_csr.padding_premarked_visited(600, device="cpu"), 600)
    for r, t in zip(one_r, one_t):
        np.testing.assert_array_equal(t.numpy(),
                                      np.asarray(r).view(t.numpy().dtype))


@pytest.mark.parametrize("bottom_up,f_edges,u_edges,f_count", [
    (False, 100.0, 1000.0, 10.0),      # stay top-down
    (False, 100.0, 1399.0, 10.0),      # switch down (100 > 1399/14)
    (True, 10.0, 10.0, 99.0),          # stay bottom-up (99 >= 2400/24)
    (True, 10.0, 10.0, 20.0),          # switch back up
])
def test_beamer_decides_like_reference(bottom_up, f_edges, u_edges,
                                       f_count):
    def w(mod, arr, b):
        return mod.Workload(3, arr(f_count), arr(f_edges), arr(7.0),
                            arr(u_edges), 1200, b, n_roots=2)

    ref = ref_engine.BeamerHybrid().decide(
        w(ref_engine, jnp.float32, jnp.asarray(bottom_up)))
    got = t_engine.BeamerHybrid().decide(
        w(t_engine, lambda x: torch.tensor(x, dtype=torch.float32),
          torch.tensor(bottom_up)))
    assert (int(got[0]), bool(got[1])) == (int(ref[0]), bool(ref[1]))


# ---------------------------------------------------------------------------
# The slice end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batched", [False, True], ids=["single", "batch4"])
@pytest.mark.parametrize("policy_index", range(4), ids=POLICY_IDS)
def test_slice_matches_reference(graphs, policy_index, batched):
    check_slice(graphs, "rmat9", policy_index, batched)


def test_nonsimd_scalar_layers_match_reference(graphs):
    g = graphs["rmat9"]
    roots = [3, 7, 11, 100]
    ct, ref = run_reference(g, ref_engine.ThresholdSimd(2048), roots,
                            algorithm="nonsimd")
    got = run_port(to_port(g), t_engine.ThresholdSimd(2048), roots,
                   ct.resolved.tile, algorithm="nonsimd")
    np.testing.assert_array_equal(got.stats.numpy(), np.asarray(ref.stats))
    np.testing.assert_array_equal(words_np(got.state.visited),
                                  np.asarray(ref.state.visited))
    np.testing.assert_array_equal(got.depths.numpy(), np.asarray(ref.depths))


def test_launches_per_layer(graphs):
    """3 kernel calls per fused layer, 1 per scalar layer."""
    g = graphs["rmat9"]
    ct, _ = run_reference(g, ref_engine.ThresholdSimd(2048), [17])
    res = run_port(to_port(g), t_engine.ThresholdSimd(2048), [17],
                   ct.resolved.tile)
    for s, mode in zip(t_engine.layer_stats(res),
                       res.stats[:, 3].tolist()):
        assert s.launches == (1 if mode == t_engine.MODE_SCALAR else 3)
