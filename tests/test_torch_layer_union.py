"""The one-launch layer kernels K5 (CSR) and K9 (SELL-C-σ), which plan
the union of the batch's work-lists in the launch and walk it with one
CTA per item for every root that lists it.

On the CPU: K5's and K9's plain versions against the reference's
``fused_gather`` layer (its planner, its Pallas gather or slab sweep in
interpret mode, restoration) at 33 roots, two root-mask words, with an
empty-frontier root and a dense root, in both directions: ``out``,
visited and the marked set exact, and ``n_active`` equal to the union
planner's per-root counts (`plan_union_plain`) on the same bitmaps;
K5's owner slots and the kernels' scratch layout.  On the card (tests
marked ``cuda``): both kernels against their plain versions at 8 and 33
roots, depths 0 and 2, both layouts of the per-root state.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.core.csr import padding_premarked_visited as ref_premarked
from repro.formats.sell import SellFormat as RefSell
from repro.kernels import gather_expand as ref_ge
from repro.kernels import ops as ref_ops

from _torch_parity import (cuda_device, rmat_graph, to_port,  # noqa: F401
                           words_np)
from repro_torch import formats, interop
from repro_torch.core import engine as t_engine
from repro_torch.kernels import gather_expand as ge
from repro_torch.kernels import layer_fused as lf
from repro_torch.kernels import ops
from repro_torch.kernels import plan as t_plan
from repro_torch.kernels import restoration as t_rest
from repro_torch.kernels import sell_expand as se

WIDE = 33           # two root-mask words
EMPTY, DENSE = 0, 1  # the roots with an empty and with a dense frontier


def _pack(dense):
    n_batch = dense.shape[0]
    return (dense.reshape(n_batch, -1, 32).astype(np.uint64)
            << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)


def _state(g, seed, n_batch):
    """(frontier, visited, p0) of a mid-traversal layer on ``g``: root
    EMPTY has an empty frontier, root DENSE nine in ten vertices in its
    frontier; visited holds the frontier, and padding is premarked."""
    n = g.n_vertices
    rng = np.random.default_rng(seed)
    base = np.asarray(ref_premarked(n))
    density = rng.uniform(0.01, 0.1, (n_batch, 1))
    density[EMPTY], density[DENSE] = 0.0, 0.9
    dense_f = rng.random((n_batch, n)) < density
    dense_v = dense_f | (rng.random((n_batch, n)) < 0.3)
    dense_v[DENSE] = dense_f[DENSE]
    pad = np.zeros((n_batch, base.shape[0] * 32 - n), bool)
    frontier = _pack(np.concatenate([dense_f, pad], 1))
    visited = _pack(np.concatenate([dense_v, pad], 1)) | base
    p0 = np.full((n_batch, base.shape[0] * 32), n, np.int32)
    return frontier, visited, p0


def _port(frontier, visited, p0, device="cpu"):
    w = lambda a: interop.words_to_torch(a, device)
    return w(frontier), w(visited), torch.from_numpy(p0.copy()).to(device)


def _check_layer(n, p0, got, ref):
    """After restoration the port's (out, P, n_active) and the
    reference's racy (out, P) agree on ``out`` and the marked set; P is
    restored."""
    out, p, _ = got
    out_r, p_r = ref
    assert int(p.min()) >= 0
    np.testing.assert_array_equal(p.numpy() != p0, p_r < 0)
    _, d_r = t_rest.restoration_plain(torch.from_numpy(p_r.copy()), n)
    np.testing.assert_array_equal(words_np(out), out_r | words_np(d_r))


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------

def _csr_case(seed, n_batch=WIDE, tile=256):
    g = rmat_graph(9)
    gt = to_port(g)
    rows_t = t_engine._pad_rows_to_tile(gt.rows, g.n_vertices, tile)
    fg = lf.fused_csr(gt.colstarts, rows_t, g.n_vertices, tile,
                      g.n_vertices_padded)
    return g, fg, _state(g, seed, n_batch)


@pytest.mark.parametrize("bottom_up", [False, True],
                         ids=["topdown", "bottomup"])
def test_layer_fused_plain_at_33_roots_matches_reference_layer(bottom_up):
    g, fg, (frontier, visited, p0) = _csr_case(0)
    n, tile = g.n_vertices, fg.tile
    active = ~visited if bottom_up else frontier
    wl, na = ref_engine.plan_active_tiles_batched(
        g.colstarts, jnp.asarray(active), n, tile, fg.n_blocks,
        packed=True)
    out_r, p_r = ref_ge.gather_expand_batched(
        wl, na, jnp.asarray(np.asarray(fg.rows)),
        jnp.asarray(np.asarray(g.colstarts)), jnp.asarray(frontier),
        jnp.asarray(visited), jnp.zeros_like(jnp.asarray(frontier)),
        jnp.asarray(p0), n_vertices=n, tile=tile, bottom_up=bottom_up,
        interpret=True)
    f, v, p = _port(frontier, visited, p0)
    got = ops.layer_fused_batched(fg, f, v, p, bottom_up=bottom_up)
    _check_layer(n, p0, got, (np.asarray(out_r), np.asarray(p_r)))
    plan = t_plan.plan_union_plain(fg, v if bottom_up else f,
                                   complement=bottom_up)
    np.testing.assert_array_equal(got[2].numpy(), plan.na.numpy())
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(na))
    if not bottom_up:
        assert int(got[2][EMPTY]) == 0
        assert int(got[2][DENSE]) == int(plan.na.max())


def test_layer_fused_owner_scan_refuses_a_ring_with_no_room():
    """K5 sizes its owner scan as K3 does; the error names K5."""
    with pytest.raises(ValueError, match="layer_fused: .*owner scan"):
        ge.owner_sub(512, 112, "layer_fused")   # a ring of 231,424 bytes


@pytest.mark.parametrize("n_batch", [8, WIDE])
def test_union_scratch_holds_every_buffer(n_batch):
    n_items, n_words, grid = 70, 16, 5
    na, buf, ptrs = lf.union_scratch(n_items, n_batch, n_words, grid,
                                     "cpu")
    sizes = [n_items * -(-n_batch // 32), n_items, 1, (n_batch + 1) * grid]
    sizes += [n_words * n_batch] * 3
    sizes = [-(-n // 4) * 4 for n in sizes]       # each on 16 bytes
    assert na.shape == (n_batch,) and buf.numel() == sum(sizes)
    assert ptrs == [buf.data_ptr() + 4 * sum(sizes[:i])
                    for i in range(len(sizes))]
    assert all((x - buf.data_ptr()) % 16 == 0 for x in ptrs)


def test_wrappers_refuse_a_misaligned_parent():
    p = torch.zeros((2 * 64 + 1,), dtype=torch.int32)[1:].view(2, 64)
    with pytest.raises(ValueError, match="16-byte"):
        lf.check_p_aligned("layer_fused", p)
    lf.check_p_aligned("layer_fused", torch.zeros((2, 64), dtype=torch.int32))


# ---------------------------------------------------------------------------
# K9
# ---------------------------------------------------------------------------

def _sell_case(seed, spp, n_batch=WIDE, sigma=128):
    g = rmat_graph(9)
    ref_fmt = RefSell.from_csr(g, sigma=sigma)
    fmt = formats.SellFormat.from_csr(to_port(g), sigma=sigma)
    return g, ref_fmt, fmt.sell_graph(spp), _state(g, seed, n_batch)


@pytest.mark.parametrize("spp", [1, 2])
@pytest.mark.parametrize("bottom_up", [False, True],
                         ids=["topdown", "bottomup"])
def test_sell_layer_fused_plain_at_33_roots_matches_reference_layer(
        bottom_up, spp):
    g, ref_fmt, graph, (frontier, visited, p0) = _sell_case(1, spp)
    n = g.n_vertices
    n_steps = graph.n_steps
    active = ~visited if bottom_up else frontier
    wl, na = jax.vmap(lambda a: ref_fmt._plan_slab_steps(a, spp, n_steps))(
        jnp.asarray(active))
    out_r, p_r = ref_ops.sell_batched(
        ref_fmt.cols, ref_fmt.slab_rows, jnp.asarray(frontier),
        jnp.asarray(visited), jnp.zeros_like(jnp.asarray(frontier)),
        jnp.asarray(p0), n_vertices=n, slabs_per_step=spp, worklist=wl,
        n_active=na, bottom_up=bottom_up, interpret=True)
    f, v, p = _port(frontier, visited, p0)
    got = ops.sell_layer_fused_batched(graph, f, v, p, bottom_up=bottom_up)
    _check_layer(n, p0, got, (np.asarray(out_r), np.asarray(p_r)))
    plan = t_plan.plan_union_plain(graph, v if bottom_up else f,
                                   complement=bottom_up)
    np.testing.assert_array_equal(got[2].numpy(), plan.na.numpy())
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(na))
    if not bottom_up:
        assert int(got[2][EMPTY]) == 0
        assert int(got[2][DENSE]) == int(plan.na.max())


# ---------------------------------------------------------------------------
# On the card: the kernels against their plain versions
# ---------------------------------------------------------------------------

def _contract(got, want, p0):
    """K5's and K9's contract: n_active, ``out`` and the marked set
    bitwise, P restored."""
    (out_k, p_k, na_k), (out_p, p_p, na_p) = got, want
    assert torch.equal(na_k.cpu(), na_p.cpu())
    assert torch.equal(out_k.cpu(), out_p.cpu())
    assert torch.equal((p_k.cpu() != p0), (p_p.cpu() != p0))
    assert int(p_k.min()) >= 0


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("bottom_up", [False, True],
                         ids=["topdown", "bottomup"])
@pytest.mark.parametrize("n_batch", [8, WIDE])
def test_cuda_layer_fused_union_matches_plain(cuda_device, n_batch,
                                              bottom_up, depth):
    g, fg, (frontier, visited, p0) = _csr_case(2, n_batch)
    f, v, p = _port(frontier, visited, p0)
    want = lf.layer_fused_plain(fg, f, v, p, bottom_up=bottom_up)
    fg_d = lf.FusedCsr(*(t.to(cuda_device) if torch.is_tensor(t) else t
                         for t in fg))
    got = lf.layer_fused_cuda(fg_d, *_port(frontier, visited, p0,
                                           cuda_device),
                              bottom_up=bottom_up, prefetch_depth=depth)
    torch.cuda.synchronize()
    _contract(got, want, torch.from_numpy(p0))


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("bottom_up", [False, True],
                         ids=["topdown", "bottomup"])
@pytest.mark.parametrize("n_batch", [8, WIDE])
def test_cuda_sell_layer_fused_union_matches_plain(cuda_device, n_batch,
                                                   bottom_up, depth):
    _, _, graph, (frontier, visited, p0) = _sell_case(3, 2, n_batch)
    f, v, p = _port(frontier, visited, p0)
    want = se.sell_layer_fused_plain(graph, f, v, p, bottom_up=bottom_up)
    graph_d = se.SellGraph(*(t.to(cuda_device) if torch.is_tensor(t) else t
                             for t in graph))
    got = se.sell_layer_fused_cuda(
        graph_d, *_port(frontier, visited, p0, cuda_device),
        bottom_up=bottom_up, prefetch_depth=depth)
    torch.cuda.synchronize()
    _contract(got, want, torch.from_numpy(p0))
