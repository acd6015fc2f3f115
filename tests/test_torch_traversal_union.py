"""The whole-traversal kernels K6 (CSR) and K10 (SELL-C-σ), whose every
layer plans the union of the batch's work-lists in the launch and walks
it with one CTA per item for every root that lists it.

On the CPU: the port's ``persistent`` pipeline at 33 roots (two
root-mask words; one root is an isolated vertex, whose frontier empties
after layer 0, layers before the others') on an R-MAT SCALE-10 graph,
under the four policies, against the reference's ``fused_gather`` path
at ``prefetch_depth=0`` on the same layout: visited, frontier, depths,
layers and the direction log bitwise; stats columns 0-4 and 6, and
column 5 (tiles) on every non-scalar CSR layer (a scalar CSR layer of
K6 reports its planned blocks, the reference's the full stream's) and
on every SELL layer.  The wrappers' scratch and loop buffers.  On the
card (tests marked ``cuda``): K6 and K10 against their plain versions
at 8 and 33 roots, under the four policies, at depths 0 and 2.
"""
import numpy as np
import pytest
import torch

from repro.api import plan as ref_plan
from repro.api.spec import TraversalSpec as RefSpec
from repro.core import engine as ref_engine
from repro.formats.sell import SellFormat as RefSell

from _torch_parity import (POLICY_IDS, POLICY_PAIRS, cuda_device,  # noqa: F401
                           rmat_graph, to_port, words_np)
import repro_torch.bfs as tbfs
from repro_torch import formats
from repro_torch.core import engine as t_engine
from repro_torch.kernels import layer_fused as lf
from repro_torch.kernels import traversal_fused as t_tf
from repro_torch.obs.metrics import clear_degrade_log, degrade_log

WIDE = 33           # two root-mask words
SIGMA = 1024        # the built-in auto σ, passed explicitly to both


@pytest.fixture(scope="module")
def rmat10():
    return rmat_graph(10)


def _roots(g, n_batch):
    """An isolated vertex first, then n_batch - 1 vertices of degree > 0
    from a fixed seed."""
    deg = np.diff(np.asarray(g.colstarts))
    rng = np.random.default_rng(0)
    picks = rng.choice(np.nonzero(deg > 0)[0], n_batch - 1, replace=False)
    return [int(np.nonzero(deg == 0)[0][0])] + picks.tolist()


def _reference(g, layout, policy_index, roots):
    """(resolved tile, result) of the reference's fused_gather path on
    ``layout`` ("csr" or "sell")."""
    graph = g if layout == "csr" else RefSell.from_csr(g, sigma=SIGMA)
    ct = ref_plan.plan(graph, RefSpec(
        policy=POLICY_PAIRS[policy_index][0], algorithm="simd",
        pipeline="fused_gather", prefetch_depth=0, packed=True,
        max_layers=128))
    return ct.resolved.tile, ct.run_batched(np.asarray(roots, np.int32))


def _port_graph(g, layout):
    gt = to_port(g)
    return formats.SellFormat.from_csr(gt, sigma=SIGMA) \
        if layout == "sell" else gt


@pytest.mark.parametrize("layout", ["csr", "sell"])
@pytest.mark.parametrize("policy_index", range(4), ids=POLICY_IDS)
def test_persistent_at_33_roots_matches_reference(rmat10, layout,
                                                  policy_index):
    roots = _roots(rmat10, WIDE)
    tile, ref = _reference(rmat10, layout, policy_index, roots)
    spec = tbfs.TraversalSpec(policy=POLICY_PAIRS[policy_index][1],
                              pipeline="persistent", tile=tile,
                              max_layers=128)
    clear_degrade_log()
    got = tbfs.plan(_port_graph(rmat10, layout), spec,
                    device="cpu").run_batched(roots)
    assert not degrade_log()
    np.testing.assert_array_equal(words_np(got.state.visited),
                                  np.asarray(ref.state.visited))
    np.testing.assert_array_equal(words_np(got.state.frontier),
                                  np.asarray(ref.state.frontier))
    np.testing.assert_array_equal(got.depths.numpy(), np.asarray(ref.depths))
    n_layers = int(ref.state.layer)
    assert int(got.state.layer) == n_layers
    assert tbfs.direction_log(got) == ref_engine.direction_log(ref)
    st_t, st_r = got.stats.numpy(), np.asarray(ref.stats)
    np.testing.assert_array_equal(st_t[:, :5], st_r[:, :5])
    np.testing.assert_array_equal(st_t[:, 6], st_r[:, 6])
    listed = (st_r[:, 3] != t_engine.MODE_SCALAR) | (layout == "sell")
    np.testing.assert_array_equal(st_t[listed, 5], st_r[listed, 5])
    assert st_t[:n_layers, 7].tolist() == [1] + [0] * (n_layers - 1)
    # the isolated root is done after layer 0, the others later
    depths = got.depths.numpy()
    assert depths[0] == 1 and depths[1:].min() > 1


@pytest.mark.parametrize("layout", ["csr", "sell"])
@pytest.mark.parametrize("n_batch", [8, WIDE])
def test_traversal_scratch_holds_every_buffer(rmat10, layout, n_batch):
    """K6's and K10's scratch: the union scratch over their items (CSR
    rows-blocks, SELL slab groups) and the loop's buffers."""
    ct = tbfs.plan(_port_graph(rmat10, layout),
                   tbfs.TraversalSpec(pipeline="persistent"), device="cpu")
    graph = ct.fmt.persistent_graph(ct.resolved)
    n_items = graph.n_blocks if layout == "csr" else graph.n_steps
    n_words, grid, max_layers = int(graph.deg.shape[0]) // 32, 7, 5
    na, buf, ptrs = lf.union_scratch(n_items, n_batch, n_words, grid, "cpu")
    sizes = [n_items * -(-n_batch // 32), n_items, 1, (n_batch + 1) * grid]
    sizes += [n_words * n_batch] * 3
    sizes = [-(-n // 4) * 4 for n in sizes]       # each on 16 bytes
    assert na.shape == (n_batch,) and buf.numel() == sum(sizes)
    assert ptrs == [buf.data_ptr() + 4 * sum(sizes[:i])
                    for i in range(len(sizes))]
    assert all((x - buf.data_ptr()) % 16 == 0 for x in ptrs)
    code = t_tf.PolicyCode(t_tf.PAPER_LAYERS, simd_layers=(1, 3))
    acc, depths, layers, stats, simd = t_tf.loop_buffers(
        code, n_batch, max_layers, "cpu")
    assert acc.dtype == torch.int64
    assert acc.shape == ((max_layers + 1) * n_batch * 4,)
    assert depths.shape == (n_batch,) and layers.shape == (1,)
    assert stats.shape == (max_layers, t_tf.N_STATS)
    assert simd.tolist() == [0, 1, 0, 1, 0]


def test_traversal_wrappers_refuse_a_misaligned_parent():
    """K6 and K10 copy and restore P with 16-byte loads; the error names
    the kernel and the tensor."""
    p = torch.zeros((2 * 64 + 1,), dtype=torch.int32)[1:].view(2, 64)
    with pytest.raises(ValueError, match="traversal_fused: deg must"):
        lf.check_p_aligned("traversal_fused", p, "deg")


# ---------------------------------------------------------------------------
# On the card: the kernels against their plain versions
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("policy_index", range(4), ids=POLICY_IDS)
@pytest.mark.parametrize("n_batch", [8, WIDE])
@pytest.mark.parametrize("layout", ["csr", "sell"])
def test_cuda_traversal_union_matches_plain(cuda_device, rmat10, layout,
                                            n_batch, policy_index, depth):
    """Frontier, visited, depths, layers and stats bitwise; P restored
    and set where the plain version's is."""
    ct = tbfs.plan(_port_graph(rmat10, layout), tbfs.TraversalSpec(
        policy=POLICY_PAIRS[policy_index][1], pipeline="persistent",
        prefetch_depth=depth), device=cuda_device)
    fmt, spec = ct.fmt, ct.resolved
    graph = fmt.persistent_graph(spec)
    roots = torch.as_tensor(_roots(rmat10, n_batch), dtype=torch.int32,
                            device=cuda_device)
    state = t_engine._init_batched(roots, fmt.n_vertices,
                                   fmt.n_vertices_padded)
    kw = dict(code=t_engine.encode_policy(spec.policy, fmt.n_vertices,
                                          n_batch, spec.max_layers),
              max_layers=spec.max_layers)
    cuda, plain = ((t_tf.traversal_fused_cuda, t_tf.traversal_fused_plain)
                   if layout == "csr" else
                   (t_tf.sell_traversal_fused_cuda,
                    t_tf.sell_traversal_fused_plain))
    want = plain(graph, *state, **kw)
    got = cuda(graph, *state, **kw, prefetch_depth=depth)
    torch.cuda.synchronize()
    for i in (0, 1, 3, 4, 5):
        assert torch.equal(got[i], want[i])
    p0 = state[2]
    assert int(got[2].min()) >= 0
    assert torch.equal(got[2] != p0, want[2] != p0)
