"""The union of the batch's work-lists and the owner scan, which the CUDA
kernels K3, K4 and K11 walk and run instead of each root's own list and
a binary search per slot.

On the CPU: `gather_expand.union_worklist` against a direct numpy
construction (list, count and root masks, any batch size, the clamped
tail and the dense arm of the semiring step); `owners_by_scan_plain`,
the owner scan's plain counterpart, against the port's and the
reference's owner search on R-MAT graphs and on graphs made to stress
it (a hub spanning several tiles, a run of isolated vertices longer
than a tile, the sentinel tail).  On the card (tests marked ``cuda``):
K3 at depths 0 and 2 under its restoration contract and K11 bitwise,
against their plain versions at B = 1, 8 and 33, on the layer's plan
(the union planner and K12 are in ``test_torch_plan.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.kernels import gather_expand as ref_ge

from _torch_parity import (csr_from_pairs, cuda_device,  # noqa: F401
                           isolated_graph, rmat_graph, to_port)
from repro_torch import interop
from repro_torch.core import engine as t_engine
from repro_torch.kernels import gather_expand as ge
from repro_torch.kernels import restoration as t_rest
from repro_torch.kernels.layer_fused import compact_worklist

N_BLOCKS = 70


def _random_lists(seed, n_batch, density=0.3, empty=()):
    """(wl, na) of random active sets in the `compact_worklist` contract;
    roots in ``empty`` list nothing."""
    rng = np.random.default_rng(seed)
    act = torch.from_numpy(rng.random((n_batch, N_BLOCKS)) < density)
    act[list(empty)] = False
    return compact_worklist(act, N_BLOCKS)


def _garbage_tail(seed, n_batch):
    """Lists whose entries past na hold arbitrary block ids."""
    wl, na = _random_lists(seed, n_batch, 0.2)
    rng = np.random.default_rng(seed + 1)
    noise = torch.from_numpy(rng.integers(0, N_BLOCKS, wl.shape)
                             .astype(np.int32))
    tail = torch.arange(N_BLOCKS) >= na[:, None]
    return torch.where(tail, noise, wl), na


def _dense_arm(seed, n_batch):
    """The semiring step's lists: planned, with the dense roots' rows
    replaced by every block (`CsrFormat._build_semiring_step`)."""
    wl, na = _random_lists(seed, n_batch, 0.1)
    dense = torch.tensor([b % 3 == 1 for b in range(n_batch)])
    full = torch.arange(N_BLOCKS, dtype=torch.int32)
    return (torch.where(dense[:, None], full[None], wl),
            torch.where(dense, N_BLOCKS, na).to(torch.int32))


UNION_CASES = {
    "b1": lambda: _random_lists(0, 1),
    "b3": lambda: _random_lists(1, 3),
    "b8": lambda: _random_lists(2, 8),
    "b33": lambda: _random_lists(3, 33),
    "b40": lambda: _random_lists(4, 40, 0.05),
    "some_roots_empty": lambda: _random_lists(5, 8, empty=(0, 3, 7)),
    "all_roots_empty": lambda: _random_lists(6, 5, empty=range(5)),
    "every_block": lambda: _random_lists(7, 8, density=1.1),
    "clamped_tail": lambda: _random_lists(8, 8, density=0.02),
    "garbage_tail": lambda: _garbage_tail(9, 33),
    "dense_arm": lambda: _dense_arm(10, 8),
}


def _union_np(wl, na):
    """The union, built directly: (list, per-root listed matrix)."""
    wl, na = wl.numpy(), na.numpy()
    listed = np.zeros((wl.shape[0], N_BLOCKS), bool)
    for b in range(wl.shape[0]):
        listed[b, wl[b, :na[b]]] = True
    return np.nonzero(listed.any(0))[0], listed


@pytest.mark.parametrize("case", list(UNION_CASES))
def test_union_worklist_matches_numpy(case):
    wl, na = UNION_CASES[case]()
    n_batch = wl.shape[0]
    ulist, ucount, rmask = ge.union_worklist(wl, na, N_BLOCKS)
    want, listed = _union_np(wl, na)
    assert ulist.dtype == ucount.dtype == rmask.dtype == torch.int32
    assert tuple(ulist.shape) == (N_BLOCKS,) and tuple(ucount.shape) == (1,)
    assert tuple(rmask.shape) == (N_BLOCKS, -(-n_batch // 32))
    assert int(ucount) == want.size
    np.testing.assert_array_equal(ulist[:want.size].numpy(), want)
    assert not ulist[want.size:].any()
    words = rmask.numpy().view(np.uint32)
    for b in range(n_batch):
        bits = (words[:, b // 32] >> np.uint32(b % 32)) & 1
        np.testing.assert_array_equal(bits.astype(bool), listed[b])
    # no bit past the batch in the last word
    assert not (words[:, -1] >> np.uint32((n_batch - 1) % 32) >> 1).any()


def test_union_worklist_of_the_planner_lists():
    """The lists the engine's planner gives a real layer (K2 + block
    marking) have the same union as their numpy construction."""
    c = _layer(8, False)
    wl, na, n_blocks = c["wl"], c["na"], int(c["wl"].shape[1])
    ulist, ucount, rmask = ge.union_worklist(wl, na, n_blocks)
    listed = np.zeros((8, n_blocks), bool)
    for b in range(8):
        listed[b, wl[b, :int(na[b])].numpy()] = True
    want = np.nonzero(listed.any(0))[0]
    assert int(ucount) == want.size > 0
    np.testing.assert_array_equal(ulist[:want.size].numpy(), want)
    bits = (rmask.numpy().view(np.uint32)[:, 0][None]
            >> np.arange(8, dtype=np.uint32)[:, None]) & 1
    np.testing.assert_array_equal(bits.astype(bool), listed)


def _pack(dense):
    d = dense.reshape(dense.shape[0], -1, 32)
    return (d.astype(np.uint64) << np.arange(32, dtype=np.uint64)) \
        .sum(-1).astype(np.uint32)


# ---------------------------------------------------------------------------
# The owner scan
# ---------------------------------------------------------------------------

def hub_graph():
    """Vertex 5 joined to 3,000 others: its adjacency spans several
    tiles of 128 and of 1024."""
    return csr_from_pairs([(5, i) for i in range(6, 3006)], 3100)


def zero_run_graph():
    """Two stars separated by 2,500 isolated vertices: one colstarts
    value shared by a run of owners longer than a tile."""
    pairs = [(0, i) for i in range(1, 40)]
    pairs += [(2600, i) for i in range(2601, 2700)]
    return csr_from_pairs(pairs, 2800)


OWNER_GRAPHS = {"rmat8": lambda: rmat_graph(8), "rmat9": rmat_graph,
                "isolated": isolated_graph, "hub": hub_graph,
                "zero_run": zero_run_graph}


@pytest.mark.parametrize("tile", [128, 1024])
@pytest.mark.parametrize("graph", list(OWNER_GRAPHS))
def test_owners_by_scan_plain_matches_the_owner_search(graph, tile):
    """Every slot of every rows-block, the sentinel tail included (one
    whole block past the last edge), against the port's binary search
    and the reference's."""
    g = OWNER_GRAPHS[graph]()
    cs = np.asarray(g.colstarts)
    n_blocks = -(-int(cs[-1]) // tile) + 1
    blocks = torch.arange(n_blocks)
    cs_t = torch.from_numpy(cs.copy())
    got = ge.owners_by_scan_plain(cs_t, blocks, tile)
    e = (blocks[:, None] * tile + torch.arange(tile)).reshape(-1)
    port = ge._owner_search(cs_t, e, len(cs)).reshape(n_blocks, tile)
    ref = np.asarray(ref_ge._owner_search(
        jnp.asarray(cs), jnp.asarray(e.numpy().astype(np.int32)), len(cs)))
    np.testing.assert_array_equal(got.numpy(), port.numpy())
    np.testing.assert_array_equal(got.numpy(), ref.reshape(n_blocks, tile))
    assert int(got[-1].min()) == g.n_vertices      # the sentinel tail


def test_owners_by_scan_plain_on_a_block_subset():
    """Any subset of blocks, in any order (the union list's blocks)."""
    g = rmat_graph(9)
    cs = torch.from_numpy(np.asarray(g.colstarts).copy())
    blocks = torch.tensor([7, 0, 3, 50, 2])
    got = ge.owners_by_scan_plain(cs, blocks, 256)
    e = (blocks[:, None] * 256 + torch.arange(256)).reshape(-1)
    want = ge._owner_search(cs, e, cs.shape[0]).reshape(5, 256)
    assert torch.equal(got, want)


@pytest.mark.parametrize("tile,depth,sub", [
    (1024, 0, 1024), (128, 0, 128), (4096, 0, 1024), (1024, 2, 1024),
    (1024, 55, 512), (16, 0, 16)])
def test_owner_sub_fits_beside_the_ring(tile, depth, sub):
    assert ge.owner_sub(tile, depth) == sub
    assert ge.stage_bytes(tile, depth) + 4 * sub + ge.SMEM_RESERVE \
        <= ge.SMEM_OPTIN_BYTES


def test_owner_sub_refuses_a_ring_with_no_room():
    with pytest.raises(ValueError, match="owner scan"):
        ge.owner_sub(28928, 1)      # a ring of 231,424 bytes


# ---------------------------------------------------------------------------
# The CUDA kernels against their plain versions (need the card)
# ---------------------------------------------------------------------------

def _layer(n_batch, bottom_up, seed=0, tile=256):
    """A mid-traversal state of ``n_batch`` roots on a reference-built
    SCALE-9 R-MAT graph and the port's plan for it (CPU tensors)."""
    g = to_port(rmat_graph(9))
    n = g.n_vertices
    v_pad = -(-(n + 1) // 32) * 32
    rng = np.random.default_rng(seed)
    dense_f = np.zeros((n_batch, v_pad), bool)
    dense_f[:, :n] = rng.random((n_batch, n)) < 0.05
    dense_v = dense_f.copy()
    dense_v[:, :n] |= rng.random((n_batch, n)) < 0.3
    dense_v[:, n:] = True
    frontier = interop.words_to_torch(_pack(dense_f), "cpu")
    visited = interop.words_to_torch(_pack(dense_v), "cpu")
    rows_t = t_engine._pad_rows_to_tile(g.rows, n, tile)
    n_blocks = int(rows_t.shape[0]) // tile
    wl, na = t_engine.plan_active_tiles_batched(
        g.colstarts, ~visited if bottom_up else frontier, n, tile, n_blocks)
    return dict(n=n, tile=tile, rows=rows_t, cs=g.colstarts.contiguous(),
                frontier=frontier, visited=visited, wl=wl, na=na,
                plan=ge.UnionPlan.of_lists(wl, na, n_blocks), v_pad=v_pad)


def _on(c, device):
    return {k: v.to(device) if torch.is_tensor(v)
            else ge.UnionPlan(*(x.to(device) for x in v))
            if isinstance(v, ge.UnionPlan) else v for k, v in c.items()}


def _k3(c, fn, bottom_up, **extra):
    out = torch.zeros_like(c["frontier"])
    p = torch.full((c["frontier"].shape[0], c["v_pad"]), c["n"],
                   dtype=torch.int32, device=out.device)
    fn(c["plan"], c["rows"], c["cs"], c["frontier"], c["visited"], out, p,
       n_vertices=c["n"], tile=c["tile"], bottom_up=bottom_up, **extra)
    return out, p


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("bottom_up", [False, True],
                         ids=["topdown", "bottomup"])
@pytest.mark.parametrize("n_batch", [1, 8, 33])
def test_cuda_gather_expand_union_matches_plain(cuda_device, n_batch,
                                                bottom_up, depth):
    c = _on(_layer(n_batch, bottom_up), cuda_device)
    out_k, p_k = _k3(c, ge.gather_expand_cuda, bottom_up,
                     prefetch_depth=depth)
    out_p, p_p = _k3(c, ge.gather_expand_plain, bottom_up)
    assert torch.equal(p_k < 0, p_p < 0)
    assert bool((p_k < 0).any())
    _, d_k = t_rest.restoration_plain(p_k, c["n"])
    _, d_p = t_rest.restoration_plain(p_p, c["n"])
    assert torch.equal(out_k | d_k, out_p | d_p)
    assert torch.equal(c["visited"] | d_k, c["visited"] | d_p)
    cs, rows = c["cs"].cpu().numpy(), c["rows"].cpu().numpy()
    fr = c["frontier"].cpu().numpy().view(np.uint32)
    for b, v in zip(*np.nonzero(p_k.cpu().numpy() < 0)):
        g = int(p_k[b, v]) + c["n"]
        u, w = (v, g) if bottom_up else (g, v)
        assert (fr[b, g >> 5] >> np.uint32(g & 31)) & 1
        assert w in rows[cs[u]:cs[u + 1]]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("n_batch", [1, 8, 33])
def test_cuda_gather_relax_union_matches_plain(cuda_device, n_batch, dtype):
    c = _layer(n_batch, False, seed=1)
    rng = np.random.default_rng(n_batch)
    if dtype == "int32":
        vals = rng.integers(0, 6, (n_batch, c["v_pad"])).astype(np.int32)
        kw = dict(unit=1, weighted=False)
    else:
        vals = (rng.random((n_batch, c["v_pad"])) * 8).astype(np.float32)
        vals[rng.random(vals.shape) < 0.3] = np.inf
        kw = dict(unit=0, weighted=True)
    c["vals"] = torch.from_numpy(vals)
    c = _on(c, cuda_device)
    args = (c["plan"], c["rows"], c["cs"], c["frontier"], c["vals"])
    got = ge.gather_relax_cuda(*args, n_vertices=c["n"], tile=c["tile"],
                               **kw)
    want = ge.gather_relax_plain(*args, n_vertices=c["n"], tile=c["tile"],
                                 **kw)
    assert got[0].dtype == c["vals"].dtype
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])
    assert bool((got[0] != c["vals"]).any())


def test_reference_planner_lists_have_the_ports_union():
    """The reference's planner and the port's give one union for the
    same layer (the kernels walk the port's)."""
    c = _layer(8, True)
    words = interop.words_to_numpy(~c["visited"])
    wl_r, na_r = ref_engine.plan_active_tiles_batched(
        jnp.asarray(np.asarray(rmat_graph(9).colstarts)), jnp.asarray(words),
        c["n"], c["tile"], int(c["wl"].shape[1]), packed=True)
    got = ge.union_worklist(c["wl"], c["na"], int(c["wl"].shape[1]))
    want = ge.union_worklist(torch.from_numpy(np.asarray(wl_r)),
                             torch.from_numpy(np.asarray(na_r)),
                             int(c["wl"].shape[1]))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
