"""Parity of the port's main-path kernels with the JAX Pallas kernels.

The plain torch versions run here; the JAX kernels run in interpret
mode, as the reference's own tests run them.  K1 (restoration) and K2
(compaction) must match bitwise, including K2's truncation past
``size`` and its ``fill`` padding.  K3 (gather-expand) races by design
and the two implementations visit tiles in different orders, so it is
held to what restoration makes exact: ``out | delta``, ``visited |
delta`` and the set of marked vertices, with every marked parent a
frontier neighbour.  The CUDA kernels are compared with the plain
versions by the tests marked ``cuda`` (skipped without a GPU) and by
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.core.csr import padding_premarked_visited as ref_premarked
from repro.kernels import compact as ref_compact
from repro.kernels import gather_expand as ref_ge
from repro.kernels import ops as ref_ops
from repro.kernels.restoration import restoration as ref_restoration

from _torch_parity import cuda_device, rmat_graph, words_np  # noqa: F401
from repro_torch import interop
from repro_torch.kernels import compact as t_compact
from repro_torch.kernels import gather_expand as t_ge
from repro_torch.kernels import ops
from repro_torch.kernels import restoration as t_rest


def _marked_parent(seed, n_rows, v_pad, density=0.2):
    rng = np.random.default_rng(seed)
    nv = v_pad - 128
    p = np.full((n_rows, v_pad), nv, np.int32)
    marked = rng.random((n_rows, v_pad)) < density
    parents = rng.integers(0, nv, (n_rows, v_pad))
    p[marked] = (parents - nv)[marked]
    p[:, : v_pad // 7] = rng.integers(0, nv, v_pad // 7)   # settled
    return p, nv


# ---------------------------------------------------------------------------
# K1 restoration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("v_pad,tile", [(1024, 256), (4096, 4096),
                                        (8192, 2048), (2048, 32)])
def test_restoration_plain_matches_pallas(v_pad, tile):
    p, nv = _marked_parent(v_pad + tile, 1, v_pad)
    f_r, d_r = ref_restoration(jnp.asarray(p[0]), n_vertices=nv, tile=tile,
                               interpret=True)
    f_t, d_t = t_rest.restoration_plain(torch.from_numpy(p[0]), nv)
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_r))
    np.testing.assert_array_equal(words_np(d_t), np.asarray(d_r))


@pytest.mark.parametrize("n_batch", [1, 3])
def test_restore_wrapper_batched_matches_reference(n_batch):
    p, nv = _marked_parent(n_batch, n_batch, 1152)
    f_r, d_r = ref_ops.restore(jnp.asarray(p), n_vertices=nv,
                               interpret=True)
    f_t, d_t = ops.restore(torch.from_numpy(p), n_vertices=nv)
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_r))
    np.testing.assert_array_equal(words_np(d_t), np.asarray(d_r))


# ---------------------------------------------------------------------------
# K2 compaction
# ---------------------------------------------------------------------------

def _bitmaps(seed, n_batch, n_words, density):
    rng = np.random.default_rng(seed)
    dense = rng.random((n_batch, n_words * 32)) < density
    w = (dense.reshape(n_batch, n_words, 32).astype(np.uint64)
         << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
    w[:, -1] |= np.uint32(1 << 31)               # the sign bit as int32
    return w


@pytest.mark.parametrize("n_words,size,fill,density", [
    (300, 300 * 32, 9600, 0.3),        # full queue (the engine's size)
    (300, 1000, 9600, 0.3),            # truncation past size
    (64, 64 * 32, -1, 0.02),           # sparse, odd fill
    (513, 513 * 32, 7, 0.9),           # dense, ragged 256-word tiles
    (40, 5, 0, 0.5),                   # tiny queue
])
def test_compact_plain_matches_pallas(n_words, size, fill, density):
    words = _bitmaps(n_words + size, 3, n_words, density)
    q_r, c_r = ref_compact.frontier_compact_batched(
        jnp.asarray(words), size=size, fill=fill, tile_words=256,
        interpret=True)
    q_t, c_t = t_compact.compact_plain(interop.words_to_torch(words, "cpu"),
                                       size, fill)
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_r))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_r))


def test_single_root_compact_is_batched_at_b1():
    words = _bitmaps(4, 1, 100, 0.2)[0]
    q_r, c_r = ref_ops.frontier_compact(jnp.asarray(words), size=2000,
                                        fill=3200, interpret=True)
    q_t, c_t = ops.frontier_compact(interop.words_to_torch(words, "cpu"),
                                    size=2000, fill=3200)
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_r))
    assert int(c_t) == int(c_r)


# ---------------------------------------------------------------------------
# K3 gather-expand
# ---------------------------------------------------------------------------

def test_owner_search_matches_reference():
    g = rmat_graph(8)
    cs = np.asarray(g.colstarts)
    e = np.arange(0, g.n_edges_padded, 3, dtype=np.int32)
    ref = ref_ge._owner_search(jnp.asarray(cs), jnp.asarray(e), len(cs))
    got = t_ge._owner_search(torch.from_numpy(cs.copy()),
                             torch.from_numpy(e), len(cs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _layer_case(seed, bottom_up, tile=256, n_batch=3):
    """A mid-traversal state on a SCALE-9 R-MAT graph and the
    reference's work-lists for it."""
    g = rmat_graph(9)
    n = g.n_vertices
    rng = np.random.default_rng(seed)
    base = np.asarray(ref_premarked(n))
    dense_f = rng.random((n_batch, n)) < 0.05
    dense_v = dense_f | (rng.random((n_batch, n)) < 0.3)
    pad = np.zeros((n_batch, base.shape[0] * 32 - n), bool)

    def pack(d):
        d = np.concatenate([d, pad], 1).reshape(n_batch, -1, 32)
        return (d.astype(np.uint64) << np.arange(32, dtype=np.uint64)) \
            .sum(-1).astype(np.uint32)

    frontier = pack(dense_f)
    visited = pack(dense_v) | base
    rows_t = ref_engine._pad_rows_to_tile(g.rows, n, tile)
    n_blocks = int(rows_t.shape[0]) // tile
    active = ~visited if bottom_up else frontier
    wl, na = ref_engine.plan_active_tiles_batched(
        g.colstarts, jnp.asarray(active), n, tile, n_blocks, packed=True)
    p0 = np.full((n_batch, base.shape[0] * 32), n, np.int32)
    return dict(g=g, n=n, tile=tile, rows_t=np.asarray(rows_t),
                cs=np.asarray(g.colstarts), frontier=frontier,
                visited=visited, wl=np.asarray(wl), na=np.asarray(na),
                p0=p0)


def _run_reference(c, bottom_up):
    out0 = np.zeros_like(c["frontier"])
    out, p = ref_ge.gather_expand_batched(
        jnp.asarray(c["wl"]), jnp.asarray(c["na"]),
        jnp.asarray(c["rows_t"]), jnp.asarray(c["cs"]),
        jnp.asarray(c["frontier"]), jnp.asarray(c["visited"]),
        jnp.asarray(out0), jnp.asarray(c["p0"]), n_vertices=c["n"],
        tile=c["tile"], bottom_up=bottom_up, interpret=True)
    return np.asarray(out), np.asarray(p)


def _run_port(c, bottom_up, fn=t_ge.gather_expand_plain, device="cpu"):
    t = lambda a: torch.from_numpy(np.array(a)).to(device)
    w = lambda a: interop.words_to_torch(a, device)
    out = torch.zeros(c["frontier"].shape, dtype=torch.int32,
                      device=device)
    p = t(c["p0"])
    fn(t(c["wl"]), t(c["na"]), t(c["rows_t"]), t(c["cs"]),
       w(c["frontier"]), w(c["visited"]), out, p, n_vertices=c["n"],
       tile=c["tile"], bottom_up=bottom_up)
    return words_np(out), p.cpu().numpy()


def _check_repaired(c, ref, got):
    """After restoration: equal out/visited/marked set; every marked
    parent is a frontier vertex adjacent to its vertex."""
    (out_r, p_r), (out_t, p_t) = ref, got
    n = c["n"]
    np.testing.assert_array_equal(p_t < 0, p_r < 0)
    _, d_r = ref_ops.restore(jnp.asarray(p_r), n_vertices=n,
                             interpret=True)
    _, d_t = t_rest.restoration_plain(torch.from_numpy(p_t), n)
    d_r, d_t = np.asarray(d_r), words_np(d_t)
    np.testing.assert_array_equal(out_t | d_t, out_r | d_r)
    np.testing.assert_array_equal(c["visited"] | d_t, c["visited"] | d_r)
    rows, cs = np.asarray(c["g"].rows), c["cs"]
    for b in range(p_t.shape[0]):
        for v in np.nonzero(p_t[b] < 0)[0]:
            u = int(p_t[b, v]) + n
            assert (c["frontier"][b, u >> 5] >> np.uint32(u & 31)) & 1
            assert v in rows[cs[u]:cs[u + 1]]
    assert (p_t < 0).any(), "the case must discover something"


@pytest.mark.parametrize("bottom_up", [False, True],
                         ids=["topdown", "bottomup"])
@pytest.mark.parametrize("seed", [0, 1])
def test_gather_expand_plain_matches_pallas(bottom_up, seed):
    c = _layer_case(seed, bottom_up)
    _check_repaired(c, _run_reference(c, bottom_up),
                    _run_port(c, bottom_up))


def test_gather_expand_single_root_wrapper():
    c = _layer_case(2, False, n_batch=1)
    ref = _run_reference(c, False)
    out = torch.zeros(c["frontier"].shape[1], dtype=torch.int32)
    p = torch.from_numpy(c["p0"][0].copy())
    ops.gather_expand(torch.from_numpy(c["wl"][0]), int(c["na"][0]),
                      torch.from_numpy(c["rows_t"]),
                      torch.from_numpy(c["cs"]),
                      interop.words_to_torch(c["frontier"][0], "cpu"),
                      interop.words_to_torch(c["visited"][0], "cpu"),
                      out, p, n_vertices=c["n"], tile=c["tile"])
    _check_repaired(c, ref, (words_np(out)[None], p.numpy()[None]))


# ---------------------------------------------------------------------------
# Wrappers: launch accounting and device dispatch
# ---------------------------------------------------------------------------

def test_count_launches_charges_one_per_wrapper_call():
    p, nv = _marked_parent(0, 2, 256)
    words = torch.zeros((2, 8), dtype=torch.int32)
    before = dict(ops.KERNEL_LAUNCHES)
    with ops.count_launches() as c:
        ops.restore(torch.from_numpy(p), n_vertices=nv)
        ops.frontier_compact_batched(words, size=256, fill=nv)
        ops.frontier_compact(words[0], size=256, fill=nv)
    assert c.count == 3
    assert ops.KERNEL_LAUNCHES == before, \
        "the plain arm must not count as a kernel launch"


def test_wrappers_refuse_other_devices():
    p = torch.zeros((2, 256), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.restore(p, n_vertices=128)


# ---------------------------------------------------------------------------
# CUDA kernels vs plain versions (need the card)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_restoration_matches_plain(cuda_device):
    p, nv = _marked_parent(3, 8, 8192)
    t = torch.from_numpy(p).to(cuda_device)
    f_k, d_k = t_rest.restoration_cuda(t, nv)
    f_p, d_p = t_rest.restoration_plain(t, nv)
    assert torch.equal(f_k, f_p) and torch.equal(d_k, d_p)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [300 * 32, 1000])
def test_cuda_compact_matches_plain(cuda_device, size):
    words = interop.words_to_torch(_bitmaps(9, 8, 300, 0.3), cuda_device)
    q_k, c_k = t_compact.compact_cuda(words, size, 9600)
    q_p, c_p = t_compact.compact_plain(words, size, 9600)
    assert torch.equal(q_k, q_p) and torch.equal(c_k, c_p)


@pytest.mark.cuda
@pytest.mark.parametrize("bottom_up", [False, True],
                         ids=["topdown", "bottomup"])
def test_cuda_gather_expand_matches_pallas(cuda_device, bottom_up):
    c = _layer_case(5, bottom_up)
    _check_repaired(c, _run_reference(c, bottom_up),
                    _run_port(c, bottom_up, t_ge.gather_expand_cuda,
                              cuda_device))
