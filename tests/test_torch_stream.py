"""The materialized stream: K2's single-pass stream arm and the
apportionment, against the reference.

`ops.frontier_queue`'s plain arm must give the Pallas K2's queue and
counts (interpret mode), truncation past ``size`` and ``fill`` padding
included, and each entry's inclusive degree prefix, each root's total
and its truncated edges as the reference's ``apportion`` counts them;
`ops.apportion`'s plain arm on that queue the reference's whole (u, v,
valid, truncated) stream, bitwise, a hub that overruns the slots
included; and the port's `_batched_edge_stream` the reference's.  The
``cuda`` twins hold the CUDA arms to the plain ones on the card: the
queue, counts, totals and truncated counts bitwise, ``cum`` on each
root's entries, the stream's ``valid`` bitwise and ``u``/``v`` wherever
``valid`` holds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.kernels import compact as ref_compact

from _torch_parity import cuda_device, rmat_graph, to_port  # noqa: F401
from repro_torch import interop
from repro_torch.core import bitmap as t_bm
from repro_torch.core import engine as t_engine
from repro_torch.kernels import apportion as t_ap
from repro_torch.kernels import compact as t_compact
from repro_torch.kernels import ops


@pytest.fixture(scope="module")
def rmat8():
    g = rmat_graph(8)
    return g, to_port(g)


def _words(seed, n_batch, n_words, density, n_vertices=None):
    """Random (B, W) uint32 words; with ``n_vertices``, no bit at or past
    it (an engine bitmap); root 0 is empty."""
    rng = np.random.default_rng(seed)
    dense = rng.random((n_batch, n_words * 32)) < density
    if n_vertices is not None:
        dense[:, n_vertices:] = False
    dense[0] = False
    return (dense.reshape(n_batch, n_words, 32).astype(np.uint64)
            << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)


def _degrees(gt):
    return t_bm.degree_matrix(gt.degrees(), gt.n_vertices_padded) \
        .reshape(-1)


#: (size, n_slots): the engine's queue and stream; a queue cut short; a
#: queue longer than the bitmap; a stream cut short (hubs keep a prefix)
CASES = {"engine": (None, None), "short_queue": (37, None),
         "long_queue": (4000, None), "short_stream": (None, 300)}


@pytest.mark.parametrize("density", [0.02, 0.3, 0.9])
@pytest.mark.parametrize("case", CASES)
def test_frontier_queue_matches_reference(rmat8, case, density):
    g, gt = rmat8
    n = g.n_vertices
    v_pad = gt.n_vertices_padded
    size, n_slots = CASES[case]
    size = size or v_pad
    n_slots = n_slots or g.n_edges_padded
    words = _words(int(density * 100), 3, v_pad // 32, density)
    q_r, c_r = ref_compact.frontier_compact_batched(
        jnp.asarray(words), size=size, fill=n, tile_words=256,
        interpret=True)
    q = ops.frontier_queue(interop.words_to_torch(words, "cpu"), size=size,
                           fill=n, deg=_degrees(gt), n_vertices=n,
                           n_slots=n_slots)
    np.testing.assert_array_equal(q.queue.numpy(), np.asarray(q_r))
    np.testing.assert_array_equal(q.count.numpy(), np.asarray(c_r))
    cs = np.asarray(g.colstarts).astype(np.int64)
    ids = np.asarray(q_r)
    safe = np.minimum(ids, n - 1)
    deg = np.where(ids < n, cs[safe + 1] - cs[safe], 0)
    cum = np.cumsum(deg, axis=1)
    np.testing.assert_array_equal(q.cum.numpy(), cum)
    np.testing.assert_array_equal(q.total.numpy(), cum[:, -1])
    _, _, _, trunc_r = jax.vmap(lambda l: ref_engine.apportion(
        g.colstarts, g.rows, l, n, n_slots))(q_r)
    np.testing.assert_array_equal(q.truncated.numpy(), np.asarray(trunc_r))


@pytest.mark.parametrize("density", [0.02, 0.3, 0.9])
@pytest.mark.parametrize("case", CASES)
def test_apportion_matches_reference(rmat8, case, density):
    """The whole stream bitwise, the invalid slots included."""
    g, gt = rmat8
    n = g.n_vertices
    size, n_slots = CASES[case]
    size = size or gt.n_vertices_padded
    n_slots = n_slots or g.n_edges_padded
    words = _words(7 + int(density * 100), 3, gt.n_vertices_padded // 32,
                   density, n)
    q = ops.frontier_queue(interop.words_to_torch(words, "cpu"), size=size,
                           fill=n, deg=_degrees(gt), n_vertices=n,
                           n_slots=n_slots)
    ref = jax.vmap(lambda l: ref_engine.apportion(
        g.colstarts, g.rows, l, n, n_slots))(jnp.asarray(q.queue.numpy()))
    got = ops.apportion(gt.colstarts, gt.rows, q, n_vertices=n,
                        n_slots=n_slots)
    for r, t in zip(ref, got):
        np.testing.assert_array_equal(t.numpy(), np.asarray(r))
    if case == "short_stream" and density > 0.1:
        assert bool(got[3].gt(0).any()), "no root overran the stream"


@pytest.mark.parametrize("bottom_up", [False, True])
def test_edge_stream_matches_reference(rmat8, bottom_up):
    """The materialized step's stream (K2's stream arm, then the
    apportionment) against the reference's `_batched_edge_stream`."""
    g, gt = rmat8
    n, v_pad, e_pad = g.n_vertices, gt.n_vertices_padded, g.n_edges_padded
    words = _words(3, 4, v_pad // 32, 0.1, n)
    if bottom_up:            # the unvisited set of a premarked bitmap
        words = ~(words | np.asarray(t_bm.pack_bool(
            torch.arange(v_pad) >= n)).view(np.uint32))
    ref = ref_engine._batched_edge_stream(g.colstarts, g.rows,
                                          jnp.asarray(words), v_pad, n,
                                          e_pad, True)
    got = t_engine._batched_edge_stream(
        gt.colstarts, gt.rows, _degrees(gt),
        interop.words_to_torch(words, "cpu"), n, e_pad)
    for r, t in zip(ref, got):
        np.testing.assert_array_equal(t.numpy(), np.asarray(r))


def test_apportion_plain_is_the_engines():
    assert t_engine.apportion is t_ap.apportion_plain


# ---------------------------------------------------------------------------
# The CUDA arms against the plain ones (need the card)
# ---------------------------------------------------------------------------

def _random_csr(seed, n_vertices):
    """Degrees 0-40 with a few hubs of 3000, rows at random."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 41, n_vertices)
    deg[rng.random(n_vertices) < 0.3] = 0
    deg[rng.integers(0, n_vertices, 5)] = 3000
    colstarts = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    rows = rng.integers(0, n_vertices, int(colstarts[-1])).astype(np.int32)
    return torch.from_numpy(colstarts), torch.from_numpy(rows)


#: (roots, words, size, n_slots) — ragged tiles, more than 32 tiles per
#: root (the look-back's second window), a short and a long queue, a
#: short stream, two root-mask words
CUDA_CASES = [(3, 300, None, None), (4, 256 * 40 + 17, None, None),
              (3, 2000, 1000, None), (2, 300, 300 * 32 + 700, None),
              (3, 2000, None, 5000), (33, 700, None, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("density", [0.01, 0.5])
@pytest.mark.parametrize("n_batch,n_words,size,n_slots", CUDA_CASES)
def test_cuda_queue_and_apportion_match_plain(cuda_device, n_batch,
                                              n_words, size, n_slots,
                                              density):
    n = 32 * n_words - 5
    colstarts, rows = _random_csr(n_words, n)
    deg = t_bm.degree_matrix(colstarts[1:] - colstarts[:-1],
                             32 * n_words).reshape(-1)
    size = size or 32 * n_words
    n_slots = n_slots or int(colstarts[-1])
    words = interop.words_to_torch(_words(n_batch, n_batch, n_words,
                                          density, n), "cpu")
    want = t_compact.queue_plain(words, size, n, deg, n, n_slots)
    dev = cuda_device
    got = t_compact.queue_cuda(words.to(dev), size, n, deg.to(dev), n,
                               n_slots)
    for name in ("queue", "count", "total", "truncated"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), \
            name
    for b in range(n_batch):
        k = min(int(want.count[b]), size)
        assert torch.equal(got.cum[b, :k].cpu(), want.cum[b, :k])
    q_plain, c_plain = t_compact.compact_plain(words, size, n)
    q_k, c_k = t_compact.compact_cuda(words.to(dev), size, n)
    assert torch.equal(q_k.cpu(), q_plain) and torch.equal(c_k.cpu(), c_plain)
    u_p, v_p, valid_p, trunc_p = t_ap.apportion_plain(colstarts, rows,
                                                      want.queue, n, n_slots)
    u_k, v_k, valid_k, trunc_k = t_ap.apportion_cuda(
        colstarts.to(dev), rows.to(dev), got, n_slots)
    assert torch.equal(valid_k.cpu(), valid_p)
    assert torch.equal(trunc_k.cpu(), trunc_p)
    assert torch.equal(u_k.cpu()[valid_p], u_p[valid_p])
    assert torch.equal(v_k.cpu()[valid_p], v_p[valid_p])
