"""The distributed step's rowsweep (`ops.rowsweep_candidates`,
`kernels/rowsweep.py`, `csrc/rowsweep.cu`) on the shards of a partition.

On the CPU the plain arm is held to a brute-force loop over each
shard's frontier vertices and their lists.  The ``cuda`` tests hold the
kernel to the plain arm bitwise on the card (atomic min does not depend
on order): every shard of D = 1, 2 and 4, rebased shards included, on
random words, an all-set frontier (every hub's list) and an empty one.
This file imports no jax, so the ``cuda`` tests run on a machine
without it.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import bfs_distributed as bd
from repro_torch.core import rmat
from repro_torch.core.csr import from_edges
from repro_torch.kernels import ops


@pytest.fixture(scope="module")
def graph():
    return from_edges(rmat.generate(5, 10, 16, device="cpu"), device="cpu")


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _words(rng, n_words, density):
    bits = rng.random((n_words, 32)) < density
    packed = (bits * (1 << np.arange(32, dtype=np.uint64))).sum(1)
    return torch.from_numpy(packed.astype(np.uint32).view(np.int32))


def _brute_force(rows_l, colstarts_l, frontier, visited, base, n_vertices):
    f = frontier.numpy().view(np.uint32)
    vis = visited.numpy().view(np.uint32)
    cs, rows = colstarts_l.numpy(), rows_l.numpy()
    cand = np.full(f.shape[0] * 32, n_vertices, np.int32)
    for u in range(cs.shape[0] - 1):
        g = base + u
        if not (f[g >> 5] >> (g & 31)) & 1:
            continue
        for v in rows[cs[u]:cs[u + 1]]:
            if v < n_vertices and not (vis[v >> 5] >> (v & 31)) & 1:
                cand[v] = min(cand[v], g)
    return cand


def _shards(graph, n_devices, seed, density):
    rows_sh, cs_sh = bd.partition_csr(graph, n_devices)
    v_cap = (cs_sh.shape[1] - 1) * n_devices
    rng = np.random.default_rng(seed)
    frontier = _words(rng, v_cap // 32, density)
    visited = frontier | _words(rng, v_cap // 32, 0.3)
    return rows_sh, cs_sh, frontier, visited


@pytest.mark.parametrize("n_devices", [1, 2, 4])
def test_plain_matches_brute_force(graph, n_devices):
    rows_sh, cs_sh, frontier, visited = _shards(graph, n_devices, 1, 0.05)
    v_loc = cs_sh.shape[1] - 1
    for d in range(n_devices):
        got = ops.rowsweep_candidates(rows_sh[d], cs_sh[d], frontier,
                                      visited, base=d * v_loc,
                                      n_vertices=graph.n_vertices)
        want = _brute_force(rows_sh[d], cs_sh[d], frontier, visited,
                            d * v_loc, graph.n_vertices)
        np.testing.assert_array_equal(got.numpy(), want)


def test_plain_reads_only_the_shards_frontier_slice(graph):
    rows_sh, cs_sh, frontier, visited = _shards(graph, 2, 2, 0.1)
    v_loc = cs_sh.shape[1] - 1
    w_loc = v_loc // 32
    outside = frontier.clone()
    outside[:w_loc] = -1                     # shard 0's words, all set
    a = ops.rowsweep_candidates(rows_sh[1], cs_sh[1], frontier, visited,
                                base=v_loc, n_vertices=graph.n_vertices)
    b = ops.rowsweep_candidates(rows_sh[1], cs_sh[1], outside, visited,
                                base=v_loc, n_vertices=graph.n_vertices)
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("density", [0.0, 0.05, 1.0])
@pytest.mark.parametrize("n_devices", [1, 2, 4])
def test_cuda_matches_plain(cuda_device, graph, n_devices, density):
    rows_sh, cs_sh, frontier, visited = _shards(graph, n_devices, 3,
                                                density)
    if density == 1.0:
        visited = torch.zeros_like(visited)   # every list, every atomic
    v_loc = cs_sh.shape[1] - 1
    for d in range(n_devices):
        kw = dict(base=d * v_loc, n_vertices=graph.n_vertices)
        want = ops.rowsweep_candidates(rows_sh[d], cs_sh[d], frontier,
                                       visited, **kw)
        before = ops.KERNEL_LAUNCHES["rowsweep"]
        got = ops.rowsweep_candidates(
            *(t.to(cuda_device) for t in (rows_sh[d], cs_sh[d], frontier,
                                          visited)), **kw)
        torch.cuda.synchronize()
        assert ops.KERNEL_LAUNCHES["rowsweep"] == before + 1
        assert torch.equal(got.cpu(), want), (n_devices, d, density)


@pytest.mark.cuda
def test_cuda_rejects_mixed_devices(cuda_device, graph):
    rows_sh, cs_sh, frontier, visited = _shards(graph, 1, 4, 0.1)
    with pytest.raises(ValueError, match="on cuda"):
        ops.rowsweep_candidates(rows_sh[0], cs_sh[0],
                                frontier.to(cuda_device), visited, base=0,
                                n_vertices=graph.n_vertices)
