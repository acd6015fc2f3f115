"""Shared parts of the semiring portfolio's end-to-end tests
(``tests/test_torch_semiring*.py``): the reference's results, cached
per process, the port's run, the port's own oracles (Dijkstra over the
hash weights, union-find, `bfs_serial`) and the whole comparison.
"""
from __future__ import annotations

import heapq

import numpy as np

from repro.api import plan as ref_plan
from repro.api.spec import TraversalSpec as RefSpec
from repro.formats.sell import SellFormat as RefSell

from _torch_parity import ROOTS, to_port, words_np
import repro_torch.bfs as tbfs
from repro_torch import formats
from repro_torch.algorithms import semiring as sr
from repro_torch.core.bfs_serial import bfs_serial
from repro_torch.obs.metrics import clear_degrade_log, degrade_log

ALGORITHMS = sr.SEMIRING_ALGORITHMS
FORMATS = ("csr", "sell")
SIGMA = 1024          # the built-in auto σ, passed explicitly to both
#: SSSP walks one delta bucket per layer: the path graph needs ~150
MAX_LAYERS = 512

_REFERENCE = {}


def _ref_format(g, fmt_name):
    return g if fmt_name == "csr" else RefSell.from_csr(g, sigma=SIGMA)


def _port_format(g, fmt_name):
    gt = to_port(g)
    return gt if fmt_name == "csr" \
        else formats.SellFormat.from_csr(gt, sigma=SIGMA)


def reference(graphs, graph_name, fmt_name, algorithm):
    """(compiled traversal, result) of the reference on the graph's batch
    of roots, cached for the process (the families are built from fixed
    seeds, so every module's graphs are the same)."""
    key = (graph_name, fmt_name, algorithm)
    if key not in _REFERENCE:
        ct = ref_plan.plan(
            _ref_format(graphs[graph_name], fmt_name),
            RefSpec(algorithm=algorithm, policy="topdown",
                    pipeline="fused_gather", prefetch_depth=0,
                    max_layers=MAX_LAYERS))
        _REFERENCE[key] = ct, ct.run_batched(
            np.asarray(ROOTS[graph_name][1], np.int32))
    return _REFERENCE[key]


def run_port(graphs, graph_name, fmt_name, algorithm, tile, roots):
    spec = tbfs.TraversalSpec(algorithm=algorithm, policy="topdown",
                              tile=tile, max_layers=MAX_LAYERS)
    return tbfs.plan(_port_format(graphs[graph_name], fmt_name), spec,
                     device="cpu").run_batched(roots)


# -- the port's own oracles ----------------------------------------------

def _adjacency(g):
    cs, rows = np.asarray(g.colstarts), np.asarray(g.rows)
    return [rows[cs[u]:cs[u + 1]] for u in range(g.n_vertices)]


def dijkstra(g, root):
    """float32-accumulating Dijkstra over the port's numpy weights."""
    adj = _adjacency(g)
    dist = np.full(g.n_vertices, np.inf, np.float32)
    dist[root] = np.float32(0)
    heap = [(0.0, int(root))]
    while heap:
        d, u = heapq.heappop(heap)
        if d > dist[u]:
            continue
        for v in adj[u]:
            nd = np.float32(dist[u] + sr.edge_weight_np(np.int32(u),
                                                        np.int32(v)))
            if nd < dist[v]:
                dist[v] = nd
                heapq.heappush(heap, (float(nd), int(v)))
    return dist


def components(g):
    """Union-find: every vertex -> the least id of its component."""
    parent = np.arange(g.n_vertices)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for u, nbrs in enumerate(_adjacency(g)):
        for v in nbrs:
            a, b = find(u), find(int(v))
            if a != b:
                parent[max(a, b)] = min(a, b)
    return np.asarray([find(x) for x in range(g.n_vertices)])


def _check_oracle(g, algorithm, values, roots):
    n = g.n_vertices
    for b, root in enumerate(roots):
        got = values[b, :n]
        if algorithm == "sssp":
            np.testing.assert_array_equal(got, dijkstra(g, root))
        elif algorithm == "cc":
            np.testing.assert_array_equal(got, components(g))
        else:
            _, depth = bfs_serial(np.asarray(g.rows),
                                  np.asarray(g.colstarts), n, root)
            np.testing.assert_array_equal(
                np.where(got >= sr.INT_INF, -1, got), depth)


def check_portfolio(graphs, graph_name, fmt_name, algorithm):
    """The port's run of ``algorithm`` on the graph's batch of roots
    equals the reference's bitwise and passes the port's oracle."""
    g = graphs[graph_name]
    roots = ROOTS[graph_name][1]
    ct, ref = reference(graphs, graph_name, fmt_name, algorithm)
    clear_degrade_log()
    got = run_port(graphs, graph_name, fmt_name, algorithm,
                    ct.resolved.tile, roots)
    assert not degrade_log()
    assert got.values.dtype == sr.get(algorithm).torch_dtype
    np.testing.assert_array_equal(got.values.numpy().view(np.int32),
                                  np.asarray(ref.values).view(np.int32))
    np.testing.assert_array_equal(got.state.parent.numpy(),
                                  np.asarray(ref.state.parent))
    np.testing.assert_array_equal(got.stats.numpy(), np.asarray(ref.stats))
    np.testing.assert_array_equal(got.depths.numpy(), np.asarray(ref.depths))
    assert int(got.state.layer) == int(ref.state.layer)
    for field in ("visited", "frontier"):
        np.testing.assert_array_equal(
            words_np(getattr(got.state, field)),
            np.asarray(getattr(ref.state, field)))
    assert int(got.state.layer) < MAX_LAYERS    # ran to its fixpoint
    _check_oracle(g, algorithm, got.values.numpy(), roots)
