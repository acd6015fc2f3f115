"""Serial queue-based top-down BFS — the paper's Algorithm 1 (numpy).

The oracle of every correctness test.  Returns the predecessor array
``P`` (the spanning tree) and the depth array ``d``; parallel engines
may produce a *different* valid tree (the benign race of §3.2) but
always the same depths.  Convention: ``P[root] = root``; unreachable
vertices keep ``P = -1`` and ``d = -1``.
"""
from __future__ import annotations

from collections import deque

import numpy as np


def bfs_serial(rows: np.ndarray, colstarts: np.ndarray, n_vertices: int,
               root: int):
    """Algorithm 1: queue BFS.  Returns (P, depth), each (V,) int32/-1."""
    rows = np.asarray(rows)
    colstarts = np.asarray(colstarts)
    parent = np.full(n_vertices, -1, dtype=np.int32)
    depth = np.full(n_vertices, -1, dtype=np.int32)
    parent[root] = root
    depth[root] = 0
    q = deque([root])
    while q:                                   # in != 0
        u = q.popleft()
        for e in range(colstarts[u], colstarts[u + 1]):
            v = rows[e]
            if v >= n_vertices:                # sentinel padding
                continue
            if parent[v] == -1:                # vis.Test(v) = 0
                parent[v] = u                  # P[v] = u
                depth[v] = depth[u] + 1
                q.append(v)                    # out.add(v)
    return parent, depth


def reference_depths(rows: np.ndarray, colstarts: np.ndarray,
                     n_vertices: int, root: int) -> np.ndarray:
    """Depths only — the layer structure every valid BFS tree shares."""
    return bfs_serial(rows, colstarts, n_vertices, root)[1]
