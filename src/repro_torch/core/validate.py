"""Graph500-style BFS spanning-tree validator — paper §5.3, in torch.

The five Graph500 "soft" checks, vectorized so that a SCALE-22 tree
validates on the card:

  1. the root is its own parent;
  2. the parent pointers form a forest rooted at ``root`` (no cycles),
     by pointer-doubling depths;
  3. every tree edge (P[v], v) is an edge of the graph, by a
     fixed-step binary search of v in the sorted adjacency of P[v];
  4. every graph edge spans at most one level and never joins a
     reached vertex to an unreached one;
  5. depths are consistent: d[v] == d[P[v]] + 1.

An optional sixth check compares depths with an oracle's (every valid
BFS tree of a graph shares its depth array).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.csr import Csr


class Validation(NamedTuple):
    ok: bool
    root_ok: bool
    no_cycles: bool
    tree_edges_exist: bool
    edge_levels_ok: bool
    component_closed: bool
    depths_consistent: bool
    depth: torch.Tensor       # (V,) int32, -1 for unreached


def compute_depths(parent: torch.Tensor, root: int, n_vertices: int):
    """Pointer-doubling depths.  Returns (depth, acyclic_ok).

    Each round ``d[v] += d[ptr[v]]; ptr[v] = ptr[ptr[v]]``; the root's
    self-loop contributes 0.  After ceil(log2 V)+1 rounds every acyclic
    chain has collapsed onto the root; survivors mean a cycle or a
    reached vertex with an unreached parent."""
    parent = parent.to(torch.int64)
    reached = parent >= 0
    idx = torch.arange(n_vertices, dtype=torch.int64,
                       device=parent.device)
    ptr = torch.where(reached, parent, idx)
    ptr[root] = root
    d = (reached & (idx != root)).to(torch.int32)
    rounds = max(1, math.ceil(math.log2(max(n_vertices, 2))) + 1)
    for _ in range(rounds):
        d = d + d[ptr]
        ptr = ptr[ptr]
    acyclic = bool(torch.all(~reached | (ptr == root)))
    depth = torch.where(reached, d, -1)
    return depth, acyclic


def _tree_edge_exists(csr: Csr, parent: torch.Tensor) -> bool:
    """For each reached non-root v, binary-search v in adj(P[v])."""
    rows = csr.rows
    n = csr.n_vertices
    v_ids = torch.arange(n, dtype=torch.int64, device=rows.device)
    reached = parent >= 0
    p = torch.where(reached, parent.to(torch.int64), 0)
    is_root = p == v_ids
    end = csr.colstarts[p + 1].to(torch.int64)
    lo, hi = csr.colstarts[p].to(torch.int64), end
    last = rows.shape[0] - 1
    steps = max(1, math.ceil(math.log2(max(int(csr.n_edges), 2))) + 1)
    for _ in range(steps):            # rows are sorted per vertex
        mid = (lo + hi) // 2
        go_right = rows[mid.clamp(0, last)] < v_ids
        lo, hi = torch.where(go_right, mid + 1, lo), \
            torch.where(go_right, hi, mid)
    found = (lo < end) & (rows[lo.clamp(0, last)] == v_ids)
    return bool(torch.all(~reached | is_root | found))


def validate(csr: Csr, parent_g500: torch.Tensor, root: int,
             reference_depth=None) -> Validation:
    """Run all soft checks on a Graph500-convention parent array."""
    v = csr.n_vertices
    dev = csr.rows.device
    parent = torch.as_tensor(parent_g500).to(dev, torch.int64)
    reached = parent >= 0

    root_ok = bool(parent[root] == root)
    depth, acyclic = compute_depths(parent, root, v)
    tree_edges = _tree_edge_exists(csr, parent)

    # per-edge checks over the (symmetrized) edge list implicit in CSR
    e = csr.n_edges
    src = torch.repeat_interleave(
        torch.arange(v, dtype=torch.int64, device=dev),
        csr.degrees().to(torch.int64), output_size=e)
    dst = csr.rows[:e].to(torch.int64)
    s_reach = reached[src]
    d_reach = reached[dst]
    closure = bool(torch.all(s_reach == d_reach))
    both = s_reach & d_reach
    levels = bool(torch.all(~both
                            | ((depth[src] - depth[dst]).abs() <= 1)))
    del src, dst, s_reach, d_reach, both

    p_safe = torch.where(reached, parent, 0)
    ids = torch.arange(v, device=dev)
    depths_consistent = bool(torch.all(
        ~reached | (ids == root) | (depth == depth[p_safe] + 1)))
    if reference_depth is not None:
        ref = torch.as_tensor(reference_depth).to(dev, depth.dtype)
        depths_consistent = depths_consistent \
            and bool(torch.equal(depth, ref))

    ok = (root_ok and acyclic and tree_edges and levels and closure
          and depths_consistent)
    return Validation(ok, root_ok, acyclic, tree_edges, levels, closure,
                      depths_consistent, depth)
