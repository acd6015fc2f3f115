"""A plain top-down BFS and the check of a delivered parent tree.

Built from the edge list alone, in plain PyTorch on whatever device the
tensors live on.  A parent tree is right when it is a BFS tree of the
root's component (the Graph500 validation rules): the root is its own
parent; a vertex is reached exactly when the reference reaches it; and
every other reached vertex's parent is a neighbour one layer closer to
the root.  BFS parents are not unique, so trees are never compared
entry by entry.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

#: edges expanded per block of a layer, to bound the memory of a layer
EXPAND_CHUNK = 1 << 27


class Adjacency(NamedTuple):
    keys: torch.Tensor      # (E,) int64 sorted ``src * V + dst``
    nbrs: torch.Tensor      # (E,) int32 ``dst`` in that order
    offsets: torch.Tensor   # (V + 1,) int64
    n_vertices: int


def adjacency(src: torch.Tensor, dst: torch.Tensor,
              n_vertices: int) -> Adjacency:
    v = int(n_vertices)
    keys = torch.sort(src.long() * v + dst.long()).values
    nbrs = (keys % v).to(torch.int32)
    counts = torch.bincount(src, minlength=v)
    offsets = torch.zeros(v + 1, dtype=torch.int64, device=src.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return Adjacency(keys, nbrs, offsets, v)


def bfs_depths(adj: Adjacency, root: int) -> torch.Tensor:
    """(V,) int32 BFS depth of every vertex from ``root``, -1 where
    unreached: one top-down expansion of the whole frontier per layer,
    in blocks of at most `EXPAND_CHUNK` edges."""
    dev = adj.nbrs.device
    depth = torch.full((adj.n_vertices,), -1, dtype=torch.int32,
                       device=dev)
    depth[root] = 0
    frontier = torch.tensor([root], dtype=torch.int64, device=dev)
    layer = 0
    while frontier.numel():
        start = adj.offsets[frontier]
        count = adj.offsets[frontier + 1] - start
        ends = torch.cumsum(count, 0)
        total = int(ends[-1])
        lo = 0
        while lo < total:
            # the frontier vertices whose lists start in [lo, lo + chunk)
            first = int(torch.searchsorted(ends, lo, right=True))
            last = int(torch.searchsorted(ends, lo + EXPAND_CHUNK,
                                            right=True))
            last = min(max(last, first + 1), frontier.numel())
            c = count[first:last]
            n = int(c.sum())
            seg = torch.repeat_interleave(
                torch.arange(last - first, device=dev), c, output_size=n)
            base = start[first:last] - (ends[first:last] - c)
            pos = base[seg] + torch.arange(n, device=dev) \
                + (ends[first - 1] if first else 0)
            nb = adj.nbrs[pos].long()
            nb = nb[depth[nb] < 0]
            depth[nb] = layer + 1
            lo = int(ends[last - 1])
        layer += 1
        frontier = torch.nonzero(depth == layer).flatten()
    return depth


def tree_errors(adj: Adjacency, parent: torch.Tensor, root: int,
                depth: torch.Tensor) -> dict:
    """Count what is wrong with a delivered (V,) parent row against the
    reference depths: ``reach``, vertices reached on one side only;
    ``parent``, reached vertices whose parent is not a neighbour one
    layer closer (for the root: not itself).  An entry outside
    ``[0, V)`` means unreached (-1 or the program's sentinel V)."""
    v = adj.n_vertices
    p = parent[:v].to(adj.nbrs.device, torch.int64)
    got = (p >= 0) & (p < v)
    want = depth >= 0
    reach = int((got != want).sum())
    both = got & want
    both[root] = False
    idx = torch.nonzero(both).flatten()
    pv = p[idx]
    key = pv * v + idx
    at = torch.searchsorted(adj.keys, key).clamp_(max=adj.keys.numel() - 1)
    good = (adj.keys[at] == key) & (depth[pv] == depth[idx] - 1)
    bad = int((~good).sum()) + int(int(p[root]) != root)
    return {"reach": reach, "parent": bad}


def control_parents(adj: Adjacency, depth: torch.Tensor,
                    root: int) -> torch.Tensor:
    """The control: the reference's reached set with the guarantee
    "parent one layer closer" broken the way a bottom-up step that tests
    the visited set in place of the frontier breaks it: every reached
    vertex takes its largest reached neighbour as parent."""
    v = adj.n_vertices
    reached = depth >= 0
    parent = torch.full((v,), -1, dtype=torch.int64, device=depth.device)
    for lo in range(0, adj.nbrs.numel(), EXPAND_CHUNK):
        s = adj.keys[lo:lo + EXPAND_CHUNK] // v
        d = adj.nbrs[lo:lo + EXPAND_CHUNK].long()
        keep = reached[s] & reached[d]
        parent.scatter_reduce_(0, d[keep], s[keep], "amax")
    parent[root] = root
    return parent.to(torch.int32)
