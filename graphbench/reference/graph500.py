"""Graph500 arithmetic that depends only on the inputs: search keys,
connected components, the edges a search traverses and the bytes a
batch of searches cannot move less of.

Frozen here so that no later change to the program can move the
yardstick: the search-key rule is the one of the port's
``core.stats.choose_roots`` (uniform draws from a CPU
`torch.Generator`, degree > 0), drawn in rounds until enough are found.
"""
from __future__ import annotations

import numpy as np
import torch

#: published HBM3 bandwidth of one NVIDIA H100 SXM (bytes per second)
H100_BYTES_PER_S = 3.35e12
EDGE_CHUNK = 1 << 26


def degrees(src: torch.Tensor, n_vertices: int) -> torch.Tensor:
    """Directed degree of every vertex (int64), from the symmetrised
    edge list: a self-loop counts twice, as the Graph500 spec counts it."""
    return torch.bincount(src, minlength=n_vertices)


def search_keys(seed: int, degree: torch.Tensor, n: int) -> np.ndarray:
    """``n`` Graph500 search keys: uniform draws among the vertices of
    degree > 0, ``4 * n`` draws a round, in draw order."""
    gen = torch.Generator().manual_seed(int(seed))
    v = int(degree.shape[0])
    keys: list[int] = []
    for _ in range(64):
        cand = torch.randint(0, v, (4 * n,), generator=gen)
        ok = degree[cand.to(degree.device)].cpu() > 0
        keys.extend(int(x) for x in cand[ok])
        if len(keys) >= n:
            return np.asarray(keys[:n], dtype=np.int64)
    raise ValueError(f"fewer than {n} vertices of degree > 0 found")


def components(src: torch.Tensor, dst: torch.Tensor,
               n_vertices: int) -> torch.Tensor:
    """Connected-component label of every vertex (the smallest vertex id
    in its component): min-label propagation over the edges in chunks,
    with pointer jumping, until nothing changes."""
    lab = torch.arange(n_vertices, dtype=torch.int64, device=src.device)
    while True:
        new = lab.clone()
        for lo in range(0, src.shape[0], EDGE_CHUNK):
            s = src[lo:lo + EDGE_CHUNK].long()
            d = dst[lo:lo + EDGE_CHUNK].long()
            new.scatter_reduce_(0, d, lab[s], "amin")
        while True:
            jumped = new[new]
            if torch.equal(jumped, new):
                break
            new = jumped
        if torch.equal(new, lab):
            return lab
        lab = new


def component_edges(label: torch.Tensor, degree: torch.Tensor
                    ) -> torch.Tensor:
    """Directed-degree sum of each component, indexed by its label."""
    return torch.zeros_like(degree).scatter_add_(0, label, degree)


def traversed_edges(label: torch.Tensor, comp_edges: torch.Tensor,
                    keys) -> np.ndarray:
    """Graph500 edge count of a search from each key: half the
    directed-degree sum of the vertices it reaches, i.e. the input
    tuples of its component."""
    k = torch.as_tensor(np.asarray(keys), device=label.device)
    return (comp_edges[label[k]] // 2).cpu().numpy()


def floor_bytes(reached: torch.Tensor, n_roots: int, n_keys: int) -> int:
    """Bytes that no correct batch of ``n_roots`` searches can move less
    of, whatever implements it and in whatever direction: each root's
    (V,) int32 parent row written once, and for every vertex of
    ``reached`` (the (V,) bool union of the batch's reached sets) but
    the ``n_keys`` distinct roots, one 4-byte adjacency entry read, the
    one that names its parent.  Offsets, frontiers and the rest of each
    list are left out: a bottom-up step may stop at the first parent it
    finds."""
    v = int(reached.shape[0])
    return int(4 * n_roots * v + 4 * (int(reached.sum()) - n_keys))


def batch_reached(label: torch.Tensor, keys) -> torch.Tensor:
    """The union of the components of ``keys``: what a correct batch of
    searches from them reaches."""
    k = torch.as_tensor(np.asarray(keys), device=label.device)
    return torch.isin(label, torch.unique(label[k]))
