"""Graph500 parent conversion for engine results.

The legacy layer-synchronous drivers of ``repro.core.bfs_parallel``
(``run_bfs``, ``expand_*``) arrive with the legacy-entry slice; the
engine's internal parent array is converted here.
"""
from __future__ import annotations

import torch


def parents_graph500(state, n_vertices: int) -> torch.Tensor:
    """Internal P (∞ == V sentinel) -> Graph500 convention (-1)."""
    p = state.parent[..., :n_vertices]
    return torch.where(p >= n_vertices, -1, p)
