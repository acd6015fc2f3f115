"""Layer-synchronous parallel top-down BFS — Algorithms 2 and 3.

Thin wrappers over `core.engine`, with the reference's names and
signatures.  ``algorithm`` picks the scalar flavour:

* ``nonsimd`` — Algorithm 2: exact dense updates, only the benign
  parent race of §3.2;
* ``simd`` — Algorithm 3: the racy word scatter and the restoration
  process (§3.3.2).

`run_bfs` and `run_bfs_jit` run the whole search through the plan
cache (`api.plan`; there is no jit here, the name is the reference's);
`init_state` and the ``expand_*`` functions are the single-root layer
of the legacy entry points, and `parents_graph500` converts engine
results.
"""
from __future__ import annotations

import torch

from repro_torch.core import engine
from repro_torch.core.csr import Csr, init_visited
from repro_torch.core.engine import BfsState
from repro_torch.device import DEFAULT_DEVICE


def init_state(csr: Csr, root: int) -> BfsState:
    """One root's initial state on the graph's device: frontier {root},
    visited the padding plus root, P the sentinel but P[root] = root."""
    frontier, visited, parent = engine.init_root_state(
        root, init_visited(csr), csr.n_vertices)
    return BfsState(frontier, visited, parent,
                    torch.zeros((), dtype=torch.int32, device=csr.device))


def _expand(colstarts, rows, n_vertices: int, state: BfsState,
            frontier_size: int, edge_slots: int, algorithm: str):
    out, visited, parent, _ = engine.scalar_expand(
        colstarts, rows, n_vertices, state.frontier, state.visited,
        state.parent, frontier_size, edge_slots, algorithm)
    return BfsState(out, visited, parent, state.layer + 1)


def expand_simd_semantics(colstarts, rows, n_vertices: int,
                          state: BfsState, frontier_size: int,
                          edge_slots: int) -> BfsState:
    """One layer of Algorithm 3 (bitmaps, racy scatter, restoration)."""
    return _expand(colstarts, rows, n_vertices, state, frontier_size,
                   edge_slots, "simd")


def expand_nonsimd(colstarts, rows, n_vertices: int, state: BfsState,
                   frontier_size: int, edge_slots: int) -> BfsState:
    """One layer of Algorithm 2 (exact dense updates)."""
    return _expand(colstarts, rows, n_vertices, state, frontier_size,
                   edge_slots, "nonsimd")


def run_bfs(csr: Csr, root, *, algorithm: str = "simd",
            collect_stats: bool = False, max_layers: int = 1024,
            policy=None, tile: int | None = None, device=DEFAULT_DEVICE):
    """The whole search for ``root`` (an int, or a sequence for a batch)
    under ``policy`` (default `engine.TopDown()`), through the plan
    cache.  Returns the final `BfsState`, with ``collect_stats`` also
    its `LayerStats`."""
    from repro_torch.api.plan import plan
    spec = engine.make_spec(policy=policy, algorithm=algorithm, tile=tile,
                            max_layers=max_layers)
    res = plan(csr, spec, device=device).run(root)
    if collect_stats:
        return res.state, engine.layer_stats(res)
    return res.state


def run_bfs_jit(colstarts, rows, root, n_vertices: int,
                algorithm: str = "simd", max_layers: int = 64, *,
                device=DEFAULT_DEVICE) -> BfsState:
    """The whole search on raw CSR arrays (`engine.traverse_arrays`
    under `TopDown`); one root, unbatched state."""
    from repro_torch.api.spec import TraversalSpec
    res = engine.traverse_arrays(
        colstarts, rows, [int(root)], n_vertices=n_vertices,
        spec=TraversalSpec(policy=engine.TopDown(), algorithm=algorithm,
                           max_layers=max_layers), device=device)
    st = res.state
    return BfsState(st.frontier[0], st.visited[0], st.parent[0], st.layer)


def parents_graph500(state, n_vertices: int) -> torch.Tensor:
    """Internal P (∞ == V sentinel) -> Graph500 convention (-1)."""
    p = state.parent[..., :n_vertices]
    return torch.where(p >= n_vertices, -1, p)
