"""Whole-traversal driver of the semiring algorithm portfolio.

A port of ``repro.algorithms.traversal``: the semiring twin of
`core.engine._traverse_impl`, batch-native (a leading root axis on
every state array), writing the SAME (max_layers, 8) stats rows, so
`engine.layer_stats` decodes them unchanged.  What differs from BFS:

* the per-vertex state is a **value row** (``vals``: depths, distances
  or component labels, int32 or float32); the format's semiring step
  (``fmt.make_semiring_step``: the union planner + K11 on CSR, + K12 on
  SELL) folds one layer of relaxations into it;
* the next frontier is the **improved** set (strictly decreased values)
  and ``parent = where(improved, p_layer, parent)``;
* **SSSP** keeps delta-stepping state: a ``pending`` bitmap (improved
  since last expanded) and a per-root bucket ``threshold``.  The
  frontier is ``pending ∧ (vals < threshold)``; a root whose bucket
  drained with work pending advances its threshold to
  ``min(pending vals) + SSSP_DELTA`` in the same layer;
* **CC** seeds every real vertex (label = own id, self-parent) and
  iterates to the fixpoint; a root whose frontier holds more than
  ``V / DENSE_FRACTION`` vertices sweeps the full work-list (the dense
  arm).

**The layer loop** is a Python loop with exactly **one host sync per
layer**, as the BFS engine's: one measure launch (``ops.measure``, K13
redesigned) counts the frontier and its degrees per root and writes the
stats row's counters and the depths, and the termination test reads its
batch count with one ``item()``; everything else (the dense flags, the
delta-stepping state and its counts, the rest of the stats row) stays
on the device.
"""
from __future__ import annotations

import torch

from repro_torch.algorithms import semiring as sr_mod
from repro_torch.core import bitmap as bm
from repro_torch.core import engine
from repro_torch.core.csr import padding_premarked_visited
from repro_torch.kernels import bitmap_kernels as bk
from repro_torch.kernels import ops

#: frontier fraction above which the CC endgame sweeps the full list
DENSE_FRACTION = 4  # frontier > V / DENSE_FRACTION => dense sweep


def init_semiring_state(sr, roots: torch.Tensor, n_vertices: int,
                        v_pad: int):
    """(frontier, vals, parent) of a fresh (B,) root batch: the roots
    (value 0, self-parent), or every real vertex for CC."""
    dev = roots.device
    n_batch = int(roots.shape[0])
    ids = torch.arange(v_pad, dtype=torch.int32, device=dev)
    vals = sr.init_vals(roots, n_vertices, v_pad)
    if sr.all_vertices_frontier:
        frontier = bm.pack_bool(ids < n_vertices).expand(n_batch, -1) \
            .contiguous()
        parent = torch.where(ids < n_vertices, ids, n_vertices) \
            .expand(n_batch, -1).contiguous()
        return frontier, vals, parent
    no_padding = torch.zeros((v_pad // bm.BITS_PER_WORD,),
                             dtype=torch.int32, device=dev)
    frontier, _, parent = engine._init_state(roots.to(torch.int32),
                                             no_padding, n_vertices)
    return frontier, vals, parent


def traverse_semiring(fmt, roots: torch.Tensor, spec, step=None,
                      deg_mat=None) -> engine.EngineResult:
    """Run ``spec.algorithm``'s semiring traversal over a (B,) int32 root
    batch on the format's device; returns an `engine.EngineResult` whose
    ``values`` is the (B, V_pad) value matrix.  ``spec`` must be
    resolved; ``step``/``deg_mat`` come from the plan cache (built here
    when absent)."""
    sr = sr_mod.get(spec.algorithm)
    n_vertices = fmt.n_vertices
    v_pad = fmt.n_vertices_padded
    dev = roots.device
    n_roots = int(roots.shape[0])
    max_layers = spec.max_layers
    is_sssp = sr.weighted
    if deg_mat is None:
        deg_mat = fmt.degree_matrix()
    if step is None:
        step = fmt.make_semiring_step(spec, sr)

    frontier, vals, parent = init_semiring_state(sr, roots, n_vertices,
                                                 v_pad)
    pending = frontier.clone() if is_sssp else None
    threshold = torch.full((n_roots,), sr_mod.SSSP_DELTA,
                           dtype=torch.float32, device=dev)
    no_dense = torch.zeros((n_roots,), dtype=torch.bool, device=dev)
    log = bk.new_log(n_roots, max_layers, None, dev)
    deg = deg_mat.reshape(-1)
    layer = 0
    while layer < max_layers:
        # one measure launch: the counters, stats columns 0, 1 and 4, the
        # depths and, but for sssp (whose next frontier is not the
        # improved set), the previous row's discovered column
        c = ops.measure(frontier, None, deg, log=log, layer=layer,
                        discovered=not is_sssp)
        # the layer's one host sync: the termination test
        if not c.total.item():
            break
        dense = (c.per_root[:, 0] * DENSE_FRACTION > n_vertices
                 if sr.all_vertices_frontier else no_dense)
        new_vals, p_layer, aux = step(frontier, vals, dense)

        improved = sr.improved(vals, new_vals)          # (B, V_pad)
        parent = torch.where(improved, p_layer, parent)
        imp_words = bm.pack_bool(improved)
        row = log.stats[layer]
        if is_sssp:
            # delta-stepping: expanded vertices leave pending, improved
            # ones (re-)enter; a drained bucket advances its threshold
            # in the same layer, so the next frontier is non-empty
            # whenever work remains
            pending = (pending & ~frontier) | imp_words
            near = bm.pack_bool(new_vals < threshold[:, None])
            # discovered, pending and pending-and-near counts in one
            # count-only measure
            counts = ops.measure(torch.cat(
                [imp_words, pending, pending & near])).per_root[:, 0]
            row[engine._ST_DISCOVERED] = counts[:n_roots].sum()
            has_pend = counts[n_roots:2 * n_roots] > 0
            drained = counts[2 * n_roots:] == 0
            minpend = torch.where(bm.unpack_bool(pending), new_vals,
                                  torch.inf).amin(dim=1)
            threshold = torch.where(drained & has_pend,
                                    minpend + sr_mod.SSSP_DELTA, threshold)
            new_frontier = pending & bm.pack_bool(
                new_vals < threshold[:, None])
        else:
            new_frontier = imp_words

        row[engine._ST_MODE] = engine.MODE_SIMD
        row[engine._ST_TILES] = aux.tiles
        row[engine._ST_TRUNC] = aux.truncated
        row[engine._ST_LAUNCH] = aux.launches
        frontier, vals = new_frontier, new_vals
        layer += 1
    if layer == max_layers > 0 and not is_sssp:
        # the last layer's discovered column: the count of its output
        ops.measure(frontier, log=log, layer=layer)

    # the reached set in the engine's visited convention (padding
    # premarked), so `parents_graph500` and the validators apply
    reached = vals < sr.identity_value(dev)
    visited = bm.pack_bool(reached) \
        | padding_premarked_visited(n_vertices, device=dev)[None]
    state = engine.BfsState(
        frontier, visited, parent,
        torch.tensor(layer, dtype=torch.int32, device=dev))
    return engine.EngineResult(state, log.depths, log.stats, vals)
