"""The union planner (not a TPU kernel): each layer's `UnionPlan` of the
items that the work-listed kernels walk, in one call, and its plain
torch version.

Two arms with one output contract (`gather_expand.UnionPlan`: the
items any root lists, ascending, then zeros; their count; a root mask
per item; each root's count):

* **CSR** (``graph`` a `layer_fused.FusedCsr`): items are rows-blocks.
  Block i is listed for root b iff some vertex in its owner range
  ``[blk_lo[i], blk_hi[i]]`` is active for b and has degree > 0 — the
  predicate of K5's in-kernel plan (`layer_fused.plan_blocks_plain`),
  which gives the lists of the reference's K2 + block marking exactly.
* **SELL** (``graph`` a `sell_expand.SellGraph`): items are slab groups.
  Group g is listed for root b iff one of its lanes' rows (< V) is
  active for b (`sell_expand.plan_slabs_plain`).

"Active" is the planning bitmap's bit, or with ``complement`` its
complement (bottom-up plans ``~visited``, exact because padding is
premarked).  A root whose ``dense`` flag is set lists every item (the
CC endgame of the semiring portfolio).

The CUDA arm (``csrc/plan_union.cu``) is two launches on one stream: a
count that writes the masks and per-CTA counts, then a write of the
ascending list; no host sync.  The plain version, `plan_union_plain`,
is the per-root planner with the dense override, folded by
`gather_expand.union_worklist`; both are bitwise equal.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import gather_expand as ge
from repro_torch.kernels import layer_fused as lf
from repro_torch.kernels import sell_expand as se

#: items per CTA chunk of the CUDA arm (the grid grows with the items
#: up to `MAX_GRID` CTAs)
ITEMS_PER_CTA = 256
MAX_GRID = 2048


def n_items(graph) -> int:
    """Rows-blocks of a `FusedCsr`, slab groups of a `SellGraph`."""
    return graph.n_steps if isinstance(graph, se.SellGraph) \
        else graph.n_blocks


def plan_union_plain(graph, words: torch.Tensor, *,
                     complement: bool = False,
                     dense: torch.Tensor | None = None) -> ge.UnionPlan:
    """Plain torch planner over (B, W) bitmaps ``words``."""
    if isinstance(graph, se.SellGraph):
        wl, na = se.plan_slabs_plain(graph, ~words if complement else words)
    else:
        wl, na = lf.plan_blocks_plain(graph, words, complement)
    n = n_items(graph)
    if dense is not None:
        full = torch.arange(n, dtype=torch.int32, device=wl.device)
        wl = torch.where(dense[:, None], full[None], wl)
        na = torch.where(dense, n, na).to(torch.int32)
    return ge.UnionPlan.of_lists(wl, na, n)


def plan_union_cuda(graph, words: torch.Tensor, *,
                    complement: bool = False,
                    dense: torch.Tensor | None = None) -> ge.UnionPlan:
    """Launch the planner (two launches) on (B, W) int32 ``words``."""
    from repro_torch.kernels import _build
    sell = isinstance(graph, se.SellGraph)
    dev = graph.cols.device if sell else graph.rows.device
    n_batch, n_words = words.shape
    want_words = graph.n_words if sell else int(graph.nz.shape[0])
    if words.dtype != torch.int32 or not words.is_contiguous() \
            or words.device != dev or n_words != want_words:
        raise ValueError(
            f"plan_union: words must be a contiguous (B, {want_words}) "
            f"int32 tensor on {dev}, got {tuple(words.shape)} "
            f"{words.dtype} on {words.device}, "
            f"contiguous={words.is_contiguous()}")
    if dense is not None and (dense.dtype != torch.bool
                              or tuple(dense.shape) != (n_batch,)
                              or dense.device != dev
                              or not dense.is_contiguous()):
        raise ValueError(f"plan_union: dense must be a contiguous ({n_batch},)"
                         f" bool tensor on {dev}")
    n = n_items(graph)
    i32 = dict(dtype=torch.int32, device=dev)
    if n == 0 or n_batch == 0:      # nothing to list
        return ge.UnionPlan(torch.zeros((n,), **i32),
                            torch.zeros((1,), **i32),
                            torch.zeros((n, -(-n_batch // 32)), **i32),
                            torch.zeros((n_batch,), **i32))
    grid = min(-(-n // ITEMS_PER_CTA), MAX_GRID)
    plan = ge.UnionPlan(torch.empty((n,), **i32), torch.empty((1,), **i32),
                        torch.empty((n, -(-n_batch // 32)), **i32),
                        torch.empty((n_batch,), **i32))
    cnt = torch.empty((n_batch + 1, grid), **i32)
    dense_ptr = dense.data_ptr() if dense is not None else None
    outs = (plan.rmask.data_ptr(), cnt.data_ptr(), plan.ulist.data_ptr(),
            plan.ucount.data_ptr(), plan.na.data_ptr())
    lib = _build.load()
    if sell:
        rc = lib.repro_plan_union_sell(
            words.data_ptr(), dense_ptr, graph.slab_rows.data_ptr(), *outs,
            n_batch, n_words, n, graph.spp, graph.n_vertices,
            int(bool(complement)), grid, _build.stream_of(words))
    else:
        rc = lib.repro_plan_union_csr(
            words.data_ptr(), dense_ptr, graph.blk_lo.data_ptr(),
            graph.blk_hi.data_ptr(), graph.nz.data_ptr(), *outs, n_batch,
            n_words, n, graph.n_vertices, int(bool(complement)), grid,
            _build.stream_of(words))
    _build.check(rc, "plan_union")
    return plan
