"""Public wrappers around the kernels (K1-K13, the union planner, the
apportionment and the distributed step's rowsweep).

Each wrapper picks its arm from the device of the tensors it is given:
a CPU tensor runs the kernel's plain torch version, a CUDA tensor
launches the hand-written CUDA kernel (which raises on any CUDA
error).  There is no other switch and no fallback: on the card the
kernel runs or the call fails.

Launch accounting, two counters:

* `count_launches` charges one launch per wrapper call, on either
  device, as the reference charges one per Pallas call at trace time —
  so `LayerStats.launches` stays 3 per fused layer and 1 per scalar
  layer even where one wrapper issues several CUDA launches.
* `KERNEL_LAUNCHES` counts, per wrapper, the calls that launched the
  CUDA kernel, and nothing else; `chip_smoke.py` reads it to show that
  the main path went through the kernels.

While a `roofline.hlo_analyze.Analyzer` is active (`ANALYZER`), each
public wrapper reports itself to it as one op (its tensor arguments and
results as bytes, no flops), as a Pallas call is one custom call in the
reference's HLO; the ops of the arm it runs are not counted again, so
the count is the same on either device.  With none active a wrapper
only reads `ANALYZER`.

Budgets.  The reference's VMEM budgets describe a TPU core's
scratchpad.  On this card the fused kernels keep their state in device
memory; what is scarce is a CTA's shared memory (the prefetch ring:
``(depth + 1) * tile * 4`` bytes of rows for K4-K6, ``(depth + 1) *
spp * 1152 * 4`` bytes of slabs for K8-K10, against the 232,448-byte
opt-in limit) and, for the cooperative launches of K5, K6, K9 and K10,
co-residency: every CTA of the grid must be resident at once.  The
grid is sized from the occupancy API at that shared memory, so a
budget that fits always yields a co-resident grid.  The ``*_fits``
functions test the shared memory; the engine degrades observably where
they fail, as the reference does.  The budgets are pure arithmetic, so
the CPU path takes the same decisions.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import apportion as ap
from repro_torch.kernels import bitmap_kernels as bk
from repro_torch.kernels import compact as ck
from repro_torch.kernels import frontier_expand as fe
from repro_torch.kernels import gather_expand as ge
from repro_torch.kernels import layer_fused as lf
from repro_torch.kernels import plan as pl
from repro_torch.kernels import restoration as rest
from repro_torch.kernels import rowsweep as rw
from repro_torch.kernels import sell_expand as se
from repro_torch.kernels import traversal_fused as tf

_LAUNCH_COUNT = [0]

#: the active `roofline.hlo_analyze.Analyzer`, or None
ANALYZER = [None]

#: CUDA kernel launches per wrapper (see module docstring)
KERNEL_LAUNCHES = {"restoration": 0, "frontier_compact_batched": 0,
                   "gather_expand_batched": 0, "gather_expand_prefetch": 0,
                   "layer_fused_batched": 0, "traversal_fused_batched": 0,
                   "sell_expand_batched": 0, "sell_expand_prefetch": 0,
                   "sell_layer_fused_batched": 0,
                   "sell_traversal_fused_batched": 0, "popcount": 0,
                   "measure": 0, "frontier_expand_batched": 0,
                   "gather_relax_batched": 0, "sell_relax_batched": 0,
                   "plan_union": 0, "apportion": 0, "rowsweep": 0}

#: dynamic shared memory one CTA can opt into on the H100
SMEM_OPTIN_BYTES = ge.SMEM_OPTIN_BYTES


def reset_kernel_launches() -> None:
    for name in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[name] = 0


def _charge_launch(n: int = 1) -> None:
    _LAUNCH_COUNT[0] += n


class count_launches:
    """Context manager counting wrapper calls made inside the block.

    >>> with ops.count_launches() as c:
    ...     step(frontier, visited, parent)
    >>> c.count   # kernel calls one layer of this step costs
    """
    count = 0

    def __enter__(self):
        self._base = _LAUNCH_COUNT[0]
        return self

    def __exit__(self, *exc):
        self.count = _LAUNCH_COUNT[0] - self._base
        return False


def _reported(fn):
    """The wrapper ``fn``, reported as one op to an active analyzer."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        analyzer = ANALYZER[0]
        if analyzer is None:
            return fn(*args, **kwargs)
        return analyzer.kernel(fn.__name__, fn, args, kwargs)
    return wrapper


def _arm(t: torch.Tensor, name: str) -> bool:
    """True for the CUDA arm, False for the plain one; else raise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {t.device}")


@_reported
def restore(parent: torch.Tensor, *, n_vertices: int):
    """K1 on a (V_pad,) or (B, V_pad) int32 P: returns (P fixed, delta
    words of shape (..., V_pad/32))."""
    _charge_launch()
    if _arm(parent, "restore"):
        KERNEL_LAUNCHES["restoration"] += 1
        return rest.restoration_cuda(parent, n_vertices)
    return rest.restoration_plain(parent, n_vertices)


@_reported
def frontier_compact_batched(words: torch.Tensor, *, size: int,
                             fill: int):
    """K2: (B, W) packed bitmaps -> ((B, size) queues, (B,) counts)."""
    _charge_launch()
    if _arm(words, "frontier_compact_batched"):
        KERNEL_LAUNCHES["frontier_compact_batched"] += 1
        return ck.compact_cuda(words, size, fill)
    return ck.compact_plain(words, size, fill)


@_reported
def frontier_queue(words: torch.Tensor, *, size: int, fill: int,
                   deg: torch.Tensor, n_vertices: int,
                   n_slots: int) -> ck.EdgeQueue:
    """K2's stream arm: the (B, size) queue of (B, W) bitmaps with each
    entry's inclusive degree prefix (``deg``: the (32 W,) padded degree
    array) and each root's total and truncated edges (`compact.EdgeQueue`),
    the input of `apportion`.  One K2 launch, charged as K2."""
    _charge_launch()
    if _arm(words, "frontier_queue"):
        KERNEL_LAUNCHES["frontier_compact_batched"] += 1
        return ck.queue_cuda(words, size, fill, deg, n_vertices, n_slots)
    return ck.queue_plain(words, size, fill, deg, n_vertices, n_slots)


@_reported
def apportion(colstarts, rows, queue: ck.EdgeQueue, *, n_vertices: int,
              n_slots: int):
    """The (u, v, valid) edge stream of ``n_slots`` slots per root over
    the adjacency of K2's stream-arm queue, and the (B,) truncated
    edges (`kernels.apportion`).  Charged no launch: the reference
    writes it in jnp; `KERNEL_LAUNCHES` counts the CUDA arm.  The CUDA
    arm writes u and v only where valid holds."""
    if _arm(rows, "apportion"):
        KERNEL_LAUNCHES["apportion"] += 1
        return ap.apportion_cuda(colstarts, rows, queue, n_slots)
    return ap.apportion_plain(colstarts, rows, queue.queue, n_vertices,
                              n_slots)


@_reported
def rowsweep_candidates(rows_l, colstarts_l, frontier, visited, *,
                        base: int, n_vertices: int) -> torch.Tensor:
    """One shard's top-down layer of the distributed BFS
    (`core.bfs_distributed._local_step`, `kernels.rowsweep`): the (v_cap,)
    min-parent candidate array of the shard ``[base, base + v_loc)``
    (``rows_l`` (e_loc,), ``colstarts_l`` (v_loc + 1,)) under the global
    (w_cap,) ``frontier`` and ``visited`` words.  Charged no launch (the
    distributed path keeps no stats buffer); `KERNEL_LAUNCHES` counts the
    CUDA arm."""
    if _arm(frontier, "rowsweep_candidates"):
        KERNEL_LAUNCHES["rowsweep"] += 1
        return rw.rowsweep_cuda(rows_l, colstarts_l, frontier, visited,
                                base, n_vertices)
    return rw.rowsweep_plain(rows_l, colstarts_l, frontier, visited, base,
                             n_vertices)


@_reported
def frontier_compact(words: torch.Tensor, *, size: int, fill: int):
    """K2 for one root ((W,) -> (size,), count): the batched call at
    B = 1."""
    queue, total = frontier_compact_batched(words[None].contiguous(),
                                            size=size, fill=fill)
    return queue[0], total[0]


@_reported
def plan_union(graph, words: torch.Tensor, *, complement: bool = False,
               dense: torch.Tensor | None = None) -> ge.UnionPlan:
    """The union planner: the `gather_expand.UnionPlan` of (B, W)
    planning bitmaps ``words`` over a `layer_fused.FusedCsr`'s
    rows-blocks or a `sell_expand.SellGraph`'s slab groups (see
    `kernels.plan`).  Charged one launch on CSR, where it stands in the
    reference's K2 planning call, and none on SELL, where the reference
    plans in jnp; `KERNEL_LAUNCHES` counts both."""
    if not isinstance(graph, se.SellGraph):
        _charge_launch()
    if _arm(words, "plan_union"):
        KERNEL_LAUNCHES["plan_union"] += 1
        return pl.plan_union_cuda(graph, words, complement=complement,
                                  dense=dense)
    return pl.plan_union_plain(graph, words, complement=complement,
                               dense=dense)


@_reported
def gather_expand_batched(plan: ge.UnionPlan, rows, colstarts, frontier,
                          visited, out_init, p_init, *, n_vertices: int,
                          tile: int, bottom_up: bool = False,
                          prefetch_depth: int = 0):
    """K3 (K4 at ``prefetch_depth > 0``) over (B, ...) state: the
    rows-blocks of ``plan`` (`plan_union`), ``rows`` tile-padded
    (n_blocks * tile,), ``colstarts`` (V+1,), bitmaps (B, W), P
    (B, V_pad).  Updates ``out_init`` and ``p_init`` in place and
    returns them as (out, parent) — restoration NOT applied."""
    _charge_launch()
    if _arm(rows, "gather_expand_batched"):
        name = ("gather_expand_prefetch" if prefetch_depth > 0
                else "gather_expand_batched")
        KERNEL_LAUNCHES[name] += 1
        return ge.gather_expand_cuda(
            plan, rows, colstarts, frontier, visited, out_init, p_init,
            n_vertices=n_vertices, tile=tile, bottom_up=bottom_up,
            prefetch_depth=prefetch_depth)
    return ge.gather_expand_plain(
        plan, rows, colstarts, frontier, visited, out_init, p_init,
        n_vertices=n_vertices, tile=tile, bottom_up=bottom_up)


@_reported
def gather_expand(worklist, n_active, rows, colstarts, frontier, visited,
                  out_init, p_init, *, n_vertices: int, tile: int,
                  bottom_up: bool = False, prefetch_depth: int = 0):
    """K3/K4 for one root's (n_blocks,) work-list and its count: the
    batched call at B = 1, on the list's plan.  ``out_init`` and
    ``p_init`` ((W,), (V_pad,)) are updated in place."""
    na = torch.as_tensor(n_active, dtype=torch.int32,
                         device=rows.device).reshape(1)
    plan = ge.UnionPlan.of_lists(worklist[None], na,
                                 int(rows.shape[0]) // tile)
    gather_expand_batched(
        plan, rows, colstarts, frontier[None].contiguous(),
        visited[None].contiguous(), out_init[None], p_init[None],
        n_vertices=n_vertices, tile=tile, bottom_up=bottom_up,
        prefetch_depth=prefetch_depth)
    return out_init, p_init


@_reported
def expand_batched(nbr, cand, valid, frontier, visited, out_init, p_init,
                   *, n_vertices: int, check_frontier: bool = False):
    """K7 over (B, E_slots) apportioned streams (``valid`` bool), (B, W)
    bitmaps and (B, V_pad) P.  Updates ``out_init`` and
    ``p_init`` in place and returns them as (out, parent) — restoration
    NOT applied."""
    _charge_launch()
    if _arm(p_init, "expand_batched"):
        KERNEL_LAUNCHES["frontier_expand_batched"] += 1
        return fe.frontier_expand_cuda(
            nbr, cand, valid, frontier, visited, out_init, p_init,
            n_vertices=n_vertices, check_frontier=check_frontier)
    return fe.frontier_expand_plain(
        nbr, cand, valid, frontier, visited, out_init, p_init,
        n_vertices=n_vertices, check_frontier=check_frontier)


@_reported
def expand(nbr, cand, valid, frontier, visited, out_init, p_init, *,
           n_vertices: int, check_frontier: bool = False):
    """K7 for one root ((E_slots,) streams, (W,), (V_pad,)): the batched
    call at B = 1; ``out_init`` and ``p_init`` are updated in place."""
    expand_batched(nbr[None].contiguous(), cand[None].contiguous(),
                   valid[None].contiguous(), frontier[None].contiguous(),
                   visited[None].contiguous(), out_init[None],
                   p_init[None], n_vertices=n_vertices,
                   check_frontier=check_frontier)
    return out_init, p_init


@_reported
def gather_relax_batched(plan: ge.UnionPlan, rows, colstarts, frontier,
                         vals, *, n_vertices: int, tile: int,
                         unit: int = 0, weighted: bool = False):
    """K11: the semiring relax over the rows-blocks of ``plan``
    (`plan_union`) of the tile-padded ``rows``; ``vals`` (B, V_pad)
    int32 or float32.  Returns (out_vals, p_layer), ``p_layer``
    `gather_expand.P_UNSET` where no edge won.  One launch charged, as
    the reference's one Pallas call (the CUDA arm is two launches, one
    per phase)."""
    _charge_launch()
    if _arm(rows, "gather_relax_batched"):
        KERNEL_LAUNCHES["gather_relax_batched"] += 1
        return ge.gather_relax_cuda(
            plan, rows, colstarts, frontier, vals, n_vertices=n_vertices,
            tile=tile, unit=unit, weighted=weighted)
    return ge.gather_relax_plain(
        plan, rows, colstarts, frontier, vals, n_vertices=n_vertices,
        tile=tile, unit=unit, weighted=weighted)


@_reported
def sell_relax_batched(graph: se.SellGraph, plan: ge.UnionPlan, frontier,
                       vals, *, unit: int = 0, weighted: bool = False):
    """K12: the semiring relax over the slab groups of ``plan``
    (`plan_union`); the contract of `gather_relax_batched`."""
    _charge_launch()
    if _arm(vals, "sell_relax_batched"):
        KERNEL_LAUNCHES["sell_relax_batched"] += 1
        return se.sell_relax_cuda(graph, plan, frontier, vals, unit=unit,
                                  weighted=weighted)
    return se.sell_relax_plain(graph, plan, frontier, vals, unit=unit,
                               weighted=weighted)


@_reported
def layer_fused_batched(graph: lf.FusedCsr, frontier, visited, parent, *,
                        bottom_up: bool = False, prefetch_depth: int = 0):
    """K5: one whole layer of (B, W) bitmaps and (B, V_pad) P — plan,
    gather-expand, restore.  Returns (out, parent, n_active (B,)); P is
    restored in place, ``out`` already holds the repair."""
    _charge_launch()
    if _arm(parent, "layer_fused_batched"):
        KERNEL_LAUNCHES["layer_fused_batched"] += 1
        return lf.layer_fused_cuda(graph, frontier, visited, parent,
                                   bottom_up=bottom_up,
                                   prefetch_depth=prefetch_depth)
    return lf.layer_fused_plain(graph, frontier, visited, parent,
                                bottom_up=bottom_up)


@_reported
def layer_fused(graph: lf.FusedCsr, frontier, visited, parent, *,
                bottom_up: bool = False, prefetch_depth: int = 0):
    """K5 for one root ((W,), (V_pad,)): the batched call at B = 1.
    Returns (out, parent, n_active (1,))."""
    out, p, na = layer_fused_batched(
        graph, frontier[None].contiguous(), visited[None].contiguous(),
        parent[None], bottom_up=bottom_up, prefetch_depth=prefetch_depth)
    return out[0], p[0], na


@_reported
def traversal_fused_batched(graph: lf.FusedCsr, frontier, visited, parent,
                            *, code: tf.PolicyCode, max_layers: int,
                            prefetch_depth: int = 0):
    """K6: the whole traversal of a root batch from its initial state.
    Returns (frontier, visited, parent, depths, layers, stats)."""
    _charge_launch()
    if _arm(parent, "traversal_fused_batched"):
        KERNEL_LAUNCHES["traversal_fused_batched"] += 1
        return tf.traversal_fused_cuda(graph, frontier, visited, parent,
                                       code=code, max_layers=max_layers,
                                       prefetch_depth=prefetch_depth)
    return tf.traversal_fused_plain(graph, frontier, visited, parent,
                                    code=code, max_layers=max_layers)


@_reported
def sell_batched(graph: se.SellGraph, frontier, visited, out_init, p_init,
                 *, plan: ge.UnionPlan | None = None, bottom_up: bool = False,
                 prefetch_depth: int = 0):
    """K8 over (B, ...) state: the slab groups of ``plan``
    (`plan_union`) — omitted, every root sweeps every group
    (`sell_expand.dense_plan`, the full SpMV sweep).  Updates
    ``out_init`` and ``p_init`` in place and returns them as (out,
    parent) — restoration NOT applied.  The slab arrays are padded to
    the step once, when ``graph`` is built (`sell_expand.sell_graph`)."""
    if plan is None:
        plan = se.dense_plan(graph.n_steps, int(frontier.shape[0]),
                             frontier.device)
    _charge_launch()
    if _arm(p_init, "sell_batched"):
        name = ("sell_expand_prefetch" if prefetch_depth > 0
                else "sell_expand_batched")
        KERNEL_LAUNCHES[name] += 1
        return se.sell_expand_cuda(graph, plan, frontier, visited, out_init,
                                   p_init, bottom_up=bottom_up,
                                   prefetch_depth=prefetch_depth)
    return se.sell_expand_plain(graph, plan, frontier, visited, out_init,
                                p_init, bottom_up=bottom_up)


@_reported
def sell(graph: se.SellGraph, frontier, visited, out_init, p_init, *,
         plan: ge.UnionPlan | None = None, bottom_up: bool = False,
         prefetch_depth: int = 0):
    """K8 for one root ((W,), (V_pad,)): the batched call at B = 1, on a
    one-root ``plan``; ``out_init`` and ``p_init`` are updated in
    place."""
    sell_batched(graph, frontier[None].contiguous(),
                 visited[None].contiguous(), out_init[None], p_init[None],
                 plan=plan, bottom_up=bottom_up,
                 prefetch_depth=prefetch_depth)
    return out_init, p_init


@_reported
def sell_layer_fused_batched(graph: se.SellGraph, frontier, visited, parent,
                             *, bottom_up: bool = False,
                             prefetch_depth: int = 0):
    """K9: one whole SELL layer of (B, W) bitmaps and (B, V_pad) P —
    plan, sweep, restore.  Returns (out, parent, n_active (B,)); P is
    restored in place, ``out`` already holds the repair."""
    _charge_launch()
    if _arm(parent, "sell_layer_fused_batched"):
        KERNEL_LAUNCHES["sell_layer_fused_batched"] += 1
        return se.sell_layer_fused_cuda(graph, frontier, visited, parent,
                                        bottom_up=bottom_up,
                                        prefetch_depth=prefetch_depth)
    return se.sell_layer_fused_plain(graph, frontier, visited, parent,
                                     bottom_up=bottom_up)


@_reported
def sell_layer_fused(graph: se.SellGraph, frontier, visited, parent, *,
                     bottom_up: bool = False, prefetch_depth: int = 0):
    """K9 for one root: the batched call at B = 1."""
    out, p, na = sell_layer_fused_batched(
        graph, frontier[None].contiguous(), visited[None].contiguous(),
        parent[None], bottom_up=bottom_up, prefetch_depth=prefetch_depth)
    return out[0], p[0], na


@_reported
def sell_traversal_fused_batched(graph: se.SellGraph, frontier, visited,
                                 parent, *, code: tf.PolicyCode,
                                 max_layers: int, prefetch_depth: int = 0):
    """K10: the whole SELL traversal of a root batch from its initial
    state.  Returns (frontier, visited, parent, depths, layers, stats)."""
    _charge_launch()
    if _arm(parent, "sell_traversal_fused_batched"):
        KERNEL_LAUNCHES["sell_traversal_fused_batched"] += 1
        return tf.sell_traversal_fused_cuda(
            graph, frontier, visited, parent, code=code,
            max_layers=max_layers, prefetch_depth=prefetch_depth)
    return tf.sell_traversal_fused_plain(graph, frontier, visited, parent,
                                         code=code, max_layers=max_layers)


@_reported
def measure(frontier: torch.Tensor, visited: torch.Tensor | None = None,
            deg: torch.Tensor | None = None, *, log: bk.LayerLog | None = None,
            layer: int = 0, discovered: bool = True) -> bk.Counters:
    """K13 redesigned, the host loops' measure: the Table 1 counters of
    (B, W) frontier words (with ``visited``, the unvisited set's too)
    over the (32 W,) padded degree array ``deg`` (None: the count-only
    arm), as `bitmap_kernels.Counters`; with ``log``, the layer's stats
    row, depths and, for a registered policy, its decision written on
    the device (``discovered``: this layer's count goes into the
    previous row's discovered column).  Outside every step, so no
    layer's launches column counts it.  `KERNEL_LAUNCHES` counts the
    degree arm as ``measure`` and the count-only arm as ``popcount``
    (K13's function)."""
    _charge_launch()
    if _arm(frontier, "measure"):
        KERNEL_LAUNCHES["popcount" if deg is None else "measure"] += 1
        return bk.measure_cuda(frontier, visited, deg, log=log, layer=layer,
                               discovered=discovered)
    return bk.measure_plain(frontier, visited, deg, log=log, layer=layer,
                            discovered=discovered)


@_reported
def popcount(words: torch.Tensor) -> torch.Tensor:
    """K13: total set bits of an int32 word tensor -> () int32 (on the
    card the measure kernel's count-only arm)."""
    _charge_launch()
    if _arm(words, "popcount"):
        KERNEL_LAUNCHES["popcount"] += 1
        return bk.popcount_cuda(words)
    return bk.popcount_plain(words)


def _depth(prefetch_depth: int, n_blocks: int) -> int:
    """The depth the kernels run: clamped to the block count."""
    return min(max(int(prefetch_depth), 0), max(int(n_blocks), 1))


def gather_stage_fits(tile: int, prefetch_depth: int,
                      n_blocks: int) -> bool:
    """True when K4's rows ring fits a CTA's shared memory."""
    return ge.stage_bytes(tile, _depth(prefetch_depth, n_blocks)) \
        <= SMEM_OPTIN_BYTES


def megakernel_budget(tile: int, prefetch_depth: int,
                      n_blocks: int) -> int:
    """Shared memory per CTA of the whole-layer kernel (K5)."""
    return lf.smem_budget(tile, _depth(prefetch_depth, n_blocks))


def megakernel_fits(tile: int, prefetch_depth: int = 0,
                    n_blocks: int = 1) -> bool:
    return megakernel_budget(tile, prefetch_depth, n_blocks) \
        <= SMEM_OPTIN_BYTES


def persistent_fits(tile: int, prefetch_depth: int = 0,
                    n_blocks: int = 1) -> bool:
    """The whole-traversal kernel (K6) runs K5's phases in CTAs of the
    same shape, so its budget is K5's; its batch state, counters
    ((max_layers + 1) * B * 4 int64) and stats live in device memory,
    so neither the batch nor the layer cap enters."""
    return megakernel_fits(tile, prefetch_depth, n_blocks)


def sell_stage_fits(spp: int, prefetch_depth: int, n_steps: int) -> bool:
    """True when K8's ring of ``cols`` and ``slab_rows`` fits a CTA."""
    return se.stage_bytes(spp, _depth(prefetch_depth, n_steps)) \
        <= SMEM_OPTIN_BYTES


def sell_megakernel_budget(spp: int, prefetch_depth: int,
                           n_steps: int) -> int:
    """Shared memory per CTA of the whole-layer SELL kernel (K9); K10
    runs K9's phases in CTAs of the same shape."""
    return se.smem_budget(spp, _depth(prefetch_depth, n_steps))


def sell_megakernel_fits(spp: int, prefetch_depth: int = 0,
                         n_steps: int = 1) -> bool:
    return sell_megakernel_budget(spp, prefetch_depth, n_steps) \
        <= SMEM_OPTIN_BYTES


def sell_persistent_fits(spp: int, prefetch_depth: int = 0,
                         n_steps: int = 1) -> bool:
    """K10's budget is K9's; its batch state and counters live in device
    memory, so neither the batch nor the layer cap enters."""
    return sell_megakernel_fits(spp, prefetch_depth, n_steps)
