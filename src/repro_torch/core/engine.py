"""The batched BFS traversal engine with pluggable direction policies.

A port of ``repro.core.engine`` on packed bitmaps, generic over the
graph's `formats.GraphFormat` (CSR, SELL-C-σ, bitmap), with the
reference's four pipelines: ``fused_gather`` (any ``prefetch_depth``),
``materialized``, ``megakernel`` and ``persistent``.  Each layer runs

    measure workload  ->  decide direction  ->  expand  ->  restore

* **measure** (`ops.measure`, K13 redesigned: `csrc/measure.cu`): the
  Table 1 counters in one launch per layer — per root the frontier's
  popcount and degree sum over the format's degree matrix and, for a
  policy that needs it, the unvisited set's; int32 per root, then the
  float32 of their exact int64 batch sums (the reference sums float32
  per-root values; the two agree wherever the sum is exact, and this
  one does not depend on a reduction order, so the whole-traversal
  kernel decides from the same numbers).  The same launch writes the
  layer's stats columns 0, 1 and 4, the previous row's "discovered"
  column, the depths and the termination test.  It replaced a dozen
  plain-torch launches per layer (word popcounts, a (B, W, 32) masked
  degree product), about 12 of the 19 ms of device time of a SCALE-22
  ``fused_gather`` traversal; it is bounded by reading the words and
  the degree matrix once.
* **decide** (`TopDown`, `ThresholdSimd`, `PaperLiteralLayers`,
  `BeamerHybrid`): small frozen objects deciding from those counters
  with torch ops.  The four registered ones decide inside the measure
  launch, from their `policy_code` (the numbers the whole-traversal
  kernels use); any other policy decides in torch from the measure's
  `Workload`.
* **expand**: the format's step (``fmt.make_steps``).  On CSR a SIMD
  or bottom-up layer is, for ``fused_gather``,
  `_make_fused_step`: the union planner (`kernels.plan`) lists the
  rows-blocks the frontier's (or the unvisited set's) adjacency touches,
  for every root at once, K3 (K4 at ``prefetch_depth > 0``) gathers and
  expands those blocks with the racy scatter, and K1 restores.  For
  ``materialized`` it is `_make_simd_step` / `_make_bottomup_step`: K2
  compacts the frontier (the unvisited set) with each entry's degree
  prefix, `ops.apportion` writes the full (u, v, valid) stream of e_pad
  slots per root from it (`csrc/apportion.cu`), K7 expands it and K1
  restores.  For ``megakernel``
  it is `_make_megakernel_step`: K5 does all of that in one launch.
  A scalar layer (`_make_scalar_step`) is K2 plus the apportionment
  and `expand_candidates`, in every pipeline.  SELL's
  steps are in `formats.sell`: the union planner, K8 over its union of
  slab groups and K1 (K8 over every slab group for ``materialized``),
  or K9.  The semiring portfolio has its own driver,
  `algorithms.traversal`.
* **restore** (§3.3.2): vertices marked by a negative P are repaired
  into ``out`` and ``visited``.

**The layer loop.**  The reference runs the whole search as one
``lax.while_loop`` with no host synchronization.  Here the loop is a
Python loop with exactly **one host sync per layer**: a single
``tolist()`` reads the measure's device buffer (is any frontier
non-empty, and the registered policy's mode), and the host then
launches the chosen step.  Everything else — counters, stats row,
depths — stays on the device.
``pipeline="persistent"`` has no host loop: the format's
whole-traversal kernel (K6 on CSR, K10 on SELL) runs the traversal in
one launch (`_traverse_persistent`).

**The dense-mask arm** (``packed=False``, CSR): the reference's
legacy parity and ablation baseline.  ``fused_gather`` plans from the
unpacked (B, V) mask (`_plan_dense`, per-root lists folded by
`gather_expand.UnionPlan.of_lists`) with no planner and no K2 launch,
then K3/K4 and K1; ``materialized`` and scalar layers build their queue
from the mask (`dense_queue`) in place of K2, then the apportionment,
K7 and K1.  Counters stay on the measure kernel (the reference's dense
``masked_edge_sum`` gives the same integers).  Every stats column but
the launches equals the packed arm's.

**Legacy entry points**: `traverse`, `traverse_arrays`,
`traverse_format`, `layer_step_format` (shims over `api.plan`, loose
knobs deprecated), `layer_step` (the scalar step on raw arrays),
`traverse_hostloop` (one root, pow2 buckets, one host read per layer),
and the single-root `edge_stream`, `scalar_expand`,
`candidate_scatter`, `plan_active_tiles` and `compact_worklist`.

State arrays carry a leading root axis (B, ...).  Bitmap words are
int32 (see `repro_torch.core.bitmap`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple
import warnings

import numpy as np
import torch

from repro_torch.core import bitmap as bm
from repro_torch.core.csr import Csr, padding_premarked_visited
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import record_degrade
from repro_torch.kernels import bitmap_kernels as bk
from repro_torch.kernels import gather_expand as ge
from repro_torch.kernels import layer_fused as lf
from repro_torch.kernels import ops
from repro_torch.kernels.apportion import apportion_plain as apportion
from repro_torch.kernels import traversal_fused as tf
from repro_torch.kernels.compact import EdgeQueue
from repro_torch.kernels.layer_fused import FusedCsr, fused_csr
from repro_torch.kernels.restoration import restoration_plain

MODE_SCALAR = 0     # plain torch Algorithm 2/3 layer
MODE_SIMD = 1       # the fused gather-expand kernel (top-down)
MODE_BOTTOMUP = 2   # the same kernel testing neighbours (bottom-up)

MODE_NAMES = {MODE_SCALAR: "topdown", MODE_SIMD: "topdown",
              MODE_BOTTOMUP: "bottomup"}

# per-layer stats buffer columns
(_ST_FRONTIER, _ST_EDGES, _ST_DISCOVERED, _ST_MODE, _ST_ACTIVE,
 _ST_TILES, _ST_TRUNC, _ST_LAUNCH) = range(8)
_N_ST = 8


class BfsState(NamedTuple):
    frontier: torch.Tensor  # (B, W) int32 words — (W,) unbatched
    visited: torch.Tensor   # (B, W) int32 words
    parent: torch.Tensor    # P, (B, V_pad) int32; init = V ("infinity")
    layer: torch.Tensor     # int32 scalar


class LayerStats(NamedTuple):
    layer: int
    frontier_vertices: int  # |in|  (Table 1 "Vertices")
    edges_examined: int     # Σ deg(in)  (Table 1 "Edges")
    discovered: int         # |out| (Table 1 "Traversed vertices")
    active_tiles: int = 0   # rows-blocks of real work (batch-summed)
    truncated_edges: int = 0  # edges clamped by apportionment overflow
    launches: int = 0       # kernel calls this layer issued


class StepAux(NamedTuple):
    """Per-layer accounting each step returns with its state: the
    batch-summed work tiles, truncated edges and kernel calls."""
    tiles: torch.Tensor | int
    truncated: torch.Tensor | int
    launches: int = 0


class Workload(NamedTuple):
    """Counters a direction policy decides from (§4.1).

    Batch sums are float32 of the exact sum (per-root values are
    int32-exact; a batch can sum past 2^31).  ``n_roots`` scales
    Beamer's V/beta to the batch.  ``layer`` is the host's layer
    index."""
    layer: int
    frontier_vertices: torch.Tensor
    frontier_edges: torch.Tensor
    unvisited_vertices: torch.Tensor
    unvisited_edges: torch.Tensor
    n_vertices: int
    bottom_up: torch.Tensor          # bool scalar, previous direction
    n_roots: int = 1


class EngineResult(NamedTuple):
    state: BfsState          # final state; batched arrays iff multi-root
    depths: torch.Tensor     # (B,) int32: layers each root stayed active
    stats: torch.Tensor      # (max_layers, 8) int32 device buffer
    values: torch.Tensor | None = None   # semiring portfolio values


# ---------------------------------------------------------------------------
# Direction policies
# ---------------------------------------------------------------------------

def _mode(w: Workload, mode: int) -> torch.Tensor:
    return torch.full((), mode, dtype=torch.int32,
                      device=w.frontier_vertices.device)


@dataclass(frozen=True)
class TopDown:
    """Always the scalar top-down layer (Algorithms 2/3)."""
    modes = (MODE_SCALAR,)
    needs_unvisited = False

    def decide(self, w: Workload):
        return _mode(w, MODE_SCALAR), torch.zeros_like(w.bottom_up)


@dataclass(frozen=True)
class ThresholdSimd:
    """§4.1 adaptive policy: the SIMD kernel on layers examining at least
    ``simd_threshold`` edges, scalar elsewhere."""
    simd_threshold: int = 16_384
    modes = (MODE_SCALAR, MODE_SIMD)
    needs_unvisited = False

    def decide(self, w: Workload):
        mode = torch.where(w.frontier_edges >= self.simd_threshold,
                           MODE_SIMD, MODE_SCALAR)
        return mode.to(torch.int32), torch.zeros_like(w.bottom_up)


@dataclass(frozen=True)
class PaperLiteralLayers:
    """The paper's literal §4.1 policy: SIMD on an explicit layer set,
    scalar elsewhere."""
    simd_layers: tuple[int, ...] = (1, 2)
    modes = (MODE_SCALAR, MODE_SIMD)
    needs_unvisited = False

    def decide(self, w: Workload):
        hit = int(w.layer) in self.simd_layers
        return _mode(w, MODE_SIMD if hit else MODE_SCALAR), \
            torch.zeros_like(w.bottom_up)


@dataclass(frozen=True)
class BeamerHybrid:
    """Direction-optimizing switch [Beamer 2012] with hysteresis: down
    when the frontier's out-edges exceed unexplored/alpha, back up when
    the frontier shrinks below V/beta.  Top-down layers use the SIMD
    kernel."""
    alpha: float = 14.0
    beta: float = 24.0
    modes = (MODE_SIMD, MODE_BOTTOMUP)
    needs_unvisited = True

    def decide(self, w: Workload):
        f_edges = w.frontier_edges.to(torch.float32)
        u_edges = w.unvisited_edges.to(torch.float32)
        f_count = w.frontier_vertices.to(torch.float32)
        # a tensor divisor: a true float32 division on every device (a
        # Python-scalar divisor may become a reciprocal multiply)
        alpha = torch.full_like(u_edges, self.alpha)
        switch_down = (~w.bottom_up) & (f_edges > u_edges / alpha)
        # V/beta scales by the batch width: counters are batch-summed
        switch_up = w.bottom_up & (
            f_count < w.n_vertices * w.n_roots / self.beta)
        bottom_up = switch_down | (~switch_up & w.bottom_up)
        mode = torch.where(bottom_up & (w.unvisited_vertices > 0),
                           MODE_BOTTOMUP, MODE_SIMD)
        return mode.to(torch.int32), bottom_up


# ---------------------------------------------------------------------------
# Shared per-layer building blocks
# ---------------------------------------------------------------------------

def restore_plain(parent, out, visited, n_vertices: int):
    """Plain restoration (§3.3.2): repair racy bitmap drops from the
    negative P marks.  Returns (parent, out, visited), all fixed."""
    fixed, repaired = restoration_plain(parent, n_vertices)
    return fixed, out | repaired, visited | repaired


def expand_candidates(u, v, valid, frontier, visited, parent,
                      n_vertices: int, algorithm: str, semiring=None,
                      vals=None):
    """The post-gather Algorithm 2/3 body on a (B, N) edge stream.

    ``"simd"``: Algorithm 3 — racy bitmap scatter + restoration;
    ``"nonsimd"``: Algorithm 2 — exact dense updates.  Returns
    (out, visited, parent).

    With a `algorithms.semiring.Semiring` and its (B, V_pad) ``vals``,
    the generic relaxation instead (the reference's pure-jnp relax
    oracle): each frontier edge's ``vals[u] ⊗ w`` candidate is folded
    into ``vals`` by scatter-min (order-independent: no race, no
    restoration), then each improved vertex takes the least u whose
    candidate equals its new value.  Returns (improved words, new vals,
    parent)."""
    n_batch, v_pad = parent.shape
    n_words = v_pad // bm.BITS_PER_WORD
    rows_b = torch.arange(n_batch, device=parent.device)[:, None]
    if semiring is not None:
        mask = valid & bm.test_bits(frontier, u) & (v < n_vertices)
        u_c = u.clamp(0, v_pad - 1).to(torch.int64)
        v_c = v.clamp(0, v_pad - 1).to(torch.int64)
        cand = semiring.mul(torch.gather(vals, 1, u_c), u, v)
        idx = torch.where(mask, v, v_pad).to(torch.int64)
        new_vals = torch.cat([vals, vals[:, :1]], 1) \
            .scatter_reduce(1, idx, cand, "amin")[:, :v_pad]
        cur = torch.gather(new_vals, 1, v_c)
        win = mask & (cand == cur) \
            & semiring.improved(torch.gather(vals, 1, v_c), cur)
        p_layer = torch.full((n_batch, v_pad + 1), ge.P_UNSET,
                             dtype=torch.int32, device=parent.device)
        p_layer.scatter_reduce_(1, torch.where(win, v, v_pad)
                                .to(torch.int64), u.to(torch.int32),
                                "amin")
        improved = semiring.improved(vals, new_vals)
        parent = torch.where(improved, p_layer[:, :v_pad], parent)
        return bm.pack_bool(improved), new_vals, parent
    if algorithm == "nonsimd":         # Algorithm 2: exact dense updates
        vis_dense = bm.unpack_bool(visited)
        mask = valid & ~torch.gather(
            vis_dense, 1, v.clamp(0, v_pad - 1).to(torch.int64))
        idx = torch.where(mask, v, v_pad).to(torch.int64)
        parent = torch.cat([parent, parent.new_zeros((n_batch, 1))], 1)
        parent[rows_b, idx] = u.to(torch.int32)
        out_dense = torch.zeros((n_batch, v_pad + 1), dtype=torch.bool,
                                device=parent.device)
        out_dense[rows_b, idx] = True
        out = bm.pack_bool(out_dense[:, :v_pad])
        return out, visited | out, parent[:, :v_pad].contiguous()
    # Algorithm 3: racy bitmap scatter + restoration
    undiscovered = ~(bm.test_bits(visited, v) | bm.test_bits(frontier, v))
    mask = valid & undiscovered
    idx = torch.where(mask, v, v_pad).to(torch.int64)
    parent = torch.cat([parent, parent.new_zeros((n_batch, 1))], 1)
    parent[rows_b, idx] = (u - n_vertices).to(torch.int32)
    parent = parent[:, :v_pad]
    word, bit = bm.word_and_bit(v)
    w_idx = torch.where(mask, word, n_words).to(torch.int64)
    out = torch.zeros((n_batch, n_words + 1), dtype=torch.int32,
                      device=parent.device)
    out[rows_b, w_idx] = torch.ones_like(bit) << bit   # racy word scatter
    parent, out, visited = restore_plain(parent, out[:, :n_words],
                                         visited, n_vertices)
    return out, visited, parent


def _mark_blocks(start, end, has, tile: int, n_blocks: int):
    """Range-mark + compact: a +1/-1 difference scatter, a prefix sum,
    `layer_fused.compact_worklist`.  ``has`` is (B, L); ``start`` and
    ``end`` broadcast to it.  Invalid ranges land on dropped slots past
    ``n_blocks``, spread over `bitmap.DROP_SLOTS` slots."""
    n_batch, n_list = has.shape
    blk_lo = start // tile
    blk_hi = (end - 1) // tile
    drop = n_blocks + 1 + torch.arange(n_list, device=has.device) \
        % bm.DROP_SLOTS
    diff = torch.zeros((n_batch, n_blocks + 1 + bm.DROP_SLOTS),
                       dtype=torch.int32, device=has.device)
    ones = torch.ones((n_batch, n_list), dtype=torch.int32,
                      device=has.device)
    diff.scatter_add_(1, torch.where(has, blk_lo, drop), ones)
    diff.scatter_add_(1, torch.where(has, blk_hi + 1, drop), -ones)
    covered = torch.cumsum(diff[:, :n_blocks + 1], dim=1)[:, :n_blocks] > 0
    return lf.compact_worklist(covered, n_blocks)


def compact_worklist(active, n: int):
    """Bool mask (B, n) -> (work-lists (B, n) int32, counts (B,) int32):
    the work-list contract, `layer_fused.compact_worklist`; a (n,) mask
    runs it at B = 1 and gives ((n,), ())."""
    if active.ndim == 1:
        wl, na = lf.compact_worklist(active[None], n)
        return wl[0], na[0]
    return lf.compact_worklist(active, n)


def mark_blocks_from_queue(colstarts, queue, n_vertices: int, tile: int,
                           n_blocks: int):
    """Range-mark the rows-blocks a (B, L) sentinel-padded vertex
    queue's adjacency touches."""
    is_real = queue < n_vertices
    safe = torch.where(is_real, queue, 0).to(torch.int64)
    start = colstarts[safe].to(torch.int64)
    end = colstarts[safe + 1].to(torch.int64)
    return _mark_blocks(start, end, is_real & (end > start), tile,
                        n_blocks)


def _plan_dense(colstarts, active_words, n_vertices: int, tile: int,
                n_blocks: int):
    """The dense-mask planning arm: (B, W) active bitmaps unpacked to a
    (B, V) mask, every marked vertex's adjacency range marked.  No K2
    and no planner launch; the same lists as the packed arm."""
    dense = bm.unpack_bool(active_words)[:, :n_vertices]
    cs = colstarts.to(torch.int64)
    start, end = cs[:-1], cs[1:]
    return _mark_blocks(start, end, dense & (end > start), tile, n_blocks)


def plan_active_tiles_batched(colstarts, active_words, n_vertices: int,
                              tile: int, n_blocks: int,
                              packed: bool = True):
    """Batched planning: (B, W) active bitmaps -> ((B, n_blocks)
    work-lists, (B,) live counts).  The packed arm compacts the batch
    in one K2 launch and marks blocks from the queues; the dense arm
    (``packed=False``, the ``fused_gather`` steps' planning there) marks
    them from the unpacked mask.  The packed arm is the reference's
    planner, kept as the yardstick of the union planner
    (`kernels.plan`), which gives the same lists and which the packed
    engine runs."""
    if not packed:
        return _plan_dense(colstarts, active_words, n_vertices, tile,
                           n_blocks)
    v_pad = active_words.shape[1] * bm.BITS_PER_WORD
    queues, _ = ops.frontier_compact_batched(active_words, size=v_pad,
                                             fill=n_vertices)
    return mark_blocks_from_queue(colstarts, queues, n_vertices, tile,
                                  n_blocks)


def plan_active_tiles(colstarts, active_words, n_vertices: int, tile: int,
                      n_blocks: int, packed: bool = False):
    """One root's planning ((W,) -> ((n_blocks,) work-list, () count)):
    `plan_active_tiles_batched` at B = 1 (default the dense arm, as in
    the reference)."""
    wl, na = plan_active_tiles_batched(colstarts, active_words[None],
                                       n_vertices, tile, n_blocks,
                                       packed=packed)
    return wl[0], na[0]


def _pad_rows_to_tile(rows, n_vertices: int, tile: int):
    """Sentinel-pad the CSR rows to a tile multiple — once, when the
    steps are built, never inside the layer loop."""
    pad = (-int(rows.shape[0])) % tile
    if pad:
        rows = torch.cat([rows, torch.full((pad,), n_vertices,
                                           dtype=torch.int32,
                                           device=rows.device)])
    return rows.contiguous()


def dense_queue(colstarts, words, list_size: int, n_vertices: int,
                n_slots: int) -> EdgeQueue:
    """The dense-mask arm's queue of (B, W) bitmaps: `bitmap.compact_mask`
    of each row's bits (ascending ids, ``n_vertices``-filled, counts not
    capped: K2's queue and counts) with each entry's inclusive degree
    prefix, read from ``colstarts`` (past a root's count it holds its
    total, where K2 writes nothing), and each root's total and truncated
    edges — the `compact.EdgeQueue` that `ops.apportion` takes.  Plain
    torch, with no host sync."""
    queue, count = bm.compact_mask(bm.unpack_bool(words), list_size,
                                   n_vertices)
    is_real = queue < n_vertices
    safe = torch.where(is_real, queue, 0).to(torch.int64)
    deg = torch.where(is_real, colstarts[safe + 1] - colstarts[safe], 0)
    cum = torch.cumsum(deg, dim=1, dtype=torch.int32)
    total = cum[:, -1].contiguous() if list_size \
        else cum.new_zeros((queue.shape[0],))
    truncated = (total - n_slots).clamp(min=0).to(torch.int32)
    return EdgeQueue(queue, count, cum, total, truncated)


def _batched_edge_stream(colstarts, rows, deg, words, n_vertices: int,
                         n_slots: int, packed: bool = True):
    """(B, W) bitmaps -> the batched apportioned streams (u, v, valid,
    truncated): the queue with each entry's degree prefix — one K2
    launch (``deg``: the padded degree array), or the dense-mask queue
    (`dense_queue`) under ``packed=False`` — then `ops.apportion` writes
    the stream from it."""
    size = words.shape[1] * bm.BITS_PER_WORD
    if packed:
        q = ops.frontier_queue(words, size=size, fill=n_vertices, deg=deg,
                               n_vertices=n_vertices, n_slots=n_slots)
    else:
        q = dense_queue(colstarts, words, size, n_vertices, n_slots)
    return ops.apportion(colstarts, rows, q, n_vertices=n_vertices,
                         n_slots=n_slots)


def edge_stream(colstarts, rows, frontier_words, list_size: int,
                n_vertices: int, n_slots: int, packed: bool = False):
    """One root's apportioned (u, v, valid, truncated) stream of
    ``n_slots`` slots over the adjacency of a (W,) bitmap's first
    ``list_size`` vertices: the queue by K2's stream arm (``packed``) or
    the dense mask (default, as in the reference), then
    `ops.apportion`; the batched calls at B = 1."""
    words = frontier_words[None].contiguous()
    if packed:
        deg = bm.degree_matrix(colstarts[1:] - colstarts[:-1],
                               words.shape[1] * bm.BITS_PER_WORD)
        q = ops.frontier_queue(words, size=list_size, fill=n_vertices,
                               deg=deg.reshape(-1), n_vertices=n_vertices,
                               n_slots=n_slots)
    else:
        q = dense_queue(colstarts, words, list_size, n_vertices, n_slots)
    u, v, valid, trunc = ops.apportion(colstarts, rows, q,
                                       n_vertices=n_vertices,
                                       n_slots=n_slots)
    return u[0], v[0], valid[0], trunc[0]


def _bottomup_stream(colstarts, rows, visited_words, n_vertices: int,
                     c_size: int, e_size: int):
    """One root's stream over the adjacency of its unvisited vertices
    (``~visited``: padding is premarked, so the complement is the real
    undiscovered set), dense arm: the candidates are the stream's
    owners."""
    return edge_stream(colstarts, rows, ~visited_words, c_size,
                       n_vertices, e_size)


def scalar_expand(colstarts, rows, n_vertices: int, frontier, visited,
                  parent, f_size: int, e_size: int, algorithm: str):
    """One plain top-down CSR layer of one root (Algorithm 2/3): the
    dense-arm `edge_stream` and `expand_candidates`.  The hostloop and
    ``bfs_parallel.expand_*`` call it.  Returns (out, visited, parent,
    truncated)."""
    u, v, valid, truncated = edge_stream(colstarts, rows, frontier, f_size,
                                         n_vertices, e_size)
    out, visited, parent = expand_candidates(
        u[None], v[None], valid[None], frontier[None], visited[None],
        parent[None], n_vertices, algorithm)
    return out[0], visited[0], parent[0], truncated


def rowsweep_stream(colstarts, rows, active_words, n_vertices: int,
                    nbr_limit: int | None = None):
    """(u, v, valid) in rows order: owners by a degree expansion of
    ``colstarts``, the frontier gate a bitmap test per edge.  With
    `candidate_scatter` it is the plain version of the distributed
    step's rowsweep kernel (`ops.rowsweep_candidates`).  Padding slots
    take the last vertex as owner, as the reference's ``jnp.repeat``
    fills them; their sentinel neighbours invalidate them.
    ``nbr_limit`` bounds valid neighbour ids: it differs from
    ``n_vertices`` only in the distributed step, whose owners are
    local ids and neighbours global ones."""
    nbr_limit = n_vertices if nbr_limit is None else nbr_limit
    deg = (colstarts[1:] - colstarts[:-1]).long()
    n_real = int(colstarts[-1])
    u = torch.full((rows.shape[0],), n_vertices - 1, dtype=torch.int32,
                   device=rows.device)
    u[:n_real] = torch.repeat_interleave(
        torch.arange(n_vertices, dtype=torch.int32, device=rows.device),
        deg, output_size=n_real)
    valid = bm.test_bits(active_words, u) & (rows < nbr_limit)
    return u, rows, valid


def candidate_scatter(u, v, valid, visited, n_vertices: int, v_cap: int):
    """A layer's discoveries as a min-parent candidate array of one
    root: ``n_vertices`` (INF) everywhere, the least discovering parent
    where a valid undiscovered candidate exists — the deterministic
    merge primitive of the distributed step."""
    mask = valid & ~bm.test_bits(visited, v) & (v < n_vertices)
    idx = torch.where(mask, v, v_cap).to(torch.int64)
    cand = torch.full((v_cap + 1,), n_vertices, dtype=torch.int32,
                      device=u.device)
    return cand.scatter_reduce_(0, idx, u.to(torch.int32), "amin")[:v_cap]


def _make_scalar_step(colstarts, rows, n_vertices: int, deg, e_pad: int,
                      algorithm: str, tile: int, packed: bool = True):
    """Plain Algorithm 2/3 layer over the root batch: the apportioned
    stream (`_batched_edge_stream`; ``deg`` is the format's padded degree
    array), then `expand_candidates`.  Its StepAux reports the full
    stream's tile count, as the reference does."""
    tiles_per_root = -(-e_pad // tile)

    def step(frontier, visited, parent):
        with ops.count_launches() as c:
            u, v, valid, trunc = _batched_edge_stream(
                colstarts, rows, deg, frontier, n_vertices, e_pad, packed)
            out, visited, parent = expand_candidates(
                u, v, valid, frontier, visited, parent, n_vertices,
                algorithm)
        aux = StepAux(frontier.shape[0] * tiles_per_root, trunc.sum(),
                      c.count)
        return out, visited, parent, aux

    return step


def kernel_expand_restore(nbr, cand, valid, frontier, visited, parent,
                          n_vertices: int, check_frontier: bool = False,
                          single: bool = False):
    """The materialized layer's expand -> restore -> OR-delta sequence:
    K7 over the apportioned stream (K7s on one root's (N,) stream and
    (W,) state where ``single``), K1, and the delta merged into ``out``
    and ``visited``.  Returns (out, visited, parent)."""
    expand = ops.expand if single else ops.expand_batched
    out_racy, p_racy = expand(
        nbr, cand, valid, frontier, visited, torch.zeros_like(frontier),
        parent, n_vertices=n_vertices, check_frontier=check_frontier)
    p_fixed, delta = ops.restore(p_racy, n_vertices=n_vertices)
    return out_racy | delta, visited | delta, p_fixed


def _make_simd_step(colstarts, rows, n_vertices: int, deg, e_pad: int,
                    tile: int, packed: bool = True):
    """§4 SIMD layer, materialized pipeline: K2 compacts the frontier
    with its degree prefix (``packed=False``: the dense-mask queue), the
    apportionment writes the full (u, v, valid) stream of e_pad slots
    per root, K7 expands it and K1 restores.  Its StepAux reports the
    full stream's tiles, as the reference does."""
    tiles_per_root = -(-e_pad // tile)

    def step(frontier, visited, parent):
        with ops.count_launches() as c:
            u, v, valid, trunc = _batched_edge_stream(
                colstarts, rows, deg, frontier, n_vertices, e_pad, packed)
            out, visited, parent = kernel_expand_restore(
                u, v, valid, frontier, visited, parent, n_vertices)
        aux = StepAux(frontier.shape[0] * tiles_per_root, trunc.sum(),
                      c.count)
        return out, visited, parent, aux

    return step


def _make_bottomup_step(colstarts, rows, n_vertices: int, deg,
                        e_pad: int, tile: int, packed: bool = True):
    """Bottom-up layer, materialized pipeline: K2 compacts the unvisited
    set (``~visited``, exact because padding is premarked) with its
    degree prefix (``packed=False``: the dense-mask queue), the
    apportionment streams its adjacency, and K7 tests each neighbour
    against the frontier (``check_frontier``) before K1 restores."""
    tiles_per_root = -(-e_pad // tile)

    def step(frontier, visited, parent):
        with ops.count_launches() as c:
            cand, nbr, valid, trunc = _batched_edge_stream(
                colstarts, rows, deg, ~visited, n_vertices, e_pad, packed)
            out, visited, parent = kernel_expand_restore(
                nbr, cand, valid, frontier, visited, parent, n_vertices,
                check_frontier=True)
        aux = StepAux(frontier.shape[0] * tiles_per_root, trunc.sum(),
                      c.count)
        return out, visited, parent, aux

    return step


def _make_fused_step(graph: FusedCsr, bottom_up: bool,
                     prefetch_depth: int = 0, packed: bool = True):
    """One fused_gather layer, both directions: the union planner lists
    the active rows-blocks of the frontier's adjacency (bottom-up: of
    the unvisited set's, ``~visited``, exact because padding is
    premarked) with their root masks, K3 (K4 at ``prefetch_depth > 0``)
    gathers and expands them, K1 restores.  ``packed=False`` plans from
    the dense mask instead (`_plan_dense`, the per-root lists folded by
    `gather_expand.UnionPlan.of_lists`): the planner's ablation
    baseline, with no planner launch."""

    def step(frontier, visited, parent):
        with ops.count_launches() as c:
            if packed:
                plan = ops.plan_union(graph, visited if bottom_up
                                      else frontier, complement=bottom_up)
            else:
                wl, na = _plan_dense(graph.colstarts, ~visited if bottom_up
                                     else frontier, graph.n_vertices,
                                     graph.tile, graph.n_blocks)
                plan = ge.UnionPlan.of_lists(wl, na, graph.n_blocks)
            out_racy, p_racy = ops.gather_expand_batched(
                plan, graph.rows, graph.colstarts, frontier, visited,
                torch.zeros_like(frontier), parent,
                n_vertices=graph.n_vertices, tile=graph.tile,
                bottom_up=bottom_up, prefetch_depth=prefetch_depth)
            p_fixed, delta = ops.restore(p_racy, n_vertices=graph.n_vertices)
        aux = StepAux(plan.na.sum(), 0, c.count)
        return out_racy | delta, visited | delta, p_fixed, aux

    return step


def _make_megakernel_step(graph: FusedCsr, bottom_up: bool,
                          prefetch_depth: int = 0):
    """One whole layer in ONE launch (K5): plan, gather-expand and
    restore.  ``out`` comes back repaired, so the visited merge is a
    plain OR."""

    def step(frontier, visited, parent):
        with ops.count_launches() as c:
            out, parent, na = ops.layer_fused_batched(
                graph, frontier, visited, parent, bottom_up=bottom_up,
                prefetch_depth=prefetch_depth)
        aux = StepAux(na.sum(), 0, c.count)
        return out, visited | out, parent, aux

    return step


def check_prefetch(tile: int, prefetch_depth: int, n_blocks: int) -> None:
    """Refuse a prefetch ring that no CTA can hold (a launch would
    fail)."""
    if not ops.gather_stage_fits(tile, prefetch_depth, n_blocks):
        depth = min(prefetch_depth, n_blocks)
        raise ValueError(
            f"prefetch_depth={prefetch_depth} at tile={tile} needs "
            f"{(depth + 1) * tile * 4} bytes of shared memory per CTA "
            f"for its rows ring; the card allows "
            f"{ops.SMEM_OPTIN_BYTES}: use a smaller depth or tile")


def _make_steps(colstarts, rows, deg, n_vertices, v_pad, e_pad, algorithm,
                tile, pipeline: str = "fused_gather",
                prefetch_depth: int = 0, packed: bool = True):
    """Per-mode steps of a pipeline (``deg``: the format's padded degree
    array, ``degree_matrix().reshape(-1)``, which K2's stream arm reads).
    ``materialized`` is K2 + the apportioned stream + K7 + K1
    (`_make_simd_step`, `_make_bottomup_step`).  ``megakernel`` (and
    the per-layer steps of ``persistent``: its degrades and its
    `CompiledTraversal.layer_step` tick) is K5, unless its budget does
    not fit: then it degrades, observably, to the ``fused_gather``
    steps.  Scalar layers are the plain step in every pipeline.
    ``packed=False`` is the dense-mask arm of the planning (``fused_gather``)
    and of the queues (``materialized``, scalar layers); K5 ignores it,
    as in the reference."""
    rows = rows.contiguous()
    colstarts = colstarts.contiguous()
    rows_t = _pad_rows_to_tile(rows, n_vertices, tile)
    n_blocks = int(rows_t.shape[0]) // tile
    check_prefetch(tile, prefetch_depth, n_blocks)
    fused = pipeline in ("megakernel", "persistent")
    if fused and not ops.megakernel_fits(tile, prefetch_depth, n_blocks):
        record_degrade(
            "smem_fallback",
            reason=(f"megakernel(tile={tile}, blocks={n_blocks}, "
                    f"depth={prefetch_depth}) needs "
                    f"{ops.megakernel_budget(tile, prefetch_depth, n_blocks)}"
                    f" bytes of shared memory per CTA, over "
                    f"{ops.SMEM_OPTIN_BYTES}"),
            fallback="pipeline='fused_gather' unfused steps (3 launches/"
                     "layer instead of 1)")
        fused = False
    if pipeline == "materialized":
        simd = _make_simd_step(colstarts, rows, n_vertices, deg, e_pad,
                               tile, packed)
        bottomup = _make_bottomup_step(colstarts, rows, n_vertices, deg,
                                       e_pad, tile, packed)
    else:
        graph = fused_csr(colstarts, rows_t, n_vertices, tile, v_pad)
        if fused:
            simd, bottomup = (_make_megakernel_step(graph, bu,
                                                    prefetch_depth)
                              for bu in (False, True))
        else:
            simd, bottomup = (_make_fused_step(graph, bu, prefetch_depth,
                                               packed)
                              for bu in (False, True))
    return {
        MODE_SCALAR: _make_scalar_step(colstarts, rows, n_vertices, deg,
                                       e_pad, algorithm, tile, packed),
        MODE_SIMD: simd,
        MODE_BOTTOMUP: bottomup,
    }


def policy_code(policy, n_vertices: int, n_roots: int,
                max_layers: int) -> tf.PolicyCode | None:
    """A registered policy as the kernels' numbers (the constants its
    comparisons use, rounded to float32 as the policy's own float32
    comparisons round them); None for any other policy, a subclass of a
    registered one included (its ``decide`` may differ)."""
    f32 = lambda x: float(np.float32(x))
    kind = type(policy)
    if kind is TopDown:
        return tf.PolicyCode(tf.TOPDOWN)
    if kind is ThresholdSimd:
        return tf.PolicyCode(tf.THRESHOLD_SIMD,
                             threshold=f32(policy.simd_threshold))
    if kind is PaperLiteralLayers:
        return tf.PolicyCode(tf.PAPER_LAYERS, simd_layers=tuple(
            int(l) for l in policy.simd_layers if 0 <= l < max_layers))
    if kind is BeamerHybrid:
        return tf.PolicyCode(
            tf.BEAMER, alpha=f32(policy.alpha),
            v_over_beta=f32(n_vertices * n_roots / policy.beta))
    return None


def encode_policy(policy, n_vertices: int, n_roots: int,
                  max_layers: int) -> tf.PolicyCode:
    """The whole-traversal kernel's numbers for a registered policy
    (`policy_code`); any other policy raises (the engine degrades such
    a policy to the megakernel steps before it gets here:
    `persistent_fallback`)."""
    code = policy_code(policy, n_vertices, n_roots, max_layers)
    if code is None:
        raise NotImplementedError(
            f"the whole-traversal kernels run the registered policies "
            f"(TopDown, ThresholdSimd, PaperLiteralLayers, BeamerHybrid); "
            f"{type(policy).__name__} has no in-kernel encoding")
    return code


# ---------------------------------------------------------------------------
# The driver
# ---------------------------------------------------------------------------

def row_popcounts(words: torch.Tensor) -> torch.Tensor:
    """Set-bit count over the trailing word axis: (B, W) -> (B,) int32,
    or (W,) -> () int32.  The serve engine's finished-slot scan: on a
    CUDA tensor one launch of the measure kernel's count-only arm, on
    the CPU its plain version."""
    rows = words.reshape(-1, words.shape[-1]).contiguous()
    return ops.measure(rows).per_root[:, 0].reshape(words.shape[:-1])


def init_root_state(root: int, base_visited: torch.Tensor,
                    n_vertices: int):
    """Frontier/visited/parent arrays for one fresh root; ``base_visited``
    is the padding-premarked visited bitmap."""
    frontier, visited, parent = _init_state(
        torch.as_tensor([root], dtype=torch.int32,
                        device=base_visited.device),
        base_visited, n_vertices)
    return frontier[0], visited[0], parent[0]


def _init_state(roots: torch.Tensor, base_visited: torch.Tensor,
                n_vertices: int):
    n_batch = roots.shape[0]
    n_words = base_visited.shape[0]
    v_pad = n_words * bm.BITS_PER_WORD
    dev = base_visited.device
    word = (roots >> bm.WORD_SHIFT).to(torch.int64)[:, None]
    bit = (torch.ones_like(roots) << (roots & bm.WORD_MASK))[:, None]
    frontier = torch.zeros((n_batch, n_words), dtype=torch.int32,
                           device=dev)
    frontier.scatter_(1, word, bit)
    visited = base_visited.expand(n_batch, -1).clone()
    visited.scatter_(1, word, torch.gather(visited, 1, word) | bit)
    parent = torch.full((n_batch, v_pad), n_vertices, dtype=torch.int32,
                        device=dev)
    parent.scatter_(1, roots.to(torch.int64)[:, None], roots[:, None])
    return frontier, visited, parent


def _init_batched(roots: torch.Tensor, n_vertices: int, v_pad: int):
    with obs_trace.call_range(obs_trace.INIT_RANGE):
        base = padding_premarked_visited(n_vertices, device=roots.device)
        assert base.shape[0] * bm.BITS_PER_WORD == v_pad
        return _init_state(roots.to(torch.int32), base, n_vertices)


def _traverse_persistent(fmt, roots: torch.Tensor, spec) -> EngineResult:
    """The whole traversal in ONE launch (K6 on CSR, K10 on SELL): init
    the batch state, hand it to the format's whole-traversal kernel and
    repackage its ``(frontier, visited, parent, depths, layers,
    stats)``."""
    frontier, visited, parent = _init_batched(roots, fmt.n_vertices,
                                              fmt.n_vertices_padded)
    with obs_trace.call_range(obs_trace.LAUNCH_RANGE):
        frontier, visited, parent, depths, layers, stats = \
            fmt.persistent_run(frontier, visited, parent, spec)
    return EngineResult(BfsState(frontier, visited, parent, layers[0]),
                        depths, stats)


def persistent_fallback(fmt, n_roots: int, spec):
    """None where the whole-traversal kernel runs ``spec``; else, with
    the degrade recorded, the ``megakernel`` spec of its per-layer
    steps: for a policy the kernel cannot encode (the reference traces
    any policy into its kernel and pins ``megakernel`` bit-identical to
    it, so only the launches column differs), or where its shared
    memory budget does not fit."""
    if policy_code(spec.policy, fmt.n_vertices, n_roots,
                   spec.max_layers) is None:
        record_degrade(
            "pipeline_unsupported",
            reason=(f"pipeline='persistent' on {fmt.name!r}: "
                    f"{type(spec.policy).__name__} is not a registered "
                    f"policy and has no in-kernel encoding"),
            fallback="pipeline='megakernel' per-layer steps (>=1 "
                     "launch/layer instead of 1/traversal)")
    elif fmt.persistent_fits(n_roots, spec):
        return None
    else:
        record_degrade(
            "smem_fallback",
            reason=(f"persistent(format={fmt.name}, "
                    f"v_pad={fmt.n_vertices_padded}, roots={n_roots}, "
                    f"tile={spec.tile}, max_layers={spec.max_layers}, "
                    f"depth={spec.prefetch_depth}) needs "
                    f"{fmt.persistent_budget(spec)} bytes of shared "
                    f"memory per CTA, over {ops.SMEM_OPTIN_BYTES}"),
            fallback="pipeline='megakernel' per-layer steps (>=1 "
                     "launch/layer instead of 1/traversal)")
    return spec.replace(pipeline="megakernel")


def _traverse_impl(fmt, roots: torch.Tensor, spec, steps=None,
                   deg_mat=None) -> EngineResult:
    """The host layer loop over a `formats.GraphFormat` and a *resolved*
    `api.spec.TraversalSpec`; ``roots`` is a (B,) int32 tensor on the
    graph's device.  ``steps``/``deg_mat`` come from the plan cache
    (built here when absent).  A ``persistent`` spec has no host loop:
    the plan runs `_traverse_persistent`, or this loop over the
    megakernel steps where `persistent_fallback` degrades it."""
    policy = spec.policy
    max_layers = spec.max_layers
    n_vertices = fmt.n_vertices
    v_pad = fmt.n_vertices_padded
    if deg_mat is None:
        deg_mat = fmt.degree_matrix()
    if steps is None:
        steps = fmt.make_steps(spec)
    dev = roots.device
    n_roots = int(roots.shape[0])

    frontier, visited, parent = _init_batched(roots, n_vertices, v_pad)
    code = policy_code(policy, n_vertices, n_roots, max_layers)
    log = bk.new_log(n_roots, max_layers, code, dev)
    deg = deg_mat.reshape(-1)
    bottom_up = torch.zeros((), dtype=torch.bool, device=dev)
    layer = 0
    while layer < max_layers:
        # measure (and, for a registered policy, decide) in one launch
        c = ops.measure(frontier, visited if policy.needs_unvisited
                        else None, deg, log=log, layer=layer)
        if code is not None:
            # the layer's one host sync: loop condition + mode together
            active, mode = log.ctrl[:2].tolist()
        else:
            w = Workload(layer, *c.sums, n_vertices, bottom_up,
                         n_roots=n_roots)
            mode_t, next_bottom_up = policy.decide(w)
            active, mode = torch.stack([log.ctrl[0], mode_t]).tolist()
        if not active:
            break
        if code is None:
            bottom_up = next_bottom_up
            log.stats[layer, _ST_MODE] = mode
        frontier, visited, parent, aux = steps[mode](frontier, visited,
                                                     parent)
        row = log.stats[layer]
        row[_ST_TILES] = aux.tiles
        row[_ST_TRUNC] = aux.truncated
        row[_ST_LAUNCH] = aux.launches
        layer += 1
    if layer == max_layers > 0:
        # the last layer's discovered column: the count of its output
        ops.measure(frontier, log=log, layer=layer)
    return EngineResult(
        BfsState(frontier, visited, parent,
                 torch.tensor(layer, dtype=torch.int32, device=dev)),
        log.depths, log.stats)


def layer_stats(result: EngineResult) -> list[LayerStats]:
    """Decode the stats buffer (one transfer, after the loop)."""
    buf = np.asarray(result.stats.cpu())
    out = []
    for i in range(buf.shape[0]):
        if not buf[i, _ST_ACTIVE]:
            break
        out.append(LayerStats(
            layer=i,
            frontier_vertices=int(buf[i, _ST_FRONTIER]),
            edges_examined=int(buf[i, _ST_EDGES]),
            discovered=int(buf[i, _ST_DISCOVERED]),
            active_tiles=int(buf[i, _ST_TILES]),
            truncated_edges=int(buf[i, _ST_TRUNC]),
            launches=int(buf[i, _ST_LAUNCH])))
    return out


def direction_log(result: EngineResult) -> list[str]:
    """Per-layer direction strings ("topdown"/"bottomup") from stats."""
    buf = np.asarray(result.stats.cpu())
    return [MODE_NAMES[int(buf[i, _ST_MODE])]
            for i in range(buf.shape[0]) if buf[i, _ST_ACTIVE]]


# ---------------------------------------------------------------------------
# Tiles
# ---------------------------------------------------------------------------

def _next_pow2(n: int, lo: int = 128) -> int:
    n = max(int(n), lo)
    return 1 << (n - 1).bit_length()


def default_tile_csr(fmt=None) -> int:
    """The auto CSR tile through `formats.affinity.resolve`:
    ``REPRO_BFS_TILE`` > the geometry-keyed row of the port's table
    (when ``fmt`` is given) > the flat ``affinity.tile<N>`` rows >
    `csr_format.DEFAULT_TILE`."""
    from repro_torch.formats import affinity
    from repro_torch.formats.csr_format import DEFAULT_TILE
    return int(affinity.resolve(fmt, "tile", DEFAULT_TILE))


def _resolve_tile_csr(tile: int | None, e_pad: int, fmt=None) -> int:
    """The CSR tile rule (`CsrFormat.resolve_tile`) for ``e_pad`` rows
    slots: ``tile`` floored at `MIN_TILE` (one lane set, so small graphs
    still split into several blocks) or, for auto, `default_tile_csr`
    capped at ``e_pad / 8`` so small graphs keep >= 8 blocks to skip,
    and never past the edge stream (rows are padded up to a tile
    multiple, so an oversized tile would balloon the stream)."""
    from repro_torch.formats.csr_format import MIN_TILE
    if tile is None:
        tile = max(MIN_TILE, min(default_tile_csr(fmt),
                                 max(e_pad // 8, MIN_TILE)))
        tile = min(tile, max(e_pad, MIN_TILE))
    return max(int(tile), MIN_TILE)


# ---------------------------------------------------------------------------
# The legacy entry points: thin shims over `api.plan`
# ---------------------------------------------------------------------------

_UNSET = object()       # legacy-shim sentinel: "knob not passed"

def make_spec(*, policy=None, algorithm: str = "simd",
              tile: int | None = None, max_layers: int = 64,
              pipeline: str = "fused_gather", packed: bool = True,
              prefetch_depth: int = 0):
    """A `TraversalSpec` from legacy knob values (``policy=None`` ->
    `TopDown()`, ``tile=None`` -> the format's auto rule): the one
    knob -> spec constructor of the shims and the ``run_bfs*``
    functions."""
    from repro_torch.api.spec import TraversalSpec
    return TraversalSpec(
        policy=policy if policy is not None else TopDown(),
        algorithm=algorithm, pipeline=pipeline, packed=packed,
        tile="auto" if tile is None else tile,
        prefetch_depth=prefetch_depth, max_layers=max_layers)


def _spec_from_knobs(entry: str, spec, knobs: dict):
    """The shims' spec: ``spec`` itself, or the loose knobs (name ->
    value or `_UNSET`) over `make_spec`'s defaults, with a DeprecationWarning
    when any is passed; ``spec=`` together with loose knobs raises
    ValueError.  Unresolved: `api.plan.plan` resolves it."""
    explicit = {k: v for k, v in knobs.items() if v is not _UNSET}
    if spec is not None:
        if explicit:
            raise ValueError(
                f"{entry}: pass either spec= or the loose knobs "
                f"({sorted(explicit)}), not both")
        return spec
    if explicit:
        warnings.warn(
            f"{entry}: the loose-knob form "
            f"({', '.join(sorted(explicit))}) is deprecated; pass "
            f"spec=repro_torch.bfs.TraversalSpec(...) instead",
            DeprecationWarning, stacklevel=3)
    return make_spec(**explicit)


def traverse_arrays(colstarts, rows, roots, *, n_vertices: int,
                    policy=_UNSET, algorithm=_UNSET, tile=_UNSET,
                    max_layers=_UNSET, pipeline=_UNSET, packed=_UNSET,
                    prefetch_depth=_UNSET, spec=None,
                    device=DEFAULT_DEVICE) -> EngineResult:
    """The engine on raw CSR arrays, viewed through `CsrFormat`: a shim
    over `api.plan.plan` (``spec=``; the loose knobs are deprecated).
    Returns batched results."""
    from repro_torch.api.plan import plan
    from repro_torch.formats.csr_format import CsrFormat
    fmt = CsrFormat(colstarts, rows, n_vertices, int(colstarts[-1]))
    s = _spec_from_knobs(
        "traverse_arrays", spec,
        dict(policy=policy, algorithm=algorithm, tile=tile,
             max_layers=max_layers, pipeline=pipeline, packed=packed,
             prefetch_depth=prefetch_depth))
    return plan(fmt, s, device=device).run_batched(roots)


def traverse_format(fmt, roots, *, policy=_UNSET, algorithm=_UNSET,
                    tile=_UNSET, max_layers=_UNSET, pipeline=_UNSET,
                    packed=_UNSET, prefetch_depth=_UNSET, spec=None,
                    device=DEFAULT_DEVICE) -> EngineResult:
    """The engine on any built `GraphFormat`: a shim over
    `api.plan.plan`.  Returns batched results."""
    from repro_torch.api.plan import plan
    s = _spec_from_knobs(
        "traverse_format", spec,
        dict(policy=policy, algorithm=algorithm, tile=tile,
             max_layers=max_layers, pipeline=pipeline, packed=packed,
             prefetch_depth=prefetch_depth))
    return plan(fmt, s, device=device).run_batched(roots)


def traverse(graph, roots, *, policy=_UNSET, algorithm=_UNSET,
             tile=_UNSET, max_layers=_UNSET, pipeline=_UNSET,
             packed=_UNSET, prefetch_depth=_UNSET, spec=None,
             device=DEFAULT_DEVICE) -> EngineResult:
    """Run the engine for one root (an int: unbatched results) or a
    sequence of roots: a shim over `api.plan.plan(graph, spec).run`.

    ``graph`` is a `Csr`, an `EdgeList` or a built `GraphFormat`;
    ``spec`` a `TraversalSpec`.  The loose knobs (``policy=None`` ->
    `TopDown()`, ``tile=None`` -> the format's auto rule) are the
    deprecated form of the same fields."""
    from repro_torch.api.plan import plan
    s = _spec_from_knobs(
        "traverse", spec,
        dict(policy=policy, algorithm=algorithm, tile=tile,
             max_layers=max_layers, pipeline=pipeline, packed=packed,
             prefetch_depth=prefetch_depth))
    return plan(graph, s, device=device).run(roots)


def layer_step(colstarts, rows, frontier, visited, parent, *,
               n_vertices: int, algorithm: str = "simd"):
    """Advance every root of a (B, ...) batch by one scalar layer on raw
    CSR arrays, where the state lies; roots with an empty frontier pass
    through unchanged.  Returns (frontier, visited, parent); P is
    updated in place."""
    v_pad = int(parent.shape[-1])
    e_pad = int(rows.shape[0])
    deg = bm.degree_matrix(colstarts[1:] - colstarts[:-1], v_pad)
    step = _make_scalar_step(colstarts.contiguous(), rows.contiguous(),
                             n_vertices, deg.reshape(-1), e_pad, algorithm,
                             _resolve_tile_csr(None, e_pad))
    return step(frontier, visited, parent)[:3]


def layer_step_format(fmt, frontier, visited, parent, *,
                      algorithm=_UNSET, pipeline=_UNSET, packed=_UNSET,
                      prefetch_depth=_UNSET, spec=None):
    """One layer of a (B, ...) batch through a format's steps, where the
    state lies: a shim over `api.plan.plan(fmt, spec).layer_step`."""
    from repro_torch.api.plan import plan
    s = _spec_from_knobs(
        "layer_step_format", spec,
        dict(algorithm=algorithm, pipeline=pipeline, packed=packed,
             prefetch_depth=prefetch_depth))
    return plan(fmt, s, device=frontier.device).layer_step(
        frontier, visited, parent)


# ---------------------------------------------------------------------------
# The legacy host loop (pow2 buckets; one host read per layer)
# ---------------------------------------------------------------------------

def _hostloop_layer(colstarts, rows, frontier, visited, parent, *,
                    n_vertices: int, mode: int, algorithm: str,
                    f_size: int, e_size: int):
    """One root's layer at its pow2 bucket, any mode, on the
    materialized stream (dense arm): K7s + K1 for the SIMD and
    bottom-up modes, the plain body for the scalar one.  Returns (out,
    visited, parent, truncated)."""
    if mode == MODE_SCALAR:
        return scalar_expand(colstarts, rows, n_vertices, frontier,
                             visited, parent, f_size, e_size, algorithm)
    if mode == MODE_SIMD:
        u, v, valid, trunc = edge_stream(colstarts, rows, frontier,
                                         f_size, n_vertices, e_size)
        return kernel_expand_restore(u, v, valid, frontier, visited,
                                     parent, n_vertices,
                                     single=True) + (trunc,)
    # MODE_BOTTOMUP: f_size buckets the unvisited-candidate list
    cand, nbr, valid, trunc = _bottomup_stream(colstarts, rows, visited,
                                               n_vertices, f_size, e_size)
    return kernel_expand_restore(nbr, cand, valid, frontier, visited,
                                 parent, n_vertices, check_frontier=True,
                                 single=True) + (trunc,)


def traverse_hostloop(csr: Csr, root: int, *, policy=None,
                      algorithm: str = "simd", tile: int | None = None,
                      max_layers: int = 1024, collect_stats: bool = False,
                      device=DEFAULT_DEVICE):
    """The legacy layer loop of one root, with power-of-two buckets:
    each layer measures its counters (the measure kernel), lets the
    policy decide, reads the counters and the mode in one host read and
    streams exactly the bucket's slots.  Returns (state, stats,
    direction log); ``stats`` (with ``collect_stats``) are
    `LayerStats` with the bucket's tile count (at ``tile``, default
    `csr_format.DEFAULT_TILE`) and no launches."""
    from repro_torch.formats.csr_format import DEFAULT_TILE
    policy = policy if policy is not None else TopDown()
    dev = resolve_device(device)
    colstarts = csr.colstarts.to(dev).contiguous()
    rows = csr.rows.to(dev).contiguous()
    n_vertices = csr.n_vertices
    deg = bm.degree_matrix(colstarts[1:] - colstarts[:-1],
                           csr.n_vertices_padded).reshape(-1)
    frontier, visited, parent = init_root_state(
        root, padding_premarked_visited(n_vertices, device=dev), n_vertices)
    bottom_up = torch.zeros((), dtype=torch.bool, device=dev)
    rows_of: list[tuple] = []
    log: list[str] = []
    layer = 0
    count = 0
    while layer < max_layers:
        c = ops.measure(frontier[None], visited[None]
                        if policy.needs_unvisited else None, deg)
        w = Workload(layer, *c.per_root[0], n_vertices, bottom_up)
        mode_t, next_bottom_up = policy.decide(w)
        # the layer's one host read: its counters and the mode
        count, edges, u_count, u_edges, mode = torch.cat(
            [c.per_root[0], mode_t.reshape(1)]).tolist()
        if count == 0:
            break
        bottom_up = next_bottom_up
        if mode == MODE_BOTTOMUP:
            f_size, e_size = _next_pow2(u_count), _next_pow2(max(u_edges, 1))
        else:
            f_size, e_size = _next_pow2(count), _next_pow2(max(edges, 1))
        frontier, visited, parent, trunc = _hostloop_layer(
            colstarts, rows, frontier, visited, parent,
            n_vertices=n_vertices, mode=mode, algorithm=algorithm,
            f_size=f_size, e_size=e_size)
        log.append(MODE_NAMES[mode])
        t = tile if tile is not None else DEFAULT_TILE
        rows_of.append((count, edges, -(-e_size // t), trunc))
        layer += 1
    else:
        count = int(bm.popcount(frontier))
    stats = []
    if collect_stats and rows_of:
        truncs = torch.stack([r[3] for r in rows_of]).tolist()
        found = [r[0] for r in rows_of[1:]] + [count]
        stats = [LayerStats(layer=i, frontier_vertices=f, edges_examined=e,
                            discovered=d, active_tiles=n_tiles,
                            truncated_edges=tr)
                 for i, ((f, e, n_tiles, _), d, tr)
                 in enumerate(zip(rows_of, found, truncs))]
    state = BfsState(frontier, visited, parent,
                     torch.tensor(layer, dtype=torch.int32, device=dev))
    return state, stats, log
