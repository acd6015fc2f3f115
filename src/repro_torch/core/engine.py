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

State arrays carry a leading root axis (B, ...).  Bitmap words are
int32 (see `repro_torch.core.bitmap`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import bitmap as bm
from repro_torch.core.csr import padding_premarked_visited
from repro_torch.errors import record_degrade
from repro_torch.kernels import bitmap_kernels as bk
from repro_torch.kernels import ops
from repro_torch.kernels.apportion import apportion_plain as apportion
from repro_torch.kernels import traversal_fused as tf
from repro_torch.kernels.layer_fused import (FusedCsr, compact_worklist,
                                             fused_csr)
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

_DROP_SLOTS = 4096    # dropped marks spread over this many slots


def restore_plain(parent, out, visited, n_vertices: int):
    """Plain restoration (§3.3.2): repair racy bitmap drops from the
    negative P marks.  Returns (parent, out, visited), all fixed."""
    fixed, repaired = restoration_plain(parent, n_vertices)
    return fixed, out | repaired, visited | repaired


def expand_candidates(u, v, valid, frontier, visited, parent,
                      n_vertices: int, algorithm: str):
    """The post-gather Algorithm 2/3 body on a (B, N) edge stream.

    ``"simd"``: Algorithm 3 — racy bitmap scatter + restoration;
    ``"nonsimd"``: Algorithm 2 — exact dense updates.  Returns
    (out, visited, parent).  (The reference's semiring branch, its
    pure-jnp relax oracle, waits for ROADMAP.md §1 item 1.)"""
    n_batch, v_pad = parent.shape
    n_words = v_pad // bm.BITS_PER_WORD
    rows_b = torch.arange(n_batch, device=parent.device)[:, None]
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
    `compact_worklist`.  Invalid ranges land on dropped slots past
    ``n_blocks``; they are spread over `_DROP_SLOTS` slots because
    millions of atomic adds on one address serialize on the card."""
    n_batch, n_list = start.shape
    blk_lo = start // tile
    blk_hi = (end - 1) // tile
    drop = n_blocks + 1 + torch.arange(n_list, device=start.device) \
        % _DROP_SLOTS
    diff = torch.zeros((n_batch, n_blocks + 1 + _DROP_SLOTS),
                       dtype=torch.int32, device=start.device)
    ones = torch.ones_like(blk_lo, dtype=torch.int32)
    diff.scatter_add_(1, torch.where(has, blk_lo, drop), ones)
    diff.scatter_add_(1, torch.where(has, blk_hi + 1, drop), -ones)
    covered = torch.cumsum(diff[:, :n_blocks + 1], dim=1)[:, :n_blocks] > 0
    return compact_worklist(covered, n_blocks)


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


def plan_active_tiles_batched(colstarts, active_words, n_vertices: int,
                              tile: int, n_blocks: int):
    """Batched planning, packed arm: (B, W) active bitmaps -> ((B,
    n_blocks) work-lists, (B,) live counts).  One K2 launch compacts the
    batch; the block marking is plain torch.  The reference's planner,
    kept as the yardstick of the union planner (`kernels.plan`), which
    gives the same lists and which the engine runs."""
    v_pad = active_words.shape[1] * bm.BITS_PER_WORD
    queues, _ = ops.frontier_compact_batched(active_words, size=v_pad,
                                             fill=n_vertices)
    return mark_blocks_from_queue(colstarts, queues, n_vertices, tile,
                                  n_blocks)


def _pad_rows_to_tile(rows, n_vertices: int, tile: int):
    """Sentinel-pad the CSR rows to a tile multiple — once, when the
    steps are built, never inside the layer loop."""
    pad = (-int(rows.shape[0])) % tile
    if pad:
        rows = torch.cat([rows, torch.full((pad,), n_vertices,
                                           dtype=torch.int32,
                                           device=rows.device)])
    return rows.contiguous()


def _batched_edge_stream(colstarts, rows, deg, words, n_vertices: int,
                         n_slots: int):
    """(B, W) bitmaps -> the batched apportioned streams (u, v, valid,
    truncated): one K2 launch compacts the batch with each entry's
    degree prefix (``deg``: the padded degree array), `ops.apportion`
    writes the stream from it."""
    q = ops.frontier_queue(words, size=words.shape[1] * bm.BITS_PER_WORD,
                           fill=n_vertices, deg=deg, n_vertices=n_vertices,
                           n_slots=n_slots)
    return ops.apportion(colstarts, rows, q, n_vertices=n_vertices,
                         n_slots=n_slots)


def _make_scalar_step(colstarts, rows, n_vertices: int, deg, e_pad: int,
                      algorithm: str, tile: int):
    """Plain Algorithm 2/3 layer over the root batch: the apportioned
    stream (`_batched_edge_stream`; ``deg`` is the format's padded degree
    array), then `expand_candidates`.  Its StepAux reports the full
    stream's tile count, as the reference does."""
    tiles_per_root = -(-e_pad // tile)

    def step(frontier, visited, parent):
        with ops.count_launches() as c:
            u, v, valid, trunc = _batched_edge_stream(
                colstarts, rows, deg, frontier, n_vertices, e_pad)
            out, visited, parent = expand_candidates(
                u, v, valid, frontier, visited, parent, n_vertices,
                algorithm)
        aux = StepAux(frontier.shape[0] * tiles_per_root, trunc.sum(),
                      c.count)
        return out, visited, parent, aux

    return step


def kernel_expand_restore(nbr, cand, valid, frontier, visited, parent,
                          n_vertices: int, check_frontier: bool = False):
    """The materialized layer's expand -> restore -> OR-delta sequence:
    K7 over the apportioned stream, K1, and the delta merged into
    ``out`` and ``visited``.  Returns (out, visited, parent)."""
    out_racy, p_racy = ops.expand_batched(
        nbr, cand, valid, frontier, visited, torch.zeros_like(frontier),
        parent, n_vertices=n_vertices, check_frontier=check_frontier)
    p_fixed, delta = ops.restore(p_racy, n_vertices=n_vertices)
    return out_racy | delta, visited | delta, p_fixed


def _make_simd_step(colstarts, rows, n_vertices: int, deg, e_pad: int,
                    tile: int):
    """§4 SIMD layer, materialized pipeline: K2 compacts the frontier
    with its degree prefix, the apportionment writes the full (u, v,
    valid) stream of e_pad slots per root, K7 expands it and K1
    restores.  Its StepAux reports the full stream's tiles, as the
    reference does."""
    tiles_per_root = -(-e_pad // tile)

    def step(frontier, visited, parent):
        with ops.count_launches() as c:
            u, v, valid, trunc = _batched_edge_stream(
                colstarts, rows, deg, frontier, n_vertices, e_pad)
            out, visited, parent = kernel_expand_restore(
                u, v, valid, frontier, visited, parent, n_vertices)
        aux = StepAux(frontier.shape[0] * tiles_per_root, trunc.sum(),
                      c.count)
        return out, visited, parent, aux

    return step


def _make_bottomup_step(colstarts, rows, n_vertices: int, deg,
                        e_pad: int, tile: int):
    """Bottom-up layer, materialized pipeline: K2 compacts the unvisited
    set (``~visited``, exact because padding is premarked) with its
    degree prefix, the apportionment streams its adjacency, and K7 tests
    each neighbour against the frontier (``check_frontier``) before K1
    restores."""
    tiles_per_root = -(-e_pad // tile)

    def step(frontier, visited, parent):
        with ops.count_launches() as c:
            cand, nbr, valid, trunc = _batched_edge_stream(
                colstarts, rows, deg, ~visited, n_vertices, e_pad)
            out, visited, parent = kernel_expand_restore(
                nbr, cand, valid, frontier, visited, parent, n_vertices,
                check_frontier=True)
        aux = StepAux(frontier.shape[0] * tiles_per_root, trunc.sum(),
                      c.count)
        return out, visited, parent, aux

    return step


def _make_fused_step(graph: FusedCsr, bottom_up: bool,
                     prefetch_depth: int = 0):
    """One fused_gather layer, both directions: the union planner lists
    the active rows-blocks of the frontier's adjacency (bottom-up: of
    the unvisited set's, ``~visited``, exact because padding is
    premarked) with their root masks, K3 (K4 at ``prefetch_depth > 0``)
    gathers and expands them, K1 restores."""

    def step(frontier, visited, parent):
        with ops.count_launches() as c:
            plan = ops.plan_union(graph, visited if bottom_up else frontier,
                                  complement=bottom_up)
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
                prefetch_depth: int = 0):
    """Per-mode steps of a pipeline (``deg``: the format's padded degree
    array, ``degree_matrix().reshape(-1)``, which K2's stream arm reads).  ``materialized`` is K2 + the
    apportioned stream + K7 + K1 (`_make_simd_step`,
    `_make_bottomup_step`).  ``megakernel`` (and the per-layer
    steps of ``persistent``, which runs them only where its kernel
    degrades) is K5, unless its budget does not fit: then it degrades,
    observably, to the ``fused_gather`` steps.  Scalar layers are the
    plain step in every pipeline."""
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
                               tile)
        bottomup = _make_bottomup_step(colstarts, rows, n_vertices, deg,
                                       e_pad, tile)
    else:
        graph = fused_csr(colstarts, rows_t, n_vertices, tile, v_pad)
        make = _make_megakernel_step if fused else _make_fused_step
        simd, bottomup = (make(graph, bu, prefetch_depth)
                          for bu in (False, True))
    return {
        MODE_SCALAR: _make_scalar_step(colstarts, rows, n_vertices, deg,
                                       e_pad, algorithm, tile),
        MODE_SIMD: simd,
        MODE_BOTTOMUP: bottomup,
    }


def policy_code(policy, n_vertices: int, n_roots: int,
                max_layers: int) -> tf.PolicyCode | None:
    """A registered policy as the kernels' numbers (the constants its
    comparisons use, rounded to float32 as the policy's own float32
    comparisons round them); None for any other policy."""
    f32 = lambda x: float(np.float32(x))
    if isinstance(policy, TopDown):
        return tf.PolicyCode(tf.TOPDOWN)
    if isinstance(policy, ThresholdSimd):
        return tf.PolicyCode(tf.THRESHOLD_SIMD,
                             threshold=f32(policy.simd_threshold))
    if isinstance(policy, PaperLiteralLayers):
        return tf.PolicyCode(tf.PAPER_LAYERS, simd_layers=tuple(
            int(l) for l in policy.simd_layers if 0 <= l < max_layers))
    if isinstance(policy, BeamerHybrid):
        return tf.PolicyCode(
            tf.BEAMER, alpha=f32(policy.alpha),
            v_over_beta=f32(n_vertices * n_roots / policy.beta))
    return None


def encode_policy(policy, n_vertices: int, n_roots: int,
                  max_layers: int) -> tf.PolicyCode:
    """The whole-traversal kernel's numbers for a registered policy
    (`policy_code`); any other policy raises."""
    code = policy_code(policy, n_vertices, n_roots, max_layers)
    if code is None:
        raise NotImplementedError(
            f"pipeline='persistent' runs the registered policies (TopDown, "
            f"ThresholdSimd, PaperLiteralLayers, BeamerHybrid); "
            f"{type(policy).__name__} has no in-kernel encoding — use "
            f"pipeline='megakernel'")
    return code


# ---------------------------------------------------------------------------
# The driver
# ---------------------------------------------------------------------------

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
    frontier, visited, parent, depths, layers, stats = \
        fmt.persistent_run(frontier, visited, parent, spec)
    return EngineResult(BfsState(frontier, visited, parent, layers[0]),
                        depths, stats)


def _persistent_degrade(fmt, n_roots: int, spec):
    """Where the whole-traversal kernel's budget does not fit: record
    the degrade and return the spec of the per-layer fallback."""
    record_degrade(
        "smem_fallback",
        reason=(f"persistent(format={fmt.name}, "
                f"v_pad={fmt.n_vertices_padded}, roots={n_roots}, "
                f"tile={spec.tile}, max_layers={spec.max_layers}, "
                f"depth={spec.prefetch_depth}) needs "
                f"{fmt.persistent_budget(spec)} bytes of shared memory "
                f"per CTA, over {ops.SMEM_OPTIN_BYTES}"),
        fallback="pipeline='megakernel' per-layer steps (>=1 launch/layer "
                 "instead of 1/traversal)")
    return spec.replace(pipeline="megakernel")


def _traverse_impl(fmt, roots: torch.Tensor, spec, steps=None,
                   deg_mat=None) -> EngineResult:
    """The engine body over a `formats.GraphFormat` and a *resolved*
    `api.spec.TraversalSpec`; ``roots`` is a (B,) int32 tensor on the
    graph's device.  ``steps``/``deg_mat`` come from the plan cache
    (built here when absent).  ``pipeline="persistent"`` goes to the
    format's whole-traversal kernel when its budget fits, else degrades
    to the megakernel steps."""
    if spec.pipeline == "persistent":
        if fmt.persistent_fits(int(roots.shape[0]), spec):
            return _traverse_persistent(fmt, roots, spec)
        spec = _persistent_degrade(fmt, int(roots.shape[0]), spec)
        steps = None
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
