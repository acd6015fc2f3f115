"""The batched BFS traversal engine with pluggable direction policies.

A port of ``repro.core.engine``'s main path: the ``fused_gather``
pipeline on packed bitmaps with ``prefetch_depth=0``.  Each layer runs

    measure workload  ->  decide direction  ->  expand  ->  restore

* **measure** (`Workload`): the Table 1 counters, computed on the
  device from word popcounts and the word-aligned degree matrix —
  int32 per root, then float32 batch sums, exactly as the reference
  computes them, so the policies' comparisons decide identically.
* **decide** (`TopDown`, `ThresholdSimd`, `PaperLiteralLayers`,
  `BeamerHybrid`): small frozen objects deciding from those counters
  with torch ops on the device.
* **expand**: a SIMD or bottom-up layer is `_make_fused_step`: K2
  compacts the frontier (or the unvisited set) into a queue, plain
  torch marks the rows-blocks its adjacency touches and compacts them
  into a work-list, K3 gathers and expands those blocks with the racy
  scatter, and K1 restores.  A scalar layer (`_make_scalar_step`) is
  K2 plus the plain apportionment and `expand_candidates`.
* **restore** (§3.3.2): vertices marked by a negative P are repaired
  into ``out`` and ``visited``.

**The layer loop.**  The reference runs the whole search as one
``lax.while_loop`` with no host synchronization.  Here the loop is a
Python loop with exactly **one host sync per layer**: a single
``tolist()`` reads the loop condition (is any frontier non-empty) and
the policy's mode together, and the host then launches the chosen
step.  Everything else — counters, stats row, depths — stays on the
device.  Capturing the layer in a CUDA graph, or running fixed
``max_layers`` iterations with masked no-op layers, is later work.

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
from repro_torch.kernels import ops
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

    Batch sums are float32 (per-root values are int32-exact; a batch
    can sum past 2^31).  ``n_roots`` scales Beamer's V/beta to the
    batch.  ``layer`` is the host's layer index."""
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
    values: torch.Tensor | None = None   # semiring portfolio (not yet)


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
        switch_down = (~w.bottom_up) & (f_edges > u_edges / self.alpha)
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

def apportion(colstarts, rows, frontier_list, n_vertices: int,
              n_slots: int):
    """Map ``n_slots`` edge slots onto the frontier's adjacency lists.

    ``frontier_list`` is (B, L), sentinel-padded (id >= n_vertices is
    empty).  Returns (u, v, valid, truncated), the streams (B, n_slots)
    and ``truncated`` (B,) the edges that did not fit: a hub whose
    adjacency overruns the slots keeps its list prefix.  Owners come
    from a marker scatter at each adjacency's end offset plus a prefix
    sum, as in the reference."""
    n_batch, n_list = frontier_list.shape
    is_real = frontier_list < n_vertices
    safe = torch.where(is_real, frontier_list, 0).to(torch.int64)
    deg = torch.where(is_real, colstarts[safe + 1] - colstarts[safe], 0)
    cum = torch.cumsum(deg, dim=1)                      # int64
    total = cum[:, -1] if n_list else cum.new_zeros((n_batch,))
    truncated = (total - n_slots).clamp(min=0).to(torch.int32)
    markers = torch.zeros((n_batch, n_slots + 1), dtype=torch.int64,
                          device=rows.device)
    markers.scatter_add_(1, cum.clamp(max=n_slots),
                         torch.ones_like(cum))
    owner = torch.cumsum(markers[:, :n_slots], dim=1)
    owner_c = owner.clamp(0, n_list - 1)
    prev = torch.where(owner_c > 0,
                       torch.gather(cum, 1, (owner_c - 1).clamp(min=0)),
                       0)
    u = torch.gather(frontier_list, 1, owner_c)
    slots = torch.arange(n_slots, dtype=torch.int64, device=rows.device)
    valid = slots < total[:, None]
    u_safe = torch.where(valid, u, 0).to(torch.int64)
    e_idx = (colstarts[u_safe] + (slots - prev)) \
        .clamp(0, rows.shape[0] - 1)
    v = rows[e_idx]
    return u.to(torch.int32), v, valid, truncated


def restore_plain(parent, out, visited, n_vertices: int):
    """Plain restoration (§3.3.2): repair racy bitmap drops from the
    negative P marks.  Returns (parent, out, visited), all fixed."""
    fixed, repaired = restoration_plain(parent, n_vertices)
    return fixed, out | repaired, visited | repaired


def row_popcounts(words: torch.Tensor) -> torch.Tensor:
    """Set-bit count over the trailing word axis: (B, W) -> (B,) int32."""
    return bm.popcount32(words).sum(dim=-1).to(torch.int32)


def expand_candidates(u, v, valid, frontier, visited, parent,
                      n_vertices: int, algorithm: str):
    """The post-gather Algorithm 2/3 body on a (B, N) edge stream.

    ``"simd"``: Algorithm 3 — racy bitmap scatter + restoration;
    ``"nonsimd"``: Algorithm 2 — exact dense updates.  Returns
    (out, visited, parent).  (The semiring branch arrives with the
    algorithm portfolio.)"""
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


def compact_worklist(active: torch.Tensor, n: int):
    """Bool mask (B, n) -> (worklist (B, n) int32, n_active (B,) int32).

    Active indices first; every entry past ``n_active`` is clamped to
    the last active index (all zeros when nothing is active) — the
    work-list contract of the reference.  Built from a prefix sum and a
    scatter, with no ``nonzero`` and no host sync."""
    n_batch = active.shape[0]
    n_active = active.sum(dim=1).to(torch.int32)
    rank = torch.cumsum(active.to(torch.int64), dim=1) - 1
    slot = torch.where(active, rank, n)
    wl = torch.zeros((n_batch, n + 1), dtype=torch.int32,
                     device=active.device)
    wl.scatter_(1, slot, torch.arange(n, dtype=torch.int32,
                                      device=active.device)
                .expand(n_batch, -1).contiguous())
    wl = wl[:, :n]
    last = torch.gather(
        wl, 1, (n_active.to(torch.int64) - 1).clamp(0, n - 1)[:, None])
    pos = torch.arange(n, device=active.device)
    wl = torch.where(pos < n_active[:, None], wl, last)
    return wl.contiguous(), n_active


_DROP_SLOTS = 4096    # dropped marks spread over this many slots


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
    batch; the block marking is plain torch."""
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


def _batched_edge_stream(colstarts, rows, frontier, list_size: int,
                         n_vertices: int, n_slots: int):
    """(B, W) frontier bitmaps -> batched apportioned streams: one K2
    launch compacts the batch, the apportionment is plain torch."""
    fl, _ = ops.frontier_compact_batched(frontier, size=list_size,
                                         fill=n_vertices)
    return apportion(colstarts, rows, fl, n_vertices, n_slots)


def _make_scalar_step(colstarts, rows, n_vertices: int, v_pad: int,
                      e_pad: int, algorithm: str, tile: int):
    """Plain Algorithm 2/3 layer over the root batch.  Its StepAux
    reports the full stream's tile count, as the reference does."""
    tiles_per_root = -(-e_pad // tile)

    def step(frontier, visited, parent):
        with ops.count_launches() as c:
            u, v, valid, trunc = _batched_edge_stream(
                colstarts, rows, frontier, v_pad, n_vertices, e_pad)
            out, visited, parent = expand_candidates(
                u, v, valid, frontier, visited, parent, n_vertices,
                algorithm)
        aux = StepAux(frontier.shape[0] * tiles_per_root, trunc.sum(),
                      c.count)
        return out, visited, parent, aux

    return step


def _make_fused_step(colstarts, rows_t, n_vertices: int, tile: int,
                     bottom_up: bool):
    """One fused_gather layer, both directions: K2 + plain block
    marking plan the active rows-blocks of the frontier's adjacency
    (bottom-up: of the unvisited set's, ``~visited``, exact because
    padding is premarked), K3 gathers and expands them, K1 restores.
    ``rows_t`` is the tile-padded rows array."""
    n_blocks = int(rows_t.shape[0]) // tile

    def step(frontier, visited, parent):
        with ops.count_launches() as c:
            active = ~visited if bottom_up else frontier
            wl, na = plan_active_tiles_batched(colstarts, active,
                                               n_vertices, tile,
                                               n_blocks)
            out_racy, p_racy = ops.gather_expand_batched(
                wl, na, rows_t, colstarts, frontier, visited,
                torch.zeros_like(frontier), parent,
                n_vertices=n_vertices, tile=tile, bottom_up=bottom_up)
            p_fixed, delta = ops.restore(p_racy, n_vertices=n_vertices)
        aux = StepAux(na.sum(), 0, c.count)
        return out_racy | delta, visited | delta, p_fixed, aux

    return step


def _make_steps(colstarts, rows, n_vertices, v_pad, e_pad, algorithm,
                tile):
    """Per-mode steps of the ``fused_gather`` pipeline, the only one
    this port has so far (`api.spec` refuses the others)."""
    rows = rows.contiguous()
    colstarts = colstarts.contiguous()
    rows_t = _pad_rows_to_tile(rows, n_vertices, tile)
    return {
        MODE_SCALAR: _make_scalar_step(colstarts, rows, n_vertices,
                                       v_pad, e_pad, algorithm, tile),
        MODE_SIMD: _make_fused_step(colstarts, rows_t, n_vertices, tile,
                                    bottom_up=False),
        MODE_BOTTOMUP: _make_fused_step(colstarts, rows_t, n_vertices,
                                        tile, bottom_up=True),
    }


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


def _traverse_impl(fmt, roots: torch.Tensor, spec, steps=None,
                   deg_mat=None) -> EngineResult:
    """The engine body over a `formats.CsrFormat` and a *resolved*
    `api.spec.TraversalSpec`; ``roots`` is a (B,) int32 tensor on the
    graph's device.  ``steps``/``deg_mat`` come from the plan cache
    (built here when absent)."""
    policy = spec.policy
    max_layers = spec.max_layers
    n_vertices = fmt.n_vertices
    v_pad = fmt.n_vertices_padded
    if deg_mat is None:
        deg_mat = bm.degree_matrix(fmt.degrees(), v_pad)
    if steps is None:
        steps = fmt.make_steps(spec)
    dev = roots.device
    n_roots = int(roots.shape[0])

    frontier, visited, parent = _init_batched(roots, n_vertices, v_pad)
    bottom_up = torch.zeros((), dtype=torch.bool, device=dev)
    depths = torch.zeros((n_roots,), dtype=torch.int32, device=dev)
    stats = torch.zeros((max_layers, _N_ST), dtype=torch.int32,
                        device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    layer = 0
    while layer < max_layers:
        f_count_b = row_popcounts(frontier)
        f_edges_b = bm.masked_degree_sum(frontier, deg_mat)
        if policy.needs_unvisited:
            # padding is premarked visited, so the word complement IS
            # the real undiscovered set
            u_words = ~visited
            u_count = row_popcounts(u_words).sum().to(torch.float32)
            u_edges = bm.masked_degree_sum(u_words, deg_mat) \
                .to(torch.float32).sum()
        else:
            u_count = u_edges = zero
        w = Workload(layer, f_count_b.to(torch.float32).sum(),
                     f_edges_b.to(torch.float32).sum(), u_count, u_edges,
                     n_vertices, bottom_up, n_roots=n_roots)
        mode_t, next_bottom_up = policy.decide(w)
        f_count = f_count_b.sum()
        # the layer's one host sync: loop condition + mode together
        active, mode = torch.stack(
            [(f_count > 0).to(torch.int32), mode_t]).tolist()
        if not active:
            break
        bottom_up = next_bottom_up
        new_f, visited, parent, aux = steps[mode](frontier, visited,
                                                  parent)
        row = stats[layer]
        row[_ST_FRONTIER] = f_count
        row[_ST_EDGES] = f_edges_b.sum()
        row[_ST_DISCOVERED] = row_popcounts(new_f).sum()
        row[_ST_MODE] = mode
        row[_ST_ACTIVE] = 1
        row[_ST_TILES] = aux.tiles
        row[_ST_TRUNC] = aux.truncated
        row[_ST_LAUNCH] = aux.launches
        depths += (f_count_b > 0).to(torch.int32)
        frontier = new_f
        layer += 1
    return EngineResult(
        BfsState(frontier, visited, parent,
                 torch.tensor(layer, dtype=torch.int32, device=dev)),
        depths, stats)


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
