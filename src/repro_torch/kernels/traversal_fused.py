"""K6 and K10 — a whole multi-root traversal per launch, on CSR (K6)
and on SELL-C-σ (K10): CUDA kernels and their plain torch versions.

The engine's layer loop — measure, decide, sweep, restore, stats — for
a root batch, from its initial (frontier, visited, P) to its end.
Returns (frontier, visited, P, depths (B,), layers (1,), stats
(max_layers, 8)), the engine's whole-traversal contract:

* the launches column is 1 on layer 0 and 0 after (one launch per
  traversal); the tiles column is the batch's n_active sum in every
  mode; the truncated column is 0;
* a scalar-mode layer tests the pre-layer ``visited`` only (the
  reference's ``_gather_tile_dyn``); SIMD and bottom-up layers test
  ``visited | out``.  K10 runs the SIMD algorithm only: its
  scalar-mode layers are the top-down slab sweep (``_sell_tile_dyn``).

The kernel cannot call a policy object, so the engine hands it a
`PolicyCode`: the policy's kind and parameters as numbers.  The batch
sums the policies compare are float32 of the exact int64 sums, as in
the engine, so both decide alike.  The CUDA kernels
(``csrc/traversal_fused.cu``, ``csrc/sell_traversal_fused.cu``, sharing
``csrc/traversal_loop.cuh``) replace
``repro.kernels.traversal_fused.traversal_fused_batched`` and
``sell_traversal_fused_batched``.  Each layer of their loop runs the
phases of the one-launch layer kernels K5 and K9: it plans the union of
the batch's work-lists in the launch and walks it with one CTA per item
for every root that lists it, on root-interleaved (n_words, B) copies
of the bitmaps that the loop keeps beside the (B, n_words) rows; the
restore pass also counts the next layer's counters.  The plain versions
walk each root's own list, layer by layer, on the host; both give the
same state, depths and stats.  The Table 1 counters come from the
padded degree array, which SELL keeps itself (it has no colstarts).
Inside a traced call (`repro_torch.obs.trace.traced_call`) the CUDA
wrappers give the kernel two small zeroed buffers, for which it runs
its traced build (phase stamps and barrier waits), and hand the launch
to `obs.trace.PHASES`; elsewhere they pass null pointers and the
untraced build runs.  The outputs are the same either way.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import bitmap as bm
from repro_torch.kernels import gather_expand as ge
from repro_torch.kernels import layer_fused as lf
from repro_torch.kernels import sell_expand as se

# engine modes and stats columns, restated: this module sits below the
# engine in the import graph (tests pin them against the engine's)
MODE_SCALAR, MODE_SIMD, MODE_BOTTOMUP = 0, 1, 2
N_STATS = 8

# policy kinds of `PolicyCode`
TOPDOWN, THRESHOLD_SIMD, PAPER_LAYERS, BEAMER = range(4)


class PolicyCode(NamedTuple):
    """A direction policy as the kernel's parameters."""
    kind: int
    alpha: float = 0.0          # BeamerHybrid
    v_over_beta: float = 0.0    # BeamerHybrid: float32(V * B / beta)
    threshold: float = 0.0      # ThresholdSimd: float32(simd_threshold)
    simd_layers: tuple = ()     # PaperLiteralLayers

    @property
    def needs_unvisited(self) -> bool:
        return self.kind == BEAMER


def layer_counters(words: torch.Tensor, deg: torch.Tensor):
    """Per-root (count, degree sum) of a (B, W) bitmap, int64; ``deg``
    is the (V_pad,) padded degree array."""
    count = bm.popcount32(words).sum(dim=1)
    edges = (bm.unpack_bool(words).to(torch.int64) * deg).sum(dim=1)
    return count, edges


def decide(code: PolicyCode, layer: int, f_count: int, f_edges: int,
           u_count: int, u_edges: int, bottom_up: bool):
    """The kernel's decide on exact batch sums: (mode, bottom_up)."""
    f32 = np.float32
    fc, fe, uc, ue = f32(f_count), f32(f_edges), f32(u_count), f32(u_edges)
    if code.kind == THRESHOLD_SIMD:
        return (MODE_SIMD if fe >= f32(code.threshold) else MODE_SCALAR,
                False)
    if code.kind == PAPER_LAYERS:
        return (MODE_SIMD if layer in code.simd_layers else MODE_SCALAR,
                False)
    if code.kind == BEAMER:
        down = not bottom_up and bool(fe > ue / f32(code.alpha))
        up = bottom_up and bool(fc < f32(code.v_over_beta))
        bottom_up = down or (not up and bottom_up)
        return (MODE_BOTTOMUP if bottom_up and uc > 0 else MODE_SIMD,
                bottom_up)
    return MODE_SCALAR, False


def _traversal_plain(deg, layer, frontier, visited, parent, *,
                     code: PolicyCode, max_layers: int):
    """The layer loop of the whole-traversal kernels, on the host:
    ``layer(frontier, visited, parent, bottom_up, scalar)`` is one
    layer's plain sweep, returning (out restored, parent, n_active)."""
    frontier, visited, parent = (frontier.clone(), visited.clone(),
                                 parent.clone())
    n_batch = frontier.shape[0]
    dev = frontier.device
    stats = torch.zeros((max_layers, N_STATS), dtype=torch.int32,
                        device=dev)
    depths = torch.zeros((n_batch,), dtype=torch.int32, device=dev)
    bottom_up = False
    layer_no = 0
    for layer_no in range(max_layers + 1):
        f_count, f_edges = layer_counters(frontier, deg)
        if layer_no == max_layers or int(f_count.sum()) == 0:
            break
        if code.needs_unvisited:
            u_count, u_edges = layer_counters(~visited, deg)
        else:
            u_count = u_edges = torch.zeros_like(f_count)
        mode, bottom_up = decide(code, layer_no, int(f_count.sum()),
                                 int(f_edges.sum()), int(u_count.sum()),
                                 int(u_edges.sum()), bottom_up)
        out, parent, na = layer(frontier, visited, parent,
                                mode == MODE_BOTTOMUP, mode == MODE_SCALAR)
        visited = visited | out
        frontier = out
        stats[layer_no] = torch.tensor(
            [int(f_count.sum()), int(f_edges.sum()),
             int(bm.popcount32(out).sum()), mode, 1, int(na.sum()), 0,
             int(layer_no == 0)], dtype=torch.int32)
        depths += (f_count > 0).to(torch.int32)
    layers = torch.tensor([layer_no], dtype=torch.int32, device=dev)
    return frontier, visited, parent, depths, layers, stats


def traversal_fused_plain(g: lf.FusedCsr, frontier, visited, parent, *,
                          code: PolicyCode, max_layers: int):
    """Plain torch K6: the layer loop on the host over `layer_fused_plain`
    sweeps."""
    def layer(f, v, p, bottom_up, scalar):
        return lf.layer_fused_plain(g, f, v, p, bottom_up=bottom_up,
                                    scalar=scalar)
    return _traversal_plain(g.deg, layer, frontier, visited, parent,
                            code=code, max_layers=max_layers)


def sell_traversal_fused_plain(g: se.SellGraph, frontier, visited, parent,
                               *, code: PolicyCode, max_layers: int):
    """Plain torch K10: the layer loop over `sell_layer_fused_plain`
    sweeps.  SELL runs the SIMD algorithm only, so a scalar-mode layer
    is the top-down sweep (``visited | out`` test), as in its per-layer
    steps."""
    def layer(f, v, p, bottom_up, scalar):
        return se.sell_layer_fused_plain(g, f, v, p, bottom_up=bottom_up)
    return _traversal_plain(g.deg, layer, frontier, visited, parent,
                            code=code, max_layers=max_layers)


def loop_buffers(code: PolicyCode, n_batch: int, max_layers: int, dev):
    """The loop's counters (int64 scratch), depths, layer count and
    stats (outputs), and the PaperLiteralLayers table."""
    i32 = dict(dtype=torch.int32, device=dev)
    acc = torch.empty(((max_layers + 1) * n_batch * 4,),
                      dtype=torch.int64, device=dev)
    simd_layer = torch.tensor(
        [int(l in code.simd_layers) for l in range(max_layers)], **i32)
    return (acc, torch.empty((n_batch,), **i32), torch.empty((1,), **i32),
            torch.empty((max_layers, N_STATS), **i32), simd_layer)


def _phase_buffers(max_layers: int, dev, walked: bool = False):
    """The launch's (collector, stamps, waits, walk counters) while a
    traced call records (`repro_torch.obs.trace.PHASES`; the walk
    counters with ``walked``, K6's, else None), else Nones."""
    from repro_torch.obs.trace import PHASES
    if not PHASES.on:
        return None, None, None, None
    return (PHASES, *PHASES.buffers(max_layers, dev),
            PHASES.walked_buffer(max_layers, dev) if walked else None)


def _ptr(t):
    return None if t is None else t.data_ptr()


def traversal_fused_grid(g: lf.FusedCsr, depth: int):
    """K6's co-resident grid and owner slots at ``depth`` (K5's
    shared memory)."""
    from repro_torch.kernels import _build
    sub = ge.owner_sub(g.tile, depth, "traversal_fused")
    return lf.cooperative_grid(_build.load().repro_traversal_fused_grid,
                               depth, g.tile, sub), sub


def sell_traversal_fused_grid(g: se.SellGraph, depth: int) -> int:
    """K10's co-resident grid at ``depth`` (K9's shared memory)."""
    from repro_torch.kernels import _build
    return lf.cooperative_grid(
        _build.load().repro_sell_traversal_fused_grid, depth, g.spp)


def traversal_fused_cuda(g: lf.FusedCsr, frontier, visited, parent, *,
                         code: PolicyCode, max_layers: int,
                         prefetch_depth: int = 0):
    """Launch K6 (one cooperative launch); the inputs are not changed."""
    from repro_torch.kernels import _build
    n_batch = int(frontier.shape[0])
    lf.check_args(g, "traversal_fused", frontier, visited, parent)
    lf.check_p_aligned("traversal_fused", parent)
    lf.check_p_aligned("traversal_fused", g.deg, "deg")
    depth = min(max(int(prefetch_depth), 0), g.n_blocks)
    grid, sub = traversal_fused_grid(g, depth)
    n_words = int(g.nz.shape[0])
    f_out, v_out, p_out = (torch.empty_like(frontier),
                           torch.empty_like(visited),
                           torch.empty_like(parent))
    # ``scratch`` keeps the memory behind ``ptrs`` alive for the launch
    na, scratch, ptrs = lf.union_scratch(g.n_blocks, n_batch, n_words,
                                         grid, g.rows.device)
    acc, depths, layers, stats, simd_layer = loop_buffers(
        code, n_batch, max_layers, g.rows.device)
    phases, stamps, waits, walked = _phase_buffers(
        max_layers, g.rows.device, walked=True)
    _build.check(_build.load().repro_traversal_fused(
        g.rows.data_ptr(), g.colstarts.data_ptr(), g.blk_lo.data_ptr(),
        g.blk_hi.data_ptr(), g.nz.data_ptr(), g.deg.data_ptr(),
        frontier.data_ptr(), visited.data_ptr(), parent.data_ptr(),
        f_out.data_ptr(), v_out.data_ptr(), p_out.data_ptr(), *ptrs[:4],
        na.data_ptr(), *ptrs[4:], acc.data_ptr(), depths.data_ptr(),
        layers.data_ptr(), stats.data_ptr(), simd_layer.data_ptr(),
        _ptr(stamps), _ptr(waits), _ptr(walked), n_batch, g.n_blocks,
        g.tile,
        int(g.colstarts.shape[0]), n_words, int(g.deg.shape[0]),
        g.n_vertices, depth, sub, int(max_layers), code.kind, code.alpha,
        code.v_over_beta, code.threshold, grid, _build.stream_of(parent)),
        "traversal_fused")
    if phases is not None:
        phases.add("traversal_fused", n_batch, grid, int(max_layers),
                   stamps, waits, stats, layers, walked)
    return f_out, v_out, p_out, depths, layers, stats


def sell_traversal_fused_cuda(g: se.SellGraph, frontier, visited, parent,
                              *, code: PolicyCode, max_layers: int,
                              prefetch_depth: int = 0):
    """Launch K10 (one cooperative launch); the inputs are not changed."""
    from repro_torch.kernels import _build
    se.check_args(g, "sell_traversal_fused", frontier=frontier,
                  visited=visited, parent=parent)
    lf.check_p_aligned("sell_traversal_fused", parent)
    lf.check_p_aligned("sell_traversal_fused", g.deg, "deg")
    n_batch = int(frontier.shape[0])
    depth = se._depth(prefetch_depth, g.n_steps)
    grid = sell_traversal_fused_grid(g, depth)
    f_out, v_out, p_out = (torch.empty_like(frontier),
                           torch.empty_like(visited),
                           torch.empty_like(parent))
    # ``scratch`` keeps the memory behind ``ptrs`` alive for the launch
    na, scratch, ptrs = lf.union_scratch(g.n_steps, n_batch, g.n_words,
                                         grid, g.cols.device)
    acc, depths, layers, stats, simd_layer = loop_buffers(
        code, n_batch, max_layers, g.cols.device)
    phases, stamps, waits, _ = _phase_buffers(max_layers, g.cols.device)
    _build.check(_build.load().repro_sell_traversal_fused(
        g.cols.data_ptr(), g.slab_rows.data_ptr(), g.deg.data_ptr(),
        frontier.data_ptr(), visited.data_ptr(), parent.data_ptr(),
        f_out.data_ptr(), v_out.data_ptr(), p_out.data_ptr(), *ptrs[:4],
        na.data_ptr(), *ptrs[4:], acc.data_ptr(), depths.data_ptr(),
        layers.data_ptr(), stats.data_ptr(), simd_layer.data_ptr(),
        _ptr(stamps), _ptr(waits), n_batch, g.n_steps, g.spp, g.n_words,
        int(g.deg.shape[0]), g.n_vertices, depth, int(max_layers),
        code.kind, code.alpha, code.v_over_beta, code.threshold, grid,
        _build.stream_of(parent)), "sell_traversal_fused")
    if phases is not None:
        phases.add("sell_traversal_fused", n_batch, grid, int(max_layers),
                   stamps, waits, stats, layers)
    return f_out, v_out, p_out, depths, layers, stats
