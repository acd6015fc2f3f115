"""K5 — one whole BFS layer per launch: CUDA kernel and its plain torch
version.

For each root of a batch: plan the rows-blocks that the active
vertices' adjacency covers (the frontier top-down, the unvisited set
``~visited`` bottom-up), gather-expand them (K3's body) into a zeroed
``out`` and, in place, P, then restore — so the returned ``out`` holds
every vertex discovered this layer and P is non-negative.  Returns
(out, P, n_active).  The CUDA kernel (``csrc/layer_fused.cu``) replaces
``repro.kernels.layer_fused``'s Pallas kernels; it runs its phases in one
cooperative launch.

**The plan.**  A block is covered iff an active vertex with degree > 0
has an edge slot in it.  Those vertices are the ids in
``[blk_lo, blk_hi]``, the owners of the block's first and last slot
(loop constants, `FusedCsr`), that have degree > 0; so a block's test
is a range count over ``active & nz``.  It gives the reference's
``_plan_in_kernel`` work-list exactly, without its difference scatter.

P is updated in place, as by K3: the engine hands each layer's P on and
keeps no copy.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import bitmap as bm
from repro_torch.kernels import gather_expand as ge
from repro_torch.kernels.restoration import restoration_plain

#: shared memory of the kernels' own reductions (block sums and ranks),
#: an upper bound of what ``nvcc -Xptxas -v`` reports for K5 and K6
FUSED_STATIC_SMEM = 1024
CTAS_PER_SM = 4            # cooperative grid: at most this many per SM


class FusedCsr(NamedTuple):
    """The fused kernels' loop constants, built once per plan."""
    rows: torch.Tensor       # (n_blocks * tile,) tile-padded adjacency
    colstarts: torch.Tensor  # (V + 1,)
    blk_lo: torch.Tensor     # (n_blocks,) owner of each block's first slot
    blk_hi: torch.Tensor     # (n_blocks,) owner of its last slot (V: pad)
    nz: torch.Tensor         # (W,) words, bit v set iff deg(v) > 0
    deg: torch.Tensor        # (V_pad,) degrees, 0 on padding
    n_vertices: int
    tile: int

    @property
    def n_blocks(self) -> int:
        return int(self.rows.shape[0]) // self.tile


def fused_csr(colstarts: torch.Tensor, rows_t: torch.Tensor,
              n_vertices: int, tile: int, v_pad: int) -> FusedCsr:
    """Block owner ranges, the degree-> 0 bitmap and padded degrees for
    the tile-padded ``rows_t``."""
    n_blocks = int(rows_t.shape[0]) // tile
    cs = colstarts.to(torch.int64)
    first = torch.arange(n_blocks, dtype=torch.int64,
                         device=cs.device) * tile
    owner = lambda e: (torch.searchsorted(cs, e, right=True) - 1) \
        .clamp(0, int(cs.shape[0]) - 1).to(torch.int32)
    deg = bm.degree_matrix(colstarts[1:] - colstarts[:-1],
                           v_pad).reshape(-1).contiguous()
    return FusedCsr(rows_t, colstarts.contiguous(), owner(first),
                    owner(first + tile - 1), bm.pack_bool(deg > 0),
                    deg, int(n_vertices), int(tile))


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


def plan_blocks_plain(g: FusedCsr, words: torch.Tensor, bottom_up: bool):
    """The in-kernel plan on (B, W) bitmaps (``visited`` bottom-up, whose
    complement is planned): ((B, n_blocks) work-lists, (B,) counts)."""
    act = (~words if bottom_up else words) & g.nz
    dense = bm.unpack_bool(act).to(torch.int32)
    prefix = torch.nn.functional.pad(torch.cumsum(dense, dim=1), (1, 0))
    lo = g.blk_lo.to(torch.int64)
    hi = g.blk_hi.clamp(max=g.n_vertices - 1).to(torch.int64)
    count = prefix[:, (hi + 1).clamp(min=0)] - prefix[:, lo]
    return compact_worklist((lo <= hi) & (count > 0), g.n_blocks)


def layer_fused_plain(g: FusedCsr, frontier, visited, parent, *,
                      bottom_up: bool = False, scalar: bool = False):
    """Plain torch K5 over (B, ...) state: (out restored, P restored in
    place, n_active).  ``scalar`` tests the pre-layer visited only (the
    whole-traversal kernel's scalar-mode layers)."""
    wl, na = plan_blocks_plain(g, visited if bottom_up else frontier,
                               bottom_up)
    out = torch.zeros_like(frontier)
    ge.gather_expand_plain(ge.UnionPlan.of_lists(wl, na, g.n_blocks),
                           g.rows, g.colstarts, frontier, visited, out,
                           parent, n_vertices=g.n_vertices, tile=g.tile,
                           bottom_up=bottom_up, scalar=scalar)
    fixed, delta = restoration_plain(parent, g.n_vertices)
    parent.copy_(fixed)
    return out | delta, parent, na


def check_args(g: FusedCsr, kernel: str, frontier, visited, parent):
    """The CUDA wrappers' argument checks: contiguous int32 on the
    graph's device, (B, W) bitmaps and a (B, V_pad) P."""
    n_batch = int(frontier.shape[0])
    for name, t, width in (("frontier", frontier, int(g.nz.shape[0])),
                           ("visited", visited, int(g.nz.shape[0])),
                           ("parent", parent, int(g.deg.shape[0]))):
        if t.dtype != torch.int32 or not t.is_contiguous() \
                or t.device != g.rows.device:
            raise ValueError(
                f"{kernel}: {name} must be a contiguous int32 tensor on "
                f"{g.rows.device}, got {t.dtype} on {t.device}, "
                f"contiguous={t.is_contiguous()}")
        if tuple(t.shape) != (n_batch, width):
            raise ValueError(f"{kernel}: {name} has shape "
                             f"{tuple(t.shape)}, expected "
                             f"{(n_batch, width)}")


def cooperative_grid(lib_fn, depth: int, tile: int) -> int:
    """CTAs of a fully co-resident grid for a fused kernel."""
    import ctypes

    from repro_torch.kernels import _build
    grid = ctypes.c_int(0)
    _build.check(lib_fn(int(depth), int(tile), CTAS_PER_SM,
                        ctypes.byref(grid)), "cooperative grid")
    return grid.value


def layer_fused_cuda(g: FusedCsr, frontier, visited, parent, *,
                     bottom_up: bool = False, prefetch_depth: int = 0):
    """Launch K5 (one cooperative launch); P is updated in place."""
    from repro_torch.kernels import _build
    n_batch = int(frontier.shape[0])
    check_args(g, "layer_fused", frontier, visited, parent)
    depth = min(max(int(prefetch_depth), 0), g.n_blocks)
    lib = _build.load()
    grid = cooperative_grid(lib.repro_layer_fused_grid, depth, g.tile)
    dev = g.rows.device
    out = torch.empty_like(frontier)
    wl = torch.empty((n_batch, g.n_blocks), dtype=torch.int32, device=dev)
    cnt = torch.empty((n_batch, grid), dtype=torch.int32, device=dev)
    na = torch.empty((n_batch,), dtype=torch.int32, device=dev)
    _build.check(lib.repro_layer_fused(
        g.rows.data_ptr(), g.colstarts.data_ptr(), g.blk_lo.data_ptr(),
        g.blk_hi.data_ptr(), g.nz.data_ptr(), frontier.data_ptr(),
        visited.data_ptr(), parent.data_ptr(), out.data_ptr(),
        wl.data_ptr(), cnt.data_ptr(), na.data_ptr(), n_batch, g.n_blocks,
        g.tile, int(g.colstarts.shape[0]), int(g.nz.shape[0]),
        int(g.deg.shape[0]), g.n_vertices, int(bool(bottom_up)), depth,
        grid, _build.stream_of(parent)), "layer_fused")
    return out, parent, na


def smem_budget(tile: int, depth: int) -> int:
    """Shared memory one CTA of K5 or K6 needs: the rows ring plus the
    reductions' scratch."""
    return ge.stage_bytes(tile, depth) + FUSED_STATIC_SMEM
