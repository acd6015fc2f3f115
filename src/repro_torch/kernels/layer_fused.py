"""K5 — one whole BFS layer per launch: CUDA kernel and its plain torch
version.

For each root of a batch: plan the rows-blocks that the active
vertices' adjacency covers (the frontier top-down, the unvisited set
``~visited`` bottom-up), gather-expand them (K3's function) into a zeroed
``out`` and, in place, P, then restore — so the returned ``out`` holds
every vertex discovered this layer and P is non-negative.  Returns
(out, P, n_active).  The CUDA kernel (``csrc/layer_fused.cu``) replaces
``repro.kernels.layer_fused``'s Pallas kernels; it runs its phases in one
cooperative launch: it plans the union of the roots' lists (the union
planner's two launches, `kernels.plan`, run in-kernel between grid
barriers) and walks it with one CTA per block for every root that lists
it, on root-interleaved (n_words, B) copies of the bitmaps made in the
launch.  The plain version walks each root's own list; after
restoration both give the same ``out``, marked set and ``n_active``.

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

import itertools
from typing import NamedTuple

import torch

from repro_torch.core import bitmap as bm
from repro_torch.kernels import gather_expand as ge
from repro_torch.kernels.restoration import restoration_plain

#: shared memory of the kernels' own reductions (block sums and ranks),
#: an upper bound of what ``nvcc -Xptxas -v`` reports for K5 and K6
FUSED_STATIC_SMEM = 1024
#: K5's, K6's, K9's and K10's cooperative grid: at most this many CTAs
#: per SM (an SM holds 2048 threads, 8 CTAs of 256); the occupancy at the
#: kernel's registers and shared memory decides.  Their union walk waits
#: on one random bitmap word per (slot, root), which more resident warps
#: hide, though each layer of K6 and K10 crosses 4 grid barriers
#: (`chip_smoke.py` times both at 4 and 8; PERF.md).
CTAS_PER_SM = 8


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

    Active indices first (`bitmap.compact_mask`); every entry past
    ``n_active`` is clamped to the last active index (all zeros when
    nothing is active) — the work-list contract of the reference."""
    wl, n_active = bm.compact_mask(active, n, 0)
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


def cooperative_grid(lib_fn, *args) -> int:
    """CTAs of a fully co-resident grid for K5, K6, K9 or K10, at most
    `CTAS_PER_SM` per SM (read at each call); ``args``: the C grid
    function's own, before the CTAs per SM."""
    import ctypes

    from repro_torch.kernels import _build
    grid = ctypes.c_int(0)
    _build.check(lib_fn(*map(int, args), CTAS_PER_SM, ctypes.byref(grid)),
                 "cooperative grid")
    return grid.value


def check_p_aligned(kernel: str, parent, name: str = "parent") -> None:
    """K5, K6, K9 and K10 read P (K6, K10 also the degrees) with 16-byte
    loads: its rows must start on 16 bytes (a tensor's own storage does;
    a slice at an odd offset may not)."""
    if parent.data_ptr() % 16:
        raise ValueError(f"{kernel}: {name} must start on a 16-byte "
                         f"boundary, got address {parent.data_ptr():#x}")


def union_scratch(n_items: int, n_batch: int, n_words: int, grid: int,
                  device):
    """K5's and K9's scratch in one ``torch.empty``: (n_active (B,),
    the buffer, pointers to rmask, ulist, ucount, cnt, then the
    interleaved fi, vi, oi).  The kernel writes every word before it
    reads it.  Each array starts on 16 bytes (K6's bottom-up walk reads
    a vertex's words of 4 roots at once)."""
    n_mask_words = -(-n_batch // 32)
    sizes = (n_items * n_mask_words, n_items, 1, (n_batch + 1) * grid) \
        + (n_words * n_batch,) * 3
    sizes = tuple(-(-n // 4) * 4 for n in sizes)
    buf = torch.empty((sum(sizes),), dtype=torch.int32, device=device)
    ptrs = [buf.data_ptr() + 4 * o
            for o in itertools.accumulate((0,) + sizes[:-1])]
    na = torch.empty((n_batch,), dtype=torch.int32, device=device)
    return na, buf, ptrs


def layer_fused_grid(g: FusedCsr, depth: int):
    """K5's co-resident grid and owner slots at ``depth``."""
    from repro_torch.kernels import _build
    sub = ge.owner_sub(g.tile, depth, "layer_fused")
    return cooperative_grid(_build.load().repro_layer_fused_grid, depth,
                            g.tile, sub), sub


def layer_fused_cuda(g: FusedCsr, frontier, visited, parent, *,
                     bottom_up: bool = False, prefetch_depth: int = 0):
    """Launch K5 (one cooperative launch); P is updated in place."""
    from repro_torch.kernels import _build
    n_batch = int(frontier.shape[0])
    check_args(g, "layer_fused", frontier, visited, parent)
    check_p_aligned("layer_fused", parent)
    depth = min(max(int(prefetch_depth), 0), g.n_blocks)
    grid, sub = layer_fused_grid(g, depth)
    n_words = int(g.nz.shape[0])
    out = torch.empty_like(frontier)
    # ``scratch`` keeps the memory behind ``ptrs`` alive for the launch
    na, scratch, ptrs = union_scratch(g.n_blocks, n_batch, n_words, grid,
                                      g.rows.device)
    _build.check(_build.load().repro_layer_fused(
        g.rows.data_ptr(), g.colstarts.data_ptr(), g.blk_lo.data_ptr(),
        g.blk_hi.data_ptr(), g.nz.data_ptr(), frontier.data_ptr(),
        visited.data_ptr(), parent.data_ptr(), out.data_ptr(), *ptrs[:4],
        na.data_ptr(), *ptrs[4:], n_batch, g.n_blocks, g.tile,
        int(g.colstarts.shape[0]), n_words, int(g.deg.shape[0]),
        g.n_vertices, int(bool(bottom_up)), depth, sub, grid,
        _build.stream_of(parent)),
        "layer_fused")
    return out, parent, na


def smem_budget(tile: int, depth: int) -> int:
    """Shared memory one CTA of K5 or K6 needs: the rows ring plus the
    reductions' scratch.  K5's owner scan takes `gather_expand.owner_sub`
    ints of what is left (a tile's worth, up to `OWNER_SUB`)."""
    return ge.stage_bytes(tile, depth) + FUSED_STATIC_SMEM
