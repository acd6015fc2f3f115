"""K8 and K9 — the SELL-C-σ slab sweep and the whole SELL layer — and
K12, the semiring relax over slab groups: CUDA kernels and their plain
torch versions.

Layout (built by `formats.sell.SellFormat`): ``cols[slab, q, lane]`` is
neighbour ``q`` of the virtual row in ``lane`` of a slab (sentinel V
pads), ``slab_rows[slab, lane]`` the vertex that owns the row; a slab
is one (W_QUANT=8, SLICE_C=128) int32 block.  The sweep walks slab
*groups* of ``spp`` slabs (the format's tile), listed per root in a
work-list as the CSR kernels list rows-blocks.

**K8** (`sell_expand_plain` / `sell_expand_cuda`): for each root b and
each slab group of a `gather_expand.UnionPlan` (`kernels.plan`) that
lists it for b, every lane whose gate side is in the frontier and whose
discovered side is in neither ``visited`` nor ``out`` (and neither
side the sentinel) writes ``P[disc] = gate - |V|`` and ORs disc's bit
into ``out`` without atomics (§3.3.2).  Top-down gates on the row and
discovers the neighbour; bottom-up swaps the roles.  ``out`` and P are
updated in place, restoration NOT applied.  The kernel walks the plan's
union with one CTA per group for every root of its mask (K9's walk,
neighbour-major), on root-interleaved copies of the bitmaps; the plain
version walks each root's groups.  At ``prefetch_depth > 0`` each CTA
keeps that many groups' ``cols`` and ``slab_rows`` in flight into a
shared-memory ring (``cp.async``); the function is K8's, so the plain
version is the same.  `dense_plan` lists every group for every root
(the full sweep).  Replaces ``repro.kernels.sell_expand``'s
``sell_expand[_batched]`` (BlockSpec and DMA arms).

**K9** (`sell_layer_fused_plain` / `sell_layer_fused_cuda`): one SELL
layer per launch — plan (a group is active iff one of its lanes owns a
row below V that is in ``words``: the frontier top-down, ``~visited``
bottom-up), K8's sweep into a zeroed ``out``, restoration.  Returns
(out restored, P restored in place, n_active).  Replaces
``sell_layer_fused[_batched]``.  The kernel plans the union of the
roots' lists in the launch and walks it with one CTA per group for
every root of its mask, neighbour-major with the roots inside (K12's
design), on root-interleaved copies of the bitmaps; the plain version
walks each root's list with K8's plain sweep.

**K12** (`sell_relax_plain` / `sell_relax_cuda`): K11's two-phase
scatter-min relax (`gather_expand.gather_relax_plain`) over the edges
of the slab groups of a `gather_expand.UnionPlan` (`kernels.plan`), src
= ``slab_rows[s, lane]`` and nbr = ``cols[s, q, lane]``.  The kernel
walks the plan's union, one CTA per group for every root of its mask,
on root-interleaved values and frontier (K11's design); the plain
version walks each root's groups.  Deterministic: both arms and the
reference agree bitwise.  Replaces ``sell_relax_batched``.

The plain versions process a root's active groups a chunk at a time,
so their racy writes collide differently from the kernels'; after
restoration ``out``, ``visited`` and the marked set are identical.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.core.bitmap import BITS_PER_WORD
from repro_torch.kernels import gather_expand as ge
from repro_torch.kernels import layer_fused as lf
from repro_torch.kernels.restoration import restoration_plain

SLICE_C = 128     # rows per slice (the reference's lane count)
W_QUANT = 8       # columns per slab: one (8, 128) int32 block
SLAB_INTS = (W_QUANT + 1) * SLICE_C   # one slab's cols + slab_rows
CHUNK_ENTRIES = 1 << 24   # plain versions: slab entries per pass


class SellGraph(NamedTuple):
    """The SELL kernels' loop constants, built once per (format, tile):
    the slab arrays padded to a multiple of ``spp`` slabs with sentinel
    slabs, and the degrees padded to V_pad."""
    cols: torch.Tensor       # (n_steps * spp, W_QUANT, SLICE_C) int32
    slab_rows: torch.Tensor  # (n_steps * spp, SLICE_C) int32
    deg: torch.Tensor        # (V_pad,) int32, 0 on padding
    n_vertices: int
    spp: int                 # slabs per work-list group (the tile)

    @property
    def n_steps(self) -> int:
        return int(self.cols.shape[0]) // self.spp

    @property
    def n_words(self) -> int:
        return int(self.deg.shape[0]) // BITS_PER_WORD


def pad_slabs(cols, slab_rows, n_vertices: int, step: int):
    """Pad the slab axis to a multiple of ``step`` with sentinel slabs
    (all-V ids mask out entirely) — the reference's ``ops._pad_slabs``."""
    pad = (-int(cols.shape[0])) % step
    if pad:
        cols = torch.cat([cols, torch.full((pad,) + tuple(cols.shape[1:]),
                                           n_vertices, dtype=torch.int32,
                                           device=cols.device)])
        slab_rows = torch.cat([slab_rows, torch.full(
            (pad, slab_rows.shape[1]), n_vertices, dtype=torch.int32,
            device=slab_rows.device)])
    return cols.contiguous(), slab_rows.contiguous()


def sell_graph(cols, slab_rows, deg, n_vertices: int, spp: int,
               v_pad: int) -> SellGraph:
    cols, slab_rows = pad_slabs(cols, slab_rows, n_vertices, spp)
    deg_pad = torch.zeros((v_pad,), dtype=torch.int32, device=deg.device)
    deg_pad[:deg.shape[0]] = deg.to(torch.int32)
    return SellGraph(cols, slab_rows, deg_pad, int(n_vertices), int(spp))


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def plan_slabs_plain(g: SellGraph, words: torch.Tensor):
    """(B, W) membership bitmaps -> ((B, n_steps) work-lists, (B,)
    counts): a group is active iff one of its lanes' rows (< V) has its
    bit set.  Ascending, tail clamped to the last active group."""
    rows = g.slab_rows.reshape(-1)
    idx = (rows >> 5).clamp(0, words.shape[1] - 1).long()
    member = ((words[:, idx] >> (rows & 31)) & 1) != 0
    member &= rows < g.n_vertices
    covered = member.reshape(words.shape[0], g.n_steps, -1).any(-1)
    return lf.compact_worklist(covered, g.n_steps)


def slab_edges(g: SellGraph, groups):
    """(src, nbr) int64 chunks of the listed slab groups' entries
    (``groups``: one root's items of a plan), K8's and K12's plain
    versions' edge stream."""
    slab = torch.arange(g.spp, dtype=torch.int64, device=g.cols.device)
    per_chunk = max(1, CHUNK_ENTRIES // (g.spp * W_QUANT * SLICE_C))
    groups = groups.to(torch.int64)
    for s in range(0, int(groups.shape[0]), per_chunk):
        slabs = (groups[s:s + per_chunk, None] * g.spp + slab).reshape(-1)
        nbr = g.cols[slabs].reshape(-1).to(torch.int64)
        src = g.slab_rows[slabs][:, None, :].expand(-1, W_QUANT, -1) \
            .reshape(-1).to(torch.int64)
        yield src, nbr


@functools.lru_cache(maxsize=16)
def dense_plan(n_steps: int, n_batch: int, device) -> ge.UnionPlan:
    """The plan that lists every one of ``n_steps`` slab groups for every
    root (the full SpMV sweep of the ``materialized`` pipeline), made
    once per (graph's step count, batch, device): the list 0..n_steps-1,
    full root masks (the last word's unused bits clear), every count
    ``n_steps``."""
    i32 = dict(dtype=torch.int32, device=device)
    words = torch.full((-(-n_batch // 32),), -1, **i32)
    if n_batch % 32:
        words[-1] = (1 << (n_batch % 32)) - 1
    return ge.UnionPlan(torch.arange(n_steps, **i32),
                        torch.full((1,), n_steps, **i32),
                        words.expand(n_steps, -1).contiguous(),
                        torch.full((n_batch,), n_steps, **i32))


def sell_expand_plain(g: SellGraph, plan: ge.UnionPlan, frontier, visited,
                      out, p, *, bottom_up: bool = False):
    """Plain torch K8 over (B, ...) state, each root's groups of the plan
    in ascending order; updates ``out``/``p`` in place and returns
    them."""
    n = g.n_vertices
    for b in range(int(plan.na.shape[0])):
        for src, nbr in slab_edges(g, plan.items_of(b)):
            valid = (src < n) & (nbr < n)
            gate, disc = (nbr, src) if bottom_up else (src, nbr)
            ge._expand_edges(n, gate, disc, valid, frontier[b], visited[b],
                             out[b], p[b])
    return out, p


def sell_layer_fused_plain(g: SellGraph, frontier, visited, parent, *,
                           bottom_up: bool = False):
    """Plain torch K9: (out restored, P restored in place, n_active)."""
    wl, na = plan_slabs_plain(g, ~visited if bottom_up else frontier)
    out = torch.zeros_like(frontier)
    sell_expand_plain(g, ge.UnionPlan.of_lists(wl, na, g.n_steps), frontier,
                      visited, out, parent, bottom_up=bottom_up)
    fixed, delta = restoration_plain(parent, g.n_vertices)
    parent.copy_(fixed)
    return out | delta, parent, na


# ---------------------------------------------------------------------------
# Budgets and the CUDA launches
# ---------------------------------------------------------------------------

def stage_bytes(spp: int, depth: int) -> int:
    """Shared memory of one CTA's ring at ``depth``: (depth + 1) slots of
    one group's cols and slab_rows (0 at depth 0)."""
    return (depth + 1) * spp * SLAB_INTS * 4 if depth > 0 else 0


def smem_budget(spp: int, depth: int) -> int:
    """Shared memory one CTA of K9 or K10 needs: the ring plus the
    reductions' scratch."""
    return stage_bytes(spp, depth) + lf.FUSED_STATIC_SMEM


def check_args(g: SellGraph, kernel: str, **named) -> None:
    """The CUDA wrappers' checks: contiguous int32 on the graph's
    device, (B, W) bitmaps and a (B, V_pad) P."""
    dev = g.cols.device
    n_batch = int(named["frontier"].shape[0])
    widths = {"frontier": g.n_words, "visited": g.n_words,
              "out": g.n_words, "p": int(g.deg.shape[0]),
              "parent": int(g.deg.shape[0])}
    for name, t in named.items():
        if t.dtype != torch.int32 or not t.is_contiguous() \
                or t.device != dev:
            raise ValueError(
                f"{kernel}: {name} must be a contiguous int32 tensor on "
                f"{dev}, got {t.dtype} on {t.device}, "
                f"contiguous={t.is_contiguous()}")
        shape = (n_batch, widths[name])
        if tuple(t.shape) != shape:
            raise ValueError(f"{kernel}: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")


def _depth(prefetch_depth: int, n_steps: int) -> int:
    return min(max(int(prefetch_depth), 0), n_steps)


def sell_expand_cuda(g: SellGraph, plan: ge.UnionPlan, frontier, visited,
                     out, p, *, bottom_up: bool = False,
                     prefetch_depth: int = 0):
    """Launch K8 over the plan's union (its ``cp.async`` ring at
    ``prefetch_depth > 0``, clamped to the step count), on
    root-interleaved bitmaps; ``out``/``p`` are updated in place."""
    from repro_torch.kernels import _build
    check_args(g, "sell_expand", frontier=frontier, visited=visited,
               out=out, p=p)
    n_batch = int(frontier.shape[0])
    ge.check_plan("sell_expand", plan, g.n_steps, n_batch, g.cols.device)
    depth = _depth(prefetch_depth, g.n_steps)
    if stage_bytes(g.spp, depth) > ge.SMEM_OPTIN_BYTES:
        raise ValueError(
            f"sell_expand: prefetch_depth={depth} at {g.spp} slabs per "
            f"step needs {stage_bytes(g.spp, depth)} bytes of shared "
            f"memory per CTA; the card allows {ge.SMEM_OPTIN_BYTES}")
    fr, vis, ob = (ge.interleaved(frontier), ge.interleaved(visited),
                   ge.interleaved(out))
    _build.check(_build.load().repro_sell_expand(
        plan.ulist.data_ptr(), plan.ucount.data_ptr(),
        plan.rmask.data_ptr(), g.cols.data_ptr(), g.slab_rows.data_ptr(),
        fr.data_ptr(), vis.data_ptr(), ob.data_ptr(), p.data_ptr(), n_batch,
        g.n_steps, g.spp, g.n_words, int(g.deg.shape[0]), g.n_vertices,
        int(bool(bottom_up)), depth, _build.stream_of(p)), "sell_expand")
    if ob is not out:
        out.copy_(ob.t())
    return out, p


def sell_layer_fused_grid(g: SellGraph, depth: int) -> int:
    """K9's co-resident grid at ``depth``."""
    from repro_torch.kernels import _build
    return lf.cooperative_grid(_build.load().repro_sell_layer_fused_grid,
                               depth, g.spp)


def sell_layer_fused_cuda(g: SellGraph, frontier, visited, parent, *,
                          bottom_up: bool = False, prefetch_depth: int = 0):
    """Launch K9 (one cooperative launch); P is updated in place."""
    from repro_torch.kernels import _build
    check_args(g, "sell_layer_fused", frontier=frontier, visited=visited,
               parent=parent)
    lf.check_p_aligned("sell_layer_fused", parent)
    n_batch = int(frontier.shape[0])
    depth = _depth(prefetch_depth, g.n_steps)
    grid = sell_layer_fused_grid(g, depth)
    out = torch.empty_like(frontier)
    # ``scratch`` keeps the memory behind ``ptrs`` alive for the launch
    na, scratch, ptrs = lf.union_scratch(g.n_steps, n_batch, g.n_words,
                                         grid, g.cols.device)
    _build.check(_build.load().repro_sell_layer_fused(
        g.cols.data_ptr(), g.slab_rows.data_ptr(), frontier.data_ptr(),
        visited.data_ptr(), parent.data_ptr(), out.data_ptr(), *ptrs[:4],
        na.data_ptr(), *ptrs[4:], n_batch, g.n_steps, g.spp, g.n_words,
        int(g.deg.shape[0]), g.n_vertices, int(bool(bottom_up)), depth,
        grid, _build.stream_of(parent)),
        "sell_layer_fused")
    return out, parent, na


# ---------------------------------------------------------------------------
# K12: the semiring relax over slab groups
# ---------------------------------------------------------------------------

def sell_relax_plain(g: SellGraph, plan: ge.UnionPlan, frontier, vals, *,
                     unit: int = 0, weighted: bool = False):
    """Plain torch K12 over (B, ...) arrays, each root's groups of the
    plan: returns (out_vals, p_layer), new tensors; ``vals`` is int32 or
    float32."""
    out = vals.clone()
    p = torch.full(vals.shape, ge.P_UNSET, dtype=torch.int32,
                   device=vals.device)
    for b in range(int(plan.na.shape[0])):
        groups = plan.items_of(b)
        for phase in (0, 1):
            for src, nbr in slab_edges(g, groups):
                ge.relax_edges(g.n_vertices, src, nbr, frontier[b],
                               vals[b], out[b], p[b], unit=unit,
                               weighted=weighted, phase=phase)
    return out, p


def sell_relax_cuda(g: SellGraph, plan: ge.UnionPlan, frontier, vals, *,
                    unit: int = 0, weighted: bool = False):
    """Launch K12 (two launches: phase 0, then phase 1) over the plan's
    union into a fresh ``out_vals`` (a copy of ``vals``) and ``p_layer``
    (`P_UNSET`), on root-interleaved values and frontier."""
    from repro_torch.kernels import _build
    n_batch = int(frontier.shape[0])
    if weighted and vals.dtype != torch.float32:
        raise ValueError("sell_relax: weighted needs float32 vals")
    ge.check_relax_args(
        "sell_relax", g.cols.device, vals,
        dict(frontier=(n_batch, g.n_words),
             vals=(n_batch, int(g.deg.shape[0]))),
        frontier=frontier)
    ge.check_plan("sell_relax", plan, g.n_steps, n_batch, g.cols.device)
    fr, vk = ge.interleaved(frontier), ge.interleaved(vals)
    out = vk.clone()
    p = torch.full(vals.shape, ge.P_UNSET, dtype=torch.int32,
                   device=vals.device)
    lib = _build.load()
    _build.check(lib.repro_sell_relax(
        plan.ulist.data_ptr(), plan.ucount.data_ptr(),
        plan.rmask.data_ptr(), g.cols.data_ptr(), g.slab_rows.data_ptr(),
        fr.data_ptr(), vk.data_ptr(), out.data_ptr(), p.data_ptr(),
        n_batch, plan.rmask.shape[1], g.spp, int(g.deg.shape[0]),
        g.n_vertices, int(unit), int(bool(weighted)),
        int(vals.dtype == torch.float32), g.n_steps,
        _build.stream_of(vals)), "sell_relax")
    return (out.t().contiguous() if n_batch > 1 else out), p
