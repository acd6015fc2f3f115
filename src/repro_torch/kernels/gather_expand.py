"""K3 and K4 — the fused work-listed CSR gather with the racy expand —
and K11, the semiring relax over the same work-lists: CUDA kernels and
their plain torch versions.

For each root b and each rows-block that the layer's plan lists for it
(a ``tile``-sized block of the tile-padded ``rows``), every edge finds
its owner by a binary search over ``colstarts``; top-down gates on the
owner being in the frontier and discovers the neighbour, bottom-up
swaps the roles.  A discovery writes ``P[c] = gate - |V|`` and ORs c's
bit into ``out`` without atomics (the §3.3.2 race).  Both arms update
``out`` and ``p`` **in place** (the engine owns both) and return them.

The plain version processes all of a root's active edges at once
(chunked to bound memory), so its racy writes collide differently from
the kernel's; restoration makes ``out``, ``visited`` and the set of
marked vertices identical in every arm.  The CUDA kernel
(``csrc/gather_expand.cu``) replaces ``repro.kernels.gather_expand``'s
Pallas kernels: at ``prefetch_depth=0`` (K3) it reads each block's rows
from device memory, at ``prefetch_depth > 0`` (K4) each CTA keeps that
many blocks' rows in flight into a shared-memory ring.  K4 computes
K3's function, so K3's plain version is K4's.

**The union.**  The kernels (K3, K4 and K11) do not walk each root's
list: they take the layer's `UnionPlan` from the union planner
(`kernels.plan.plan_union`, two launches on the card): the items any root
lists, a device count, a root mask per item and each root's count.  One
CTA serves every root of a block's mask, reading the block's rows and
finding its owners once (`owners_by_scan_plain` is that owner scan's
plain counterpart).  The wrappers hand the kernels the per-root state
root-interleaved, (n_words, B) bitmaps and (v_pad, B) values, so that
the B words of one vertex share a sector, and copy ``out`` back to
(B, ...); at B = 1 the two layouts are one.  Both arms take the plan;
the plain versions walk, for each root, the blocks whose mask has its
bit, in ascending order: that root's own list.  `union_worklist` folds
per-root lists into a plan's first three fields (the plain planner's
second half, `UnionPlan.of_lists`).

``scalar=True`` (plain version only) tests the pre-layer ``visited``
alone, as the whole-traversal kernel's scalar-mode layers do.

**K11** (`gather_relax_plain` / `gather_relax_cuda`) walks the same
work-listed blocks for the semiring portfolio: every edge whose owner
u is in the frontier offers ``cand = vals[u] + unit (+ w(u, v))`` to
v.  Phase 0 folds the candidates into ``out_vals`` (a copy of
``vals``) by scatter-min; phase 1, over the finished values, sets
``p_layer[v]`` to the least u whose candidate equals ``out_vals[v]``
and beat ``vals[v]`` (`P_UNSET` where none did).  Min is
order-independent, so both arms and the reference agree bitwise.
Replaces ``repro.kernels.gather_expand.gather_relax_batched``.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.algorithms.semiring import candidate
from repro_torch.core.bitmap import WORD_MASK, WORD_SHIFT

#: the per-layer parent scatter's "no edge won" value
P_UNSET = 2**31 - 1
CHUNK_EDGES = 1 << 24      # plain version: edges per vectorized pass
SMEM_OPTIN_BYTES = 232_448  # H100: dynamic shared memory a CTA can opt into
OWNER_SUB = 1024           # slots whose owners one scan puts in shared memory
SMEM_RESERVE = 1024        # the kernels' static shared memory, rounded up


def _owner_search(colstarts: torch.Tensor, e_idx: torch.Tensor,
                  n_entries: int) -> torch.Tensor:
    """Largest u with ``colstarts[u] <= e`` — the reference's branchless
    bit-lifting binary search.  ``colstarts[0] == 0 <= e`` holds for
    every slot, so the descent is total; ``n_entries - 1`` (== V) marks
    the sentinel-padded tail of rows."""
    u = torch.zeros(e_idx.shape, dtype=torch.int64, device=e_idx.device)
    step = 1
    while step * 2 < n_entries:
        step *= 2
    while step:
        cand = u + step
        ok = (cand < n_entries) \
            & (colstarts[cand.clamp(0, n_entries - 1)] <= e_idx)
        u = torch.where(ok, cand, u)
        step //= 2
    return u


def owners_by_scan_plain(colstarts: torch.Tensor, blocks: torch.Tensor,
                         tile: int) -> torch.Tensor:
    """The owners of every slot of rows-blocks ``blocks`` ((k,) ids) as
    (k, tile) int64, by the CUDA kernels' owner scan: the owners lo and
    hi of each block's first and last slot; every u in (lo, hi] put at
    slot ``colstarts[u] - e0`` by scatter-max (zero-degree vertices share
    a colstarts value, and the owner is the largest); slot 0 takes lo;
    a running max along the slots fills the rest.  Equals `_owner_search`
    on every slot, the sentinel tail (owner V) included."""
    n_cs = colstarts.shape[0]
    dev = colstarts.device
    k = int(blocks.shape[0])
    e0 = blocks.to(torch.int64) * tile
    lo = _owner_search(colstarts, e0, n_cs)
    hi = _owner_search(colstarts, e0 + tile - 1, n_cs)
    own = torch.full((k, tile), -1, dtype=torch.int64, device=dev)
    own[:, 0] = lo
    span = hi - lo
    blk = torch.repeat_interleave(torch.arange(k, device=dev), span)
    first = torch.cumsum(span, 0) - span
    u = lo[blk] + 1 + torch.arange(int(span.sum()), device=dev) \
        - first[blk]
    slot = colstarts[u].to(torch.int64) - e0[blk]
    own.view(-1).scatter_reduce_(0, blk * tile + slot, u, "amax")
    return torch.cummax(own, dim=1).values


@functools.lru_cache(maxsize=64)
def _union_constants(n_batch: int, n_ids: int, device: torch.device):
    """`union_worklist`'s inputs that depend only on the shapes: the ids
    0..n_ids-1, each root's bit of its mask word (bit 31 is INT32_MIN)
    and each root's word, made once per shape, not before every launch."""
    ids = torch.arange(n_ids, dtype=torch.int32, device=device)
    root = torch.arange(n_batch, device=device)
    bit = (torch.ones((n_batch, 1), dtype=torch.int32, device=device)
           << (root % 32).to(torch.int32)[:, None])
    return ids, bit, root // 32


def union_worklist(wl: torch.Tensor, na: torch.Tensor, n_blocks: int):
    """(B, L) work-lists and (B,) counts -> (ulist (n_blocks,) int32, the
    blocks any root lists in ascending order, then zeros; ucount (1,)
    int32; rmask (n_blocks, ceil(B / 32)) int32, bit ``b % 32`` of word
    ``b // 32`` set when root b lists the block).  Entries of ``wl[b]``
    at or past ``na[b]`` (the clamped tail) set no bit.  Any B; no host
    sync, no ``nonzero``.  The plain planner's second half
    (`UnionPlan.of_lists`)."""
    n_batch, n_list = wl.shape
    dev = wl.device
    ids, bit, word = _union_constants(n_batch, max(n_list, n_blocks), dev)
    live = ids[:n_list] < na[:, None]
    # listed[b, blk] where root b lists blk; column n_blocks takes the
    # tail entries
    listed = torch.zeros((n_batch, n_blocks + 1), dtype=torch.bool,
                         device=dev)
    listed.scatter_(1, torch.where(live, wl, n_blocks).to(torch.int64),
                    True)
    listed = listed[:, :n_blocks]
    # a word's bits are distinct, so their int32 sum is their OR
    words = torch.zeros(((n_batch + 31) // 32, n_blocks), dtype=torch.int32,
                        device=dev)
    words.index_add_(0, word, listed * bit)
    any_root = listed.any(0)
    rank = torch.cumsum(any_root, 0)            # 1-based rank, int64
    # listed blocks go to their rank, the others to a dump slot past the end
    ulist = torch.zeros((n_blocks + 1,), dtype=torch.int32, device=dev)
    ulist.scatter_(0, torch.where(any_root, rank - 1, n_blocks),
                   ids[:n_blocks])
    ucount = rank[-1:].to(torch.int32) if n_blocks else \
        torch.zeros((1,), dtype=torch.int32, device=dev)
    return ulist[:n_blocks], ucount, words.t().contiguous()


class UnionPlan(NamedTuple):
    """One layer's plan of the items (CSR rows-blocks, SELL slab groups)
    that the work-listed kernels walk: `union_worklist`'s output plus
    each root's count."""
    ulist: torch.Tensor   # (n_items,) int32: listed items ascending, zeros
    ucount: torch.Tensor  # (1,) int32: how many items any root lists
    rmask: torch.Tensor   # (n_items, ceil(B / 32)) int32 root masks
    na: torch.Tensor      # (B,) int32: the items each root lists

    @classmethod
    def of_lists(cls, wl: torch.Tensor, na: torch.Tensor,
                 n_items: int) -> "UnionPlan":
        """The plan of (B, L) per-root work-lists and their (B,) counts."""
        return cls(*union_worklist(wl, na, n_items), na.to(torch.int32))

    def listed(self) -> torch.Tensor:
        """(B, n_items) bool: root b lists item i."""
        n_batch = int(self.na.shape[0])
        root = torch.arange(n_batch, device=self.rmask.device)
        words = self.rmask[:, root // 32].t()
        return ((words >> (root % 32).to(torch.int32)[:, None]) & 1) != 0

    def items_of(self, b: int) -> torch.Tensor:
        """Root b's items, ascending (int64): its own work-list."""
        words = self.rmask[:, b // 32]
        return torch.nonzero((words >> (b % 32)) & 1).flatten()


def check_plan(kernel: str, plan: UnionPlan, n_items: int, n_batch: int,
               device) -> None:
    """The CUDA wrappers' checks of a plan: contiguous int32 tensors on
    ``device`` of the shapes ``n_items`` and ``n_batch`` give."""
    shapes = dict(ulist=(n_items,), ucount=(1,),
                  rmask=(n_items, -(-n_batch // 32)), na=(n_batch,))
    for name, t in plan._asdict().items():
        if t.dtype != torch.int32 or not t.is_contiguous() \
                or t.device != device:
            raise ValueError(
                f"{kernel}: plan.{name} must be a contiguous int32 tensor "
                f"on {device}, got {t.dtype} on {t.device}, "
                f"contiguous={t.is_contiguous()}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{kernel}: plan.{name} has shape "
                             f"{tuple(t.shape)}, expected {shapes[name]}")


def owner_sub(tile: int, depth: int, kernel: str = "gather_expand") -> int:
    """Slots per owner scan of the CUDA kernels (K3, K4, K5, K11):
    `OWNER_SUB` (or the tile), fewer where a rows ring leaves less room;
    refused below one warp's worth (or the tile)."""
    room = (SMEM_OPTIN_BYTES - stage_bytes(tile, depth) - SMEM_RESERVE) // 4
    sub = min(tile, OWNER_SUB, room)
    if sub < min(tile, 32):
        raise ValueError(
            f"{kernel}: prefetch_depth={depth} at tile={tile} leaves "
            f"{max(room, 0) * 4} bytes of shared memory per CTA for the "
            f"owner scan; it needs {4 * min(tile, 32)}")
    return sub


def interleaved(t: torch.Tensor) -> torch.Tensor:
    """(B, n) -> its root-interleaved (n, B) layout (a copy where B > 1;
    at B = 1 the two layouts are one)."""
    return t.t().contiguous() if t.shape[0] > 1 else t


def _expand_edges(n_vertices: int, gate, cand, valid, frontier, vis, out,
                  p, scalar: bool = False, check_gate: bool = True) -> None:
    """The `_expand_tile` body on one root's 1-D views, in place; the
    gate's frontier test is skipped where ``check_gate`` is False (the
    top-down materialized stream, whose gates are frontier vertices)."""
    n_words = out.shape[0]
    word = cand >> WORD_SHIFT
    bits = torch.ones_like(cand, dtype=torch.int32) \
        << (cand & WORD_MASK).to(torch.int32)
    w_clip = word.clamp(0, n_words - 1)
    out_words = out[w_clip]
    seen = vis[w_clip] if scalar else vis[w_clip] | out_words
    undiscovered = (seen & bits) == 0
    mask = valid & undiscovered
    if check_gate:
        gw = (gate >> WORD_SHIFT).clamp(0, n_words - 1)
        gb = (gate & WORD_MASK).to(torch.int32)
        mask &= ((frontier[gw] >> gb) & 1) != 0
    p[cand[mask]] = (gate[mask] - n_vertices).to(torch.int32)
    out[word[mask]] = (out_words | bits)[mask]      # racy word writes


def gather_expand_plain(plan: UnionPlan, rows, colstarts, frontier,
                        visited, out, p, *, n_vertices: int, tile: int,
                        bottom_up: bool = False, scalar: bool = False):
    """Plain torch K3 over (B, ...) arrays, each root's blocks of the
    plan in ascending order; updates ``out``/``p`` in place and returns
    them."""
    n_cs = colstarts.shape[0]
    lane = torch.arange(tile, dtype=torch.int64, device=rows.device)
    per_chunk = max(1, CHUNK_EDGES // tile)
    for b in range(int(plan.na.shape[0])):
        blocks = plan.items_of(b)
        for s in range(0, int(blocks.shape[0]), per_chunk):
            e = (blocks[s:s + per_chunk, None] * tile + lane).reshape(-1)
            u = _owner_search(colstarts, e, n_cs)
            v = rows[e].to(torch.int64)
            valid = (u < n_vertices) & (v < n_vertices)
            gate, cand = (v, u) if bottom_up else (u, v)
            _expand_edges(n_vertices, gate, cand, valid, frontier[b],
                          visited[b], out[b], p[b], scalar)
    return out, p


def stage_bytes(tile: int, depth: int) -> int:
    """Shared memory of one CTA's rows ring at ``depth`` (0: none)."""
    return (depth + 1) * tile * 4 if depth > 0 else 0


def gather_expand_cuda(plan: UnionPlan, rows, colstarts, frontier,
                       visited, out, p, *, n_vertices: int, tile: int,
                       bottom_up: bool = False, prefetch_depth: int = 0):
    """Launch the CUDA kernel (K3, or K4 at ``prefetch_depth > 0``,
    clamped to the block count as the reference clamps it) over the
    plan's union, on root-interleaved bitmaps; ``out``/``p`` are updated
    in place."""
    from repro_torch.kernels import _build
    n_batch, n_words = visited.shape
    n_blocks = int(rows.shape[0]) // tile
    v_pad = p.shape[1]
    named = dict(rows=rows, colstarts=colstarts, frontier=frontier,
                 visited=visited, out=out, p=p)
    for name, t in named.items():
        if t.dtype != torch.int32 or not t.is_contiguous() \
                or t.device != rows.device:
            raise ValueError(
                f"gather_expand: {name} must be a contiguous int32 tensor "
                f"on {rows.device}, got {t.dtype} on {t.device}, "
                f"contiguous={t.is_contiguous()}")
    if rows.shape[0] != n_blocks * tile:
        raise ValueError(f"rows has {rows.shape[0]} slots, expected a "
                         f"multiple of tile = {tile}; pad rows to the tile "
                         f"once at build")
    for name, t, shape in (("frontier", frontier, (n_batch, n_words)),
                           ("out", out, (n_batch, n_words)),
                           ("p", p, (n_batch, v_pad))):
        if tuple(t.shape) != shape:
            raise ValueError(f"gather_expand: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    check_plan("gather_expand", plan, n_blocks, n_batch, rows.device)
    depth = min(max(int(prefetch_depth), 0), n_blocks)
    if stage_bytes(tile, depth) > SMEM_OPTIN_BYTES:
        raise ValueError(
            f"gather_expand: prefetch_depth={depth} at tile={tile} needs "
            f"{stage_bytes(tile, depth)} bytes of shared memory per CTA; "
            f"the card allows {SMEM_OPTIN_BYTES}")
    sub = owner_sub(tile, depth)
    fr, vis, ob = (interleaved(frontier), interleaved(visited),
                   interleaved(out))
    lib = _build.load()
    _build.check(lib.repro_gather_expand(
        plan.ulist.data_ptr(), plan.ucount.data_ptr(),
        plan.rmask.data_ptr(), rows.data_ptr(), colstarts.data_ptr(),
        fr.data_ptr(), vis.data_ptr(), ob.data_ptr(), p.data_ptr(),
        n_batch, plan.rmask.shape[1], int(tile), sub, colstarts.shape[0],
        v_pad, int(n_vertices), int(bool(bottom_up)), depth, n_blocks,
        _build.stream_of(rows)), "gather_expand")
    if ob is not out:
        out.copy_(ob.t())
    return out, p


# ---------------------------------------------------------------------------
# K11: the semiring relax
# ---------------------------------------------------------------------------

def relax_candidates(n_vertices: int, src, nbr, frontier, vals, *,
                     unit: int, weighted: bool):
    """One root's edge stream -> (mask, cand): the edges whose source is
    a real frontier vertex and whose neighbour is real, and every edge's
    candidate ``vals[src] + unit (+ w(src, nbr))``."""
    v_pad = vals.shape[0]
    valid = (src < n_vertices) & (nbr < n_vertices)
    sw = (src >> WORD_SHIFT).clamp(0, frontier.shape[0] - 1)
    in_front = ((frontier[sw] >> (src & WORD_MASK).to(torch.int32)) & 1) \
        != 0
    cand = candidate(vals[src.clamp(0, v_pad - 1)], src, nbr, unit=unit,
                     weighted=weighted)
    return valid & in_front, cand


def relax_edges(n_vertices: int, src, nbr, frontier, vals, out, p, *,
                unit: int, weighted: bool, phase: int) -> None:
    """One root's relax over an edge stream (1-D views), in place: phase
    0 folds the frontier edges' candidates into ``out`` by scatter-min,
    phase 1 takes into ``p`` the least source among the edges whose
    candidate equals the finished ``out`` and beat ``vals``."""
    mask, cand = relax_candidates(n_vertices, src, nbr, frontier, vals,
                                  unit=unit, weighted=weighted)
    if phase == 0:
        out.scatter_reduce_(0, nbr[mask], cand[mask], "amin",
                            include_self=True)
        return
    nbr_c = nbr.clamp(0, vals.shape[0] - 1)
    cur = out[nbr_c]
    win = mask & (cand == cur) & (cur < vals[nbr_c])
    p.scatter_reduce_(0, nbr[win], src[win].to(torch.int32), "amin",
                      include_self=True)


def worklist_edges(blocks, rows, colstarts, tile: int):
    """(src, nbr) int64 chunks of the listed rows-blocks' edge slots
    (``blocks``: one root's active work-list entries)."""
    lane = torch.arange(tile, dtype=torch.int64, device=rows.device)
    per_chunk = max(1, CHUNK_EDGES // tile)
    blocks = blocks.to(torch.int64)
    for s in range(0, int(blocks.shape[0]), per_chunk):
        e = (blocks[s:s + per_chunk, None] * tile + lane).reshape(-1)
        yield (_owner_search(colstarts, e, colstarts.shape[0]),
               rows[e].to(torch.int64))


def gather_relax_plain(plan: UnionPlan, rows, colstarts, frontier, vals,
                       *, n_vertices: int, tile: int, unit: int = 0,
                       weighted: bool = False):
    """Plain torch K11 over (B, ...) arrays, each root's blocks of the
    plan: returns (out_vals, p_layer), new tensors; ``vals`` is int32 or
    float32."""
    out = vals.clone()
    p = torch.full(vals.shape, P_UNSET, dtype=torch.int32,
                   device=vals.device)
    for b in range(int(plan.na.shape[0])):
        blocks = plan.items_of(b)
        for phase in (0, 1):
            for u, v in worklist_edges(blocks, rows, colstarts, tile):
                relax_edges(n_vertices, u, v, frontier[b], vals[b], out[b],
                            p[b], unit=unit, weighted=weighted,
                            phase=phase)
    return out, p


def check_relax_args(kernel: str, device, vals, shapes: dict,
                     **ints) -> None:
    """The relax wrappers' checks: contiguous tensors on ``device``,
    int32 or float32 ``vals``, int32 everything else, and the shapes
    named in ``shapes``."""
    if vals.dtype not in (torch.int32, torch.float32):
        raise ValueError(f"{kernel}: vals must be int32 or float32, got "
                         f"{vals.dtype}")
    for name, t in dict(ints, vals=vals).items():
        if (name != "vals" and t.dtype != torch.int32) \
                or not t.is_contiguous() or t.device != device:
            raise ValueError(
                f"{kernel}: {name} must be a contiguous tensor on "
                f"{device} (int32, or float32 for vals), got {t.dtype} "
                f"on {t.device}, contiguous={t.is_contiguous()}")
    named = dict(ints, vals=vals)
    for name, shape in shapes.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(f"{kernel}: {name} has shape "
                             f"{tuple(named[name].shape)}, expected "
                             f"{shape}")


def gather_relax_cuda(plan: UnionPlan, rows, colstarts, frontier, vals,
                      *, n_vertices: int, tile: int, unit: int = 0,
                      weighted: bool = False):
    """Launch K11 (two launches: phase 0, then phase 1) over the plan's
    union into a fresh ``out_vals`` (a copy of ``vals``) and ``p_layer``
    (`P_UNSET`), on root-interleaved values and frontier."""
    from repro_torch.kernels import _build
    n_batch, v_pad = vals.shape
    n_blocks = int(rows.shape[0]) // tile
    if weighted and vals.dtype != torch.float32:
        raise ValueError("gather_relax: weighted needs float32 vals")
    check_relax_args(
        "gather_relax", rows.device, vals,
        dict(rows=(n_blocks * tile,), frontier=(n_batch, v_pad // 32)),
        rows=rows, colstarts=colstarts, frontier=frontier)
    check_plan("gather_relax", plan, n_blocks, n_batch, rows.device)
    sub = owner_sub(tile, 0)
    fr, vk = interleaved(frontier), interleaved(vals)
    out = vk.clone()
    p = torch.full(vals.shape, P_UNSET, dtype=torch.int32,
                   device=vals.device)
    lib = _build.load()
    _build.check(lib.repro_gather_relax(
        plan.ulist.data_ptr(), plan.ucount.data_ptr(),
        plan.rmask.data_ptr(), rows.data_ptr(), colstarts.data_ptr(),
        fr.data_ptr(), vk.data_ptr(), out.data_ptr(), p.data_ptr(),
        n_batch, plan.rmask.shape[1], int(tile), sub, colstarts.shape[0],
        v_pad, int(n_vertices), int(unit), int(bool(weighted)),
        int(vals.dtype == torch.float32), n_blocks,
        _build.stream_of(rows)), "gather_relax")
    return (out.t().contiguous() if n_batch > 1 else out), p
