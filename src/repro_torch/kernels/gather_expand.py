"""K3 and K4 — the fused work-listed CSR gather with the racy expand:
CUDA kernel and its plain torch version.

For each root b and each of its first ``n_active[b]`` work-list entries
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

``scalar=True`` (plain version only) tests the pre-layer ``visited``
alone, as the whole-traversal kernel's scalar-mode layers do.
"""
from __future__ import annotations

import torch

from repro_torch.core.bitmap import WORD_MASK, WORD_SHIFT

CHUNK_EDGES = 1 << 24      # plain version: edges per vectorized pass
CTAS_PER_SM = 4            # CUDA grid: CTAs per SM striding the lists
SMEM_OPTIN_BYTES = 232_448  # H100: dynamic shared memory a CTA can opt into


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


def _expand_edges(n_vertices: int, gate, cand, valid, frontier, vis, out,
                  p, scalar: bool = False) -> None:
    """The `_expand_tile` body on one root's 1-D views, in place."""
    n_words = out.shape[0]
    word = cand >> WORD_SHIFT
    bits = torch.ones_like(cand, dtype=torch.int32) \
        << (cand & WORD_MASK).to(torch.int32)
    w_clip = word.clamp(0, n_words - 1)
    out_words = out[w_clip]
    seen = vis[w_clip] if scalar else vis[w_clip] | out_words
    undiscovered = (seen & bits) == 0
    gw = (gate >> WORD_SHIFT).clamp(0, n_words - 1)
    gb = (gate & WORD_MASK).to(torch.int32)
    in_front = ((frontier[gw] >> gb) & 1) != 0
    mask = valid & undiscovered & in_front
    p[cand[mask]] = (gate[mask] - n_vertices).to(torch.int32)
    out[word[mask]] = (out_words | bits)[mask]      # racy word writes


def gather_expand_plain(wl, na, rows, colstarts, frontier, visited, out,
                        p, *, n_vertices: int, tile: int,
                        bottom_up: bool = False, scalar: bool = False):
    """Plain torch K3 over (B, ...) arrays; updates ``out``/``p`` in
    place and returns them."""
    n_cs = colstarts.shape[0]
    lane = torch.arange(tile, dtype=torch.int64, device=rows.device)
    per_chunk = max(1, CHUNK_EDGES // tile)
    for b, n_act in enumerate(na.tolist()):
        blocks = wl[b, :n_act].to(torch.int64)
        for s in range(0, int(n_act), per_chunk):
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


def gather_expand_cuda(wl, na, rows, colstarts, frontier, visited, out,
                       p, *, n_vertices: int, tile: int,
                       bottom_up: bool = False, prefetch_depth: int = 0):
    """Launch the CUDA kernel (K3, or K4 at ``prefetch_depth > 0``,
    clamped to the block count as the reference clamps it); ``out``/``p``
    are updated in place."""
    from repro_torch.kernels import _build
    n_batch, n_blocks = wl.shape
    n_words = visited.shape[1]
    v_pad = p.shape[1]
    named = dict(wl=wl, na=na, rows=rows, colstarts=colstarts,
                 frontier=frontier, visited=visited, out=out, p=p)
    for name, t in named.items():
        if t.dtype != torch.int32 or not t.is_contiguous() \
                or t.device != rows.device:
            raise ValueError(
                f"gather_expand: {name} must be a contiguous int32 tensor "
                f"on {rows.device}, got {t.dtype} on {t.device}, "
                f"contiguous={t.is_contiguous()}")
    if rows.shape[0] != n_blocks * tile:
        raise ValueError(f"rows has {rows.shape[0]} slots, expected "
                         f"n_blocks * tile = {n_blocks * tile}; pad rows "
                         f"to the tile once at build")
    for name, t, shape in (("na", na, (n_batch,)),
                           ("frontier", frontier, (n_batch, n_words)),
                           ("out", out, (n_batch, n_words)),
                           ("p", p, (n_batch, v_pad))):
        if tuple(t.shape) != shape:
            raise ValueError(f"gather_expand: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    depth = min(max(int(prefetch_depth), 0), n_blocks)
    if stage_bytes(tile, depth) > SMEM_OPTIN_BYTES:
        raise ValueError(
            f"gather_expand: prefetch_depth={depth} at tile={tile} needs "
            f"{stage_bytes(tile, depth)} bytes of shared memory per CTA; "
            f"the card allows {SMEM_OPTIN_BYTES}")
    sms = torch.cuda.get_device_properties(rows.device) \
        .multi_processor_count
    grid_x = max(1, min(n_blocks, CTAS_PER_SM * sms))
    lib = _build.load()
    _build.check(lib.repro_gather_expand(
        wl.data_ptr(), na.data_ptr(), rows.data_ptr(),
        colstarts.data_ptr(), frontier.data_ptr(), visited.data_ptr(),
        out.data_ptr(), p.data_ptr(), n_batch, n_blocks, int(tile),
        colstarts.shape[0], n_words, v_pad, int(n_vertices),
        int(bool(bottom_up)), depth, grid_x, _build.stream_of(rows)),
        "gather_expand")
    return out, p
