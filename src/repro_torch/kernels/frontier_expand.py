"""K7 — the materialized pipeline's expansion over an apportioned edge
stream (the paper's Listing 1): CUDA kernel and its plain torch version.

The stream is ``(nbr, cand, valid)``, (B, E_slots) per root: slot i
offers ``cand`` to be discovered from ``nbr`` when ``valid``.  A slot
passes when cand's bit is in neither ``visited`` nor ``out`` and,
bottom-up (``check_frontier``), nbr is in the frontier; then
``P[cand] = nbr - |V|`` and cand's bit is ORed into ``out`` without
atomics (§3.3.2).  Both arms update ``out`` and ``p`` **in place** and
return them, restoration NOT applied.

The reference's grid walks a root's tiles in order, so tile t + 1 sees
tile t's writes; the CUDA kernel (``csrc/frontier_expand.cu``) has no
such order and the plain version processes the stream a chunk at a
time, so K7 is held to K3's contract: after restoration ``out``,
``visited`` and the marked set are exact, and every mark names the
``nbr`` of a valid slot (a frontier vertex, bottom-up).  Neither arm
assumes that the valid slots are a prefix of a row, though
`engine.apportion` writes them so.  The kernel takes 16 slots per
thread by 16-byte loads (only where a flag is set) when every stream's
base is 16-byte aligned, and the rest one slot per thread.  Replaces
``repro.kernels.frontier_expand.frontier_expand_batched`` and, at
B = 1, ``frontier_expand``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gather_expand import CHUNK_EDGES, _expand_edges

CTAS_PER_SM = 8        # grid: a grid-stride loop over the chunks
CHUNK_SLOTS = 16       # slots per thread of the kernel's vector path
THREADS = 256


def frontier_expand_plain(nbr, cand, valid, frontier, visited, out, p, *,
                          n_vertices: int, check_frontier: bool = False):
    """Plain torch K7 over (B, E_slots) streams; updates ``out``/``p`` in
    place and returns them."""
    for b in range(cand.shape[0]):
        for s in range(0, cand.shape[1], CHUNK_EDGES):
            c = cand[b, s:s + CHUNK_EDGES].to(torch.int64)
            g = nbr[b, s:s + CHUNK_EDGES].to(torch.int64)
            ok = (valid[b, s:s + CHUNK_EDGES] != 0) & (c >= 0) \
                & (c < n_vertices) & (g >= 0) & (g < n_vertices)
            _expand_edges(n_vertices, g, c, ok, frontier[b], visited[b],
                          out[b], p[b], check_gate=check_frontier)
    return out, p


def frontier_expand_cuda(nbr, cand, valid, frontier, visited, out, p, *,
                         n_vertices: int, check_frontier: bool = False):
    """Launch K7 (``valid`` bool, one byte per slot); ``out``/``p`` are
    updated in place."""
    from repro_torch.kernels import _build
    n_batch, n_slots = cand.shape
    n_words = visited.shape[1]
    v_pad = p.shape[1]
    dev = p.device
    named = dict(nbr=nbr, cand=cand, valid=valid, frontier=frontier,
                 visited=visited, out=out, p=p)
    shapes = dict(nbr=(n_batch, n_slots), cand=(n_batch, n_slots),
                  valid=(n_batch, n_slots), frontier=(n_batch, n_words),
                  visited=(n_batch, n_words), out=(n_batch, n_words),
                  p=(n_batch, v_pad))
    for name, t in named.items():
        if t.dtype != (torch.bool if name == "valid" else torch.int32) \
                or not t.is_contiguous() or t.device != dev \
                or tuple(t.shape) != shapes[name]:
            raise ValueError(
                f"frontier_expand: {name} must be a contiguous "
                f"{'bool' if name == 'valid' else 'int32'} tensor of "
                f"shape {shapes[name]} on {dev}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}, "
                f"contiguous={t.is_contiguous()}")
    if v_pad != 32 * n_words:
        raise ValueError(f"frontier_expand: p has {v_pad} columns, expected "
                         f"32 * n_words = {32 * n_words}")
    vec = all(t.data_ptr() % 16 == 0 for t in (nbr, cand, valid))
    chunks = -(-n_batch * n_slots // (CHUNK_SLOTS if vec else 1))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = max(1, min(-(-chunks // THREADS), CTAS_PER_SM * sms))
    lib = _build.load()
    _build.check(lib.repro_frontier_expand(
        nbr.data_ptr(), cand.data_ptr(), valid.data_ptr(),
        frontier.data_ptr(), visited.data_ptr(), out.data_ptr(),
        p.data_ptr(), n_batch, n_slots, n_words, int(n_vertices),
        int(bool(check_frontier)), int(vec), grid, _build.stream_of(p)),
        "frontier_expand")
    return out, p
