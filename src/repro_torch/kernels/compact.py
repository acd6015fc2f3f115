"""K2 — SIMD frontier compaction (paper §4 queue generation): CUDA
kernel and its plain torch version.

A (B, W) packed bitmap becomes a (B, size) queue of its set-bit vertex
ids in ascending order, padded with ``fill``, plus the (B,) set-bit
counts (not capped at ``size``).  Ids whose rank is ``>= size`` are
dropped, exactly like the reference's ``size=`` truncation.  The CUDA
kernels (``csrc/compact.cu``) replace ``repro.kernels.compact``'s
Pallas kernels; the single-root form is the batched one at B = 1.
"""
from __future__ import annotations

import torch

from repro_torch.core.bitmap import BITS_PER_WORD, word_bits

TILE_WORDS = 256    # words per CTA in the CUDA kernels (csrc/compact.cu)


def compact_plain(words: torch.Tensor, size: int, fill: int):
    """(B, W) words -> ((B, size) int32 queue, (B,) int32 counts): rank
    every set bit by an exclusive prefix sum over the lanes and scatter
    its id to its rank (ranks past ``size`` land in a dropped slot)."""
    n_batch, n_words = words.shape
    bits = word_bits(words).reshape(n_batch, -1)
    rank = torch.cumsum(bits, dim=1) - bits
    col = torch.where(bits != 0, rank, size).clamp(max=size)
    vid = torch.arange(n_words * BITS_PER_WORD, dtype=torch.int32,
                       device=words.device).expand(n_batch, -1)
    queue = torch.full((n_batch, size + 1), int(fill), dtype=torch.int32,
                       device=words.device)
    queue.scatter_(1, col, vid)
    return queue[:, :size].contiguous(), \
        bits.sum(dim=1).to(torch.int32)


def compact_cuda(words: torch.Tensor, size: int, fill: int):
    """Launch the CUDA compaction on a (B, W) int32 CUDA tensor."""
    from repro_torch.kernels import _build
    if words.dtype != torch.int32 or words.ndim != 2 \
            or not words.is_contiguous():
        raise ValueError(f"frontier compaction needs contiguous (B, W) "
                         f"int32 words, got {words.dtype} "
                         f"{tuple(words.shape)}")
    n_batch, n_words = words.shape
    n_tiles = -(-n_words // TILE_WORDS)
    dev = words.device
    lib = _build.load()
    stream = _build.stream_of(words)
    per_tile = torch.empty((n_batch, n_tiles), dtype=torch.int32,
                           device=dev)
    _build.check(lib.repro_tile_popcounts(
        words.data_ptr(), per_tile.data_ptr(), n_batch, n_words, n_tiles,
        stream), "frontier_compact (tile popcounts)")
    incl = torch.cumsum(per_tile, dim=1, dtype=torch.int32)
    offs = (incl - per_tile).contiguous()
    total = incl[:, -1].contiguous() if n_tiles else \
        torch.zeros((n_batch,), dtype=torch.int32, device=dev)
    queue = torch.empty((n_batch, int(size)), dtype=torch.int32,
                        device=dev)
    _build.check(lib.repro_rank_scatter(
        words.data_ptr(), offs.data_ptr(), total.data_ptr(),
        queue.data_ptr(), n_batch, n_words, n_tiles, int(size), int(fill),
        stream), "frontier_compact (rank scatter)")
    return queue, total
