"""K2 — SIMD frontier compaction (paper §4 queue generation): CUDA
kernel and its plain torch version.

A (B, W) packed bitmap becomes a (B, size) queue of its set-bit vertex
ids in ascending order, padded with ``fill``, plus the (B,) set-bit
counts (not capped at ``size``).  Ids whose rank is ``>= size`` are
dropped, exactly like the reference's ``size=`` truncation.  The CUDA
kernel (``csrc/compact.cu``) replaces ``repro.kernels.compact``'s
Pallas kernels in one single-pass launch (decoupled look-back across
each root's tiles); the single-root form is the batched one at B = 1.

Its stream arm (`queue_plain`, `queue_cuda`) is the first half of the
materialized stream: the same launch also writes each queue entry's
inclusive degree prefix (``cum`` of ``engine.apportion``) and each
root's ``total`` and ``truncated`` (`EdgeQueue`), from which
``ops.apportion`` writes the stream.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.bitmap import BITS_PER_WORD, compact_mask, unpack_bool

TILE_WORDS = 256    # words per CTA in the CUDA kernel (csrc/compact.cu)


class EdgeQueue(NamedTuple):
    """K2's stream arm: a (B, L) queue and its degree prefix.  ``cum``
    holds the inclusive prefix of the entries' degrees on the first
    min(count, L) entries (the CUDA arm leaves the rest unwritten);
    ``total`` is the prefix's last value (0 for an empty queue) and
    ``truncated`` = max(total - n_slots, 0), all (B,) int32."""
    queue: torch.Tensor
    count: torch.Tensor
    cum: torch.Tensor
    total: torch.Tensor
    truncated: torch.Tensor


def compact_plain(words: torch.Tensor, size: int, fill: int):
    """(B, W) words -> ((B, size) int32 queue, (B,) int32 counts):
    `bitmap.compact_mask` of the unpacked bits (a prefix sum ranks every
    set bit and a scatter puts its id at its rank)."""
    return compact_mask(unpack_bool(words), size, fill)


def queue_plain(words: torch.Tensor, size: int, fill: int,
                deg: torch.Tensor, n_vertices: int,
                n_slots: int) -> EdgeQueue:
    """Plain stream arm: `compact_plain` plus the entries' degrees
    (``deg``: the (32 W,) padded degree array; 0 past ``n_vertices``)
    and their int32 prefix, as ``engine.apportion`` computes them."""
    queue, count = compact_plain(words, size, fill)
    is_real = queue < n_vertices
    d = torch.where(is_real, deg[torch.where(is_real, queue, 0).long()], 0)
    cum = torch.cumsum(d, dim=1, dtype=torch.int32)
    total = cum[:, -1] if size else cum.new_zeros((queue.shape[0],))
    truncated = (total - n_slots).clamp(min=0).to(torch.int32)
    return EdgeQueue(queue, count, cum, total.contiguous(), truncated)


def _launch(words, size, fill, deg=None, n_vertices=0, n_slots=0):
    from repro_torch.kernels import _build
    if words.dtype != torch.int32 or words.ndim != 2 \
            or not words.is_contiguous():
        raise ValueError(f"frontier compaction needs contiguous (B, W) "
                         f"int32 words, got {words.dtype} "
                         f"{tuple(words.shape)}")
    n_batch, n_words = words.shape
    dev = words.device
    i32 = dict(dtype=torch.int32, device=dev)
    queue = torch.empty((n_batch, int(size)), **i32)
    count = torch.empty((n_batch,), **i32)
    status = torch.empty((n_batch, -(-n_words // TILE_WORDS)),
                         dtype=torch.int64, device=dev)
    cum = total = truncated = None
    if deg is not None:
        if deg.dtype != torch.int32 or tuple(deg.shape) != (
                n_words * BITS_PER_WORD,) or not deg.is_contiguous():
            raise ValueError(f"frontier compaction: deg must be a "
                             f"contiguous int32 ({n_words * BITS_PER_WORD},)"
                             f" tensor, got {deg.dtype} {tuple(deg.shape)}")
        cum = torch.empty((n_batch, int(size)), **i32)
        total = torch.empty((n_batch,), **i32)
        truncated = torch.empty((n_batch,), **i32)
    if n_words == 0:                  # no tile: nothing to launch
        queue.fill_(int(fill))
        for t in (count, total, truncated):
            if t is not None:
                t.zero_()
        return queue, count, cum, total, truncated
    ptr = lambda t: None if t is None else t.data_ptr()
    _build.check(_build.load().repro_compact(
        words.data_ptr(), ptr(deg), queue.data_ptr(), count.data_ptr(),
        ptr(cum), ptr(total), ptr(truncated), status.data_ptr(), n_batch,
        n_words, int(size), int(fill), int(n_vertices), int(n_slots),
        _build.stream_of(words)), "frontier_compact")
    return queue, count, cum, total, truncated


def compact_cuda(words: torch.Tensor, size: int, fill: int):
    """Launch the CUDA compaction on a (B, W) int32 CUDA tensor."""
    queue, count, *_ = _launch(words, size, fill)
    return queue, count


def queue_cuda(words: torch.Tensor, size: int, fill: int,
               deg: torch.Tensor, n_vertices: int,
               n_slots: int) -> EdgeQueue:
    """Launch the CUDA compaction's stream arm."""
    return EdgeQueue(*_launch(words, size, fill, deg, n_vertices, n_slots))
