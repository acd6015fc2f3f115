"""Bitmap (bit-array) data structure — the paper's §3.3.1, in torch.

Vertices are single bits packed into 32-bit words (BITS_PER_WORD =
32).  The reference stores the words as uint32; this port stores the
same bit patterns as **int32**, because torch has no uint32 ``~``,
``<<``, ``>>`` or ``index_put`` on every backend.  The conventions that
keep the two bitwise identical:

* ``words.view(int32)`` / ``.view(uint32)`` crosses the packages
  (`repro_torch.interop`);
* every right shift is followed by a mask (``>>`` is arithmetic on
  int32, so the sign bit would smear without it);
* sums that can pass 2^31 run in int64 and wrap back to int32
  (`_wrap_i32`).

Every helper accepts leading batch axes where the engine needs them
(the reference vmaps its 1-D helpers instead).
"""
from __future__ import annotations

import torch

BITS_PER_WORD = 32
WORD_SHIFT = 5          # log2(BITS_PER_WORD)
WORD_MASK = BITS_PER_WORD - 1
WORD_DTYPE = torch.int32

__all__ = [
    "BITS_PER_WORD",
    "num_words",
    "zeros",
    "word_and_bit",
    "test_bits",
    "set_bits_exact",
    "set_bits_racy",
    "pack_bool",
    "unpack_bool",
    "popcount",
    "compact",
    "bit2vertex",
    "word_bits",
    "degree_matrix",
    "masked_degree_sum",
]


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding an unsigned 32-bit pattern -> the same bits as int32."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def popcount32(words: torch.Tensor) -> torch.Tensor:
    """Elementwise set-bit count of 32-bit words (SWAR in int64; torch
    has no popcount op).  Returns int64."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def num_words(n_vertices: int) -> int:
    """Number of 32-bit words needed to hold ``n_vertices`` bits."""
    return (int(n_vertices) + BITS_PER_WORD - 1) // BITS_PER_WORD


def zeros(n_vertices: int, device=None) -> torch.Tensor:
    """A fresh all-zeros bitmap covering ``n_vertices`` bits."""
    return torch.zeros((num_words(n_vertices),), dtype=WORD_DTYPE,
                       device=device)


def word_and_bit(vertices: torch.Tensor):
    """Index transformation vertex -> (word index, bit offset)."""
    v = vertices.to(torch.int32)
    return v >> WORD_SHIFT, v & WORD_MASK


def test_bits(bitmap: torch.Tensor, vertices: torch.Tensor) -> torch.Tensor:
    """Gather words and test each vertex's bit (TestBit of Alg. 3).

    Out-of-range word indices clip to the last word, as the reference's
    clip-mode gather does.  ``bitmap`` (..., W) and ``vertices``
    (..., N) share their leading axes."""
    word_idx, bit = word_and_bit(vertices)
    idx = word_idx.clamp(0, bitmap.shape[-1] - 1).long()
    words = torch.gather(bitmap, -1, idx)
    return ((words >> bit) & 1) != 0


def pack_bool(dense: torch.Tensor) -> torch.Tensor:
    """Pack a (..., W*32) bool array into a (..., W) bitmap.  Exact."""
    n = dense.shape[-1]
    assert n % BITS_PER_WORD == 0, "pad to a word multiple first"
    bits = dense.reshape(*dense.shape[:-1], -1, BITS_PER_WORD) \
        .to(torch.int64)
    weights = torch.ones((), dtype=torch.int64, device=dense.device) \
        << torch.arange(BITS_PER_WORD, dtype=torch.int64,
                        device=dense.device)
    return _wrap_i32((bits * weights).sum(-1))


def word_bits(words: torch.Tensor) -> torch.Tensor:
    """Expand packed words into per-bit lanes: (..., W) -> (..., W, 32)
    int32 of 0/1 (bit k of word w is vertex 32w + k)."""
    shifts = torch.arange(BITS_PER_WORD, dtype=torch.int32,
                          device=words.device)
    return (words[..., None] >> shifts) & 1


def unpack_bool(bitmap: torch.Tensor) -> torch.Tensor:
    """Expand a (..., W) bitmap into a (..., W*32) bool array.  Exact."""
    return word_bits(bitmap).reshape(*bitmap.shape[:-1], -1).bool()


def set_bits_exact(bitmap: torch.Tensor, vertices: torch.Tensor,
                   valid: torch.Tensor | None = None) -> torch.Tensor:
    """Deterministic OR of the given vertices' bits into a (W,) bitmap.

    A dense-bool scatter (duplicate sets are idempotent) followed by a
    pack; ids outside ``[0, W*32)`` or with ``valid`` False drop out."""
    n = bitmap.shape[-1] * BITS_PER_WORD
    v = vertices.to(torch.int64)
    keep = (v >= 0) & (v < n)
    if valid is not None:
        keep = keep & valid
    v = torch.where(keep, v, n)
    dense = torch.zeros((n + 1,), dtype=torch.bool, device=bitmap.device)
    dense[v] = True
    return bitmap | pack_bool(dense[:n])


def set_bits_racy(bitmap: torch.Tensor, vertices: torch.Tensor,
                  valid: torch.Tensor | None = None) -> torch.Tensor:
    """Racy word-level OR-scatter — the paper's non-atomic SetBit.

    Each lane reads its word (pre-update), ORs its bit and scatters the
    word back; lanes that target one word overwrite each other ("some
    lane wins"), the bit race of §3.3.2 that restoration repairs.
    ``bitmap`` is (W,)."""
    w = bitmap.shape[-1]
    word_idx, bit = word_and_bit(vertices)
    if valid is not None:
        word_idx = torch.where(valid, word_idx, w)
    gathered = bitmap[word_idx.clamp(0, w - 1).long()]
    updated = gathered | (torch.ones_like(bit) << bit)
    ext = torch.cat([bitmap, bitmap.new_zeros((1,))])
    ext[word_idx.clamp(0, w).long()] = updated
    return ext[:w]


def popcount(bitmap: torch.Tensor) -> torch.Tensor:
    """Total number of set bits (frontier size), int32 scalar."""
    return popcount32(bitmap).sum().to(torch.int32)


#: the lanes a compaction or a range-mark drops land on this many slots
#: past the live ones (millions of writes to one address serialize on
#: the card)
DROP_SLOTS = 4096


def compact_mask(mask: torch.Tensor, size: int, fill_value: int):
    """Bool (B, n) -> ((B, size) int32 ascending indices of the set lanes,
    padded with ``fill_value``, lanes ranked past ``size`` dropped; (B,)
    int32 counts of the set lanes, not capped at ``size``).  A prefix sum
    ranks the set lanes and a scatter puts each index at its rank: no
    ``nonzero``, no host sync."""
    n_batch, n = mask.shape
    ids = torch.arange(n, device=mask.device)
    rank = torch.cumsum(mask, dim=1, dtype=torch.int32) - 1
    slot = torch.where(mask & (rank < size), rank.to(torch.int64),
                       size + ids % DROP_SLOTS)
    out = torch.full((n_batch, size + DROP_SLOTS), int(fill_value),
                     dtype=torch.int32, device=mask.device)
    out.scatter_(1, slot, ids.to(torch.int32).expand(n_batch, -1)
                 .contiguous())
    return out[:, :size].contiguous(), mask.sum(dim=1, dtype=torch.int32)


def compact(bitmap: torch.Tensor, size: int, fill_value: int
            ) -> torch.Tensor:
    """(..., W) bitmap -> ``size`` ascending set-bit vertex ids per row,
    padded with ``fill_value`` (ids past ``size`` are dropped):
    `compact_mask` of the unpacked bits."""
    dense = unpack_bool(bitmap)
    lead, n = dense.shape[:-1], dense.shape[-1]
    out, _ = compact_mask(dense.reshape(-1, n), size, fill_value)
    return out.reshape(*lead, size)


def bit2vertex(word_idx: torch.Tensor, bit: torch.Tensor) -> torch.Tensor:
    """Inverse index transformation (bit2vertex of Alg. 3)."""
    return (word_idx.to(torch.int32) << WORD_SHIFT) | bit.to(torch.int32)


def degree_matrix(degrees: torch.Tensor, n_bits: int) -> torch.Tensor:
    """(V,) degrees -> (W, 32) word-aligned degree matrix (zero for
    padding vertices), the loop constant of `masked_degree_sum`."""
    deg = torch.zeros((n_bits,), dtype=torch.int32, device=degrees.device)
    deg[:degrees.shape[0]] = degrees.to(torch.int32)
    return deg.reshape(-1, BITS_PER_WORD)


def masked_degree_sum(words: torch.Tensor, deg_mat: torch.Tensor
                      ) -> torch.Tensor:
    """Σ deg over the set bits of a packed (..., W) bitmap — the Table 1
    "Edges" counter, int32 per leading index."""
    return (word_bits(words) * deg_mat).sum(dim=(-2, -1)) \
        .to(torch.int32)
