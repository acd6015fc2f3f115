"""K13 — total set bits of a word bitmap: CUDA kernel and its plain
torch version.

The frontier-size reduction of the termination test (``while in != 0``,
Alg. 3 line 7): the engine's host loop reads its loop condition from
it.  The CUDA kernel (``csrc/popcount.cu``) replaces
``repro.kernels.bitmap_kernels.popcount``: a grid-stride ``__popc`` sum,
one warp-shuffle reduction per CTA and one atomic add per CTA into a
zeroed int.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitmap as bm

CTAS_PER_SM = 2        # grid: a grid-stride loop fills the card


def popcount_plain(words: torch.Tensor) -> torch.Tensor:
    """Set bits of an int32 word tensor of any shape -> () int32."""
    return bm.popcount32(words).sum().to(torch.int32)


def popcount_cuda(words: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on a contiguous int32 CUDA tensor."""
    from repro_torch.kernels import _build
    if words.dtype != torch.int32 or not words.is_contiguous():
        raise ValueError(f"popcount needs contiguous int32 words, got "
                         f"{words.dtype}, contiguous="
                         f"{words.is_contiguous()}")
    total = torch.zeros((), dtype=torch.int32, device=words.device)
    n = words.numel()
    sms = torch.cuda.get_device_properties(words.device) \
        .multi_processor_count
    grid = max(1, min(-(-n // 1024), CTAS_PER_SM * sms))
    lib = _build.load()
    _build.check(lib.repro_popcount(words.data_ptr(), total.data_ptr(), n,
                                    grid, _build.stream_of(words)),
                 "popcount")
    return total
