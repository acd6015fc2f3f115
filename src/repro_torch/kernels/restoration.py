"""K1 — the restoration process (Alg. 3 lines 15-29): CUDA kernel and
its plain torch version.

Every vertex v with ``P[v] < 0`` was discovered this layer; restoration
returns P with ``P[v] + |V|`` there and a delta bitmap with exactly
those bits set, which the caller ORs into ``out`` and ``visited`` to
repair the bits the racy expansion dropped.  The CUDA kernel
(``csrc/restoration.cu``) replaces ``repro.kernels.restoration``'s
Pallas kernel; the wrapper `ops.restore` picks the arm by device.
"""
from __future__ import annotations

import torch

from repro_torch.core.bitmap import BITS_PER_WORD, pack_bool


def restoration_plain(parent: torch.Tensor, n_vertices: int):
    """(..., V_pad) int32 P -> (P fixed, (..., V_pad/32) delta words)."""
    marked = parent < 0
    return torch.where(marked, parent + n_vertices, parent), \
        pack_bool(marked)


def restoration_cuda(parent: torch.Tensor, n_vertices: int):
    """Launch the CUDA kernel on a (..., V_pad) int32 CUDA tensor."""
    from repro_torch.kernels import _build
    if parent.dtype != torch.int32 or not parent.is_contiguous():
        raise ValueError(f"restoration needs a contiguous int32 P, got "
                         f"{parent.dtype}, contiguous="
                         f"{parent.is_contiguous()}")
    v_pad = parent.shape[-1]
    if v_pad % BITS_PER_WORD:
        raise ValueError(f"V_pad={v_pad} must be a multiple of "
                         f"{BITS_PER_WORD}")
    p_out = torch.empty_like(parent)
    delta = torch.empty(parent.shape[:-1] + (v_pad // BITS_PER_WORD,),
                        dtype=torch.int32, device=parent.device)
    lib = _build.load()
    _build.check(lib.repro_restoration(
        parent.data_ptr(), p_out.data_ptr(), delta.data_ptr(),
        parent.numel(), int(n_vertices), _build.stream_of(parent)),
        "restoration")
    return p_out, delta
