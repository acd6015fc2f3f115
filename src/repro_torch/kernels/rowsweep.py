"""The distributed step's rowsweep (not a TPU kernel; the reference
writes it in jnp): CUDA kernel and its plain torch version.

One shard's top-down layer (`core.bfs_distributed._local_step`).  The
shard owns vertices ``[base, base + v_loc)`` and their out-edges as a
rebased CSR slice: ``colstarts_l`` (v_loc + 1,) and ``rows_l`` (e_loc,)
of global neighbour ids.  ``frontier`` and ``visited`` are the
replicated (w_cap,) global bitmaps.  The result is the (v_cap,) int32
min-parent candidate array: ``n_vertices`` (INF) everywhere, else the
least global owner ``base + u`` of a frontier vertex u of the shard
with an edge to an unvisited v < n_vertices.

`rowsweep_plain` is the reference's composition, `engine.rowsweep_stream`
then `engine.candidate_scatter`.  The CUDA kernel
(``csrc/rowsweep.cu``) computes the same array in one launch, one warp
per frontier word of the shard, with an atomic min per candidate;
order does not matter to a min, so the two agree bitwise.
"""
from __future__ import annotations

import torch

from repro_torch.core.bitmap import BITS_PER_WORD

THREADS = 256
CTAS_PER_SM = 8        # grid cap: a grid-stride loop over the words


def check_inputs(rows_l, colstarts_l, frontier, visited, base: int,
                 n_vertices: int) -> int:
    """Validate one shard's inputs; returns ``v_loc``."""
    v_loc = colstarts_l.shape[0] - 1
    n_words = frontier.shape[0]
    dev = frontier.device
    for name, t in (("rows_l", rows_l), ("colstarts_l", colstarts_l),
                    ("frontier", frontier), ("visited", visited)):
        if t.dtype != torch.int32 or t.dim() != 1 \
                or not t.is_contiguous() or t.device != dev:
            raise ValueError(
                f"rowsweep: {name} must be a contiguous 1-D int32 tensor "
                f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if tuple(visited.shape) != (n_words,):
        raise ValueError(f"rowsweep: visited has shape "
                         f"{tuple(visited.shape)}, frontier ({n_words},)")
    if v_loc % BITS_PER_WORD or base % BITS_PER_WORD or base < 0 \
            or base + v_loc > n_words * BITS_PER_WORD \
            or n_vertices > n_words * BITS_PER_WORD:
        raise ValueError(
            f"rowsweep: the shard [{base}, {base + v_loc}) must be "
            f"word-aligned inside the {n_words * BITS_PER_WORD} vertices "
            f"of the bitmaps, which must hold n_vertices={n_vertices}")
    return v_loc


def rowsweep_plain(rows_l, colstarts_l, frontier, visited, base: int,
                   n_vertices: int) -> torch.Tensor:
    """The candidate array by the reference's two steps."""
    # engine imports ops, which imports this module: import at call time
    from repro_torch.core import engine
    v_loc = check_inputs(rows_l, colstarts_l, frontier, visited, base,
                         n_vertices)
    w0 = base // BITS_PER_WORD
    local = frontier[w0:w0 + v_loc // BITS_PER_WORD]
    u, v, valid = engine.rowsweep_stream(colstarts_l, rows_l, local, v_loc,
                                         nbr_limit=n_vertices)
    return engine.candidate_scatter(u + base, v, valid, visited, n_vertices,
                                    frontier.shape[0] * BITS_PER_WORD)


def rowsweep_cuda(rows_l, colstarts_l, frontier, visited, base: int,
                  n_vertices: int) -> torch.Tensor:
    """Fill the candidate array with ``n_vertices`` and launch the CUDA
    rowsweep on it."""
    from repro_torch.kernels import _build
    v_loc = check_inputs(rows_l, colstarts_l, frontier, visited, base,
                         n_vertices)
    dev = frontier.device
    cand = torch.full((frontier.shape[0] * BITS_PER_WORD,), n_vertices,
                      dtype=torch.int32, device=dev)
    n_words = v_loc // BITS_PER_WORD
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = max(1, min(-(-n_words // (THREADS // 32)), CTAS_PER_SM * sms))
    _build.check(_build.load().repro_rowsweep(
        rows_l.data_ptr(), colstarts_l.data_ptr(), frontier.data_ptr(),
        visited.data_ptr(), cand.data_ptr(), n_words,
        base // BITS_PER_WORD, int(base), int(n_vertices), grid,
        _build.stream_of(cand)), "rowsweep")
    return cand
