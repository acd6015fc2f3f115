"""Public wrappers around the main-path kernels (K1, K2, K3).

Each wrapper picks its arm from the device of the tensors it is given:
a CPU tensor runs the kernel's plain torch version, a CUDA tensor
launches the hand-written CUDA kernel (which raises on any CUDA
error).  There is no other switch and no fallback: on the card the
kernel runs or the call fails.

Launch accounting, two counters:

* `count_launches` charges one launch per wrapper call, on either
  device, as the reference charges one per Pallas call at trace time —
  so `LayerStats.launches` stays 3 per fused layer and 1 per scalar
  layer even where one wrapper issues several CUDA launches.
* `KERNEL_LAUNCHES` counts, per wrapper, the calls that launched the
  CUDA kernel, and nothing else; `chip_smoke.py` reads it to show that
  the main path went through the kernels.

The reference's VMEM budgets (``ops.VMEM_BYTES``, ``compact_fits``,
``megakernel_fits``) describe a TPU core's scratchpad and have no
counterpart on this path.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import compact as ck
from repro_torch.kernels import gather_expand as ge
from repro_torch.kernels import restoration as rest

_LAUNCH_COUNT = [0]

#: CUDA kernel launches per wrapper (see module docstring)
KERNEL_LAUNCHES = {"restoration": 0, "frontier_compact_batched": 0,
                   "gather_expand_batched": 0}


def reset_kernel_launches() -> None:
    for name in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[name] = 0


def _charge_launch(n: int = 1) -> None:
    _LAUNCH_COUNT[0] += n


class count_launches:
    """Context manager counting wrapper calls made inside the block.

    >>> with ops.count_launches() as c:
    ...     step(frontier, visited, parent)
    >>> c.count   # kernel calls one layer of this step costs
    """
    count = 0

    def __enter__(self):
        self._base = _LAUNCH_COUNT[0]
        return self

    def __exit__(self, *exc):
        self.count = _LAUNCH_COUNT[0] - self._base
        return False


def _arm(t: torch.Tensor, name: str) -> bool:
    """True for the CUDA arm, False for the plain one; else raise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {t.device}")


def restore(parent: torch.Tensor, *, n_vertices: int):
    """K1 on a (V_pad,) or (B, V_pad) int32 P: returns (P fixed, delta
    words of shape (..., V_pad/32))."""
    _charge_launch()
    if _arm(parent, "restore"):
        KERNEL_LAUNCHES["restoration"] += 1
        return rest.restoration_cuda(parent, n_vertices)
    return rest.restoration_plain(parent, n_vertices)


def frontier_compact_batched(words: torch.Tensor, *, size: int,
                             fill: int):
    """K2: (B, W) packed bitmaps -> ((B, size) queues, (B,) counts)."""
    _charge_launch()
    if _arm(words, "frontier_compact_batched"):
        KERNEL_LAUNCHES["frontier_compact_batched"] += 1
        return ck.compact_cuda(words, size, fill)
    return ck.compact_plain(words, size, fill)


def frontier_compact(words: torch.Tensor, *, size: int, fill: int):
    """K2 for one root ((W,) -> (size,), count): the batched call at
    B = 1."""
    queue, total = frontier_compact_batched(words[None].contiguous(),
                                            size=size, fill=fill)
    return queue[0], total[0]


def gather_expand_batched(worklist, n_active, rows, colstarts, frontier,
                          visited, out_init, p_init, *, n_vertices: int,
                          tile: int, bottom_up: bool = False):
    """K3 over (B, ...) state: ``worklist`` (B, n_blocks), ``n_active``
    (B,), ``rows`` tile-padded (n_blocks * tile,), ``colstarts``
    (V+1,), bitmaps (B, W), P (B, V_pad).  Updates ``out_init`` and
    ``p_init`` in place and returns them as (out, parent) — restoration
    NOT applied."""
    _charge_launch()
    if _arm(rows, "gather_expand_batched"):
        KERNEL_LAUNCHES["gather_expand_batched"] += 1
        fn = ge.gather_expand_cuda
    else:
        fn = ge.gather_expand_plain
    return fn(worklist, n_active, rows, colstarts, frontier, visited,
              out_init, p_init, n_vertices=n_vertices, tile=tile,
              bottom_up=bottom_up)


def gather_expand(worklist, n_active, rows, colstarts, frontier, visited,
                  out_init, p_init, *, n_vertices: int, tile: int,
                  bottom_up: bool = False):
    """K3 for one root: the batched call at B = 1.  ``out_init`` and
    ``p_init`` ((W,), (V_pad,)) are updated in place."""
    na = torch.as_tensor(n_active, dtype=torch.int32,
                         device=rows.device).reshape(1)
    gather_expand_batched(
        worklist[None].contiguous(), na, rows, colstarts,
        frontier[None].contiguous(), visited[None].contiguous(),
        out_init[None], p_init[None], n_vertices=n_vertices, tile=tile,
        bottom_up=bottom_up)
    return out_init, p_init
