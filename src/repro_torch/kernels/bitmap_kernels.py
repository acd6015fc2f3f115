"""K13 redesigned: the host loops' measure kernel — CUDA kernel and its
plain torch version.

One launch per layer of a host loop reads the (B, W) frontier words,
optionally the (B, W) visited words, and the format's (W, 32)
`degree_matrix` (flattened: the padded degree array), and returns
`Counters`: per root the frontier count and degree sum and, with
``visited``, the unvisited set's (``~visited``: padding is premarked),
the float32 of each counter's exact int64 batch sum, and the batch's
frontier count (K13's result, the termination test).  Without degrees
it is the count-only arm: per-root set-bit counts, which is what
``popcount`` (K13's signature: the total of a word tensor) launches,
and the portfolio's delta-stepping counts.  Given a `LayerLog` it also
writes what the host loop used to write with torch ops: the previous
stats row's "discovered" column, the layer's stats columns 0, 1 and 4,
the depths, and, for a registered policy, the decision (stats column 3
and ``log.ctrl``).

The CUDA kernel (``csrc/measure.cu``) replaces
``repro.kernels.bitmap_kernels.popcount`` and the plain-torch counters
the port's host loops ran around it (``row_popcounts`` and
``bitmap.masked_degree_sum``, on the frontier and on ``~visited``, then
another popcount for "discovered"): about 12 of the 19 ms of device time
of a SCALE-22 CSR ``fused_gather`` traversal before it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import bitmap as bm
from repro_torch.kernels import traversal_fused as tf

THREADS = 256
# grid: a CTA takes a contiguous range of steps of 32 words; at most
# CTAS_PER_SM CTAs per SM (tools/sweep_measure.py), at least
# MIN_STEPS_PER_WARP steps per warp
CTAS_PER_SM = 2
MIN_STEPS_PER_WARP = 1
# stats columns the measure writes (engine's _ST_FRONTIER, _ST_EDGES,
# _ST_DISCOVERED, _ST_MODE, _ST_ACTIVE)
_FRONTIER, _EDGES, _DISCOVERED, _MODE, _ACTIVE = range(5)


class Counters(NamedTuple):
    """One measure: the Table 1 counters of a root batch."""
    per_root: torch.Tensor  # (B, 4) int32: frontier count, degree sum,
    #                         unvisited count, degree sum
    sums: torch.Tensor      # (4,) float32 of the exact int64 batch sums
    total: torch.Tensor     # () int32: the batch's frontier count


class LayerLog(NamedTuple):
    """The device buffers of one host-loop traversal that the measure
    updates: the stats buffer, the depths, ``ctrl`` = (active, mode,
    bottom_up) for the host's one read per layer, and ``acc``, the
    kernel's (4 B + 1,) int64 accumulator and ticket (zero between
    launches).  ``code`` is the policy's `traversal_fused.PolicyCode`,
    or None where the host decides."""
    stats: torch.Tensor
    depths: torch.Tensor
    ctrl: torch.Tensor
    acc: torch.Tensor
    code: tf.PolicyCode | None
    simd_layer: torch.Tensor


def new_log(n_batch: int, max_layers: int, code, device) -> LayerLog:
    """A zeroed `LayerLog` for a traversal of ``n_batch`` roots."""
    i32 = dict(dtype=torch.int32, device=device)
    layers = code.simd_layers if code is not None else ()
    return LayerLog(
        torch.zeros((max_layers, tf.N_STATS), **i32),
        torch.zeros((n_batch,), **i32), torch.zeros((3,), **i32),
        torch.zeros((4 * n_batch + 1,), dtype=torch.int64, device=device),
        code,
        torch.tensor([int(l in layers) for l in range(max_layers)], **i32))


def _check(name: str, t: torch.Tensor, shape, dtype=torch.int32) -> None:
    if t.dtype != dtype or not t.is_contiguous() \
            or tuple(t.shape) != tuple(shape):
        raise ValueError(f"measure: {name} must be a contiguous {dtype} "
                         f"tensor of shape {tuple(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)}, contiguous={t.is_contiguous()}")


def measure_plain(frontier, visited=None, deg=None, *, log=None,
                  layer: int = 0, discovered: bool = True) -> Counters:
    """Plain torch measure of (B, W) int32 words: the counters and, with
    ``log``, the kernel's updates of it (see the module docstring)."""
    count = bm.popcount32(frontier).sum(dim=1)
    zero = torch.zeros_like(count)
    edges = zero if deg is None else tf.layer_counters(frontier, deg)[1]
    if visited is None:
        u_count = u_edges = zero
    else:
        u_count, u_edges = tf.layer_counters(~visited, deg)
    per_root = torch.stack([count, edges, u_count, u_edges], dim=1)
    tot = per_root.sum(dim=0)
    counters = Counters(per_root.to(torch.int32), tot.to(torch.float32),
                        tot[0].to(torch.int32))
    if log is not None:
        _record_plain(log, counters, tot, layer, discovered)
    return counters


def _record_plain(log: LayerLog, c: Counters, tot, layer: int,
                  discovered: bool) -> None:
    f_tot, f_edges, u_tot, u_edges = tot.tolist()
    if discovered and layer > 0:
        log.stats[layer - 1, _DISCOVERED] = tot[0]     # int32 wrap
    active = f_tot > 0
    log.ctrl[0] = int(active)
    if not active or layer >= log.stats.shape[0]:
        return
    row = log.stats[layer]
    row[_FRONTIER] = tot[0]
    row[_EDGES] = tot[1]
    row[_ACTIVE] = 1
    log.depths.add_((c.per_root[:, 0] > 0).to(torch.int32))
    if log.code is not None:
        mode, bottom_up = tf.decide(log.code, layer, f_tot, f_edges, u_tot,
                                    u_edges, bool(log.ctrl[2]))
        row[_MODE] = mode
        log.ctrl[1] = mode
        log.ctrl[2] = int(bottom_up)


def _grid(words: torch.Tensor, steps: int) -> int:
    sms = torch.cuda.get_device_properties(words.device) \
        .multi_processor_count
    per_cta = (THREADS // 32) * MIN_STEPS_PER_WARP
    return max(1, min(-(-steps // per_cta), CTAS_PER_SM * sms))


def measure_cuda(frontier, visited=None, deg=None, *, log=None,
                 layer: int = 0, discovered: bool = True) -> Counters:
    """Launch the measure kernel on CUDA tensors."""
    from repro_torch.kernels import _build
    n_batch, n_words = frontier.shape
    _check("frontier", frontier, (n_batch, n_words))
    if visited is not None:
        if deg is None:
            raise ValueError("measure: the unvisited pair needs deg")
        _check("visited", visited, (n_batch, n_words))
    if deg is not None:
        _check("deg", deg, (32 * n_words,))
        if deg.data_ptr() % 16:
            raise ValueError("measure: deg must be 16-byte aligned")
    dev = frontier.device
    per_root = torch.empty((n_batch, 4), dtype=torch.int32, device=dev)
    sums = torch.empty((4,), dtype=torch.float32, device=dev)
    total = torch.empty((), dtype=torch.int32, device=dev)
    if log is None:
        acc = torch.zeros((4 * n_batch + 1,), dtype=torch.int64, device=dev)
        ctrl = stats = depths = simd_layer = None
        max_layers, code = 0, None
    else:
        _check("log.acc", log.acc, (4 * n_batch + 1,), torch.int64)
        _check("log.depths", log.depths, (n_batch,))
        acc, ctrl, stats, depths = log.acc, log.ctrl, log.stats, log.depths
        simd_layer, max_layers, code = (log.simd_layer, log.stats.shape[0],
                                        log.code)
    steps = -(-n_words // 32)
    ptr = lambda t: None if t is None else t.data_ptr()
    kind = -1 if code is None else code.kind
    lib = _build.load()
    _build.check(lib.repro_measure(
        frontier.data_ptr(), ptr(visited), ptr(deg), per_root.data_ptr(),
        sums.data_ptr(), total.data_ptr(), acc.data_ptr(), ptr(ctrl),
        ptr(stats), ptr(depths), ptr(simd_layer), n_words, n_batch,
        int(layer), int(max_layers),
        int(layer) - 1 if discovered and log is not None else -1, kind,
        code.alpha if code else 0.0, code.v_over_beta if code else 0.0,
        code.threshold if code else 0.0, _grid(frontier, steps),
        _build.stream_of(frontier)), "measure")
    return Counters(per_root, sums, total)


def popcount_plain(words: torch.Tensor) -> torch.Tensor:
    """Set bits of an int32 word tensor of any shape -> () int32."""
    return bm.popcount32(words).sum().to(torch.int32)


def popcount_cuda(words: torch.Tensor) -> torch.Tensor:
    """K13 on the card: the measure kernel's count-only arm over the
    words as one row."""
    if words.dtype != torch.int32 or not words.is_contiguous():
        raise ValueError(f"popcount needs contiguous int32 words, got "
                         f"{words.dtype}, contiguous="
                         f"{words.is_contiguous()}")
    return measure_cuda(words.reshape(1, -1)).total
