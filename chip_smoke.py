#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives ``repro_torch`` only (never ``jax``, never ``repro``):

1. device: require CUDA; print the card's name and power limit;
2. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. kernels vs plain versions on the card, at the main path's shapes,
   with inputs captured from a real layer of the main path (restoration
   and compaction must match exactly; gather-expand must give the same
   repaired ``out``/``visited`` and marked set, and every mark must
   name a frontier neighbour); each kernel's median time, its plain
   version's, and its bound.  The same on that layer for K4 (the
   prefetch ring, depths 1, 2, 4: K3's contract) and K5 (one layer in
   one launch: n_active, ``out`` and the marked set bitwise, exactly
   one CUDA launch per call by the profiler), and for K2/K3 at B = 1
   from a ``run(root)`` traversal;
4. main path: Graph500 R-MAT SCALE 22 / edgefactor 16 from ``--seed``,
   an all-auto plan (must resolve to BeamerHybrid + fused_gather), a
   batch of 8 roots with degree > 0, timed; every tree validated and
   its depths checked against an independent level-synchronous BFS;
5. the fusion paths at the same size — ``fused_gather`` at
   ``prefetch_depth=2`` (K4), ``megakernel`` at depth 0 and 2 (K5) and
   ``persistent`` (K6): each timed over 3 runs, trees valid, visited,
   frontier, depths, layers, stats columns 0-6 and the direction log
   equal to the main path's, the launches column as contracted, no
   degrade, and by the profiler one K5 launch per layer and one K6
   launch per traversal; K6 against its plain version on the batch's
   initial state;
5b. SELL-C-σ at the same size: the autotuner must pick ``sell`` for the
   graph; ``formats.build(g, "auto")`` builds the layout on the card
   (slabs, fill, bytes, build seconds and peak memory printed); the
   SELL paths — ``fused_gather`` at depth 0 and 2 (K8 + K1),
   ``megakernel`` (K9) and ``persistent`` (K10) — each timed over 3
   runs, trees valid, visited, frontier, depths, layers, stats columns
   0-4 and 6 and the direction log equal to the CSR main path's, the
   launches column as contracted, no degrade, one K9 launch per layer
   and one K10 launch per traversal by the profiler; K8 (depths 0, 1,
   2, 4), K9 and K13 against their plain versions on the largest
   captured SELL layer, K10 on the batch's initial state;
6. the four direction policies at SCALE 16, batch 8, on every pipeline
   of CSR and of SELL;
7. GPU vs the port's CPU path at SCALE 12 for CSR and SELL (the SELL
   layout built on the card equals the CPU build bitwise): visited,
   depths, the stats buffer and the direction log must be identical;
8. the kernels' launch counts from their paths' runs (all > 0; K13 runs
   every host-loop path's termination test).

Any failure raises and exits non-zero.  Run from the repository root:

    python3 chip_smoke.py [--seed 0] [--scale 22] [--profile]
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
BATCH = 8                     # BfsServeConfig.batch_slots
REPLACES = {
    "restoration": "src/repro/kernels/restoration.py:65",
    "frontier_compact_batched": "src/repro/kernels/compact.py:211",
    "gather_expand_batched": "src/repro/kernels/gather_expand.py:565",
    "gather_expand_prefetch": "src/repro/kernels/gather_expand.py:565",
    "layer_fused_batched": "src/repro/kernels/layer_fused.py:308",
    "traversal_fused_batched": "src/repro/kernels/traversal_fused.py:457",
    "sell_expand_batched": "src/repro/kernels/sell_expand.py:402",
    "sell_expand_prefetch": "src/repro/kernels/sell_expand.py:402",
    "sell_layer_fused_batched": "src/repro/kernels/sell_expand.py:647",
    "sell_traversal_fused_batched":
        "src/repro/kernels/traversal_fused.py:519",
    "popcount": "src/repro/kernels/bitmap_kernels.py:39",
}
CSRC = "src/repro_torch/kernels/csrc/"
SOURCES = {
    "restoration": CSRC + "restoration.cu",
    "frontier_compact_batched": CSRC + "compact.cu",
    "gather_expand_batched": CSRC + "gather_expand.cu",
    "gather_expand_prefetch": CSRC + "gather_expand.cu",
    "layer_fused_batched": CSRC + "layer_fused.cu",
    "traversal_fused_batched": CSRC + "traversal_fused.cu",
    "sell_expand_batched": CSRC + "sell_expand.cu",
    "sell_expand_prefetch": CSRC + "sell_expand.cu",
    "sell_layer_fused_batched": CSRC + "sell_layer_fused.cu",
    "sell_traversal_fused_batched": CSRC + "sell_traversal_fused.cu",
    "popcount": CSRC + "popcount.cu",
}
#: the fusion paths of phase 5 (TraversalSpec fields) and the kernel
#: each must launch
PATHS = {
    "fused_gather_d2": (dict(prefetch_depth=2), "gather_expand_prefetch"),
    "megakernel": (dict(pipeline="megakernel"), "layer_fused_batched"),
    "megakernel_d2": (dict(pipeline="megakernel", prefetch_depth=2),
                      "layer_fused_batched"),
    "persistent": (dict(pipeline="persistent"), "traversal_fused_batched"),
}
#: the SELL paths of phase 5b: (TraversalSpec fields, the kernels each
#: must launch, its launches column per layer)
SELL_PATHS = {
    "sell_fused_gather": (dict(), ("sell_expand_batched", "restoration"),
                          2),
    "sell_fused_gather_d2": (dict(prefetch_depth=2),
                             ("sell_expand_prefetch",), 2),
    "sell_megakernel": (dict(pipeline="megakernel"),
                        ("sell_layer_fused_batched",), 1),
    "sell_persistent": (dict(pipeline="persistent"),
                        ("sell_traversal_fused_batched",), 0),
}
PREFETCH_DEPTHS = (1, 2, 4)
SELL_DEPTHS = (0, 1, 2, 4)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, setup=None) -> float:
    """Median device time of ``fn`` over ``reps`` calls (CUDA events
    around each call; ``setup`` runs outside the timed window)."""
    import torch
    if setup:
        setup()
    fn()                                     # warm-up
    times = []
    for _ in range(reps):
        if setup:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def level_bfs_depths(src, dst, n_vertices: int, root: int):
    """Independent level-synchronous BFS over the edge list (torch on
    the card): depths, -1 where unreached."""
    import torch
    depth = torch.full((n_vertices,), -1, dtype=torch.int32,
                       device=src.device)
    frontier = torch.zeros((n_vertices,), dtype=torch.bool,
                           device=src.device)
    depth[root] = 0
    frontier[root] = True
    d = 0
    while bool(frontier.any()):
        d += 1
        nxt = torch.zeros_like(frontier)
        nxt[dst[frontier[src]]] = True
        nxt &= depth < 0
        depth[nxt] = d
        frontier = nxt
    return depth


class Capture:
    """Records the kernel inputs of the fused layer with the most active
    tiles while a traversal runs (the wrappers are wrapped, not
    changed)."""

    def __init__(self, ops):
        self.ops = ops
        self.best = None
        self._pending = None

    def __enter__(self):
        ops = self.ops
        self._orig = (ops.frontier_compact_batched,
                      ops.gather_expand_batched)
        orig_compact, orig_gather = self._orig

        def compact(words, *, size, fill):
            self._pending = (words.clone(), size, fill)
            return orig_compact(words, size=size, fill=fill)

        def gather(wl, na, rows, colstarts, frontier, visited, out, p,
                   **kw):
            tiles = int(na.sum())
            if self.best is None or tiles > self.best["tiles"]:
                self.best = dict(
                    tiles=tiles, compact=self._pending, wl=wl.clone(),
                    na=na.clone(), rows=rows, colstarts=colstarts,
                    frontier=frontier.clone(), visited=visited.clone(),
                    out=out.clone(), p=p.clone(),
                    kw={k: v for k, v in kw.items()
                        if k != "prefetch_depth"})
            return orig_gather(wl, na, rows, colstarts, frontier, visited,
                               out, p, **kw)

        ops.frontier_compact_batched = compact
        ops.gather_expand_batched = gather
        return self

    def __exit__(self, *exc):
        self.ops.frontier_compact_batched, \
            self.ops.gather_expand_batched = self._orig
        return False


def k3_bytes(cap, n_marked: int) -> int:
    """Bytes K3 must move for the captured layer, each input read once:
    rows of the union of active blocks, the colstarts entries their
    owners span, wl/na, frontier + visited + out read, out written, and
    one P word per marked vertex."""
    import torch
    tile = cap["kw"]["tile"]
    wl, na = cap["wl"], cap["na"]
    n_batch, n_blocks = wl.shape
    used = torch.zeros((n_blocks,), dtype=torch.bool, device=wl.device)
    for b in range(n_batch):
        used[wl[b, :int(na[b])].long()] = True
    blocks = torch.nonzero(used).flatten()
    cs = cap["colstarts"]
    first = torch.searchsorted(cs, (blocks * tile).to(cs.dtype),
                               right=True) - 1
    last = torch.searchsorted(cs, (blocks * tile + tile - 1).to(cs.dtype),
                              right=True) - 1
    cs_entries = int((last - first + 2).sum())
    words = cap["frontier"].numel()
    return (4 * tile * int(blocks.numel()) + 4 * cs_entries
            + 4 * (n_batch + int(na.sum())) + 4 * 4 * words
            + 4 * n_marked)


def fused_layer_bytes(fg, frontier, visited, bottom_up: bool,
                      n_marked: int) -> int:
    """Bytes one fused layer (K5) must move, each input read once: the
    planning reads (two owner ids per block, the degree bitmap, the
    frontier and visited words), the rows of the union of active blocks
    and the colstarts entries they span, P read once for restoration,
    one P word written per discovery, ``out`` and the counts written."""
    import torch
    from repro_torch.kernels.layer_fused import plan_blocks_plain
    wl, na = plan_blocks_plain(fg, visited if bottom_up else frontier,
                               bottom_up)
    used = torch.zeros((fg.n_blocks,), dtype=torch.bool,
                       device=wl.device)
    for b in range(wl.shape[0]):
        used[wl[b, :int(na[b])].long()] = True
    blocks = torch.nonzero(used).flatten()
    cs_entries = int((fg.blk_hi[blocks] - fg.blk_lo[blocks] + 2).sum())
    n_batch, n_words = frontier.shape
    v_pad = int(fg.deg.shape[0])
    return (4 * fg.tile * int(blocks.numel()) + 4 * cs_entries
            + 8 * fg.n_blocks + 4 * n_words + 8 * n_batch * n_words
            + 4 * n_batch * v_pad + 4 * n_marked + 4 * n_batch * n_words
            + 4 * n_batch)


def device_kernels(fn):
    """Run ``fn`` under the profiler: {kernel name: launches} of the
    device-side events (kernels and copies)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and e.self_device_time_total > 0}


def launches_of(kernels: dict, name: str) -> int:
    return sum(n for k, n in kernels.items() if name in k)


def check_marks(cap, p_racy, frontier_b):
    """Every marked P names a frontier vertex adjacent to its vertex."""
    import torch
    n = cap["kw"]["n_vertices"]
    rows, cs = cap["rows"], cap["colstarts"]
    for b in range(p_racy.shape[0]):
        cand = torch.nonzero(p_racy[b] < 0).flatten()
        if cand.numel() == 0:
            continue
        gate = (p_racy[b, cand] + n).long()
        assert bool(((gate >= 0) & (gate < n)).all()), "parent out of range"
        fw = frontier_b[b, (gate >> 5)]
        assert bool((((fw >> (gate & 31).int()) & 1) == 1).all()), \
            f"root {b}: a marked parent is not in the frontier"
        # binary search cand in adj(gate) (rows sorted per vertex)
        lo, end = cs[gate].long(), cs[gate + 1].long()
        hi = end.clone()
        for _ in range(32):
            mid = (lo + hi) // 2
            right = rows[mid.clamp(max=rows.numel() - 1)] < cand
            lo, hi = torch.where(right, mid + 1, lo), \
                torch.where(right, hi, mid)
        found = (lo < end) & (rows[lo.clamp(max=rows.numel() - 1)] == cand)
        assert bool(found.all()), \
            f"root {b}: a marked parent is not a neighbour"


def phase_kernels(cap, n_vertices: int, v_pad: int, reps: int,
                  label: str = ""):
    """Phase 3: each kernel against its plain version on the card.  The
    plain K3's output stays in ``cap["plain_k3"]`` for phase 3b."""
    import torch
    from repro_torch.kernels import compact as ck
    from repro_torch.kernels import gather_expand as ge
    from repro_torch.kernels import restoration as rest
    results = {}
    kw = cap["kw"]
    n_batch, n_words = cap["frontier"].shape

    # K2 on the captured planning bitmap
    words, size, fill = cap["compact"]
    q_k, c_k = ck.compact_cuda(words, size, fill)
    q_p, c_p = ck.compact_plain(words, size, fill)
    err = max(int((q_k - q_p).abs().max()), int((c_k - c_p).abs().max()))
    assert err == 0, f"frontier compaction disagrees: max |err| {err}"
    k2_bytes = 4 * words.numel() + 4 * n_batch * size + 4 * n_batch
    results["frontier_compact_batched"] = dict(
        max_abs_err=err, bytes=k2_bytes,
        ms=cuda_ms(lambda: ck.compact_cuda(words, size, fill), reps),
        plain_ms=cuda_ms(lambda: ck.compact_plain(words, size, fill),
                         max(3, reps // 4)))

    # K3 on the captured layer; K1 on its racy output
    def k3(fn):
        out, p = cap["out"].clone(), cap["p"].clone()
        fn(cap["wl"], cap["na"], cap["rows"], cap["colstarts"],
           cap["frontier"], cap["visited"], out, p, **kw)
        return out, p

    out_k, p_k = k3(ge.gather_expand_cuda)
    out_p, p_p = k3(ge.gather_expand_plain)
    torch.cuda.synchronize()
    marked_k, marked_p = p_k < 0, p_p < 0
    k3_err = int((marked_k != marked_p).sum())
    fixed_k, delta_k = rest.restoration_plain(p_k, n_vertices)
    fixed_p, delta_p = rest.restoration_plain(p_p, n_vertices)
    for name, a, b in (("out|delta", out_k | delta_k, out_p | delta_p),
                       ("visited|delta", cap["visited"] | delta_k,
                        cap["visited"] | delta_p)):
        k3_err = max(k3_err, int((a != b).sum()))
        assert torch.equal(a, b), f"gather_expand: {name} disagrees"
    assert k3_err == 0, "gather_expand: the marked sets disagree"
    check_marks(cap, p_k, cap["frontier"])
    n_marked = int(marked_k.sum())
    cap["plain_k3"] = (out_p, p_p)
    out_buf, p_buf = cap["out"].clone(), cap["p"].clone()

    def reset():
        out_buf.copy_(cap["out"])
        p_buf.copy_(cap["p"])

    def run_k3(fn):
        return lambda: fn(cap["wl"], cap["na"], cap["rows"],
                          cap["colstarts"], cap["frontier"],
                          cap["visited"], out_buf, p_buf, **kw)

    results["gather_expand_batched"] = dict(
        max_abs_err=k3_err, bytes=k3_bytes(cap, n_marked),
        active_tiles=cap["tiles"], marked=n_marked,
        bottom_up=kw["bottom_up"],
        ms=cuda_ms(run_k3(ge.gather_expand_cuda), reps, setup=reset),
        plain_ms=cuda_ms(run_k3(ge.gather_expand_plain),
                         max(3, reps // 4), setup=reset))

    # K1 on the kernel's racy P
    f_k, d_k = rest.restoration_cuda(p_k, n_vertices)
    f_p, d_p = rest.restoration_plain(p_k, n_vertices)
    err = max(int((f_k - f_p).abs().max()),
              int((d_k != d_p).sum()))
    assert err == 0, f"restoration disagrees: {err}"
    results["restoration"] = dict(
        max_abs_err=err,
        bytes=8 * n_batch * v_pad + n_batch * v_pad // 8,
        ms=cuda_ms(lambda: rest.restoration_cuda(p_k, n_vertices), reps),
        plain_ms=cuda_ms(lambda: rest.restoration_plain(p_k, n_vertices),
                         max(3, reps // 4)))
    for name, r in results.items():
        r["bound_ms"] = r["bytes"] / HBM_BYTES_PER_S * 1e3
        log(json.dumps({"kernel": name + label, "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bytes": r["bytes"],
                        "bound_ms": r["bound_ms"],
                        "max_abs_err": r["max_abs_err"]}))
    log(f"K3 layer{label}: {cap['tiles']} active tiles, {n_marked} "
        f"marked, bottom_up={kw['bottom_up']}")
    return results


def phase_prefetch(cap, reps: int, k3: dict):
    """Phase 3b: K4 at each depth on the captured layer, on K3's
    contract against the plain version (K3's)."""
    import torch
    from repro_torch.kernels import gather_expand as ge
    from repro_torch.kernels import restoration as rest
    kw, n = cap["kw"], cap["kw"]["n_vertices"]
    out_p, p_p = cap["plain_k3"]
    _, delta_p = rest.restoration_plain(p_p, n)
    out_buf, p_buf = cap["out"].clone(), cap["p"].clone()

    def reset():
        out_buf.copy_(cap["out"])
        p_buf.copy_(cap["p"])

    per_depth = {}
    for depth in PREFETCH_DEPTHS:
        reset()
        run = lambda: ge.gather_expand_cuda(
            cap["wl"], cap["na"], cap["rows"], cap["colstarts"],
            cap["frontier"], cap["visited"], out_buf, p_buf,
            prefetch_depth=depth, **kw)
        run()
        torch.cuda.synchronize()
        _, delta_k = rest.restoration_plain(p_buf, n)
        err = int(((p_buf < 0) != (p_p < 0)).sum())
        for name, a, b in (("out|delta", out_buf | delta_k, out_p | delta_p),
                           ("visited|delta", cap["visited"] | delta_k,
                            cap["visited"] | delta_p)):
            err = max(err, int((a != b).sum()))
        assert err == 0, f"K4 at depth {depth} disagrees with K3's plain"
        check_marks(cap, p_buf, cap["frontier"])
        per_depth[depth] = cuda_ms(run, reps, setup=reset)
        log(json.dumps({"kernel": "gather_expand_prefetch",
                        "prefetch_depth": depth, "ms": per_depth[depth],
                        "k3_ms": k3["ms"], "max_abs_err": err}))
    return dict(max_abs_err=0, ms=per_depth[2], plain_ms=k3["plain_ms"],
                bytes=k3["bytes"], bound_ms=k3["bound_ms"],
                per_depth=per_depth)


def phase_layer_fused(cap, v_pad: int, reps: int):
    """Phase 3c: K5 on the captured layer against its plain version:
    n_active, ``out`` and the marked set bitwise, every parent a
    frontier neighbour, one CUDA launch per call."""
    import torch
    from repro_torch.kernels import layer_fused as lf
    kw, n = cap["kw"], cap["kw"]["n_vertices"]
    fg = lf.fused_csr(cap["colstarts"], cap["rows"], n, kw["tile"], v_pad)
    bu = kw["bottom_up"]
    p_buf = cap["p"].clone()
    run = lambda: lf.layer_fused_cuda(fg, cap["frontier"], cap["visited"],
                                      p_buf, bottom_up=bu)
    out_k, p_k, na_k = run()
    p_plain = cap["p"].clone()
    out_p, p_p, na_p = lf.layer_fused_plain(fg, cap["frontier"],
                                            cap["visited"], p_plain,
                                            bottom_up=bu)
    torch.cuda.synchronize()
    marked_k, marked_p = p_k != cap["p"], p_p != cap["p"]
    err = max(int((na_k != na_p).sum()), int((na_k != cap["na"]).sum()),
              int((out_k != out_p).sum()), int((marked_k != marked_p).sum()),
              int(((cap["visited"] | out_k)
                   != (cap["visited"] | out_p)).sum()))
    assert err == 0, "layer_fused disagrees with its plain version"
    check_marks(cap, torch.where(marked_k, p_k - n, cap["p"]),
                cap["frontier"])
    n_marked = int(marked_k.sum())

    def reset():
        p_buf.copy_(cap["p"])

    reset()
    kernels = device_kernels(run)
    assert sum(kernels.values()) == 1 \
        and launches_of(kernels, "layer_fused_kernel") == 1, \
        f"K5 must be one CUDA launch per call, profiler saw {kernels}"
    res = dict(max_abs_err=err, n_marked=n_marked,
               bytes=fused_layer_bytes(fg, cap["frontier"], cap["visited"],
                                       bu, n_marked),
               ms=cuda_ms(run, reps, setup=reset),
               plain_ms=cuda_ms(lambda: lf.layer_fused_plain(
                   fg, cap["frontier"], cap["visited"], p_plain,
                   bottom_up=bu), 3, setup=lambda: p_plain.copy_(cap["p"])))
    res["bound_ms"] = res["bytes"] / HBM_BYTES_PER_S * 1e3
    log(json.dumps({"kernel": "layer_fused_batched", "ms": res["ms"],
                    "plain_ms": res["plain_ms"], "bytes": res["bytes"],
                    "bound_ms": res["bound_ms"], "max_abs_err": err,
                    "cuda_launches_per_call": 1}))
    return res


class LayerCapture:
    """Records every K5 layer's inputs (frontier, visited, direction) and
    its discoveries while a megakernel traversal runs."""

    def __init__(self, ops):
        self.ops = ops
        self.layers = []

    def __enter__(self):
        orig = self._orig = self.ops.layer_fused_batched

        def layer(graph, frontier, visited, parent, **kw):
            f, v = frontier.clone(), visited.clone()
            out, p, na = orig(graph, frontier, visited, parent, **kw)
            from repro_torch.core.engine import row_popcounts
            self.layers.append((graph, f, v, kw["bottom_up"],
                                int(row_popcounts(out).sum())))
            return out, p, na

        self.ops.layer_fused_batched = layer
        return self

    def __exit__(self, *exc):
        self.ops.layer_fused_batched = self._orig
        return False


def phase_persistent_kernel(ct, roots, layers, reps: int):
    """K6 against its plain version on the batch's initial state; bytes
    = the per-layer K5 bytes of the same traversal (``layers`` from a
    `LayerCapture`) plus one read of the degrees."""
    import torch
    from repro_torch.core import engine
    from repro_torch.kernels import traversal_fused as tf
    fmt, spec = ct.fmt, ct.resolved
    fg = fmt.fused_graph(spec)
    r = torch.as_tensor(roots, dtype=torch.int32, device=fmt.device)
    state = engine._init_batched(r, fmt.n_vertices, fmt.n_vertices_padded)
    code = engine.encode_policy(spec.policy, fmt.n_vertices, len(roots),
                                spec.max_layers)
    kw = dict(code=code, max_layers=spec.max_layers)
    got = tf.traversal_fused_cuda(fg, *state, **kw)
    want = tf.traversal_fused_plain(fg, *state, **kw)
    torch.cuda.synchronize()
    err = 0
    for i, name in ((0, "frontier"), (1, "visited"), (3, "depths"),
                    (4, "layers"), (5, "stats")):
        err = max(err, int((got[i] != want[i]).sum()))
        assert torch.equal(got[i], want[i]), \
            f"traversal_fused: {name} disagrees with its plain version"
    bytes_ = sum(fused_layer_bytes(g, f, v, bu, m)
                 for g, f, v, bu, m in layers) + 4 * int(fg.deg.shape[0])
    res = dict(max_abs_err=err, bytes=bytes_,
               bound_ms=bytes_ / HBM_BYTES_PER_S * 1e3,
               ms=cuda_ms(lambda: tf.traversal_fused_cuda(fg, *state, **kw),
                          reps),
               plain_ms=cuda_ms(lambda: tf.traversal_fused_plain(
                   fg, *state, **kw), 1))
    log(json.dumps({"kernel": "traversal_fused_batched", "ms": res["ms"],
                    "plain_ms": res["plain_ms"], "bytes": bytes_,
                    "bound_ms": res["bound_ms"], "max_abs_err": err,
                    "layers": int(got[4][0])}))
    return res


class SellCapture:
    """Records the K8 inputs of the SELL layer with the most active
    groups, and every K9 layer's inputs, while traversals run (the
    wrappers are wrapped, not changed)."""

    def __init__(self, ops):
        self.ops = ops
        self.best = None
        self.layers = []

    def __enter__(self):
        ops = self.ops
        self._orig = (ops.sell_batched, ops.sell_layer_fused_batched)
        orig_sell, orig_layer = self._orig

        def sell(graph, frontier, visited, out, p, *, worklist, n_active,
                 **kw):
            groups = int(n_active.sum())
            if self.best is None or groups > self.best["groups"]:
                self.best = dict(
                    groups=groups, graph=graph, wl=worklist.clone(),
                    na=n_active.clone(), frontier=frontier.clone(),
                    visited=visited.clone(), out=out.clone(), p=p.clone(),
                    bottom_up=kw["bottom_up"])
            return orig_sell(graph, frontier, visited, out, p,
                             worklist=worklist, n_active=n_active, **kw)

        def layer(graph, frontier, visited, parent, **kw):
            f, v = frontier.clone(), visited.clone()
            out, p, na = orig_layer(graph, frontier, visited, parent, **kw)
            from repro_torch.core.engine import row_popcounts
            self.layers.append((graph, f, v, kw["bottom_up"],
                                int(row_popcounts(out).sum())))
            return out, p, na

        ops.sell_batched = sell
        ops.sell_layer_fused_batched = layer
        return self

    def __exit__(self, *exc):
        self.ops.sell_batched, self.ops.sell_layer_fused_batched = \
            self._orig
        return False


def sell_groups(graph, wl, na) -> int:
    """Slab groups in the union of the roots' work-lists."""
    import torch
    used = torch.zeros((graph.n_steps,), dtype=torch.bool, device=wl.device)
    for b in range(wl.shape[0]):
        used[wl[b, :int(na[b])].long()] = True
    return int(used.sum())


def sell_k8_bytes(cap, n_marked: int) -> int:
    """Bytes K8 must move for a captured layer, each input read once:
    cols and slab_rows of the union of active groups, wl/na, frontier +
    visited + out read, out written, one P word per marked vertex."""
    from repro_torch.kernels.sell_expand import SLAB_INTS
    graph = cap["graph"]
    n_batch, n_words = cap["frontier"].shape
    return (4 * graph.spp * SLAB_INTS * sell_groups(graph, cap["wl"],
                                                    cap["na"])
            + 4 * (n_batch + int(cap["na"].sum()))
            + 4 * 4 * n_batch * n_words + 4 * n_marked)


def sell_layer_bytes(graph, frontier, visited, bottom_up: bool,
                     n_marked: int) -> int:
    """Bytes one SELL layer (K9) must move, each input read once: every
    slab's row ids (the plan), the planning and sweep bitmaps, the cols
    of the union of active groups, P read once for restoration, one P
    word per discovery, ``out`` and the counts written."""
    from repro_torch.kernels.sell_expand import (SLICE_C, W_QUANT,
                                                 plan_slabs_plain)
    wl, na = plan_slabs_plain(graph, ~visited if bottom_up else frontier)
    n_batch, n_words = frontier.shape
    v_pad = int(graph.deg.shape[0])
    return (4 * int(graph.slab_rows.numel())
            + 4 * graph.spp * W_QUANT * SLICE_C * sell_groups(graph, wl, na)
            + 8 * n_batch * n_words + 4 * n_batch * v_pad + 4 * n_marked
            + 4 * n_batch * n_words + 4 * n_batch)


def sell_check_marks(cap, p_racy, g):
    """`check_marks` for a SELL layer: the SELL adjacency is the CSR
    adjacency, so the marks are checked against the main path's CSR."""
    check_marks(dict(kw=dict(n_vertices=g.n_vertices), rows=g.rows,
                     colstarts=g.colstarts), p_racy, cap["frontier"])


def phase_sell_kernels(cap, g, reps: int):
    """K8 (depths 0, 1, 2, 4) and K9 on the captured SELL layer, K13 on
    its frontier words, each against its plain version on the card."""
    import torch
    from repro_torch.kernels import bitmap_kernels as bk
    from repro_torch.kernels import restoration as rest
    from repro_torch.kernels import sell_expand as se
    graph, n = cap["graph"], g.n_vertices
    bu = cap["bottom_up"]
    res = {}

    out_p, p_p = cap["out"].clone(), cap["p"].clone()
    se.sell_expand_plain(graph, cap["wl"], cap["na"], cap["frontier"],
                         cap["visited"], out_p, p_p, bottom_up=bu)
    _, delta_p = rest.restoration_plain(p_p, n)
    out_buf, p_buf = cap["out"].clone(), cap["p"].clone()

    def reset():
        out_buf.copy_(cap["out"])
        p_buf.copy_(cap["p"])

    def k8(fn, **kw):
        return lambda: fn(graph, cap["wl"], cap["na"], cap["frontier"],
                          cap["visited"], out_buf, p_buf, bottom_up=bu, **kw)

    per_depth = {}
    n_marked = int((p_p < 0).sum())
    for depth in SELL_DEPTHS:
        reset()
        k8(se.sell_expand_cuda, prefetch_depth=depth)()
        torch.cuda.synchronize()
        _, delta_k = rest.restoration_plain(p_buf, n)
        err = int(((p_buf < 0) != (p_p < 0)).sum())
        for name, a, b in (("out|delta", out_buf | delta_k, out_p | delta_p),
                           ("visited|delta", cap["visited"] | delta_k,
                            cap["visited"] | delta_p)):
            err = max(err, int((a != b).sum()))
        assert err == 0, f"K8 at depth {depth} disagrees with its plain"
        sell_check_marks(cap, p_buf, g)
        per_depth[depth] = cuda_ms(k8(se.sell_expand_cuda,
                                      prefetch_depth=depth), reps,
                                   setup=reset)
        log(json.dumps({"kernel": "sell_expand", "prefetch_depth": depth,
                        "ms": per_depth[depth], "max_abs_err": err}))
    bytes_k8 = sell_k8_bytes(cap, n_marked)
    plain_ms = cuda_ms(k8(se.sell_expand_plain), max(3, reps // 4),
                       setup=reset)
    res["sell_expand_batched"] = dict(
        max_abs_err=0, ms=per_depth[0], plain_ms=plain_ms, bytes=bytes_k8,
        groups=cap["groups"], marked=n_marked, bottom_up=bu)
    res["sell_expand_prefetch"] = dict(
        max_abs_err=0, ms=per_depth[2], plain_ms=plain_ms, bytes=bytes_k8,
        per_depth=per_depth)

    # K9 on the same state
    p9 = cap["p"].clone()
    run9 = lambda: se.sell_layer_fused_cuda(graph, cap["frontier"],
                                            cap["visited"], p9, bottom_up=bu)
    out_k, p_k, na_k = run9()
    p9_plain = cap["p"].clone()
    out_q, p_q, na_q = se.sell_layer_fused_plain(
        graph, cap["frontier"], cap["visited"], p9_plain, bottom_up=bu)
    torch.cuda.synchronize()
    marked_k, marked_q = p_k != cap["p"], p_q != cap["p"]
    err = max(int((na_k != na_q).sum()), int((na_k != cap["na"]).sum()),
              int((out_k != out_q).sum()), int((marked_k != marked_q).sum()))
    assert err == 0, "sell_layer_fused disagrees with its plain version"
    sell_check_marks(cap, torch.where(marked_k, p_k - n, cap["p"]), g)
    bytes_k9 = sell_layer_bytes(graph, cap["frontier"], cap["visited"], bu,
                                int(marked_k.sum()))
    res["sell_layer_fused_batched"] = dict(
        max_abs_err=err, bytes=bytes_k9,
        ms=cuda_ms(run9, reps, setup=lambda: p9.copy_(cap["p"])),
        plain_ms=cuda_ms(lambda: se.sell_layer_fused_plain(
            graph, cap["frontier"], cap["visited"], p9_plain, bottom_up=bu),
            3, setup=lambda: p9_plain.copy_(cap["p"])))

    # K13 on the layer's frontier words
    words = cap["frontier"]
    got, want = bk.popcount_cuda(words), bk.popcount_plain(words)
    err = abs(int(got) - int(want))
    assert err == 0, f"popcount disagrees: {int(got)} vs {int(want)}"
    res["popcount"] = dict(
        max_abs_err=err, bytes=4 * words.numel() + 4,
        ms=cuda_ms(lambda: bk.popcount_cuda(words), reps),
        plain_ms=cuda_ms(lambda: bk.popcount_plain(words), reps))
    for name, r in res.items():
        r["bound_ms"] = r["bytes"] / HBM_BYTES_PER_S * 1e3
        log(json.dumps({"kernel": name, "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bytes": r["bytes"],
                        "bound_ms": r["bound_ms"],
                        "max_abs_err": r["max_abs_err"]}))
    log(f"K8 layer: {cap['groups']} active slab groups (all roots), "
        f"{n_marked} marked, bottom_up={bu}")
    return res


def phase_sell_traversal_kernel(ct, roots, layers, reps: int):
    """K10 against its plain version on the batch's initial state; bytes
    = the per-layer K9 bytes of the same traversal (``layers`` from a
    `SellCapture` of a megakernel run) plus one read of the degrees."""
    import torch
    from repro_torch.core import engine
    from repro_torch.kernels import traversal_fused as tf
    fmt, spec = ct.fmt, ct.resolved
    graph = fmt.sell_graph(spec.tile)
    r = torch.as_tensor(roots, dtype=torch.int32, device=fmt.device)
    state = engine._init_batched(r, fmt.n_vertices, fmt.n_vertices_padded)
    code = engine.encode_policy(spec.policy, fmt.n_vertices, len(roots),
                                spec.max_layers)
    kw = dict(code=code, max_layers=spec.max_layers)
    got = tf.sell_traversal_fused_cuda(graph, *state, **kw)
    want = tf.sell_traversal_fused_plain(graph, *state, **kw)
    torch.cuda.synchronize()
    err = 0
    for i, name in ((0, "frontier"), (1, "visited"), (3, "depths"),
                    (4, "layers"), (5, "stats")):
        err = max(err, int((got[i] != want[i]).sum()))
        assert torch.equal(got[i], want[i]), \
            f"sell_traversal_fused: {name} disagrees with its plain version"
    bytes_ = sum(sell_layer_bytes(gr, f, v, bu, m)
                 for gr, f, v, bu, m in layers) + 4 * int(graph.deg.shape[0])
    res = dict(max_abs_err=err, bytes=bytes_,
               bound_ms=bytes_ / HBM_BYTES_PER_S * 1e3,
               ms=cuda_ms(lambda: tf.sell_traversal_fused_cuda(
                   graph, *state, **kw), reps),
               plain_ms=cuda_ms(lambda: tf.sell_traversal_fused_plain(
                   graph, *state, **kw), 1))
    log(json.dumps({"kernel": "sell_traversal_fused_batched",
                    "ms": res["ms"], "plain_ms": res["plain_ms"],
                    "bytes": bytes_, "bound_ms": res["bound_ms"],
                    "max_abs_err": err, "layers": int(got[4][0])}))
    return res


def phase_sell(g, roots, base, oracle, edges: int, reps: int):
    """Phase 5b: the SELL-C-σ layout of the main path's graph, built on
    the card by the autotuner's choice, on its four paths and kernels.
    Returns ({kernel: results}, {kernel: launches})."""
    import torch
    import repro_torch.bfs as bfs
    from repro_torch import formats
    from repro_torch.formats import autotune
    from repro_torch.kernels import ops
    choice = autotune.choose(g)
    log(f"autotune: {choice.format} ({choice.reason})")
    assert choice.format == "sell", choice
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fmt = formats.build(g, "auto")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    assert isinstance(fmt, formats.SellFormat), type(fmt)
    log(f"sell layout: {fmt.n_slabs} slabs, sigma {fmt.sigma}, fill "
        f"{fmt.fill_ratio:.6f}, {fmt.footprint().summary()}; built on the "
        f"card in {build_s:.6f} s, peak device memory during the build "
        f"{peak / 2**30:.3f} GiB")
    kres, launches = {}, {}
    for name, (fields, kernels, per_layer) in SELL_PATHS.items():
        ct, launched, _ = run_path(fmt, g, roots, name, fields, kernels,
                                   per_layer, base, oracle, edges,
                                   (0, 1, 2, 3, 4, 6))
        for k in kernels:
            launches.setdefault(k, launched[k])
        if name == "sell_fused_gather":           # an untimed capture run
            with SellCapture(ops) as cap:
                ct.run_batched(roots)
        if name == "sell_megakernel":
            kernels_seen = profile_run(ct, roots, name, top=8)
            n_layers = int(base.state.layer)
            got = launches_of(kernels_seen, "sell_layer_fused_kernel")
            assert got == n_layers, \
                f"K9 must be one CUDA launch per layer, saw {got}"
            log(f"sell_megakernel: {n_layers} K9 launches for {n_layers} "
                f"layers")
            with SellCapture(ops) as mega_cap:
                ct.run_batched(roots)
        if name == "sell_persistent":
            kernels_seen = profile_run(ct, roots, name, top=8)
            assert launches_of(kernels_seen,
                               "sell_traversal_fused_kernel") == 1, \
                "K10 must be one CUDA launch per traversal"
            log(f"sell_persistent: 1 K10 launch per traversal; "
                f"{sum(kernels_seen.values()) - 1} other device events "
                f"(initial state)")
            kres["sell_traversal_fused_batched"] = \
                phase_sell_traversal_kernel(ct, roots, mega_cap.layers, 5)
        del ct
    kres.update(phase_sell_kernels(cap.best, g, reps))
    del cap, mega_cap, fmt
    bfs.clear_plan_cache()
    torch.cuda.empty_cache()
    return kres, launches


def profile_run(ct, roots, label: str = "main path", top: int = 15):
    """Trace one run: device time by kernel name and the device's idle
    share of the run's wall time.  Returns {kernel name: launches}."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ct.run_batched(roots)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (kernels, copies), not the host ops that
    # launched them, whose device time would count the same work twice
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")
              and e.self_device_time_total > 0]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = sum(e.self_device_time_total for e in events)
    log(f"profile {label}: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms, idle share {1 - busy_us / wall_us:.4f}, "
        f"{sum(e.count for e in events)} device events")
    for e in events[:top]:
        log(f"  {e.self_device_time_total / 1e3:10.3f} ms  x{e.count:<5d} "
            f"{e.key[:90]}")
    return {e.key: e.count for e in events}


def make_graph(scale: int, seed: int, device: str):
    from repro_torch.core import csr as csr_mod
    from repro_torch.core import rmat
    edges = rmat.generate(seed, scale, 16, device=device)
    g = csr_mod.from_edges(edges, device=device)
    del edges
    return g


def pick_roots(g, n: int, seed: int):
    import torch
    deg = g.degrees().cpu()
    cands = torch.nonzero(deg > 0).flatten()
    gen = torch.Generator().manual_seed(seed)
    pick = torch.randperm(cands.numel(), generator=gen)[:n]
    return cands[pick].tolist()


def trees_ok(g, res, roots, oracle):
    import torch
    import repro_torch.bfs as bfs
    from repro_torch.core.validate import validate
    parents = bfs.parents_graph500(res.state, g.n_vertices)
    for b, r in enumerate(roots):
        v = validate(g, parents[b], r, reference_depth=oracle(r))
        assert v.ok, f"root {r}: tree invalid {v[:7]}"
        assert int(res.depths[b]) == int(v.depth.max()) + 1, \
            f"root {r}: engine depth {int(res.depths[b])} vs tree"
    return parents


def launch_column(per_layer: int, n_layers: int) -> list:
    """The stats launches column of a path: ``per_layer`` wrapper calls
    per layer, or 0 for one launch per traversal (charged to layer 0)."""
    if per_layer == 0:
        return [1] + [0] * (n_layers - 1)
    return [per_layer] * n_layers


def run_path(graph, g, roots, name: str, fields: dict, kernels, per_layer,
             base, oracle, edges: int, stat_cols):
    """Phases 5 and 5b: one path of ``graph`` (the main path's CSR ``g``
    or a SELL layout of it) at the main path's size, counted, timed over
    3 runs and held to the main path's result: visited, frontier,
    depths, layers, the stats columns ``stat_cols`` and the direction
    log; the launches column per `launch_column`; no degrade; each of
    ``kernels`` launched."""
    import torch
    import repro_torch.bfs as bfs
    from repro_torch import errors
    from repro_torch.kernels import ops
    ct = bfs.plan(graph, bfs.TraversalSpec(**fields))
    assert isinstance(ct.resolved.policy, bfs.BeamerHybrid), ct.resolved
    ct.run_batched(roots)                           # warm-up
    torch.cuda.synchronize()
    errors.DEGRADES.clear()
    ops.reset_kernel_launches()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = ct.run_batched(roots)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if len(times) == 1:
            launches = dict(ops.KERNEL_LAUNCHES)
    assert not errors.DEGRADES, f"{name}: degraded: {errors.DEGRADES}"
    for kernel in kernels:
        assert launches[kernel] > 0, f"{name}: {kernel} was never launched"
    n_layers = int(base.state.layer)
    modes = base.stats[:n_layers, 3]
    assert bool((modes != 0).all()), "BeamerHybrid ran a scalar layer"
    cols = list(stat_cols)
    for what, a, b in (("visited", res.state.visited, base.state.visited),
                       ("frontier", res.state.frontier, base.state.frontier),
                       ("depths", res.depths, base.depths),
                       (f"stats columns {cols}", res.stats[:, cols],
                        base.stats[:, cols])):
        assert torch.equal(a, b), f"{name}: {what} differ from the main path"
    assert int(res.state.layer) == n_layers
    assert bfs.direction_log(res) == bfs.direction_log(base)
    col = res.stats[:n_layers, 7].tolist()
    want = launch_column(per_layer, n_layers)
    assert col == want, f"{name}: launches column {col}, expected {want}"
    trees_ok(g, res, roots, oracle)
    log(f"path {name}: {len(roots)} roots, {n_layers} layers, "
        f"{edges} traversed edges, runs {[round(t, 6) for t in times]} s "
        f"-> {edges / times[0]:.6e} TEPS (first run); launches "
        f"{ {k: launches[k] for k in kernels} }; trees valid, "
        f"visited/depths/stats {cols}/direction log equal the main path; "
        f"no degrade")
    return ct, launches, times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=int, default=22,
                    help="R-MAT scale of the main path (22; 20 is the "
                         "only allowed cut)")
    ap.add_argument("--reps", type=int, default=20,
                    help="timed repetitions per kernel")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one main-path run with "
                         "torch.profiler and print device time by kernel")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "smoke test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import repro_torch.bfs as bfs
    from repro_torch import errors
    from repro_torch.core import bfs_serial
    from repro_torch.core.csr import traversed_edges
    from repro_torch.kernels import _build, ops

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {kind} x{torch.cuda.device_count()}")
    if args.scale != 22:
        log(f"CUT: main path at SCALE {args.scale} instead of 22")

    # 2. build
    t0 = time.perf_counter()
    _build.build()
    _build.load()
    log(f"build: {time.perf_counter() - t0:.3f} s")
    for entry in _build.BUILD_LOG:
        for line in entry.splitlines():
            if line.startswith("==") or "registers" in line \
                    or "spill" in line:
                log("  " + line.strip())

    # main-path graph and a capture run (warm-up) for phase 3
    t0 = time.perf_counter()
    g = make_graph(args.scale, args.seed, "cuda")
    torch.cuda.synchronize()
    log(f"graph: SCALE {args.scale} V={g.n_vertices} E={g.n_edges} "
        f"(generated + CSR in {time.perf_counter() - t0:.3f} s)")
    ct = bfs.plan(g, bfs.TraversalSpec())
    r = ct.resolved
    log(f"resolved spec: {r}")
    assert isinstance(r.policy, bfs.BeamerHybrid), r.policy
    assert r.pipeline == "fused_gather" and r.packed \
        and r.prefetch_depth == 0, r
    roots = pick_roots(g, BATCH, args.seed)
    log(f"roots: {roots}")
    with Capture(ops) as cap:
        ct.run_batched(roots)
    torch.cuda.synchronize()

    # 3. kernels vs plain versions; 3b K4; 3c K5; K2/K3 at B = 1
    kres = phase_kernels(cap.best, g.n_vertices, g.n_vertices_padded,
                         args.reps)
    kres["gather_expand_prefetch"] = phase_prefetch(
        cap.best, args.reps, kres["gather_expand_batched"])
    kres["layer_fused_batched"] = phase_layer_fused(
        cap.best, g.n_vertices_padded, args.reps)
    del cap
    torch.cuda.empty_cache()
    with Capture(ops) as cap1:
        ct.run(roots[0])
    torch.cuda.synchronize()
    phase_kernels(cap1.best, g.n_vertices, g.n_vertices_padded,
                  max(5, args.reps // 4), label="_b1")
    del cap1
    torch.cuda.empty_cache()

    # 4. main path (the counted run)
    ops.reset_kernel_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ct.run_batched(roots)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(ops.KERNEL_LAUNCHES)
    more = []
    for _ in range(2):
        t1 = time.perf_counter()
        ct.run_batched(roots)
        torch.cuda.synchronize()
        more.append(time.perf_counter() - t1)
    for s in bfs.layer_stats(res):
        log(f"  {s}")
    log(f"direction_log: {bfs.direction_log(res)}")
    src = torch.repeat_interleave(
        torch.arange(g.n_vertices, device="cuda"), g.degrees().long(),
        output_size=g.n_edges)
    dst = g.rows[:g.n_edges].long()
    oracle_depths = {r: level_bfs_depths(src, dst, g.n_vertices, r)
                     for r in roots}
    parents = trees_ok(g, res, roots, oracle_depths.__getitem__)
    del src, dst
    edges = sum(int(traversed_edges(g, parents[b] >= 0))
                for b in range(len(roots)))
    log(f"main path: {len(roots)} roots, {edges} traversed edges, "
        f"{elapsed:.6f} s -> {edges / elapsed:.6e} TEPS "
        f"(repeat runs {[round(x, 6) for x in more]} s); trees valid, "
        f"depths equal the level-synchronous oracle")
    log(f"peak device memory: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if args.profile:
        profile_run(ct, roots)

    # 5. the fusion paths at the main path's size
    path_launches = {}
    csr_per_layer = {"fused_gather_d2": 3, "persistent": 0}
    for name in PATHS:
        fields, kernel = PATHS[name]
        ct_path, launched, _ = run_path(
            g, g, roots, name, fields, (kernel,),
            csr_per_layer.get(name, 1), res, oracle_depths.__getitem__,
            edges, range(7))
        path_launches[kernel] = launched[kernel]
        if name == "megakernel":
            kernels = profile_run(ct_path, roots, "megakernel", top=8)
            n_layers = int(res.state.layer)
            assert launches_of(kernels, "layer_fused_kernel") == n_layers, \
                "K5 must be one CUDA launch per layer"
            log(f"megakernel: {n_layers} K5 launches for {n_layers} layers")
            with LayerCapture(ops) as fused_layers:
                ct_path.run_batched(roots)
        if name == "persistent":
            kernels = profile_run(ct_path, roots, "persistent", top=8)
            assert launches_of(kernels, "traversal_fused_kernel") == 1, \
                "K6 must be one CUDA launch per traversal"
            log(f"persistent: 1 K6 launch per traversal; "
                f"{sum(kernels.values()) - 1} other device events "
                f"(initial state)")
            kres["traversal_fused_batched"] = phase_persistent_kernel(
                ct_path, roots, fused_layers.layers, 5)
        del ct_path
    del fused_layers
    launches.update(path_launches)

    # 5b. SELL-C-σ at the main path's size
    sell_kres, sell_launches = phase_sell(g, roots, res,
                                          oracle_depths.__getitem__, edges,
                                          args.reps)
    kres.update(sell_kres)
    for name, n in sell_launches.items():
        if not launches.get(name):
            launches[name] = n
    del ct, res, parents, g, oracle_depths
    bfs.clear_plan_cache()
    torch.cuda.empty_cache()

    # 6. four policies at SCALE 16, every pipeline of CSR and SELL
    from repro_torch import formats
    g16 = make_graph(16, args.seed, "cuda")
    sell16 = formats.build(g16, "auto")
    assert isinstance(sell16, formats.SellFormat), type(sell16)
    roots16 = pick_roots(g16, BATCH, args.seed + 1)
    rows_np = g16.rows.cpu().numpy()
    cs_np = g16.colstarts.cpu().numpy()
    ref_depth = {}

    def serial(root):
        if root not in ref_depth:
            ref_depth[root] = bfs_serial.bfs_serial(
                rows_np, cs_np, g16.n_vertices, root)[1]
        return ref_depth[root] if root == roots16[0] else None

    for pol in (bfs.TopDown(), bfs.ThresholdSimd(), bfs.PaperLiteralLayers(),
                bfs.BeamerHybrid()):
        base16 = bfs.plan(g16, bfs.TraversalSpec(policy=pol)) \
            .run_batched(roots16)
        trees_ok(g16, base16, roots16, serial)
        errors.DEGRADES.clear()
        runs = [(g16, fields) for fields, _ in PATHS.values()]
        runs += [(sell16, fields) for fields, _, _ in SELL_PATHS.values()]
        for graph, fields in runs:
            res = bfs.plan(graph, bfs.TraversalSpec(policy=pol, **fields)) \
                .run_batched(roots16)
            trees_ok(g16, res, roots16, serial)
            for what, a, b in (
                    ("visited", res.state.visited, base16.state.visited),
                    ("depths", res.depths, base16.depths),
                    ("stats columns 0-4", res.stats[:, :5],
                     base16.stats[:, :5])):
                assert torch.equal(a, b), \
                    f"{type(pol).__name__} {type(graph).__name__} " \
                    f"{fields}: {what} differ"
            assert bfs.direction_log(res) == bfs.direction_log(base16)
        assert not errors.DEGRADES, errors.DEGRADES
        log(f"policy {type(pol).__name__} @ SCALE 16: trees valid, root 0 "
            f"depths equal bfs_serial, every CSR and SELL pipeline equals "
            f"fused_gather; {bfs.direction_log(base16)}")
    del g16, sell16
    bfs.clear_plan_cache()

    # 7. GPU vs the port's CPU path at SCALE 12
    g12 = make_graph(12, args.seed, "cuda")
    roots12 = pick_roots(g12, BATCH, args.seed + 2)
    g12_cpu = type(g12)(g12.rows.cpu(), g12.colstarts.cpu(),
                        g12.n_vertices, g12.n_edges)
    sell12 = formats.SellFormat.from_csr(g12)
    sell12_cpu = formats.SellFormat.from_csr(g12_cpu)
    for name in ("cols", "slab_rows", "deg"):
        assert torch.equal(getattr(sell12, name).cpu(),
                           getattr(sell12_cpu, name)), \
            f"the SELL layout built on the card differs in {name}"
    log(f"sell layout @ SCALE 12: the card's build equals the CPU build "
        f"({sell12.n_slabs} slabs)")
    for pol in (bfs.TopDown(), bfs.ThresholdSimd(2048),
                bfs.PaperLiteralLayers(), bfs.BeamerHybrid()):
        for layout, (gg, gc) in (("csr", (g12, g12_cpu)),
                                 ("sell", (sell12, sell12_cpu))):
            for pipeline in ("fused_gather", "megakernel", "persistent"):
                spec = bfs.TraversalSpec(policy=pol, pipeline=pipeline)
                a = bfs.plan(gg, spec).run_batched(roots12)
                c = bfs.plan(gc, spec, device="cpu").run_batched(roots12)
                for name, x, y in (("visited", a.state.visited,
                                    c.state.visited),
                                   ("depths", a.depths, c.depths),
                                   ("stats", a.stats, c.stats)):
                    assert torch.equal(x.cpu(), y), \
                        f"{type(pol).__name__} {layout} {pipeline}: GPU " \
                        f"and CPU {name} differ"
                assert bfs.direction_log(a) == bfs.direction_log(c)
        log(f"parity {type(pol).__name__} @ SCALE 12: GPU == CPU "
            f"(visited, depths, stats, direction_log) on fused_gather, "
            f"megakernel and persistent, for CSR and SELL")

    # 8. launch counts of the paths' runs
    log("launch counts (main path, fusion and SELL paths): " + ", ".join(
        f"{k}={v}" for k, v in launches.items()))
    for name, n in launches.items():
        assert n > 0, f"{name} was never launched on the main path"
    leaked = [m for m in sys.modules
              if m == "jax" or m.startswith("jax.") or m == "repro"
              or m.startswith("repro.")]
    assert not leaked, f"imported the JAX package: {leaked[:5]}"

    rows = []
    for name in SOURCES:
        k = kres[name]
        rows.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=k["max_abs_err"], ms=k["ms"],
            plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by="bytes", library_ms=None))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
