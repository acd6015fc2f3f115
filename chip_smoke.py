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
6. the four direction policies at SCALE 16, batch 8, on every pipeline;
7. GPU vs the port's CPU path at SCALE 12: visited, depths, the stats
   buffer and the direction log must be identical;
8. the kernels' launch counts from their paths' runs (all > 0).

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
}
CSRC = "src/repro_torch/kernels/csrc/"
SOURCES = {
    "restoration": CSRC + "restoration.cu",
    "frontier_compact_batched": CSRC + "compact.cu",
    "gather_expand_batched": CSRC + "gather_expand.cu",
    "gather_expand_prefetch": CSRC + "gather_expand.cu",
    "layer_fused_batched": CSRC + "layer_fused.cu",
    "traversal_fused_batched": CSRC + "traversal_fused.cu",
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
PREFETCH_DEPTHS = (1, 2, 4)


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


def run_path(g, roots, name: str, base, oracle, edges: int):
    """Phase 5: one fusion path at the main path's size, counted, timed
    over 3 runs and held to the main path's result."""
    import torch
    import repro_torch.bfs as bfs
    from repro_torch import errors
    from repro_torch.kernels import ops
    fields, kernel = PATHS[name]
    ct = bfs.plan(g, bfs.TraversalSpec(**fields))
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
    assert launches[kernel] > 0, f"{name}: {kernel} was never launched"
    n_layers = int(base.state.layer)
    modes = base.stats[:n_layers, 3]
    assert bool((modes != 0).all()), "BeamerHybrid ran a scalar layer"
    for what, a, b in (("visited", res.state.visited, base.state.visited),
                       ("frontier", res.state.frontier, base.state.frontier),
                       ("depths", res.depths, base.depths),
                       ("stats columns 0-6", res.stats[:, :7],
                        base.stats[:, :7])):
        assert torch.equal(a, b), f"{name}: {what} differ from fused_gather"
    assert int(res.state.layer) == n_layers
    assert bfs.direction_log(res) == bfs.direction_log(base)
    col = res.stats[:n_layers, 7].tolist()
    want = {"persistent": [1] + [0] * (n_layers - 1),
            "fused_gather_d2": [3] * n_layers}.get(name, [1] * n_layers)
    assert col == want, f"{name}: launches column {col}, expected {want}"
    trees_ok(g, res, roots, oracle)
    log(f"path {name}: {len(roots)} roots, {n_layers} layers, "
        f"{edges} traversed edges, runs {[round(t, 6) for t in times]} s "
        f"-> {edges / times[0]:.6e} TEPS (first run); {kernel} launches "
        f"{launches[kernel]}; trees valid, visited/depths/stats/direction "
        f"log equal fused_gather; no degrade")
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
    for name in PATHS:
        ct_path, launched, _ = run_path(g, roots, name, res,
                                        oracle_depths.__getitem__, edges)
        path_launches[PATHS[name][1]] = launched[PATHS[name][1]]
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
    del ct, res, parents, g, oracle_depths
    bfs.clear_plan_cache()
    torch.cuda.empty_cache()

    # 6. four policies at SCALE 16, every pipeline
    g16 = make_graph(16, args.seed, "cuda")
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
        for fields, _ in PATHS.values():
            res = bfs.plan(g16, bfs.TraversalSpec(policy=pol, **fields)) \
                .run_batched(roots16)
            trees_ok(g16, res, roots16, serial)
            for what, a, b in (
                    ("visited", res.state.visited, base16.state.visited),
                    ("depths", res.depths, base16.depths),
                    ("stats columns 0-4", res.stats[:, :5],
                     base16.stats[:, :5])):
                assert torch.equal(a, b), \
                    f"{type(pol).__name__} {fields}: {what} differ"
            assert bfs.direction_log(res) == bfs.direction_log(base16)
        assert not errors.DEGRADES, errors.DEGRADES
        log(f"policy {type(pol).__name__} @ SCALE 16: trees valid, root 0 "
            f"depths equal bfs_serial, every pipeline equals fused_gather; "
            f"{bfs.direction_log(base16)}")
    del g16
    bfs.clear_plan_cache()

    # 7. GPU vs the port's CPU path at SCALE 12
    g12 = make_graph(12, args.seed, "cuda")
    roots12 = pick_roots(g12, BATCH, args.seed + 2)
    g12_cpu = type(g12)(g12.rows.cpu(), g12.colstarts.cpu(),
                        g12.n_vertices, g12.n_edges)
    for pol in (bfs.TopDown(), bfs.ThresholdSimd(2048),
                bfs.PaperLiteralLayers(), bfs.BeamerHybrid()):
        for pipeline in ("fused_gather", "megakernel", "persistent"):
            spec = bfs.TraversalSpec(policy=pol, pipeline=pipeline)
            a = bfs.plan(g12, spec).run_batched(roots12)
            c = bfs.plan(g12_cpu, spec, device="cpu").run_batched(roots12)
            for name, x, y in (("visited", a.state.visited,
                                c.state.visited),
                               ("depths", a.depths, c.depths),
                               ("stats", a.stats, c.stats)):
                assert torch.equal(x.cpu(), y), \
                    f"{type(pol).__name__} {pipeline}: GPU and CPU " \
                    f"{name} differ"
            assert bfs.direction_log(a) == bfs.direction_log(c)
        log(f"parity {type(pol).__name__} @ SCALE 12: GPU == CPU "
            f"(visited, depths, stats, direction_log) on fused_gather, "
            f"megakernel and persistent")

    # 8. launch counts of the paths' runs
    log("launch counts (main path and fusion paths): " + ", ".join(
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
