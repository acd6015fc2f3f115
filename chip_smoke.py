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
   version's, and its bound;
4. main path: Graph500 R-MAT SCALE 22 / edgefactor 16 from ``--seed``,
   an all-auto plan (must resolve to BeamerHybrid + fused_gather), a
   batch of 8 roots with degree > 0, timed; every tree validated and
   its depths checked against an independent level-synchronous BFS;
5. the four direction policies at SCALE 16, batch 8;
6. GPU vs the port's CPU path at SCALE 12: visited, depths, the stats
   buffer and the direction log must be identical;
7. the kernels' launch counts from the main-path run (all > 0).

Any failure raises and exits non-zero.  Run from the repository root:

    python3 chip_smoke.py [--seed 0] [--scale 22]
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
}
SOURCES = {
    "restoration": "src/repro_torch/kernels/csrc/restoration.cu",
    "frontier_compact_batched": "src/repro_torch/kernels/csrc/compact.cu",
    "gather_expand_batched": "src/repro_torch/kernels/csrc/gather_expand.cu",
}


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
                    out=out.clone(), p=p.clone(), kw=dict(kw))
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


def phase_kernels(cap, n_vertices: int, v_pad: int, reps: int):
    """Phase 3: each kernel against its plain version on the card."""
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
        log(json.dumps({"kernel": name, "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bytes": r["bytes"],
                        "bound_ms": r["bound_ms"],
                        "max_abs_err": r["max_abs_err"]}))
    log(f"K3 layer: {cap['tiles']} active tiles, {n_marked} marked, "
        f"bottom_up={kw['bottom_up']}")
    return results


def profile_run(ct, roots) -> None:
    """Trace one main-path run: device time by kernel name and the
    device's idle share of the run's wall time."""
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
    log(f"profile: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms, idle share {1 - busy_us / wall_us:.4f}")
    for e in events[:15]:
        log(f"  {e.self_device_time_total / 1e3:10.3f} ms  x{e.count:<5d} "
            f"{e.key[:90]}")


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

    # 3. kernels vs plain versions
    kres = phase_kernels(cap.best, g.n_vertices, g.n_vertices_padded,
                         args.reps)
    del cap
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
    parents = trees_ok(
        g, res, roots,
        lambda root: level_bfs_depths(src, dst, g.n_vertices, root))
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
    del ct, res, parents, g
    bfs.clear_plan_cache()
    torch.cuda.empty_cache()

    # 5. four policies at SCALE 16
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
        res = bfs.plan(g16, bfs.TraversalSpec(policy=pol)) \
            .run_batched(roots16)
        trees_ok(g16, res, roots16, serial)
        log(f"policy {type(pol).__name__} @ SCALE 16: trees valid, root 0 "
            f"depths equal bfs_serial; {bfs.direction_log(res)}")
    del g16
    bfs.clear_plan_cache()

    # 6. GPU vs the port's CPU path at SCALE 12
    g12 = make_graph(12, args.seed, "cuda")
    roots12 = pick_roots(g12, BATCH, args.seed + 2)
    g12_cpu = type(g12)(g12.rows.cpu(), g12.colstarts.cpu(),
                        g12.n_vertices, g12.n_edges)
    for pol in (bfs.TopDown(), bfs.ThresholdSimd(2048),
                bfs.PaperLiteralLayers(), bfs.BeamerHybrid()):
        spec = bfs.TraversalSpec(policy=pol)
        a = bfs.plan(g12, spec).run_batched(roots12)
        c = bfs.plan(g12_cpu, spec, device="cpu").run_batched(roots12)
        for name, x, y in (("visited", a.state.visited, c.state.visited),
                           ("depths", a.depths, c.depths),
                           ("stats", a.stats, c.stats)):
            assert torch.equal(x.cpu(), y), \
                f"{type(pol).__name__}: GPU and CPU {name} differ"
        assert bfs.direction_log(a) == bfs.direction_log(c)
        log(f"parity {type(pol).__name__} @ SCALE 12: GPU == CPU "
            f"(visited, depths, stats, direction_log)")

    # 7. launch counts of the main-path run
    log("launch counts (main path): " + ", ".join(
        f"{k}={v}" for k, v in launches.items()))
    for name, n in launches.items():
        assert n > 0, f"{name} was never launched on the main path"
    leaked = [m for m in sys.modules
              if m == "jax" or m.startswith("jax.") or m == "repro"
              or m.startswith("repro.")]
    assert not leaked, f"imported the JAX package: {leaked[:5]}"

    rows = []
    for name in ("restoration", "frontier_compact_batched",
                 "gather_expand_batched"):
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
