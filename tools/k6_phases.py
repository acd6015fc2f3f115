"""Where K6's time goes in one benchmark cell: a ``--trace 1`` run of
``graphbench.run`` read phase by phase.

    python3 tools/k6_phases.py --workload kron-s25.search8 --seed 7 \
        [--seconds 10] [--calls 16] [--reps 3] [--out FILE]

From the checkout's root, on a machine with a GPU.  The run is the
benchmark's own (`graphbench.run.execute` with ``trace=True``); this
script only keeps its trace and driver and reads, afterwards:

* the readers ``graphbench/metrics/{k6_wait_share,k6_walk_share}.search``
  and ``run_idle_share.search1`` on the traced stretch (the ``.search1``
  K6 readers are the ``.search`` ones);
* the stretch's K6 launches (`repro_torch.obs.trace.PHASES`, the last N
  for the N K6 events of the trace): start-up and the four phases of a
  layer (plan, union, walk, update) in ns and as shares of the stamped
  time, the barrier wait share of each phase, layers a launch and the
  bottom-up ones (stats column 3), the same split by layer direction,
  and the stamped time against the kernel events' durations;
* K6's walk counters (``walked``): in each bottom-up layer the neighbour
  entries tested over the slots of the blocks walked (``examined /
  slots``; the slot walk tested every slot), over all bottom-up layers
  and by layer position;
* the %globaltimer step: the greatest common divisor of the stamps'
  differences;
* the device's idle seconds inside each of the port's per-call ranges;
* before the window, the cost of tracing: K6's device time a call by
  CUDA events around the launch, over the first ``--calls`` batches,
  ``--reps`` times each way, untraced (no profiler: null stamp
  pointers) and inside a ``torch.profiler`` session (stamps on).

Prints the result as one JSON line, and appends it to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from graphbench import cells, run, trace as gtrace  # noqa: E402

K6 = "traversal_fused"
READERS = ("k6_wait_share.search", "k6_walk_share.search",
           "run_idle_share.search1")
MODES = {0: "scalar", 1: "simd", 2: "bottom-up"}


def is_k6(name: str) -> bool:
    return "traversal_fused_kernel" in name and "sell_" not in name


def tracing_cost(driver, calls: int, reps: int) -> dict:
    """K6's device ms a call, untraced and traced, by CUDA events
    around each launch, on the same batches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import traversal_fused as tf
    launch = tf.traversal_fused_cuda
    pairs: list = []

    def timed(*args, **kw):
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        out = launch(*args, **kw)
        end.record()
        pairs.append((start, end))
        return out

    n = min(calls, len(driver.batches))
    ms = {"untraced": [], "traced": []}
    tf.traversal_fused_cuda = timed
    try:
        for _ in range(reps):
            for way in ("untraced", "traced"):
                pairs.clear()
                if way == "traced":
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]):
                        for j in range(n):
                            driver._call(j)
                        torch.cuda.synchronize()
                else:
                    for j in range(n):
                        driver._call(j)
                    torch.cuda.synchronize()
                ms[way] += [s.elapsed_time(e) for s, e in pairs]
    finally:
        tf.traversal_fused_cuda = launch
    u, t = float(np.mean(ms["untraced"])), float(np.mean(ms["traced"]))
    return {"calls": n, "reps": reps, "untraced_ms": u, "traced_ms": t,
            "overhead": t / u - 1.0,
            "untraced_spread": _spread(ms["untraced"]),
            "traced_spread": _spread(ms["traced"])}


def _spread(values) -> float:
    import statistics
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def walk_counts(launches) -> dict | None:
    """``examined / slots`` of the bottom-up layers of the launches that
    carry K6's walk counters: over all of them and by layer position
    (None where no launch carries them)."""
    got = [p for p in launches if p.walked is not None]
    if not got:
        return None
    by_layer: dict = {}
    for p in got:
        for l in range(p.layers):
            if int(p.modes[l]) != 2:
                continue
            row = by_layer.setdefault(l, [0, 0])
            row[0] += int(p.walked[l, 0])
            row[1] += int(p.walked[l, 1])
    examined = sum(e for e, _ in by_layer.values())
    slots = sum(s for _, s in by_layer.values())
    return {"examined": examined, "slots": slots,
            "examined_over_slots": examined / slots if slots else None,
            "by_layer": [{"layer": l, "examined": e, "slots": s,
                          "examined_over_slots": e / s if s else None}
                         for l, (e, s) in sorted(by_layer.items())]}


def phase_table(trace, launches) -> dict:
    """The K6 launches of the stretch, phase by phase."""
    from repro_torch.obs.trace import LAYER_PHASES
    events = sorted((ts, dur) for ts, dur, name, cat in trace.device
                    if cat == "kernel" and is_k6(name))
    out: dict = {"launches": len(launches), "k6_events": len(events)}
    if not launches:
        return out
    span = sum(p.span_ns for p in launches)
    startup = sum(p.startup_ns for p in launches)
    by_phase = np.sum([p.layer_ns.sum(axis=0) for p in launches], axis=0)
    cycles = sum(p.cta_cycles for p in launches)
    waits = np.sum([p.wait_cycles[:-1].sum(axis=0) for p in launches],
                   axis=0)
    wait_startup = sum(int(p.wait_cycles[-1].sum()) for p in launches)
    out["span_s"] = span / 1e9
    out["share"] = {"startup": startup / span,
                    **{k: float(v) / span
                       for k, v in zip(LAYER_PHASES, by_phase)}}
    out["wait_share"] = {
        "all": sum(p.wait_total for p in launches) / cycles,
        "startup": wait_startup / cycles,
        **{k: float(v) / cycles for k, v in zip(LAYER_PHASES, waits)}}
    out["layers_per_launch"] = float(np.mean([p.layers for p in launches]))
    out["bottom_up_per_launch"] = float(np.mean(
        [int((p.modes == 2).sum()) for p in launches]))
    out["ctas"] = sorted({p.ctas for p in launches})
    out["grid"] = sorted({p.grid for p in launches})
    by_mode: dict = {}
    for p in launches:
        for l in range(p.layers):
            m = MODES.get(int(p.modes[l]), str(int(p.modes[l])))
            row = by_mode.setdefault(m, {"layers": 0, "ns": np.zeros(4),
                                         "wait": 0})
            row["layers"] += 1
            row["ns"] += p.layer_ns[l]
            row["wait"] += int(p.wait_cycles[l].sum())
    out["by_direction"] = {
        m: {"layers": r["layers"], "share_of_span": float(r["ns"].sum())
            / span, **{k: float(v) / float(r["ns"].sum())
                       for k, v in zip(LAYER_PHASES, r["ns"])},
            "wait_share_of_all_cycles": r["wait"] / cycles}
        for m, r in by_mode.items()}
    # each layer's position: ns of its four phases, summed over launches
    depth = max(p.layers for p in launches)
    per_layer = np.zeros((depth, 4))
    modes = [set() for _ in range(depth)]
    for p in launches:
        per_layer[:p.layers] += p.layer_ns
        for l in range(p.layers):
            modes[l].add(MODES.get(int(p.modes[l])))
    out["by_layer_ms_per_launch"] = [
        {"layer": l, "modes": sorted(m for m in modes[l] if m),
         **{k: float(v) / len(launches) / 1e6
            for k, v in zip(LAYER_PHASES, per_layer[l])}}
        for l in range(depth)]
    out["bottom_up_walked"] = walk_counts(launches)
    # stamps against the kernel events, in launch order
    if len(events) == len(launches):
        dur = np.asarray([d for _, d in events]) * 1e3          # ns
        ext = np.asarray([p.span_ns for p in launches], dtype=float)
        out["stamped_over_event"] = float(ext.sum() / dur.sum())
        out["extent_minus_event_ns_max"] = float((ext - dur).max())
    steps = np.concatenate([np.diff(p.stamps_ns) for p in launches])
    steps = steps[steps > 0].astype(np.int64)
    out["globaltimer_step_ns"] = int(np.gcd.reduce(steps)) if len(steps) \
        else None
    out["smallest_stamp_step_ns"] = int(steps.min()) if len(steps) else None
    return out


def idle_in_ranges(trace) -> dict:
    """Seconds of the stretch in which the device was idle while the
    host was inside each per-call range (``bfs.roots``, ``bfs.init``,
    ``bfs.launch``), and inside ``bfs.run`` but none of those."""
    import importlib.util
    from repro_torch.obs.trace import CALL_RANGES, RUN_RANGE
    spec = importlib.util.spec_from_file_location(
        "run_idle_share", ROOT / "graphbench" / "metrics"
        / "run_idle_share.search1.py")
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    lo, hi = trace.t0_us, trace.t0_us + trace.window_s * 1e6
    edges = [lo, *trace.intervals().reshape(-1).tolist(), hi]
    idle = [[s, e] for s, e in zip(edges[::2], edges[1::2]) if e > s]
    out = {}
    for name in CALL_RANGES:
        iv = reader._merged((max(ts, lo), min(ts + dur, hi))
                            for ts, dur, n in trace.host if n == name)
        out[name] = reader._overlap(iv, idle) / 1e6
    out["bfs.run only"] = out[RUN_RANGE] - sum(
        v for k, v in out.items() if k != RUN_RANGE)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--calls", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    from repro_torch.obs.trace import PHASES, read_phases
    cell = cells.resolve(args.workload)
    kept: dict = {}
    make_driver, profile = run.make_driver, gtrace.profile

    def keep_driver(*a, **kw):
        kept["driver"] = make_driver(*a, **kw)
        return kept["driver"]

    def keep_trace(*a, **kw):
        kept["trace"] = profile(*a, **kw)
        return kept["trace"]

    def before_window():
        kept["cost"] = tracing_cost(kept["driver"], args.calls, args.reps)

    run.make_driver, gtrace.profile = keep_driver, keep_trace
    try:
        out = run.execute(cell, args.seed, args.seconds, True,
                          after_setup=before_window)
    finally:
        run.make_driver, gtrace.profile = make_driver, profile
    trace = kept["trace"]
    rec = run.Record(trace=trace)
    metrics = {}
    for name in READERS:
        read = cells.load_reader(ROOT / "graphbench" / "metrics"
                                 / f"{name}.py")
        metrics[name] = read(rec)
    n = sum(1 for _, _, name, cat in trace.device
            if cat == "kernel" and is_k6(name))
    launches = [read_phases(x) for x in PHASES.last(K6, n)]
    row = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(),
           "correct": out["correct"], "checks": out["checks"],
           "metrics": {k: v["value"] for k, v in out["metrics"].items()},
           "new_metrics": metrics,
           "busy_s": out["device"].get("busy_s"),
           "window_s": out["device"].get("window_s"),
           "idle_gaps": out.get("breakdown", {}).get("idle_gaps"),
           "tracing_cost": kept["cost"],
           "idle_s_in_ranges": idle_in_ranges(trace),
           "phases": phase_table(trace, launches)}
    print(json.dumps(row, default=_plain))
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(row, default=_plain) + "\n")
    return 0 if out["correct"] else 1


def _plain(x):
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return None if math.isnan(x) else float(x)
    if isinstance(x, np.ndarray):
        return x.tolist()
    raise TypeError(type(x))


if __name__ == "__main__":
    sys.exit(main())
