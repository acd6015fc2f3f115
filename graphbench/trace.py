"""The traced stretch of a run: ``torch.profiler`` over a callable, read
back from its Chrome trace into device intervals and host spans.

Device time counts kernels, copies and memsets.  An idle gap is a
stretch of the window in which no device event ran; it is named by
what the host was doing at its middle: the innermost ``graphbench.*``
range of the harness and the innermost host event (an operator or a
CUDA runtime call) there.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from contextlib import nullcontext
from dataclasses import dataclass

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "graphbench.window"
#: empty CUPTI sessions have been seen on the card: trace again
SESSIONS = 3
#: gaps named one by one; the rest of the idle time is "short gaps"
NAMED_GAPS = 2000


@dataclass
class Trace:
    window_s: float
    t0_us: float                  # the window's start in the trace
    device: list[tuple]           # (ts_us, dur_us, name, cat)
    host: list[tuple]             # (ts_us, dur_us, name)

    def device_s(self, cats=DEVICE_CATS) -> float:
        return sum(d for _, d, _, c in self.device if c in cats) / 1e6

    def intervals(self) -> np.ndarray:
        """Merged (start, end) device intervals, µs, clipped to the
        window."""
        if not self.device:
            return np.zeros((0, 2))
        iv = sorted((max(t, self.t0_us),
                     min(t + d, self.t0_us + self.window_s * 1e6))
                    for t, d, _, _ in self.device)
        merged = [list(iv[0])]
        for s, e in iv[1:]:
            if s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return np.asarray([m for m in merged if m[1] > m[0]])

    def busy_s(self) -> float:
        iv = self.intervals()
        return float((iv[:, 1] - iv[:, 0]).sum()) / 1e6 if len(iv) else 0.0

    def device_ops(self, top: int = 10) -> list:
        by: dict[str, float] = {}
        for _, d, name, _ in self.device:
            by[name] = by.get(name, 0.0) + d / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        iv = self.intervals()
        end = self.t0_us + self.window_s * 1e6
        starts = np.concatenate([[self.t0_us], iv[:, 1]]) if len(iv) \
            else np.asarray([self.t0_us])
        ends = np.concatenate([iv[:, 0], [end]]) if len(iv) \
            else np.asarray([end])
        gap = ends - starts
        keep = gap > 0
        starts, gap = starts[keep], gap[keep]
        order = np.argsort(-gap)
        named, rest = order[:NAMED_GAPS], order[NAMED_GAPS:]
        h_ts = np.asarray([h[0] for h in self.host])
        h_end = h_ts + np.asarray([h[1] for h in self.host])
        h_dur = np.asarray([h[1] for h in self.host])
        is_ours = np.asarray([h[2].startswith("graphbench.")
                              for h in self.host])
        by: dict[str, float] = {}
        for i in named:
            mid = starts[i] + gap[i] / 2
            on = (h_ts <= mid) & (h_end > mid) if len(h_ts) else \
                np.zeros(0, bool)
            label = "host idle"
            if on.any():
                idx = np.nonzero(on)[0]
                inner = idx[np.argmin(h_dur[idx])]
                ours = idx[is_ours[idx]]
                outer = (self.host[ours[np.argmin(h_dur[ours])]][2]
                         if len(ours) else "")
                label = self.host[inner][2]
                if outer and outer != label:
                    label = f"{outer}/{label}"
            by[label] = by.get(label, 0.0) + float(gap[i]) / 1e6
        if len(rest):
            by["short gaps"] = float(gap[rest].sum()) / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:top]


def _read(path: str) -> tuple[list, list, tuple | None]:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, host, window = [], [], None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat", ""), float(e["ts"]), float(e["dur"])
        if cat in DEVICE_CATS:
            device.append((ts, dur, e["name"], cat))
        elif cat in HOST_CATS:
            host.append((ts, dur, e["name"]))
            if e["name"] == WINDOW:
                window = (ts, dur)
    return device, host, window


def profile(fn, sync) -> Trace:
    """Run ``fn`` once under the profiler, inside a ``graphbench.window``
    range ended by ``sync()``; trace again (up to `SESSIONS` times)
    where the session recorded no device event."""
    import torch
    from torch.profiler import ProfilerActivity, record_function
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    trace = None
    for _ in range(SESSIONS):
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                with record_function(WINDOW):
                    fn()
                    sync()
                wall = time.perf_counter() - t0
            prof.export_chrome_trace(path)
            device, host, window = _read(path)
        t0_us, dur_us = window if window else (
            min((h[0] for h in host), default=0.0), wall * 1e6)
        trace = Trace(dur_us / 1e6, t0_us, device, host)
        if device:
            break
    return trace


def span(name: str, on: bool):
    """A ``graphbench.<name>`` range while traced, else nothing."""
    if not on:
        return nullcontext()
    from torch.profiler import record_function
    return record_function("graphbench." + name)
