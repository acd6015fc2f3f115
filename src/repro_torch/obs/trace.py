"""Span tracer + instrumented host-stepped traversal (a port of
``repro.obs.trace``).

* `SpanTracer` — a context-manager span recorder (nesting:
  traversal → layer → step) that exports Chrome trace-event JSON;
  open ``chrome://tracing`` or https://ui.perfetto.dev and load the
  file.  Spans are wall-clock (``time.perf_counter``); callers pass
  the tensors a span produced to `SpanTracer.device_sync` so its close
  waits for the card's work (CUDA launches are asynchronous).
* `trace_run` — the instrumented traversal: a host Python layer loop
  over the plan's single-layer tick (`CompiledTraversal.layer_step`,
  the same steps the serve tier ticks), so per-layer wall times attach
  to the familiar `LayerStats` rows.  The counters come from the
  measure kernel (one launch per layer, as the host loops run it),
  never from plain-torch counters on the card.
* `torch_profiler` — ``torch.profiler`` around a block, writing a
  Chrome trace into a log directory.  The kernels show under their own
  symbol names (``gather_expand_kernel``, ``restoration_kernel``, ...);
  the wrappers carry no ``record_function`` ranges.

The host-stepped loop pays one device sync per layer — the price of
per-layer timing, and the reason `trace_run` is a separate entry point
instead of a flag on ``run``.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Iterator, NamedTuple

import numpy as np
import torch

from repro_torch.core import engine as _engine
from repro_torch.kernels import ops

#: span names — the chip smoke's gate counts these
TRAVERSAL_SPAN = "bfs.traversal"
LAYER_SPAN = "bfs.layer"
STEP_SPAN = "bfs.layer_step"
#: the whole-traversal persistent pipeline is ONE kernel launch (K6 on
#: CSR, K10 on SELL) — there is no per-layer host boundary to time, so
#: trace_run records ONE span of this name and recovers per-layer
#: counters from the kernel's stats buffer
PERSISTENT_SPAN = "bfs.traversal.persistent"
#: the semiring portfolio (sssp/cc/ksource_bfs) runs its own layer
#: loop with its own carry, so trace_run records ONE span of this name
#: and recovers per-layer counters from that loop's stats buffer
SEMIRING_SPAN = "bfs.traversal.semiring"


@dataclass
class Span:
    """One closed span: microsecond offset + duration relative to the
    tracer's origin, plus free-form ``args`` shown in the trace UI."""
    name: str
    ts_us: float = 0.0
    dur_us: float = 0.0
    tid: int = 1
    args: dict = field(default_factory=dict)


class SpanTracer:
    """Records nested wall-clock spans; exports Chrome trace events.

    Usage::

        tr = SpanTracer()
        with tr.span("bfs.traversal", n_roots=4):
            with tr.span("bfs.layer", layer=0):
                ...work...
        tr.export("obs_trace.json")      # load in Perfetto

    ``sync=True`` (default) makes `device_sync` wait for the card
    (``torch.cuda.synchronize`` on the tensors' device) so spans
    measure finished device work, not launch latency; ``sync=False``
    turns every `device_sync` into a no-op.  On the CPU it does nothing
    either way.
    """

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.spans: list[Span] = []
        self._origin = time.perf_counter()
        self._stack: list[Span] = []

    def _now_us(self) -> float:
        return (time.perf_counter() - self._origin) * 1e6

    @contextlib.contextmanager
    def span(self, name: str, **args: Any) -> Iterator[Span]:
        """Open a span; closes (records duration) on exit.  Extra
        kwargs become the trace event's ``args`` and may be amended on
        the yielded `Span` before exit."""
        s = Span(name, args=dict(args))
        self._stack.append(s)
        s.ts_us = self._now_us()
        try:
            yield s
        finally:
            s.dur_us = self._now_us() - s.ts_us
            self._stack.pop()
            self.spans.append(s)

    def device_sync(self, *tensors) -> None:
        """Wait for the card's work on the tensors' devices so the
        enclosing span's close time is honest.  No-op when the tracer
        was built with ``sync=False`` and for CPU tensors."""
        if not self.sync:
            return
        for dev in {t.device for t in tensors
                    if isinstance(t, torch.Tensor)}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    # -- export ----------------------------------------------------------
    def to_chrome(self) -> dict:
        """Chrome trace-event JSON object (the ``traceEvents`` array
        of complete "X" events).  Nesting is implied by time
        containment on the shared tid — exactly how Perfetto draws
        flame stacks."""
        pid = os.getpid()
        events: list[dict] = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": "repro.bfs"},
        }]
        for s in sorted(self.spans, key=lambda s: s.ts_us):
            events.append({
                "name": s.name, "cat": "bfs", "ph": "X",
                "ts": round(s.ts_us, 3), "dur": round(s.dur_us, 3),
                "pid": pid, "tid": s.tid, "args": s.args,
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        """Write the Chrome trace JSON to ``path``; returns the path."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, indent=1)
        return path

    def __len__(self) -> int:
        return len(self.spans)


@contextlib.contextmanager
def torch_profiler(logdir: str | None):
    """``torch.profiler`` (CPU activity, and CUDA where the card is
    there) around a block, writing its Chrome trace to
    ``logdir/bfs_trace_<pid>_<ns>.json``; a no-op yielding None when
    ``logdir`` is None.  Yields ``logdir``."""
    if logdir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(
        logdir, f"bfs_trace_{os.getpid()}_{time.time_ns()}.json"))


class TraceRun(NamedTuple):
    """What `trace_run` returns: the usual engine outputs plus timing.

    ``stats[i]`` and ``layer_seconds[i]`` describe the same layer —
    the per-layer timing "attached to the LayerStats row".  ``state``
    and ``depths`` match `EngineResult` semantics (unbatched when a
    scalar root was passed)."""
    state: _engine.BfsState
    depths: torch.Tensor                  # (B,) or scalar int32
    stats: list[_engine.LayerStats]
    layer_seconds: list[float]
    tracer: SpanTracer


def _unbatch(state, depths, single: bool):
    if not single:
        return state, depths
    return (_engine.BfsState(state.frontier[0], state.visited[0],
                             state.parent[0], state.layer), depths[0])


def _one_span(ct, roots_b, tracer, profile_logdir, name: str, top_args,
              layer_args):
    """The one-span branches (persistent, semiring): one run, counters
    from its stats buffer (``layer_args(stats)`` adds the span's own
    args), the span's seconds amortized over the recovered layers."""
    with torch_profiler(profile_logdir), \
            tracer.span(name, **top_args) as top:
        res = ct.run_batched(roots_b)
        tracer.device_sync(res.state.parent, res.stats)
        stats = _engine.layer_stats(res)
        top.args["n_layers"] = len(stats)
        top.args["launches"] = sum(s.launches for s in stats)
        top.args.update(layer_args(stats))
    per_layer_s = (top.dur_us / 1e6) / max(len(stats), 1)
    return res, stats, [per_layer_s] * len(stats)


def trace_run(graph, roots, *, spec=None, tracer: SpanTracer | None = None,
              sync: bool = True, profile_logdir: str | None = None,
              device=None) -> TraceRun:
    """Instrumented traversal: per-layer wall-clock spans + counters.

    Runs a host Python layer loop over the plan's single-layer tick —
    `CompiledTraversal.layer_step`, the steps the serve tier ticks — so
    it never perturbs ``run``.  Each layer pays one sync (what buys
    honest timings).  Per-layer Table 1 counters (frontier vertices,
    edges examined, discovered) come from the measure kernel: one
    launch per layer over the new frontier (its count is the layer's
    "discovered" and the next layer's frontier and edges) plus one
    before the first layer; on the CPU its plain version.  The integers
    equal the reference's host recomputation.

    Args:
      graph: a `Csr`/`EdgeList`/`GraphFormat` (planned here) or an
        existing `repro_torch.bfs.CompiledTraversal` (reused).
      roots: int (unbatched result) or sequence (leading root axis).
      spec: optional `TraversalSpec` when ``graph`` is not already a
        plan.  The layer tick runs the spec's fixed SIMD/scalar step
        (``algorithm``); direction *policies* do not apply to the
        host-stepped mode.
      tracer: record into an existing `SpanTracer` (default: a fresh
        one with ``sync=``).
      sync: wait for the card at span close (see `SpanTracer`).
      profile_logdir: also wrap the loop in `torch_profiler`.
      device: where a graph that is not yet a plan is planned (the
        ``plan`` default, ``"cuda"``, when None).

    Returns a `TraceRun`; ``len(stats) == len(layer_seconds)`` == the
    number of layer spans recorded.
    """
    from repro_torch.api.plan import CompiledTraversal, plan as _plan
    if isinstance(graph, CompiledTraversal):
        ct = graph
    else:
        ct = (_plan(graph, spec) if device is None
              else _plan(graph, spec, device=device))
    if ct.mesh is not None:
        raise NotImplementedError(
            "trace_run hosts the single-chip layer tick; mesh-bound "
            "plans have no per-layer step to instrument")
    tracer = tracer if tracer is not None else SpanTracer(sync=sync)
    fmt, rspec = ct.fmt, ct.resolved
    n_vertices, v_pad = fmt.n_vertices, fmt.n_vertices_padded

    single = np.ndim(roots.cpu() if isinstance(roots, torch.Tensor)
                     else roots) == 0
    roots_b = ct._roots(roots)
    n_roots = int(roots_b.shape[0])
    top_args = dict(n_roots=n_roots, format=type(fmt).__name__,
                    pipeline=rspec.pipeline, algorithm=rspec.algorithm,
                    n_vertices=n_vertices)

    if rspec.is_semiring or rspec.pipeline == "persistent":
        if rspec.is_semiring:
            res, stats, layer_seconds = _one_span(
                ct, roots_b, tracer, profile_logdir, SEMIRING_SPAN,
                top_args, lambda st: {"relaxations": sum(
                    s.edges_examined for s in st)})
        else:
            res, stats, layer_seconds = _one_span(
                ct, roots_b, tracer, profile_logdir, PERSISTENT_SPAN,
                top_args, lambda st: {"layers": [
                    {"frontier_vertices": s.frontier_vertices,
                     "edges_examined": s.edges_examined,
                     "discovered": s.discovered} for s in st]})
        state, depths = _unbatch(res.state, res.depths, single)
        return TraceRun(state, depths, stats, layer_seconds, tracer)

    deg = ct.executable.deg_mat.reshape(-1)

    def counters(frontier):
        """The measure kernel's per-root frontier counts and degree
        sums, read once."""
        return ops.measure(frontier, None, deg).per_root[:, :2].cpu()

    stats: list[_engine.LayerStats] = []
    layer_seconds: list[float] = []
    depths = torch.zeros((n_roots,), dtype=torch.int32)

    with torch_profiler(profile_logdir), \
            tracer.span(TRAVERSAL_SPAN, **top_args) as top:
        with tracer.span("bfs.init"):
            frontier, visited, parent = _engine._init_batched(
                roots_b, n_vertices, v_pad)
            tracer.device_sync(frontier, visited, parent)
        per_root = counters(frontier)
        layer = 0
        while layer < rspec.max_layers:
            f_count_b = per_root[:, 0]
            f_count = int(f_count_b.sum())
            if f_count == 0:
                break
            f_edges = int(per_root[:, 1].sum())
            with tracer.span(LAYER_SPAN, layer=layer,
                             frontier_vertices=f_count,
                             edges_examined=f_edges) as lsp:
                with tracer.span(STEP_SPAN, layer=layer):
                    frontier, visited, parent = ct.layer_step(
                        frontier, visited, parent)
                    tracer.device_sync(frontier, visited, parent)
                per_root = counters(frontier)
                discovered = int(per_root[:, 0].sum())
                lsp.args["discovered"] = discovered
            stats.append(_engine.LayerStats(
                layer=layer, frontier_vertices=f_count,
                edges_examined=f_edges, discovered=discovered))
            layer_seconds.append(lsp.dur_us / 1e6)
            depths += (f_count_b > 0).to(torch.int32)
            layer += 1
        top.args["n_layers"] = layer

    dev = frontier.device
    state = _engine.BfsState(frontier, visited, parent,
                             torch.tensor(layer, dtype=torch.int32,
                                          device=dev))
    state, depths = _unbatch(state, depths.to(dev), single)
    return TraceRun(state, depths, stats, layer_seconds, tracer)
