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
  symbol names (``gather_expand_kernel``, ``restoration_kernel``, ...).
* `traced_call`, `call_range` and `PHASES` — the main path's own
  tracing, on exactly while a ``torch.profiler`` session records
  (tested once a `CompiledTraversal.run` / ``run_batched`` call): the
  call runs inside a ``bfs.run`` range with ``bfs.roots`` (root checks
  and upload), ``bfs.init`` (the batch's initial state) and
  ``bfs.launch`` (the whole-traversal wrapper's buffers and launch)
  inside it, on the profiler's clock beside the kernels, and each K6 /
  K10 launch writes phase stamps and barrier waits
  (``kernels/csrc/traversal_loop.cuh``) into small device buffers that
  `KernelPhases` keeps, unread, until the caller has synced
  (`read_phases` decodes one launch on the host).

The host-stepped loop pays one device sync per layer — the price of
per-layer timing, and the reason `trace_run` is a separate entry point
instead of a flag on ``run``.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
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
#: counters from the kernel's stats buffer and, on the card, per-layer
#: seconds from its phase stamps
PERSISTENT_SPAN = "bfs.traversal.persistent"
#: the semiring portfolio (sssp/cc/ksource_bfs) runs its own layer
#: loop with its own carry, so trace_run records ONE span of this name
#: and recovers per-layer counters from that loop's stats buffer
SEMIRING_SPAN = "bfs.traversal.semiring"
#: the per-call profiler ranges of `traced_call` and `call_range`
RUN_RANGE = "bfs.run"
ROOTS_RANGE = "bfs.roots"
INIT_RANGE = "bfs.init"
LAUNCH_RANGE = "bfs.launch"
CALL_RANGES = (RUN_RANGE, ROOTS_RANGE, INIT_RANGE, LAUNCH_RANGE)
#: the latest K6 / K10 launches `PHASES` keeps
PHASES_CAP = 4096
#: a layer's phases in the whole-traversal loop, each ended by a grid
#: barrier
LAYER_PHASES = ("plan", "union", "walk", "update")


def stamp_count(max_layers: int) -> int:
    """Stamps of a launch: entry, 2 start-up barriers, 4 a layer."""
    return 3 + 4 * max_layers


def wait_count(max_layers: int) -> int:
    """Wait slots of a launch: 4 barriers for each layer and the
    start-up, then the CTAs' summed cycles and their number."""
    return 4 * (max_layers + 1) + 2


def walked_count(max_layers: int) -> int:
    """K6's walk counters of a launch: for each layer, the neighbour
    entries its bottom-up walk tested and the slots of the blocks it
    walked (both 0 on a top-down or scalar layer)."""
    return 2 * max_layers


class Launch(NamedTuple):
    """One traced K6 / K10 launch, its tensors still on the device:
    ``kernel`` is ``"traversal_fused"`` (K6) or
    ``"sell_traversal_fused"`` (K10); ``stamps`` (`stamp_count`) and
    ``waits`` (`wait_count`, uint64 bits in int64) are the kernel's
    tracing buffers, ``stats`` (max_layers, 8) and ``layers`` (1,) its
    outputs; ``walked`` (`walked_count`, K6 only, else None) its
    bottom-up walk's counters."""
    kernel: str
    n_batch: int
    grid: int
    max_layers: int
    stamps: torch.Tensor
    waits: torch.Tensor
    stats: torch.Tensor
    layers: torch.Tensor
    walked: torch.Tensor | None = None


class Phases(NamedTuple):
    """One launch read on the host (`read_phases`).  ``stamps_ns`` are
    the stamps written (%globaltimer ns: entry, the 2 start-up barriers,
    4 a layer); ``layer_ns[l]`` the layer's `LAYER_PHASES`, each from
    the stamp before to the stamp after its barrier; ``wait_cycles``
    (layers + 1, 4) every CTA's summed barrier waits, the last row the
    start-up's; ``cta_cycles`` every CTA's entry-to-exit cycles, summed
    over ``ctas`` CTAs; ``modes`` the layers' stats column 3;
    ``walked`` (layers, 2) each layer's bottom-up neighbour entries
    tested and slots walked (K6), else None."""
    kernel: str
    n_batch: int
    grid: int
    stamps_ns: np.ndarray
    layer_ns: np.ndarray
    wait_cycles: np.ndarray
    cta_cycles: int
    ctas: int
    modes: np.ndarray
    walked: np.ndarray | None = None

    @property
    def layers(self) -> int:
        return len(self.layer_ns)

    @property
    def startup_ns(self) -> int:
        """Entry to the stamp after the second start-up barrier."""
        return int(self.stamps_ns[2] - self.stamps_ns[0])

    @property
    def span_ns(self) -> int:
        """Entry to the last stamp."""
        return int(self.stamps_ns[-1] - self.stamps_ns[0])

    @property
    def walk_ns(self) -> int:
        return int(self.layer_ns[:, LAYER_PHASES.index("walk")].sum())

    @property
    def wait_total(self) -> int:
        """Every CTA's waits at every barrier, in cycles."""
        return int(self.wait_cycles.sum())

    def layer_seconds(self) -> list[float]:
        """Each layer from the stamp after the previous layer's last
        barrier (the start-up's for layer 0) to the stamp after its
        own."""
        return [float(ns) / 1e9 for ns in self.layer_ns.sum(axis=1)]


def read_phases(launch: Launch) -> Phases:
    """Copy one launch's buffers to the host and decode them (after the
    caller's sync)."""
    layers = int(launch.layers.cpu()[0])
    stamps = launch.stamps.cpu().numpy()[:stamp_count(layers)]
    waits = launch.waits.cpu().numpy().view(np.uint64)
    m = launch.max_layers
    wait_cycles = np.concatenate(
        [waits[:4 * layers].reshape(layers, 4), waits[4 * m:4 * m + 4][None]])
    walked = None
    if launch.walked is not None:
        walked = launch.walked.cpu().numpy().view(np.uint64)[
            :2 * layers].reshape(layers, 2)
    return Phases(launch.kernel, launch.n_batch, launch.grid, stamps,
                  np.diff(stamps[2:]).reshape(layers, 4), wait_cycles,
                  int(waits[4 * (m + 1)]), int(waits[4 * (m + 1) + 1]),
                  launch.stats[:layers, 3].cpu().numpy(), walked)


def align_us(phases: Phases, event_ts_us: float) -> np.ndarray:
    """The stamps on a profiler trace's clock (µs): the entry stamp at
    the launch's kernel event ``ts``, the others at their offsets."""
    return event_ts_us + (phases.stamps_ns - phases.stamps_ns[0]) / 1e3


class KernelPhases:
    """The latest `PHASES_CAP` traced K6 / K10 launches, in launch
    order.  The wrappers record a launch while `on` (inside a traced
    call or `recording`): `buffers` gives its zeroed device buffers and
    `add` keeps them with its outputs; nothing is copied to the host.
    ``added`` counts every launch ever added."""

    def __init__(self, cap: int = PHASES_CAP):
        self.launches: collections.deque[Launch] = collections.deque(
            maxlen=cap)
        self.added = 0
        self._local = threading.local()
        self._lock = threading.Lock()

    @property
    def on(self) -> bool:
        return getattr(self._local, "on", False)

    @contextlib.contextmanager
    def recording(self):
        """Record this thread's K6 / K10 launches inside the block."""
        prev = self.on
        self._local.on = True
        try:
            yield self
        finally:
            self._local.on = prev

    @staticmethod
    def buffers(max_layers: int, device) -> tuple:
        """Zeroed (stamps, waits) for one launch, one allocation."""
        n = stamp_count(max_layers)
        buf = torch.zeros((n + wait_count(max_layers),), dtype=torch.int64,
                          device=device)
        return buf[:n], buf[n:]

    @staticmethod
    def walked_buffer(max_layers: int, device) -> torch.Tensor:
        """K6's zeroed walk counters (`walked_count`) for one launch."""
        return torch.zeros((walked_count(max_layers),), dtype=torch.int64,
                           device=device)

    def add(self, kernel: str, n_batch: int, grid: int, max_layers: int,
            stamps, waits, stats, layers, walked=None) -> None:
        with self._lock:
            self.launches.append(Launch(kernel, n_batch, grid, max_layers,
                                        stamps, waits, stats, layers,
                                        walked))
            self.added += 1

    def last(self, kernel: str, n: int) -> list[Launch]:
        """The latest ``n`` launches of ``kernel`` kept (fewer where
        fewer were)."""
        if n <= 0:
            return []
        with self._lock:
            kept = list(self.launches)
        return [x for x in kept if x.kernel == kernel][-n:]


PHASES = KernelPhases()


def traced_call(fn, *args):
    """``fn(*args)`` as one `CompiledTraversal.run` / ``run_batched``
    call: while a ``torch.profiler`` session records (the one test a
    call makes), inside a `RUN_RANGE` range with its K6 / K10 launches
    recorded into `PHASES`; else the bare call."""
    if not torch._C._autograd._profiler_enabled():
        return fn(*args)
    from torch.profiler import record_function
    with PHASES.recording(), record_function(RUN_RANGE):
        return fn(*args)


def call_range(name: str):
    """A profiler range ``name`` inside a traced call, else nothing."""
    if not PHASES.on:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(name)


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
    args).  The run records its K6 / K10 launch, and where one ran (a
    persistent plan on the card) each layer's seconds are its stamped
    ones; elsewhere (the plain versions on the CPU, a degraded or
    semiring run) the span's seconds are split evenly over the layers,
    which is no measurement."""
    added = PHASES.added
    with torch_profiler(profile_logdir), \
            tracer.span(name, **top_args) as top:
        with PHASES.recording():
            res = ct.run_batched(roots_b)
        tracer.device_sync(res.state.parent, res.stats)
        stats = _engine.layer_stats(res)
        top.args["n_layers"] = len(stats)
        top.args["launches"] = sum(s.launches for s in stats)
        top.args.update(layer_args(stats))
    if PHASES.added > added:
        seconds = read_phases(PHASES.launches[-1]).layer_seconds()
        if len(seconds) == len(stats):
            return res, stats, seconds
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

    deg = ct.fmt.degree_matrix().reshape(-1)

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
