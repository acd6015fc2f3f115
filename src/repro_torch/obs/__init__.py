"""Observability — spans, metrics, and the analytic bytes model (a port
of ``repro.obs``).

* `obs.trace`      — span tracer (traversal → layer → step nesting,
  wall clock + optional device sync) exporting Chrome trace-event
  JSON, the host-stepped instrumented traversal (`trace_run`) over the
  plan's `layer_step`, `torch_profiler`, which takes the place of
  the reference's ``xla_profiler``, and the main path's own tracing
  while a profiler records (`traced_call`: the ``bfs.*`` ranges of a
  call and the K6 / K10 phase stamps that `PHASES` keeps).
* `obs.metrics`    — process-local counters/gauges/histograms with a
  JSON snapshot and Prometheus-style text exposition; the serve tier
  records latency, tick time, queue depth and slot occupancy through
  it, and `record_degrade` is the port's one emission point for
  degrades.
* `obs.cost_drift` — the analytic `layer_bytes` models against what
  the plan's single-layer tick moves, counted by
  `roofline.hlo_analyze` (`measure_drift`), per (format, pipeline).
"""
from repro_torch.obs.cost_drift import Drift, drift_rows, measure_drift
from repro_torch.obs.metrics import (Counter, DegradeEvent, Gauge, Histogram,
                                     MetricsRegistry, clear_degrade_log,
                                     degrade_log, get_registry,
                                     record_degrade)
from repro_torch.obs.trace import (SpanTracer, TraceRun, torch_profiler,
                                   trace_run)

__all__ = [
    "Counter",
    "DegradeEvent",
    "Drift",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "SpanTracer",
    "TraceRun",
    "clear_degrade_log",
    "degrade_log",
    "drift_rows",
    "get_registry",
    "measure_drift",
    "record_degrade",
    "torch_profiler",
    "trace_run",
]
