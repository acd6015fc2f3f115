"""Process-local metrics registry: counters, gauges, histograms (a copy
of ``repro.obs.metrics``; pure Python, no torch).

The serve tier's operational truth lives here — per-query
submit→harvest latency, tick duration, queue depth, slot occupancy —
so one snapshot shows the serving distributions next to the degrade
counters that explain them.

Deliberately dependency-free and synchronous (this is a single-process
engine; the registry is the in-process end of the pipe a real
deployment would scrape).  Two export forms:

* `MetricsRegistry.snapshot()` — a JSON-ready dict that round-trips
  through ``json.dumps``/``loads`` unchanged (the obs-smoke contract);
* `MetricsRegistry.to_prometheus()` — Prometheus-style text
  exposition (counters/gauges as samples, histograms as summaries
  with p50/p90/p99 quantile samples plus ``_count``/``_sum``).

Histograms keep a bounded reservoir of the most recent
``RESERVOIR_SIZE`` observations for quantiles (exact until the cap,
sliding-window after) while ``count``/``sum``/``min``/``max`` stay
exact over the full stream.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import logging
import math
import threading
import time
from typing import Iterator

RESERVOIR_SIZE = 4096

#: quantiles exported by snapshots and the text exposition
QUANTILES = (0.5, 0.9, 0.99)


class Counter:
    """Monotonically increasing counter."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(
                f"counter {self.name!r} cannot decrease (inc by "
                f"{amount}); use a Gauge for values that go down")
        self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Last-write-wins instantaneous value."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0

    def set(self, value: float) -> None:
        self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self._value -= amount

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Streaming distribution with exact count/sum/min/max and
    reservoir-backed quantiles (`QUANTILES`)."""

    def __init__(self, name: str, help: str = "",
                 reservoir: int = RESERVOIR_SIZE):
        self.name = name
        self.help = help
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._window: collections.deque = collections.deque(
            maxlen=reservoir)

    def observe(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.sum += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        self._window.append(value)

    def time(self) -> "_Timer":
        """``with hist.time(): ...`` observes the block's wall
        seconds."""
        return _Timer(self)

    def percentile(self, p: float) -> float:
        """p in [0, 1]; nearest-rank over the reservoir window (NaN
        when nothing has been observed)."""
        if not self._window:
            return math.nan
        xs = sorted(self._window)
        idx = min(len(xs) - 1, max(0, math.ceil(p * len(xs)) - 1))
        return xs[idx]

    def summary(self) -> dict:
        d = {"count": self.count,
             "sum": self.sum,
             "min": self.min if self.count else None,
             "max": self.max if self.count else None}
        for q in QUANTILES:
            v = self.percentile(q)
            d[f"p{int(q * 100)}"] = None if math.isnan(v) else v
        return d


class _Timer:
    def __init__(self, hist: Histogram):
        self._hist = hist

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._hist.observe(time.perf_counter() - self._t0)
        return False


class MetricsRegistry:
    """Get-or-create registry of named metrics.

    Names are free-form dotted strings (``serve.tick_s``,
    ``bench.bfs_packed.path_teps``); re-requesting a name returns the
    existing metric, and requesting it as a different type raises
    (one name, one meaning)."""

    def __init__(self):
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help: str, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kwargs)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested as {cls.__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  reservoir: int = RESERVOIR_SIZE) -> Histogram:
        return self._get(Histogram, name, help, reservoir=reservoir)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __iter__(self) -> Iterator[tuple[str, object]]:
        return iter(sorted(self._metrics.items()))

    def clear(self) -> None:
        """Drop every metric (tests)."""
        with self._lock:
            self._metrics.clear()

    # -- export ----------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-ready state: ``{"counters": {...}, "gauges": {...},
        "histograms": {name: {count, sum, min, max, p50, p90, p99}}}``.
        Round-trips through ``json.dumps``/``loads`` unchanged."""
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, m in self:
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            else:
                out["histograms"][name] = m.summary()
        # the round-trip contract, enforced at the source: every value
        # must be JSON-representable (inf/nan would survive dumps but
        # not strict parsers)
        return json.loads(json.dumps(out))

    def to_prometheus(self) -> str:
        """Prometheus text exposition (histograms as summaries)."""
        lines: list[str] = []
        for name, m in self:
            pname = name.replace(".", "_").replace("-", "_")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {pname} counter")
                lines.append(f"{pname} {m.value:g}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {pname} gauge")
                lines.append(f"{pname} {m.value:g}")
            else:
                lines.append(f"# TYPE {pname} summary")
                for q in QUANTILES:
                    v = m.percentile(q)
                    if not math.isnan(v):
                        lines.append(
                            f'{pname}{{quantile="{q:g}"}} {v:g}')
                lines.append(f"{pname}_count {m.count}")
                lines.append(f"{pname}_sum {m.sum:g}")
        return "\n".join(lines) + ("\n" if lines else "")


#: the process-default registry — what the serve tier records into
#: unless handed an explicit one
_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _REGISTRY


# ---------------------------------------------------------------------------
# Degradation events
# ---------------------------------------------------------------------------
# A degrade is a fallback to a slower path where a kernel's budget does
# not fit (a CTA's shared memory for K5/K6/K9/K10's rings) or where a
# pipeline cannot run a spec (an unregistered policy under
# ``persistent``).  Each is the right *behavior* (the traversal still
# runs) but must not be silent: an operator watching a latency
# regression needs the signal that a slower pipeline ran.
# `record_degrade` is the port's one emission point: every fallback site
# produces a `DegradeEvent` — counted under ``serve.degrade.<site>``,
# appended to a bounded in-process log, and warn-once logged with the
# budget that failed and the pipeline that actually runs.

_LOG = logging.getLogger("repro_torch.serve")

#: bounded ring of recent events — the post-mortem view `degrade_log`
#: exposes (counters aggregate; this keeps the *reasons*)
_DEGRADE_LOG_SIZE = 256


@dataclasses.dataclass(frozen=True)
class DegradeEvent:
    """One observable step down the degradation ladder.

    Attributes:
      site: stable counter key (``serve.degrade.<site>``) — e.g.
        ``"smem_fallback"`` (a shared-memory budget rejected the
        kernel) or ``"pipeline_unsupported"`` (the pipeline cannot run
        the spec).
      reason: which budget/capability failed, with numbers.
      fallback: what actually runs instead (the honest record an
        operator needs next to a latency regression).
      detail: optional free-form context (geometry, shapes).
    """

    site: str
    reason: str
    fallback: str
    detail: str = ""


_degrade_events: collections.deque = collections.deque(
    maxlen=_DEGRADE_LOG_SIZE)
_degrade_warned: set = set()
_degrade_lock = threading.Lock()


def record_degrade(site: str, reason: str, fallback: str,
                   detail: str = "",
                   registry: MetricsRegistry | None = None
                   ) -> DegradeEvent:
    """Emit a `DegradeEvent`: count + log-once + append to the ring.

    Called where the fallback is decided (host booleans at plan or
    step-build time), so it is a pure host side effect.  The warn-once
    key is ``(site, reason)``: the first occurrence logs at WARNING on
    the ``repro_torch.serve`` logger, repeats only count (a serving
    loop rebuilding steps per geometry must not spam).
    """
    ev = DegradeEvent(site=site, reason=reason, fallback=fallback,
                      detail=detail)
    reg = registry if registry is not None else get_registry()
    reg.counter(
        f"serve.degrade.{site}",
        "observable degradation events (see obs.metrics.DegradeEvent)"
    ).inc()
    with _degrade_lock:
        _degrade_events.append(ev)
        key = (site, reason)
        first = key not in _degrade_warned
        if first:
            _degrade_warned.add(key)
    if first:
        _LOG.warning("degrade[%s]: %s -> running %s%s", site, reason,
                     fallback, f" ({detail})" if detail else "")
    return ev


def degrade_log() -> tuple:
    """Snapshot of the most recent `DegradeEvent`\\ s (newest last)."""
    with _degrade_lock:
        return tuple(_degrade_events)


def clear_degrade_log() -> None:
    """Drop the event ring and re-arm every warn-once (tests)."""
    with _degrade_lock:
        _degrade_events.clear()
        _degrade_warned.clear()
