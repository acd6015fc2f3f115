"""Serve-tier robustness primitives — admission control, deadlines,
fault injection (a copy of ``repro.serve.robust``; pure Python).

A serving engine that melts down under overload — or silently delivers
corrupted trees when a device step fails — is not a serving engine.  This module holds the pieces `GraphEngine` composes:

* `AdmissionPolicy` / `AdmissionDecision` / `AdmissionQueue` — a
  *bounded* priority queue with an explicit admit/reject decision at
  ``submit`` time.  Backpressure beats buffering: an unbounded queue
  converts overload into unbounded latency (every queued query's
  deadline silently dies), a silently-dropping ``deque(maxlen=...)``
  converts it into lost queries.  The bounded queue rejects loudly
  (`repro_torch.errors.QueueFullError`) so the *client* decides.
* circuit state — the three-position breaker the
  ``serve.circuit_state`` gauge exports: `CIRCUIT_HEALTHY` (slots
  free or queue shallow), `CIRCUIT_DEGRADED` (every slot busy and the
  queue past ``degraded_depth`` — optional priority shedding kicks
  in), `CIRCUIT_SHEDDING` (queue at capacity — every submit
  rejected).
* `ServeFaultInjector` — deterministic, fire-once faults at
  configured serve *ticks*.  Three flavours, matching how devices actually fail: the step raises
  (``fail_ticks``), the step stalls (``slow_ticks``/``slow_s``), the
  step returns garbage (``poison`` — (tick, slot) pairs whose parent
  row is corrupted; the engine's harvest-time sanity check must catch
  and re-run them).  Chaos tests drive traffic through an injector
  and assert ZERO lost or corrupted queries.
* `backoff_s` — capped exponential backoff for the engine's tick
  retry loop.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable

from repro_torch.errors import InjectedFault

# -- circuit breaker states -------------------------------------------------
CIRCUIT_HEALTHY = "healthy"
CIRCUIT_DEGRADED = "degraded"
CIRCUIT_SHEDDING = "shedding"

#: gauge encoding for ``serve.circuit_state`` (metrics are floats;
#: the snapshot stays JSON-scalar)
CIRCUIT_CODES = {CIRCUIT_HEALTHY: 0, CIRCUIT_DEGRADED: 1,
                 CIRCUIT_SHEDDING: 2}


def backoff_s(attempt: int, base: float = 0.01,
              cap: float = 0.25) -> float:
    """Capped exponential backoff: ``min(cap, base * 2**attempt)``."""
    return min(cap, base * (2 ** attempt))


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """When to admit, degrade, and shed.

    Attributes:
      queue_capacity: bounded-queue size.  At capacity the circuit is
        `CIRCUIT_SHEDDING` and every submit raises `QueueFullError`.
      degraded_depth: queue depth at/above which — with every slot
        busy — the circuit reports `CIRCUIT_DEGRADED`.
      shed_min_priority: optional load-shedding floor: while DEGRADED,
        queries with ``priority <`` this are rejected
        (`AdmissionRejected`) to keep room for the important ones.
        ``None`` (default) disables priority shedding — only the hard
        capacity bound rejects.
    """

    queue_capacity: int
    degraded_depth: int
    shed_min_priority: int | None = None

    def __post_init__(self):
        if self.queue_capacity < 1:
            raise ValueError(
                f"queue_capacity must be >= 1, got {self.queue_capacity}")
        if self.degraded_depth < 0:
            raise ValueError(
                f"degraded_depth must be >= 0, got {self.degraded_depth}")


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    """The typed record of one submit-time admission decision.

    Rejections carry this on the raised `AdmissionRejected` as
    ``.decision`` so a client's retry policy can read *why* (circuit
    state, queue depth) instead of parsing a message string.
    """

    admitted: bool
    circuit: str            # CIRCUIT_* at decision time
    queue_depth: int        # depth when the decision was made
    reason: str = ""


class AdmissionQueue:
    """Bounded priority queue: higher ``priority`` first, FIFO within
    a priority level (heap key ``(-priority, seq)``).

    ``push`` refuses past ``capacity`` unless ``force=True`` — the
    force path exists for the engine's *requeue* of in-flight queries
    on tick failure, which must never lose a query to its own
    backpressure.  Truthiness and ``len`` mirror the deque this
    replaces (``assert not engine.queue`` keeps working).
    """

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._heap: list = []
        self._seq = 0

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

    @property
    def full(self) -> bool:
        return len(self._heap) >= self.capacity

    def push(self, item, priority: int = 0, *,
             force: bool = False) -> bool:
        """Enqueue; returns False (without enqueuing) when at capacity
        and not ``force``."""
        if self.full and not force:
            return False
        heapq.heappush(self._heap, (-int(priority), self._seq, item))
        self._seq += 1
        return True

    def pop(self):
        """Highest-priority (then oldest) item; raises IndexError when
        empty."""
        return heapq.heappop(self._heap)[2]

    def items(self) -> list:
        """Queued items in pop order (non-destructive)."""
        return [t[2] for t in sorted(self._heap)]

    def remove_if(self, pred: Callable) -> list:
        """Remove and return every queued item matching ``pred``
        (deadline expiry harvests through this)."""
        removed = [t[2] for t in self._heap if pred(t[2])]
        if removed:
            self._heap = [t for t in self._heap if not pred(t[2])]
            heapq.heapify(self._heap)
        return removed


@dataclasses.dataclass
class ServeFaultInjector:
    """Deterministic, fire-once fault schedule for the serve tick.

    Configured trigger points + a ``fired`` set so each listed fault
    raises exactly once — retries then succeed, proving the recovery
    machinery rather than looping forever.

    Attributes:
      fail_ticks: tick numbers whose device dispatch raises
        `repro_torch.errors.InjectedFault` (once each).
      slow_ticks: tick numbers stalled by ``slow_s`` wall seconds
        (once each) — exercises deadline budgets.
      slow_s: the stall duration.
      poison: ``(tick, slot)`` pairs — after the listed tick's
        dispatch succeeds, that slot's parent row is corrupted in
        place (once each).  The engine's harvest-time sanity check
        must detect the corruption and re-run the query; a delivered
        poisoned result is the chaos-test failure mode.
    """

    fail_ticks: tuple = ()
    slow_ticks: tuple = ()
    slow_s: float = 0.0
    poison: tuple = ()      # ((tick, slot), ...)

    def __post_init__(self):
        self.fail_ticks = tuple(int(t) for t in self.fail_ticks)
        self.slow_ticks = tuple(int(t) for t in self.slow_ticks)
        self.poison = tuple((int(t), int(s)) for t, s in self.poison)
        self._fired_fail: set = set()
        self._fired_slow: set = set()
        self._fired_poison: set = set()

    def check_tick(self, tick: int) -> None:
        """Raise `InjectedFault` if ``tick`` is scheduled to fail and
        hasn't fired yet."""
        if tick in self.fail_ticks and tick not in self._fired_fail:
            self._fired_fail.add(tick)
            raise InjectedFault(
                f"injected device-step failure at serve tick {tick} "
                f"(ServeFaultInjector.fail_ticks={self.fail_ticks})")

    def stall_s(self, tick: int) -> float:
        """Seconds to stall ``tick`` (0.0 when not scheduled/already
        fired)."""
        if tick in self.slow_ticks and tick not in self._fired_slow:
            self._fired_slow.add(tick)
            return float(self.slow_s)
        return 0.0

    def poison_slots(self, tick: int) -> tuple:
        """Slots whose parent row to corrupt after ``tick`` (each
        (tick, slot) pair fires once)."""
        out = []
        for t, s in self.poison:
            if t == tick and (t, s) not in self._fired_poison:
                self._fired_poison.add((t, s))
                out.append(s)
        return tuple(out)

    @property
    def faults_remaining(self) -> int:
        """Scheduled faults that have not fired yet (chaos tests
        assert 0 at drain)."""
        return (len(set(self.fail_ticks) - self._fired_fail)
                + len(set(self.slow_ticks) - self._fired_slow)
                + len(set(self.poison) - self._fired_poison))
