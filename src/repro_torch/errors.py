"""Typed failure taxonomy of the port — a copy of ``repro.errors``.

Every failure the plan/serve path raises or attaches derives from
`ReproError`, so a caller can tell "your graph is malformed" (client
bug, never retry) from "the queue is full" (backpressure, retry later)
from "your query ran out of budget" (partial result, decide) from "the
device step failed" (infrastructure, the engine already retried):

    ReproError
    ├── GraphValidationError   (also ValueError)   admission-time input
    ├── AdmissionRejected                          load-shed at submit
    │   └── QueueFullError                         bounded-queue overflow
    ├── DeadlineExceeded                           query budget expired
    ├── InjectedFault          (also RuntimeError) chaos-test fault
    └── TickRetriesExhausted   (also RuntimeError) retry budget spent

Dual inheritance keeps old callers working: `GraphValidationError` IS-A
``ValueError``, `InjectedFault` and `TickRetriesExhausted` are
``RuntimeError``\\ s.  `DeadlineExceeded` is attached to a truncated
query result (``BfsQuery.error``), not raised from the tick loop.  This
module is import-leaf.  Degrades are recorded by
`repro_torch.obs.metrics.record_degrade`.
"""
from __future__ import annotations


class ReproError(Exception):
    """Base class of every typed failure this package raises."""


class GraphValidationError(ReproError, ValueError):
    """A graph (or root) failed admission-time structural validation.

    Raised by `repro_torch.bfs.plan`, `GraphEngine` construction and
    ``submit`` when the input could produce a *wrong answer* rather
    than an error: non-monotone ``colstarts``, out-of-range neighbor
    ids, wrong dtypes, NaN-shaped geometry, roots outside ``[0, V)``.
    The message names the violated invariant and the fix.
    """


class AdmissionRejected(ReproError):
    """The serve tier declined to enqueue a query (load shedding).

    Carries the `repro_torch.serve.robust.AdmissionDecision` that
    rejected it as ``decision`` — the typed record of *why* (circuit
    state, queue depth) for the client's retry policy.
    """

    def __init__(self, message: str, decision=None):
        super().__init__(message)
        self.decision = decision


class QueueFullError(AdmissionRejected):
    """The engine's bounded submit queue is at capacity: the client sees
    the rejection and can retry after draining, with jitter, or route
    elsewhere."""


class DeadlineExceeded(ReproError):
    """A query's wall-clock (or global run) budget expired.

    Attached to the harvested `BfsQuery` as ``query.error`` with
    ``truncated=True`` — the parent array, when present, is PARTIAL.

    Attributes:
      uid: the query's uid (None for engine-global budgets).
      elapsed_s: wall seconds from submit when the budget tripped.
      budget_s: the configured budget.
      where: ``"queued"`` (expired before ever running),
        ``"in_flight"`` (expired mid-traversal) or ``"global"``
        (the `run_until_done` budget harvested it).
    """

    def __init__(self, message: str, *, uid=None, elapsed_s=None,
                 budget_s=None, where: str = "in_flight"):
        super().__init__(message)
        self.uid = uid
        self.elapsed_s = elapsed_s
        self.budget_s = budget_s
        self.where = where


class InjectedFault(ReproError, RuntimeError):
    """A `repro_torch.serve.robust.ServeFaultInjector` fired inside the
    engine tick, to prove the retry/requeue machinery recovers."""


class TickRetriesExhausted(ReproError, RuntimeError):
    """A serve tick kept failing past the capped-backoff retry budget.

    Before raising, the engine re-queues every in-flight query (their
    state restarts from the root), so even this terminal path loses
    nothing — a later `run_until_done` drains them.
    """
