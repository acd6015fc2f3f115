"""Continuous-batching BFS query service over one resident graph (a port
of ``repro.serve.graph_engine``).

A request pool, a fixed query batch with slot reuse (a finished query's
slot is refilled from the queue on the next tick — "continuous
batching"), and a batch shape that never changes.

One tick == one BFS layer for EVERY active slot, via the plan's
single-layer steps (`CompiledTraversal.layer_step`, leading root
axis).  The ``algorithm="simd"`` tick runs the ``fused_gather`` layer:
the union planner lists the active rows-blocks of every slot's
frontier, so slots whose frontier has emptied cost nothing until the
host harvests the parent row and refills the slot.  The per-tick host
sync is one (B,) frontier-count readback (`engine.row_popcounts`: one
launch of the measure kernel's count-only arm on the card); whole-query
throughput without any tick sync is what `run_direct` provides.

**Preprocess-on-load**: the engine picks a graph layout at
construction — ``graph_format="auto"`` runs `formats.autotune` on the
graph's degree statistics; any registered name forces that layout.
The rest of the configuration is ONE `TraversalSpec` (``spec=``),
planned once on ``device`` (default ``"cuda"``; ``device="cpu"`` runs
the plain torch path).

**Robustness**: the queue is *bounded* — `submit` returns a typed
`serve.robust.AdmissionDecision` or raises `QueueFullError` /
`AdmissionRejected`; queries carry optional wall-clock deadlines
(`DeadlineExceeded` attached to the truncated result) and per-query
layer budgets; a failed device tick retries with capped exponential
backoff and, on exhaustion, re-queues every in-flight query before
raising `TickRetriesExhausted` (zero lost queries); every harvested
result passes a sanity check (root self-parented, ids in range) and a
corrupted slot is re-run instead of delivered; and the
``serve.circuit_state`` gauge exports the healthy/degraded/shedding
breaker position.

The port's steps update P in place, so the retry contract ("a failed
attempt cannot corrupt slot state") is kept by handing each attempt a
copy of the (frontier, visited, parent) triple and keeping its outputs
only on success: one (B, V_pad) int32 copy of P per tick.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.csr import padding_premarked_visited
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.errors import (AdmissionRejected, DeadlineExceeded,
                                QueueFullError, TickRetriesExhausted)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.serve import robust


@dataclass
class BfsQuery:
    uid: int
    root: int
    parent: np.ndarray | None = None   # Graph500 convention (-1 unreached)
    n_layers: int = 0
    done: bool = False
    truncated: bool = False            # hit a budget (layers/deadline):
    #                                    the parent array is PARTIAL
    #                                    (-1 may mean "not reached
    #                                    yet") or None (never ran)
    priority: int = 0                  # admission order; shedding floor
    deadline_s: float | None = None    # wall-clock budget from submit
    max_layers: int | None = None      # per-query layer budget override
    #                                    (None = the engine spec's)
    error: Exception | None = None     # typed degradation record —
    #                                    DeadlineExceeded on budget
    #                                    expiry; None on clean finishes
    retries: int = 0                   # times this query was re-run
    #                                    (tick failure / poisoned slot)
    meta: dict = field(default_factory=dict)


class GraphEngine:
    """Serve many concurrent BFS queries against one device-resident
    graph.

    Args:
      graph: the resident graph — a `Csr` or an already-built
        `formats.GraphFormat` (moved to ``device`` and kept there for
        the engine's lifetime).
      batch_slots: fixed query-batch width.
      graph_format: layout for the tick — "auto" (autotune from graph
        statistics, the default), any registered format name, or None
        to wrap a Csr as-is.  A passed-in built format is kept under
        "auto"/None/its own name; forcing a *different* name re-lays
        it out when the format can.
      spec: a `repro_torch.bfs.TraversalSpec` — the ONE configuration
        object for the tick (algorithm, pipeline, packed,
        prefetch_depth, tile) and the per-query layer budget
        (``max_layers``).  Planned once at construction
        (``self.compiled``).
      algorithm/max_layers/pipeline/packed/prefetch_depth: deprecated
        loose-knob form of the same fields (DeprecationWarning).
      registry: a `repro_torch.obs.MetricsRegistry` to record serving
        metrics into (default: the process registry).  Recorded under
        ``serve.*``: per-query submit→harvest latency
        (``serve.query_latency_s``), tick duration (``serve.tick_s``),
        queue depth / slot occupancy / circuit-state gauges, and
        tick/query/skip/reject/retry counters.
      queue_capacity: bounded submit-queue size (default
        ``16 * batch_slots``); ignored when ``admission`` is passed.
      admission: a full `serve.robust.AdmissionPolicy`.
      injector: a `serve.robust.ServeFaultInjector` — chaos-test hook
        firing failures/stalls/poisoned rows at configured ticks.
      max_tick_retries: device-tick retry budget (capped exponential
        backoff between attempts); on exhaustion every in-flight
        query is re-queued and `TickRetriesExhausted` raises.
      retry_backoff_s: backoff base for `serve.robust.backoff_s`.
      device: where the graph lives and the ticks run (default
        ``"cuda"``, raising without it; ``"cpu"`` for the plain path).
    """

    def __init__(self, graph, batch_slots: int = 8,
                 algorithm=engine._UNSET, max_layers=engine._UNSET,
                 graph_format: str | None = "auto",
                 pipeline=engine._UNSET, packed=engine._UNSET,
                 prefetch_depth=engine._UNSET, spec=None,
                 registry: obs_metrics.MetricsRegistry | None = None,
                 queue_capacity: int | None = None,
                 admission: robust.AdmissionPolicy | None = None,
                 injector: robust.ServeFaultInjector | None = None,
                 max_tick_retries: int = 3,
                 retry_backoff_s: float = 0.01,
                 device=DEFAULT_DEVICE):
        from repro_torch.api.plan import plan as _plan
        from repro_torch.core.csr import Csr as _Csr, check_structure
        from repro_torch.formats import GraphFormat, autotune
        self.device = resolve_device(device)
        # admission-time validation: a raw Csr is checked BEFORE
        # autotune re-lays it out — a malformed graph must be a typed
        # construction error, not a wrong resident layout
        if isinstance(graph, _Csr):
            check_structure(graph)
            graph = graph._replace(rows=graph.rows.to(self.device),
                                   colstarts=graph.colstarts.to(
                                       self.device))
        if isinstance(graph, GraphFormat):
            self.csr = None
            graph = graph.to(self.device)
            self.fmt = (graph if graph_format in (None, "auto",
                                                  graph.name)
                        else autotune.build(graph, graph_format))
        else:
            self.csr = graph
            self.fmt = autotune.build(graph, graph_format or "csr")
        # the tick never evaluates a direction policy; "auto" and the
        # neutral TopDown (object or registered name) pass silently,
        # anything else was a real configuration intent
        if spec is not None \
                and spec.policy not in ("auto", "topdown") \
                and spec.policy != engine.TopDown():
            import warnings
            warnings.warn(
                "GraphEngine: the serve tick is policy-free (one "
                "layer per tick; scalar vs SIMD comes from "
                "spec.algorithm) — spec.policy is ignored",
                UserWarning, stacklevel=2)
        spec = engine._spec_from_knobs(
            "GraphEngine", spec,
            dict(algorithm=algorithm, max_layers=max_layers,
                 pipeline=pipeline, packed=packed,
                 prefetch_depth=prefetch_depth))
        if spec.policy == "auto":
            # pin a concrete policy the tick never reads: keeps
            # .resolved honest about the direction machinery not
            # running here
            spec = spec.replace(policy="topdown")
        if spec.is_semiring:
            # the tick contract is one BFS layer per slot; the
            # portfolio loop owns its own value/frontier carry and
            # has no single-layer tick
            raise ValueError(
                f"GraphEngine's tick spec cannot use the semiring "
                f"algorithm {spec.algorithm!r}: the slot machinery "
                f"advances one BFS layer per tick — use "
                f"shortest_paths()/components()/ksource_depths() "
                f"(run-direct portfolio queries), and keep spec."
                f"algorithm a scalar value or 'auto'")
        self.compiled = _plan(self.fmt, spec, device=self.device)
        b = batch_slots
        self.n_vertices = self.fmt.n_vertices
        v_pad = self.fmt.n_vertices_padded
        w = v_pad // 32
        i32 = dict(dtype=torch.int32, device=self.device)
        self.frontier = torch.zeros((b, w), **i32)
        self.visited = torch.zeros((b, w), **i32)
        self.parent = torch.full((b, v_pad), self.n_vertices, **i32)
        self._base_visited = padding_premarked_visited(self.n_vertices,
                                                       device=self.device)
        self.slots: list[BfsQuery | None] = [None] * b
        # bounded priority queue: higher priority first, FIFO within a
        # level; at capacity `submit` rejects with a typed error
        if admission is None:
            cap = (int(queue_capacity) if queue_capacity is not None
                   else 16 * b)
            admission = robust.AdmissionPolicy(
                queue_capacity=cap, degraded_depth=max(1, cap // 2))
        self.admission = admission
        self.queue = robust.AdmissionQueue(admission.queue_capacity)
        self.injector = injector
        self.max_tick_retries = int(max_tick_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self._tick_no = 0
        self.finished: list[BfsQuery] = []
        self.metrics = (registry if registry is not None
                        else obs_metrics.get_registry())
        self._m_latency = self.metrics.histogram(
            "serve.query_latency_s",
            "submit->harvest wall seconds per query")
        self._m_tick = self.metrics.histogram(
            "serve.tick_s", "wall seconds per engine tick")
        self._m_queue = self.metrics.gauge(
            "serve.queue_depth", "queries waiting for a slot")
        self._m_occupancy = self.metrics.gauge(
            "serve.slot_occupancy", "active slots / batch_slots")
        self._m_ticks = self.metrics.counter(
            "serve.ticks", "engine ticks that dispatched a layer_step")
        self._m_skipped = self.metrics.counter(
            "serve.ticks_skipped",
            "ticks short-circuited with no active slot (no device "
            "dispatch)")
        self._m_submitted = self.metrics.counter(
            "serve.queries_submitted")
        self._m_finished = self.metrics.counter("serve.queries_finished")
        self._m_truncated = self.metrics.counter(
            "serve.queries_truncated",
            "queries harvested PARTIAL at a layers/deadline budget")
        self._m_rejected = self.metrics.counter(
            "serve.rejected",
            "submits refused by admission control (queue full / "
            "priority shed)")
        self._m_retries = self.metrics.counter(
            "serve.retries", "failed device-tick attempts retried")
        self._m_requeued = self.metrics.counter(
            "serve.requeued",
            "in-flight queries re-queued after tick failure or a "
            "corrupted slot")
        self._m_poisoned = self.metrics.counter(
            "serve.poisoned",
            "corrupted slot results caught by the harvest sanity "
            "check (re-run, never delivered)")
        self._m_deadline = self.metrics.counter(
            "serve.deadline_exceeded",
            "queries harvested with a DeadlineExceeded error")
        self._m_circuit = self.metrics.gauge(
            "serve.circuit_state",
            "admission circuit: 0=healthy 1=degraded 2=shedding")
        self._m_portfolio = self.metrics.counter(
            "serve.portfolio_queries",
            "semiring portfolio queries (shortest_paths/components/"
            "ksource_depths) answered run-direct")
        self._semiring_plans: dict[str, object] = {}

    # -- resolved-spec views --------------------------------------------
    @property
    def resolved(self):
        """The fully-concrete `TraversalSpec` the tick runs."""
        return self.compiled.resolved

    @property
    def algorithm(self) -> str:
        return self.compiled.resolved.algorithm

    @property
    def pipeline(self) -> str:
        return self.compiled.resolved.pipeline

    @property
    def packed(self) -> bool:
        return self.compiled.resolved.packed

    @property
    def prefetch_depth(self) -> int:
        return self.compiled.resolved.prefetch_depth

    @property
    def max_layers(self) -> int:
        return self.compiled.resolved.max_layers

    # -- admission ---------------------------------------------------------
    def circuit_state(self) -> str:
        """Current breaker position (`serve.robust.CIRCUIT_*`)."""
        depth = len(self.queue)
        if self.queue.full:
            return robust.CIRCUIT_SHEDDING
        if (self._active_slots() == len(self.slots)
                and depth >= self.admission.degraded_depth):
            return robust.CIRCUIT_DEGRADED
        return robust.CIRCUIT_HEALTHY

    def _set_circuit_gauge(self, state: str | None = None) -> str:
        state = state if state is not None else self.circuit_state()
        self._m_circuit.set(robust.CIRCUIT_CODES[state])
        return state

    def try_submit(self, query: BfsQuery) -> robust.AdmissionDecision:
        """Admission decision without raising: validates the root
        (typed `GraphValidationError` — malformed input is a client
        bug, not backpressure), then admits or rejects per the
        circuit."""
        from repro_torch.api.plan import check_roots
        check_roots(query.root, self.n_vertices)
        state = self._set_circuit_gauge()
        depth = len(self.queue)
        if state == robust.CIRCUIT_SHEDDING:
            self._m_rejected.inc()
            return robust.AdmissionDecision(
                admitted=False, circuit=state, queue_depth=depth,
                reason=(f"queue at capacity "
                        f"({depth}/{self.queue.capacity})"))
        floor = self.admission.shed_min_priority
        if (state == robust.CIRCUIT_DEGRADED and floor is not None
                and query.priority < floor):
            self._m_rejected.inc()
            return robust.AdmissionDecision(
                admitted=False, circuit=state, queue_depth=depth,
                reason=(f"load shedding: priority {query.priority} < "
                        f"floor {floor} while degraded"))
        query.meta.setdefault("submit_t", time.perf_counter())
        self.queue.push(query, query.priority)
        self._m_submitted.inc()
        self._m_queue.set(len(self.queue))
        self._set_circuit_gauge()
        return robust.AdmissionDecision(
            admitted=True, circuit=state, queue_depth=len(self.queue))

    def submit(self, query: BfsQuery) -> robust.AdmissionDecision:
        """Admit ``query`` or raise the typed rejection
        (`QueueFullError` at capacity, `AdmissionRejected` when
        priority-shed); returns the `AdmissionDecision` on admit."""
        decision = self.try_submit(query)
        if not decision.admitted:
            cls = (QueueFullError
                   if decision.circuit == robust.CIRCUIT_SHEDDING
                   else AdmissionRejected)
            raise cls(f"query uid={query.uid} rejected: "
                      f"{decision.reason}", decision=decision)
        return decision

    def _expire_queued(self) -> None:
        """Harvest queued queries whose deadline passed before they
        ever got a slot (parent=None — they never ran)."""
        now = time.perf_counter()

        def expired(q):
            return (q.deadline_s is not None
                    and now - q.meta.get("submit_t", now) > q.deadline_s)

        for q in self.queue.remove_if(expired):
            elapsed = now - q.meta.get("submit_t", now)
            q.error = DeadlineExceeded(
                f"query uid={q.uid} expired after {elapsed:.3f}s in "
                f"the queue (deadline_s={q.deadline_s}) without ever "
                f"getting a slot", uid=q.uid, elapsed_s=elapsed,
                budget_s=q.deadline_s, where="queued")
            q.parent = None
            q.truncated = True
            q.done = True
            self.finished.append(q)
            self._m_finished.inc()
            self._m_truncated.inc()
            self._m_deadline.inc()
        self._m_queue.set(len(self.queue))

    def _fill_slots(self):
        """Refill free slots from the queue: in-place row writes of the
        root's initial state."""
        for i, q in enumerate(self.slots):
            if (q is None or q.done) and self.queue:
                nxt = self.queue.pop()
                self.slots[i] = nxt
                f_row, v_row, p_row = engine.init_root_state(
                    nxt.root, self._base_visited, self.n_vertices)
                self.frontier[i] = f_row
                self.visited[i] = v_row
                self.parent[i] = p_row
        self._m_queue.set(len(self.queue))

    def _active_slots(self) -> int:
        return sum(q is not None and not q.done for q in self.slots)

    # -- result integrity / recovery ---------------------------------------
    def _result_ok(self, row: torch.Tensor, root: int) -> torch.Tensor:
        """Harvest-time sanity check of a slot's (V,) parent row, on the
        row's device: the root must be self-parented and every entry a
        legal id (unreached == sentinel ``n_vertices``).  A violation
        means the slot's state was corrupted (e.g. an injected
        poisoned result) — the query is re-run, never delivered.
        Returns a bool scalar tensor."""
        return (row[root] == root) & ((row >= 0)
                                      & (row <= self.n_vertices)).all()

    def _requeue(self, i: int, q: BfsQuery) -> None:
        """Re-run ``q`` from its root: reset its progress and force it
        back onto the queue (past capacity if need be — the engine's
        own recovery must never lose a query to its own
        backpressure)."""
        q.n_layers = 0
        q.done = False
        q.truncated = False
        q.parent = None
        q.retries += 1
        self.slots[i] = None
        self.queue.push(q, q.priority, force=True)
        self._m_requeued.inc()
        self._m_queue.set(len(self.queue))

    def _requeue_in_flight(self) -> None:
        for i, q in enumerate(self.slots):
            if q is not None and not q.done:
                self._requeue(i, q)

    def _dispatch_with_retry(self, tick_no: int) -> None:
        """Run the device tick, retrying with capped exponential
        backoff.  Each attempt steps a copy of the state triple (the
        steps update P in place) and the outputs are kept only on
        success, so a failed attempt cannot corrupt slot state.  On
        exhaustion every in-flight query is re-queued (restart from
        root) and `TickRetriesExhausted` raises — a loud
        infrastructure error with zero lost queries."""
        last: Exception | None = None
        for attempt in range(self.max_tick_retries + 1):
            try:
                if self.injector is not None:
                    stall = self.injector.stall_s(tick_no)
                    if stall > 0:
                        time.sleep(stall)
                    self.injector.check_tick(tick_no)
                self.frontier, self.visited, self.parent = \
                    self.compiled.layer_step(self.frontier.clone(),
                                             self.visited.clone(),
                                             self.parent.clone())
                return
            except Exception as exc:    # noqa: BLE001 — retry any
                last = exc              # device-step failure flavour
                self._m_retries.inc()
                if attempt < self.max_tick_retries:
                    time.sleep(robust.backoff_s(
                        attempt, self.retry_backoff_s))
        self._requeue_in_flight()
        raise TickRetriesExhausted(
            f"serve tick {tick_no} failed {self.max_tick_retries + 1} "
            f"times; {self._m_requeued.value:g} in-flight queries "
            f"re-queued (none lost) — last error: {last!r}") from last

    def _harvest(self, i: int, q: BfsQuery, truncated: bool = False,
                 error: Exception | None = None,
                 check: bool = True) -> bool:
        """Deliver slot ``i``'s result; returns False when the sanity
        check caught a corrupted slot (the query was re-queued
        instead).  The check runs on the device; the row crosses to
        the host once, already in the Graph500 convention."""
        row = self.parent[i, :self.n_vertices]
        ok = self._result_ok(row, q.root) if check else None
        parent = torch.where(row >= self.n_vertices, -1, row).cpu().numpy()
        if check and not bool(ok):
            self._m_poisoned.inc()
            self._requeue(i, q)
            return False
        q.parent = parent
        q.truncated = truncated
        q.error = error
        q.done = True
        self.finished.append(q)
        self._m_finished.inc()
        if truncated:
            self._m_truncated.inc()
        if isinstance(error, DeadlineExceeded):
            self._m_deadline.inc()
        t0 = q.meta.get("submit_t")
        if t0 is not None:
            q.meta["latency_s"] = time.perf_counter() - t0
            self._m_latency.observe(q.meta["latency_s"])
        return True

    def run_direct(self, roots) -> engine.EngineResult:
        """Whole-traversal fast path: run root(s) to completion through
        the plan, bypassing the per-tick slot machinery (no admission
        queue).  Under ``spec.pipeline="persistent"`` the batch is ONE
        kernel launch (K6 on CSR, K10 on SELL).  The tick path (`step`)
        keeps the per-layer steps regardless of pipeline: a tick is by
        definition one layer, so ``"persistent"`` ticks run the
        whole-layer megakernel steps instead."""
        return self.compiled.run(roots)

    # -- algorithm portfolio queries ---------------------------------------
    def _semiring_plan(self, algorithm: str):
        """One lazily-built portfolio plan per algorithm, cached on the
        engine (and shared process-wide through the plan cache)."""
        ct = self._semiring_plans.get(algorithm)
        if ct is None:
            from repro_torch.api.plan import plan as _plan
            from repro_torch.api.spec import TraversalSpec
            # a deep bucket/propagation chain (SSSP on a path graph
            # walks one delta bucket per iteration) needs more
            # iterations than a BFS diameter bound; the loop exits
            # early, so the generous ceiling costs nothing
            spec = TraversalSpec(
                algorithm=algorithm, policy="topdown",
                max_layers=max(512, self.max_layers))
            ct = self._semiring_plans[algorithm] = _plan(
                self.fmt, spec, device=self.device)
        return ct

    def shortest_paths(self, roots):
        """Single-source shortest paths (min-plus semiring, the
        synthetic symmetric-hash edge weights in [1, 2)) from one root
        (int) or a root batch.  Returns ``(distances, parent)`` host
        arrays over the real vertices: ``distances`` float32 with
        ``inf`` for unreached vertices, ``parent`` int32 with ``-1``
        for unreached (the root is its own parent)."""
        ct = self._semiring_plan("sssp")
        res = ct.run(roots)
        self._m_portfolio.inc()
        dist = res.values[..., :self.n_vertices].cpu().numpy()
        p = res.state.parent[..., :self.n_vertices].cpu().numpy()
        return dist, np.where(np.isfinite(dist), p, -1)

    def components(self):
        """Connected-component labels (min-label propagation run to
        fixpoint).  Returns ``(labels, n_components)``: ``labels`` is
        an int32 host array mapping every real vertex to the smallest
        vertex id in its component."""
        ct = self._semiring_plan("cc")
        res = ct.run(0)       # root is irrelevant: every vertex seeds
        self._m_portfolio.inc()
        labels = res.values[:self.n_vertices].cpu().numpy()
        return labels, int(np.unique(labels).size)

    def ksource_depths(self, roots):
        """Batched k-source BFS: one traversal, one depth row per root.
        Returns the (k, n_vertices) int32 per-source depth matrix with
        ``-1`` for unreached vertices."""
        from repro_torch.algorithms.semiring import INT_INF
        ct = self._semiring_plan("ksource_bfs")
        roots = np.atleast_1d(np.asarray(roots, np.int32))
        res = ct.run_batched(roots)
        self._m_portfolio.inc()
        depths = res.values[:, :self.n_vertices].cpu().numpy()
        return np.where(depths >= INT_INF, -1, depths)

    def step(self):
        """One engine tick: advance every active query by one layer.

        When every slot is empty/done after the refill (drain tail, or
        ticking an idle engine) no layer is dispatched — the tick is a
        host no-op counted in ``serve.ticks_skipped``."""
        with self._m_tick.time():
            self._expire_queued()
            self._fill_slots()
            n_active = self._active_slots()
            self._m_occupancy.set(n_active / max(len(self.slots), 1))
            self._set_circuit_gauge()
            if n_active == 0:
                self._m_skipped.inc()
                return
            self._m_ticks.inc()
            tick_no = self._tick_no
            self._tick_no += 1
            self._dispatch_with_retry(tick_no)
            if self.injector is not None:
                for s in self.injector.poison_slots(tick_no):
                    if 0 <= s < len(self.slots) \
                            and self.slots[s] is not None \
                            and not self.slots[s].done:
                        # corrupt the slot's parent row the way a bad
                        # device step would: every entry off-by-one,
                        # so parent[root] != root
                        v_pad = self.parent.shape[1]
                        self.parent[s] = (torch.arange(
                            v_pad, dtype=torch.int32,
                            device=self.device) + 1) % self.n_vertices
            counts = engine.row_popcounts(self.frontier).cpu().numpy()
            now = time.perf_counter()
            for i, q in enumerate(self.slots):
                if q is None or q.done:
                    continue
                q.n_layers += 1
                budget = (q.max_layers if q.max_layers is not None
                          else self.max_layers)
                elapsed = now - q.meta.get("submit_t", now)
                if counts[i] == 0:
                    self._harvest(i, q)
                elif q.deadline_s is not None \
                        and elapsed > q.deadline_s:
                    self._harvest(
                        i, q, truncated=True,
                        error=DeadlineExceeded(
                            f"query uid={q.uid} exceeded its "
                            f"deadline_s={q.deadline_s} after "
                            f"{elapsed:.3f}s / {q.n_layers} layers "
                            f"(partial tree delivered)",
                            uid=q.uid, elapsed_s=elapsed,
                            budget_s=q.deadline_s, where="in_flight"))
                elif q.n_layers >= budget:
                    self._harvest(i, q, truncated=True)

    def _harvest_global_budget(self, budget_s: float,
                               elapsed: float) -> None:
        """`run_until_done` budget expiry: deliver every in-flight
        query as a truncated partial and every queued query as
        never-ran — nothing is lost, everything is typed."""
        for i, q in enumerate(self.slots):
            if q is not None and not q.done:
                self._harvest(
                    i, q, truncated=True,
                    error=DeadlineExceeded(
                        f"run_until_done budget_s={budget_s} expired "
                        f"after {elapsed:.3f}s with query uid={q.uid} "
                        f"in flight ({q.n_layers} layers done)",
                        uid=q.uid, elapsed_s=elapsed,
                        budget_s=budget_s, where="global"),
                    check=False)
        while self.queue:
            q = self.queue.pop()
            q.error = DeadlineExceeded(
                f"run_until_done budget_s={budget_s} expired after "
                f"{elapsed:.3f}s with query uid={q.uid} still queued",
                uid=q.uid, elapsed_s=elapsed, budget_s=budget_s,
                where="global")
            q.parent = None
            q.truncated = True
            q.done = True
            self.finished.append(q)
            self._m_finished.inc()
            self._m_truncated.inc()
            self._m_deadline.inc()
        self._m_queue.set(0)

    def run_until_done(self, max_ticks: int = 100_000,
                       budget_s: float | None = None) -> int:
        """Drain the queue; returns the number of ticks taken.

        ``budget_s`` is the global wall-clock budget: when it expires,
        in-flight queries are delivered as truncated partials and
        queued ones as never-ran, each carrying a
        `DeadlineExceeded(where="global")`."""
        ticks = 0
        t0 = time.perf_counter()
        while (self.queue or any(q is not None and not q.done
                                 for q in self.slots)):
            elapsed = time.perf_counter() - t0
            if budget_s is not None and elapsed > budget_s:
                self._harvest_global_budget(budget_s, elapsed)
                break
            self.step()
            ticks += 1
            if ticks >= max_ticks:
                now = time.perf_counter()
                slot_report = {}
                for i, q in enumerate(self.slots):
                    if q is None or q.done:
                        continue
                    left = (None if q.deadline_s is None else round(
                        q.deadline_s
                        - (now - q.meta.get("submit_t", now)), 3))
                    slot_report[i] = {
                        "n_layers": q.n_layers,
                        "deadline_remaining_s": left,
                        "retries": q.retries,
                    }
                raise RuntimeError(
                    f"graph serving did not converge within "
                    f"{max_ticks} ticks: queue_depth="
                    f"{len(self.queue)}, active_slots="
                    f"{self._active_slots()}/{len(self.slots)}, "
                    f"per-slot state={slot_report}, "
                    f"max_layers={self.max_layers}, "
                    f"circuit={self.circuit_state()}")
        return ticks
