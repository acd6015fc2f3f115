"""The port's serve tier (`repro_torch.serve`) held against the
reference's (`repro.serve`), case by case of
``tests/test_serve_robust.py``.

Both engines get the same graph, the same queries and the same fault
schedule; the reference runs its ``fused_gather`` tick explicitly
(``pipeline="fused_gather", prefetch_depth=0``: its auto pipeline
reads benchmark rows that pick kernels this container's jax cannot
run).  Each case holds the port to the reference's per-query outcome
(uid, n_layers, done/truncated flags, retries, typed error and its
``where``) in delivery order and to its ``serve.*`` counters; parents
are held by `validate` with depths equal to `bfs_serial`, not bitwise.
Deadline cases trip on the injector's stalls, never on sleeps between
ticks."""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.spec import TraversalSpec as RefSpec
from repro.core.csr import from_edges
from repro.core.rmat import EdgeList, generate
from repro import errors as ref_errors
from repro.obs import metrics as ref_metrics
from repro.serve import graph_engine as ref_ge
from repro.serve import robust as ref_robust

from _torch_parity import cuda_device, to_port  # noqa: F401
import repro_torch.bfs as tbfs
from repro_torch import errors
from repro_torch.core.bfs_serial import bfs_serial
from repro_torch.core.validate import validate
from repro_torch.kernels import ops
from repro_torch.obs import metrics
from repro_torch.serve import graph_engine as t_ge
from repro_torch.serve import robust
from _torch_parity import builtin_knobs  # noqa: F401

# the reference's pinned fused_gather depth-0 results hold the port's
# built-in knobs, not the affinity table's picks
pytestmark = pytest.mark.usefixtures("builtin_knobs")

CSR = from_edges(generate(jax.random.PRNGKey(3), scale=7, edgefactor=6))
V = CSR.n_vertices
REF = dict(ge=ref_ge, robust=ref_robust, errors=ref_errors,
           metrics=ref_metrics)
PORT = dict(ge=t_ge, robust=robust, errors=errors, metrics=metrics)
#: the counters both engines must agree on
COUNTERS = ("serve.ticks", "serve.ticks_skipped", "serve.retries",
            "serve.requeued", "serve.poisoned", "serve.rejected",
            "serve.deadline_exceeded", "serve.queries_submitted",
            "serve.queries_finished", "serve.queries_truncated")


def _path_csr(n=64):
    """0-1-2-...-(n-1): one layer per tick, n-1 layers from root 0 —
    the deterministic long-running query for deadline tests."""
    src = jnp.asarray(list(range(n - 1)) + list(range(1, n)), jnp.int32)
    dst = jnp.asarray(list(range(1, n)) + list(range(n - 1)), jnp.int32)
    return from_edges(EdgeList(src=src, dst=dst, n_vertices=n))


PATH = _path_csr(64)


def _engine(side, graph=CSR, spec=None, injector=None, admission=None,
            **kw):
    """An engine of ``side`` (REF or PORT) over ``graph``; ``spec``,
    ``injector`` and ``admission`` are field dicts built into each
    side's own classes."""
    kw.setdefault("batch_slots", 4)
    kw.setdefault("retry_backoff_s", 0.001)
    spec = dict(spec or {})
    rob = side["robust"]
    if injector is not None:
        kw["injector"] = (injector(rob) if callable(injector)
                          else rob.ServeFaultInjector(**injector))
    if admission is not None:
        kw["admission"] = rob.AdmissionPolicy(**admission)
    registry = side["metrics"].MetricsRegistry()
    if side is REF:
        return ref_ge.GraphEngine(graph, spec=RefSpec(
            pipeline="fused_gather", prefetch_depth=0, **spec),
            registry=registry, **kw)
    return t_ge.GraphEngine(to_port(graph), spec=tbfs.TraversalSpec(**spec),
                            registry=registry, device="cpu", **kw)


def _outcome(q):
    err = q.error
    return (q.uid, q.root, q.n_layers, q.done, q.truncated, q.retries,
            type(err).__name__ if err is not None else None,
            getattr(err, "where", None), getattr(err, "uid", None),
            q.parent is None)


def _both(drive, **kw):
    """Build both engines, run ``drive(engine, side)`` on each, and hold
    the port's outcomes and counters to the reference's.  Returns the
    two engines and drive's two results."""
    out = []
    for side in (REF, PORT):
        eng = _engine(side, **kw)
        out.append((eng, drive(eng, side)))
    (ref, r_res), (port, p_res) = out
    assert [_outcome(q) for q in port.finished] \
        == [_outcome(q) for q in ref.finished]
    rc = ref.metrics.snapshot()["counters"]
    pc = port.metrics.snapshot()["counters"]
    assert {k: pc[k] for k in COUNTERS} == {k: rc[k] for k in COUNTERS}
    return ref, port, r_res, p_res


def _valid(graph, queries) -> None:
    """Every delivered whole tree passes `validate` with bfs_serial's
    depths."""
    gt = to_port(graph)
    rows, cs = np.asarray(graph.rows), np.asarray(graph.colstarts)
    for q in queries:
        if q.parent is None or q.truncated:
            continue
        _, depth = bfs_serial(rows, cs, graph.n_vertices, q.root)
        assert validate(gt, torch.from_numpy(q.parent), q.root,
                        reference_depth=depth).ok, q.uid


def _submit_all(eng, side, roots, **fields):
    qs = [side["ge"].BfsQuery(uid=i, root=int(r), **fields)
          for i, r in enumerate(roots)]
    for q in qs:
        eng.submit(q)
    return qs


# -- robust primitives --------------------------------------------------------

def test_backoff_is_capped_exponential():
    for mod in (ref_robust, robust):
        assert mod.backoff_s(0, base=0.01, cap=1.0) == 0.01
        assert mod.backoff_s(3, base=0.01, cap=1.0) == 0.08
        assert mod.backoff_s(30, base=0.01, cap=0.25) == 0.25
    assert [robust.backoff_s(a) for a in range(8)] == \
        [ref_robust.backoff_s(a) for a in range(8)]


def test_admission_queue_priority_then_fifo():
    got = []
    for mod in (ref_robust, robust):
        q = mod.AdmissionQueue(capacity=8)
        assert not q and len(q) == 0
        for item, prio in (("a", 0), ("b", 5), ("c", 0), ("d", 5)):
            q.push(item, prio)
        got.append([q.pop() for _ in range(4)])
    assert got[1] == got[0] == ["b", "d", "a", "c"]


def test_admission_queue_capacity_and_force():
    for mod in (ref_robust, robust):
        q = mod.AdmissionQueue(capacity=2)
        assert q.push(1) and q.push(2)
        assert q.full
        assert not q.push(3)          # refused, not enqueued
        assert len(q) == 2
        assert q.push(4, force=True)  # recovery path bypasses the bound
        assert len(q) == 3


def test_admission_queue_remove_if():
    got = []
    for mod in (ref_robust, robust):
        q = mod.AdmissionQueue(capacity=8)
        for i in range(6):
            q.push(i, priority=i % 2)
        evens = q.remove_if(lambda x: x % 2 == 0)
        got.append((sorted(evens), q.items()))
    assert got[1] == got[0]
    assert got[1][0] == [0, 2, 4] and sorted(got[1][1]) == [1, 3, 5]


def test_admission_policy_validates():
    for mod in (ref_robust, robust):
        with pytest.raises(ValueError):
            mod.AdmissionPolicy(queue_capacity=0, degraded_depth=1)
        with pytest.raises(ValueError):
            mod.AdmissionPolicy(queue_capacity=4, degraded_depth=-1)
    assert robust.CIRCUIT_CODES == ref_robust.CIRCUIT_CODES


def test_injector_fires_once_per_trigger():
    for side in (REF, PORT):
        inj = side["robust"].ServeFaultInjector(
            fail_ticks=(2,), slow_ticks=(1,), slow_s=0.5,
            poison=((3, 0),))
        assert inj.faults_remaining == 3
        inj.check_tick(0)                      # not scheduled: no raise
        assert inj.stall_s(1) == 0.5
        assert inj.stall_s(1) == 0.0           # fired
        with pytest.raises(side["errors"].InjectedFault):
            inj.check_tick(2)
        inj.check_tick(2)                      # fired: no raise
        assert inj.poison_slots(3) == (0,)
        assert inj.poison_slots(3) == ()
        assert inj.faults_remaining == 0


def test_error_taxonomy_matches_reference():
    for name in ("GraphValidationError", "AdmissionRejected",
                 "QueueFullError", "DeadlineExceeded", "InjectedFault",
                 "TickRetriesExhausted"):
        r, t = getattr(ref_errors, name), getattr(errors, name)
        assert [c.__name__ for c in t.__mro__] == \
            [c.__name__ for c in r.__mro__], name
    e = errors.DeadlineExceeded("x", uid=3, elapsed_s=1.5, budget_s=1.0,
                                where="queued")
    assert (e.uid, e.elapsed_s, e.budget_s, e.where) == (3, 1.5, 1.0,
                                                         "queued")
    assert errors.AdmissionRejected("x", decision=7).decision == 7


# -- admission control --------------------------------------------------------

def test_bounded_queue_rejects_typed():
    def drive(eng, side):
        admitted, circuits = 0, []
        for i in range(9):
            try:
                assert eng.submit(side["ge"].BfsQuery(uid=i, root=i)) \
                    .admitted
                admitted += 1
            except side["errors"].QueueFullError as e:
                assert isinstance(e, side["errors"].AdmissionRejected)
                assert "capacity" in e.decision.reason
                circuits.append(e.decision.circuit)
        shed = eng.metrics.snapshot()["gauges"]["serve.circuit_state"]
        ticks = eng.run_until_done()
        healthy = eng.metrics.gauge("serve.circuit_state").value
        return admitted, circuits, shed, ticks, healthy
    _, port, r, p = _both(drive, batch_slots=2, queue_capacity=3)
    assert p == r
    assert p[0] == 3 and p[1] == [robust.CIRCUIT_SHEDDING] * 6
    assert p[2] == robust.CIRCUIT_CODES[robust.CIRCUIT_SHEDDING]
    assert p[4] == robust.CIRCUIT_CODES[robust.CIRCUIT_HEALTHY]
    _valid(CSR, port.finished)


def test_priority_shedding_when_degraded():
    def drive(eng, side):
        _submit_all(eng, side, range(4))
        eng.step()   # fills the slot -> occupancy 1.0, queue depth 3
        state = eng.circuit_state()
        with pytest.raises(side["errors"].AdmissionRejected) as ei:
            eng.submit(side["ge"].BfsQuery(uid=90, root=1, priority=0))
        assert not isinstance(ei.value, side["errors"].QueueFullError)
        assert eng.submit(side["ge"].BfsQuery(uid=91, root=2,
                                              priority=9)).admitted
        eng.run_until_done()
        return state, ei.value.decision.reason
    _, port, r, p = _both(drive, batch_slots=1, admission=dict(
        queue_capacity=64, degraded_depth=2, shed_min_priority=5))
    assert p == r and p[0] == robust.CIRCUIT_DEGRADED
    assert "shedding" in p[1]
    assert {q.uid for q in port.finished} == {0, 1, 2, 3, 91}
    _valid(CSR, port.finished)


def test_priority_order_drains_high_first():
    def drive(eng, side):
        eng.submit(side["ge"].BfsQuery(uid=0, root=0))
        eng.step()
        eng.submit(side["ge"].BfsQuery(uid=1, root=1, priority=0))
        eng.submit(side["ge"].BfsQuery(uid=2, root=2, priority=3))
        return eng.run_until_done()
    _, port, r, p = _both(drive, batch_slots=1)
    assert p == r
    uids = [q.uid for q in port.finished]
    assert uids.index(2) < uids.index(1)


# -- deadlines ----------------------------------------------------------------

def test_queued_deadline_expires_without_running():
    def drive(eng, side):
        eng.submit(side["ge"].BfsQuery(uid=0, root=0))
        q = side["ge"].BfsQuery(uid=1, root=1, deadline_s=0.0)
        eng.submit(q)
        eng.run_until_done()
        return q.error.budget_s
    _, port, r, p = _both(drive, batch_slots=1)
    q = next(q for q in port.finished if q.uid == 1)
    assert q.done and q.truncated and q.parent is None
    assert isinstance(q.error, errors.DeadlineExceeded)
    assert (q.error.where, q.error.uid, p) == ("queued", 1, r)


def test_in_flight_deadline_returns_partial():
    """After a warm query, a stall of the query's second tick trips its
    deadline mid-traversal: a partial tree rooted at 0 is delivered."""
    def drive(eng, side):
        eng.submit(side["ge"].BfsQuery(uid=99, root=0))
        eng.run_until_done()
        eng.injector = side["robust"].ServeFaultInjector(
            slow_ticks=(eng._tick_no + 1,), slow_s=1.2)
        q = side["ge"].BfsQuery(uid=0, root=0, deadline_s=1.0)
        eng.submit(q)
        eng.step()   # fills the slot, runs layer 1 (under the deadline)
        assert not q.done
        eng.run_until_done()      # the stalled tick trips the deadline
        return q.parent[:4].tolist()
    _, port, r, p = _both(drive, graph=PATH, batch_slots=1,
                          spec=dict(max_layers=200))
    q = next(q for q in port.finished if q.uid == 0)
    assert q.done and q.truncated and q.n_layers == 2
    assert isinstance(q.error, errors.DeadlineExceeded)
    assert q.error.where == "in_flight"
    assert p == r and p[0] == 0
    assert port.metrics.snapshot()["counters"][
        "serve.deadline_exceeded"] == 1


def test_per_query_layer_budget_overrides_spec():
    def drive(eng, side):
        q = side["ge"].BfsQuery(uid=0, root=0, max_layers=1)
        eng.submit(q)
        eng.run_until_done()
    _, port, _, _ = _both(drive, batch_slots=1)
    (q,) = port.finished
    assert q.truncated and q.n_layers == 1
    assert q.error is None       # layer truncation is budget, not error


def test_global_budget_harvests_everything():
    def drive(eng, side):
        _submit_all(eng, side, range(6))
        eng.run_until_done(budget_s=0.0)
        return len(eng.queue)
    _, port, r, p = _both(drive, batch_slots=2)
    assert p == r == 0 and len(port.finished) == 6
    for q in port.finished:
        assert isinstance(q.error, errors.DeadlineExceeded)
        assert q.error.where == "global"


def test_slow_tick_trips_deadline():
    def drive(eng, side):
        _submit_all(eng, side, [0], deadline_s=1.0)
        eng.run_until_done()
    _, port, _, _ = _both(drive, graph=PATH, batch_slots=1,
                          spec=dict(max_layers=200),
                          injector=dict(slow_ticks=(0,), slow_s=1.2))
    (q,) = port.finished
    assert q.done and q.truncated and q.n_layers == 1
    assert isinstance(q.error, errors.DeadlineExceeded)
    assert q.error.where == "in_flight"


# -- fault injection / recovery ----------------------------------------------

def test_injected_failures_retry_and_lose_nothing():
    def drive(eng, side):
        _submit_all(eng, side, [(i * 11) % V for i in range(10)])
        eng.run_until_done()
        return eng.injector.faults_remaining
    _, port, r, p = _both(drive, injector=dict(fail_ticks=(0, 2, 5)))
    assert p == r == 0
    assert {q.uid for q in port.finished} == set(range(10))
    assert port.metrics.snapshot()["counters"]["serve.retries"] == 3
    assert all(not q.truncated and q.error is None for q in port.finished)
    _valid(CSR, port.finished)


def test_poisoned_result_never_delivered():
    def drive(eng, side):
        _submit_all(eng, side, range(8))
        eng.run_until_done()
    _, port, _, _ = _both(drive, injector=dict(poison=((0, 0), (1, 2))))
    snap = port.metrics.snapshot()["counters"]
    assert snap["serve.poisoned"] == snap["serve.requeued"] == 2
    assert len(port.finished) == 8
    assert len([q for q in port.finished if q.retries > 0]) == 2
    _valid(CSR, port.finished)


def test_retry_exhaustion_requeues_then_raises_typed():
    def always_fail(rob):
        class AlwaysFail(rob.ServeFaultInjector):
            def check_tick(self, tick):
                if tick == 0:
                    raise InjectedFaultOf[rob]("tick 0 always fails")
        return AlwaysFail()

    def drive(eng, side):
        qs = _submit_all(eng, side, range(4))
        with pytest.raises(side["errors"].TickRetriesExhausted) as ei:
            eng.step()
        assert isinstance(ei.value, RuntimeError)
        assert isinstance(ei.value.__cause__, side["errors"].InjectedFault)
        queued = len(eng.queue)
        retries = [q.retries for q in qs]
        eng.run_until_done()
        return queued, retries
    InjectedFaultOf = {ref_robust: ref_errors.InjectedFault,
                       robust: errors.InjectedFault}
    _, port, r, p = _both(drive, injector=always_fail, max_tick_retries=2)
    assert p == r == (4, [1, 1, 1, 1])
    assert {q.uid for q in port.finished} == {0, 1, 2, 3}
    _valid(CSR, port.finished)


def test_nonconvergence_report_carries_slot_state():
    for side in (REF, PORT):
        eng = _engine(side, batch_slots=2)
        eng.submit(side["ge"].BfsQuery(uid=0, root=0, deadline_s=120.0))
        eng.submit(side["ge"].BfsQuery(uid=1, root=1))
        with pytest.raises(RuntimeError) as ei:
            eng.run_until_done(max_ticks=1)
        msg = str(ei.value)
        assert "deadline_remaining_s" in msg
        assert "retries" in msg and "circuit=" in msg


def test_finished_queries_are_exactly_once():
    """No duplicate delivery under mixed injection."""
    def drive(eng, side):
        _submit_all(eng, side, [(i * 5) % V for i in range(12)])
        eng.run_until_done()
    _, port, _, _ = _both(drive, injector=dict(fail_ticks=(1,),
                                               poison=((0, 1),)))
    uids = [q.uid for q in port.finished]
    assert sorted(uids) == list(range(12)) and len(set(uids)) == 12
    _valid(CSR, port.finished)


@pytest.mark.parametrize("pipeline", ["fused_gather", "persistent"])
@pytest.mark.parametrize("how", ["step_then_raise", "corrupt_then_raise"])
def test_failed_tick_that_mutated_state_corrupts_nothing(pipeline, how):
    """A tick that updates its inputs in place and then fails: the retry
    runs on the pre-tick state, so no slot is corrupted and no query is
    lost (the answers equal an engine without the fault)."""
    def run(fault: bool):
        eng = _engine(PORT, graph_format="csr",
                      spec=dict(pipeline=pipeline))
        step = eng.compiled.layer_step
        fired = []

        def failing(frontier, visited, parent):
            out = step(frontier, visited, parent)
            if fault and eng._tick_no in (2, 4) \
                    and eng._tick_no not in fired:
                fired.append(eng._tick_no)
                if how == "corrupt_then_raise":
                    parent.fill_(7)
                    visited.zero_()
                    frontier.fill_(-1)
                raise errors.InjectedFault("failed after mutating state")
            return out
        eng.compiled.layer_step = failing
        _submit_all(eng, PORT, [(i * 7) % V for i in range(10)])
        eng.run_until_done()
        return eng, fired
    eng, fired = run(True)
    base, _ = run(False)
    assert fired == [2, 4]
    snap = eng.metrics.snapshot()["counters"]
    assert snap["serve.retries"] == 2
    assert snap["serve.poisoned"] == snap["serve.requeued"] == 0
    assert [(q.uid, q.n_layers) for q in eng.finished] == \
        [(q.uid, q.n_layers) for q in base.finished]
    assert all(q.retries == 0 and not q.truncated for q in eng.finished)
    _valid(CSR, eng.finished)


def test_smem_fallback_degrade_is_observable(monkeypatch, caplog):
    """A shared-memory budget that K5 misses: the engine's megakernel
    tick degrades to fused_gather, counted as
    ``serve.degrade.smem_fallback``, logged and kept in the degrade
    log with the budget that failed; the answers are unchanged."""
    from repro_torch.kernels import gather_expand as t_gek
    metrics.clear_degrade_log()
    reg = metrics.get_registry()
    before = reg.counter("serve.degrade.smem_fallback").value
    tile = 128
    monkeypatch.setattr(ops, "SMEM_OPTIN_BYTES",
                        t_gek.stage_bytes(tile, 0) + 1)
    with caplog.at_level(logging.WARNING, logger="repro_torch.serve"):
        eng = _engine(PORT, graph_format="csr",
                      spec=dict(pipeline="megakernel", tile=tile))
    assert reg.counter("serve.degrade.smem_fallback").value == before + 1
    events = [e for e in metrics.degrade_log()
              if e.site == "smem_fallback"]
    assert events and "shared memory" in events[-1].reason
    assert "fused_gather" in events[-1].fallback
    assert any("degrade[smem_fallback]" in r.getMessage()
               for r in caplog.records)
    _submit_all(eng, PORT, range(6))
    eng.run_until_done()
    _valid(CSR, eng.finished)
    metrics.clear_degrade_log()


# -- the spec, run_direct and the portfolio ------------------------------------

def test_tick_is_policy_free():
    with pytest.warns(UserWarning, match="policy-free"):
        eng = _engine(PORT, spec=dict(policy="beamer"))
    assert eng.resolved.policy == tbfs.BeamerHybrid()
    eng = _engine(PORT)
    assert eng.resolved.policy == tbfs.TopDown()
    assert (eng.algorithm, eng.pipeline, eng.packed, eng.prefetch_depth) \
        == ("simd", "fused_gather", True, 0)
    with pytest.raises(ValueError, match="semiring"):
        _engine(PORT, spec=dict(algorithm="sssp"))
    with pytest.raises(errors.GraphValidationError):
        eng.submit(t_ge.BfsQuery(uid=0, root=V))


@pytest.mark.parametrize("pipeline", ["fused_gather", "persistent"])
def test_run_direct_matches_the_ticks(pipeline):
    eng = _engine(PORT, graph_format="csr", spec=dict(pipeline=pipeline))
    roots = [0, 9, 33]
    res = eng.run_direct(roots)
    qs = _submit_all(eng, PORT, roots)
    eng.run_until_done()
    assert [q.n_layers for q in qs] == res.depths.tolist()
    for b, q in enumerate(qs):
        p = tbfs.parents_graph500(res.state, V)[b].numpy()
        assert np.array_equal(p >= 0, q.parent >= 0)


def test_portfolio_matches_reference():
    ref = ref_ge.GraphEngine(CSR, graph_format="csr", spec=RefSpec(
        pipeline="fused_gather", prefetch_depth=0),
        registry=ref_metrics.MetricsRegistry())
    port = _engine(PORT, graph_format="csr")
    for r in (3, [3, 11, 40]):
        (rd, rp), (td, tp) = ref.shortest_paths(r), port.shortest_paths(r)
        assert np.array_equal(np.asarray(rd).view(np.int32),
                              td.view(np.int32))
        assert np.array_equal(np.asarray(rp), tp)
    (rl, rn), (tl, tn) = ref.components(), port.components()
    assert np.array_equal(np.asarray(rl), tl) and rn == tn
    roots = [0, 7, 64]
    assert np.array_equal(np.asarray(ref.ksource_depths(roots)),
                          port.ksource_depths(roots))
    assert port.metrics.counter("serve.portfolio_queries").value \
        == ref.metrics.counter("serve.portfolio_queries").value == 4


# -- on the card --------------------------------------------------------------

@pytest.mark.cuda
def test_engine_on_the_card(cuda_device):
    """The engine on the card answers as on the CPU: the same outcomes
    and counters, valid trees; each tick's finished-slot scan is one
    launch of the measure kernel's count-only arm."""
    runs = []
    for device in ("cpu", cuda_device):
        eng = t_ge.GraphEngine(to_port(CSR), batch_slots=4,
                               registry=metrics.MetricsRegistry(),
                               device=device, injector=robust.
                               ServeFaultInjector(fail_ticks=(1,),
                                                  poison=((0, 1),)),
                               retry_backoff_s=0.001)
        ops.reset_kernel_launches()
        _submit_all(eng, PORT, [(i * 5) % V for i in range(12)])
        ticks = eng.run_until_done()
        runs.append((eng, ticks, dict(ops.KERNEL_LAUNCHES)))
    (cpu, t_cpu, _), (gpu, t_gpu, launched) = runs
    assert [_outcome(q) for q in gpu.finished] == \
        [_outcome(q) for q in cpu.finished]
    assert launched["popcount"] == gpu.metrics.counter("serve.ticks").value
    _valid(CSR, gpu.finished)
