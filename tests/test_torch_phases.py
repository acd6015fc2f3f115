"""The main path's own tracing (`repro_torch.obs.trace`): the per-call
profiler ranges of `CompiledTraversal.run` / ``run_batched``, the
collector of K6 / K10 launches and the decoding of their phase stamps
and barrier waits.

On the CPU: no range and no launch while no profiler records; under
``torch.profiler`` one ``bfs.run`` range a call with ``bfs.roots``,
``bfs.init`` and (persistent) ``bfs.launch`` inside it; the collector's
bound and order; `read_phases` on hand-made buffers; `trace_run`'s
persistent branch taking its layer seconds from a recorded launch.  On
the card (tests marked ``cuda``): K6 and K10 at SCALE 20 with 8 roots
give the same outputs with stamps on and off, the stamps are ordered
and counted as the layers say, the waits fit inside the CTAs' cycles,
and each launch's stamps lie inside its kernel event.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.bfs as tbfs
from repro_torch import formats
from repro_torch.core import engine as t_engine
from repro_torch.core import rmat
from repro_torch.core.csr import from_edges
from repro_torch.kernels import traversal_fused as t_tf
from repro_torch.obs import trace
from repro_torch.obs.trace import (PHASES, KernelPhases, Launch,
                                   read_phases, stamp_count, wait_count)

RANGES = (trace.RUN_RANGE, trace.ROOTS_RANGE, trace.INIT_RANGE,
          trace.LAUNCH_RANGE)


@pytest.fixture(scope="module")
def rmat9_cpu():
    return rmat.generate(3, 9, device="cpu")


def _plan(edges, pipeline, device="cpu"):
    return tbfs.plan(edges, tbfs.TraversalSpec(pipeline=pipeline),
                     device=device)


def _call(ct, entry):
    if entry == "run":
        return ct.run(5)
    return ct.run_batched([1, 2, 5])


@pytest.mark.parametrize("entry", ["run", "run_batched"])
@pytest.mark.parametrize("pipeline", ["persistent", "fused_gather"])
def test_untraced_call_opens_nothing(rmat9_cpu, monkeypatch, pipeline,
                                     entry):
    """With no profiler recording, no ``bfs.*`` range is opened and the
    collector takes nothing."""
    import torch.profiler as tp
    opened = []
    real = tp.record_function
    monkeypatch.setattr(tp, "record_function",
                        lambda name, *a: opened.append(name)
                        or real(name, *a))
    ct = _plan(rmat9_cpu, pipeline)
    added = PHASES.added
    _call(ct, entry)
    assert [n for n in opened if n.startswith("bfs.")] == []
    assert PHASES.added == added and not PHASES.on


@pytest.mark.parametrize("entry", ["run", "run_batched"])
@pytest.mark.parametrize("pipeline", ["persistent", "fused_gather"])
def test_profiled_call_ranges_once(rmat9_cpu, pipeline, entry):
    """Under ``torch.profiler``: one ``bfs.run`` a call (``run`` goes
    through the batched path without a second one), the inner ranges
    once each and inside it; the CPU path records no launch."""
    ct = _plan(rmat9_cpu, pipeline)
    assert ct.resolved.pipeline == pipeline
    added = PHASES.added
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _call(ct, entry)
        _call(ct, entry)
    ev = [e for e in prof.events() if e.name in RANGES]
    count = {n: sum(e.name == n for e in ev) for n in RANGES}
    assert count == {trace.RUN_RANGE: 2, trace.ROOTS_RANGE: 2,
                     trace.INIT_RANGE: 2,
                     trace.LAUNCH_RANGE: 2 if pipeline == "persistent"
                     else 0}
    runs = [e.time_range for e in ev if e.name == trace.RUN_RANGE]
    for e in ev:
        if e.name != trace.RUN_RANGE:
            assert sum(r.start <= e.time_range.start
                       and e.time_range.end <= r.end for r in runs) == 1
    assert PHASES.added == added and not PHASES.on


def test_traced_call_records_only_while_profiling():
    seen = []
    trace.traced_call(lambda: seen.append(PHASES.on))
    with profile(activities=[ProfilerActivity.CPU]):
        trace.traced_call(lambda: seen.append(PHASES.on))
    trace.traced_call(lambda: seen.append(PHASES.on))
    assert seen == [False, True, False]


def _launch(kernel="traversal_fused", *, max_layers=4, layers=2,
            stamps=None, waits=None, modes=(1, 2)):
    """A launch whose buffers are filled by hand (CPU tensors)."""
    st = torch.zeros((stamp_count(max_layers),), dtype=torch.int64)
    wt = torch.zeros((wait_count(max_layers),), dtype=torch.int64)
    if stamps is not None:
        st[:len(stamps)] = torch.as_tensor(stamps)
    if waits is not None:
        for i, v in waits.items():
            wt[i] = v
    stats = torch.zeros((max_layers, 8), dtype=torch.int32)
    stats[:layers, 3] = torch.as_tensor(modes[:layers])
    return Launch(kernel, 8, 3, max_layers, st, wt, stats,
                  torch.tensor([layers], dtype=torch.int32))


def test_read_phases_decodes_by_hand():
    # entry 1000; start-up barriers at 1100, 1200; layer 0's four
    # barriers at 1210, 1230, 1330, 1400; layer 1's at 1405, 1410, 1510,
    # 1600
    stamps = [1000, 1100, 1200, 1210, 1230, 1330, 1400, 1405, 1410, 1510,
              1600]
    m = 4
    waits = {0: 7, 2: 11, 4: 1, 6: 5, 4 * m: 3, 4 * m + 1: 2,
             4 * (m + 1): 400, 4 * (m + 1) + 1: 3}
    p = read_phases(_launch(stamps=stamps, waits=waits))
    assert p.layers == 2 and p.n_batch == 8 and p.grid == 3
    assert p.stamps_ns.tolist() == stamps
    assert p.layer_ns.tolist() == [[10, 20, 100, 70], [5, 5, 100, 90]]
    assert p.startup_ns == 200 and p.span_ns == 600 and p.walk_ns == 200
    assert p.wait_cycles.tolist() == [[7, 0, 11, 0], [1, 0, 5, 0],
                                      [3, 2, 0, 0]]
    assert p.wait_total == 29 and p.cta_cycles == 400 and p.ctas == 3
    assert p.modes.tolist() == [1, 2]
    assert p.layer_seconds() == pytest.approx([200e-9, 200e-9])
    assert trace.align_us(p, 50.0).tolist() == pytest.approx(
        [50.0 + (s - 1000) / 1e3 for s in stamps])


def test_read_phases_of_a_launch_with_no_layer():
    p = read_phases(_launch(layers=0, stamps=[5, 6, 9]))
    assert p.layers == 0 and p.layer_ns.shape == (0, 4)
    assert p.span_ns == 4 and p.walk_ns == 0 and p.layer_seconds() == []


def test_waits_are_uint64_bits():
    """A wait slot past 2**63 cycles reads back unsigned."""
    big = -(2**62)             # int64 bits of 3 * 2**62
    p = read_phases(_launch(waits={4 * 5: big}))
    assert p.cta_cycles == 3 * 2**62


def test_buffer_sizes_are_the_kernels():
    """traversal_loop.cuh's slots: entry, 2 start-up barriers and 4 a
    layer of stamps; 4 waits a layer and the start-up's, then 2
    totals."""
    assert stamp_count(64) == 2 + 4 * 64 + 1
    assert wait_count(64) == 4 * (64 + 1) + 2


def test_collector_keeps_the_latest_in_order():
    c = KernelPhases(cap=3)
    stamps, waits = c.buffers(4, "cpu")
    assert stamps.shape == (stamp_count(4),) and waits.shape == \
        (wait_count(4),) and int(stamps.abs().sum() + waits.abs().sum()) \
        == 0
    for i, k in enumerate(["traversal_fused", "sell_traversal_fused",
                           "traversal_fused", "traversal_fused",
                           "traversal_fused"]):
        c.add(k, i, 1, 4, stamps, waits, None, None)
    assert c.added == 5 and len(c.launches) == 3
    assert [x.n_batch for x in c.last("traversal_fused", 2)] == [3, 4]
    assert [x.n_batch for x in c.last("traversal_fused", 9)] == [2, 3, 4]
    assert c.last("sell_traversal_fused", 1) == []
    assert c.last("traversal_fused", 0) == []
    assert not c.on
    with c.recording():
        assert c.on
        with c.recording():
            assert c.on
        assert c.on
    assert not c.on


def test_trace_run_persistent_reads_stamped_layers(rmat9_cpu,
                                                    monkeypatch):
    """Where the launch was recorded, each layer's seconds are its
    stamped ones, summing to at most the span; the plain version on the
    CPU records nothing, so this stands in a launch that stamps its
    layers 1 µs apart per phase step."""
    plain = t_tf.traversal_fused_plain

    def stamped(*a, **kw):
        out = plain(*a, **kw)
        if PHASES.on:
            layers = int(out[4][0])
            st, wt = PHASES.buffers(kw["max_layers"], "cpu")
            n = stamp_count(layers)
            st[:n] = torch.arange(n, dtype=torch.int64) ** 2 * 1000
            PHASES.add("traversal_fused", int(out[0].shape[0]), 1,
                       kw["max_layers"], st, wt, out[5], out[4])
        return out

    monkeypatch.setattr(t_tf, "traversal_fused_plain", stamped)
    ct = _plan(rmat9_cpu, "persistent")
    added = PHASES.added
    ct.run_batched([1, 2])
    assert PHASES.added == added
    tr = ct.trace_run([1, 2])
    assert PHASES.added == added + 1 and not PHASES.on
    layers = len(tr.stats)
    ends = [(2 + 4 * l) ** 2 * 1000 for l in range(layers + 1)]
    assert tr.layer_seconds == pytest.approx(
        [(b - a) / 1e9 for a, b in zip(ends, ends[1:])])
    span = tr.tracer.spans[0]
    assert span.name == trace.PERSISTENT_SPAN
    assert sum(tr.layer_seconds) <= span.dur_us / 1e6


# -- on the card -------------------------------------------------------

@pytest.fixture(scope="module")
def rmat20_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return from_edges(rmat.generate(7, 20, device="cuda"), device="cuda")


def _cuda_case(csr, layout, policy):
    """The plan, the kernel's graph, the initial state of 8 roots of
    degree > 0, the launch's arguments and the wrapper."""
    graph = csr if layout == "csr" else formats.SellFormat.from_csr(csr)
    ct = tbfs.plan(graph, tbfs.TraversalSpec(policy=policy,
                                             pipeline="persistent"),
                   device="cuda")
    spec = ct.resolved
    roots = _roots(csr, 8)
    state = t_engine._init_batched(
        torch.as_tensor(roots, dtype=torch.int32, device="cuda"),
        ct.fmt.n_vertices, ct.fmt.n_vertices_padded)
    kw = dict(code=t_engine.encode_policy(spec.policy, ct.fmt.n_vertices,
                                          8, spec.max_layers),
              max_layers=spec.max_layers,
              prefetch_depth=spec.prefetch_depth)
    launch = (t_tf.traversal_fused_cuda if layout == "csr"
              else t_tf.sell_traversal_fused_cuda)
    return ct, ct.fmt.persistent_graph(spec), state, kw, launch


def _roots(csr, n, skip=0):
    """``n`` vertices of degree > 0 from a fixed seed."""
    deg = torch.diff(csr.colstarts).cpu().numpy()[:csr.n_vertices]
    pick = np.random.default_rng(skip).choice(np.nonzero(deg > 0)[0], n,
                                              replace=False)
    return [int(v) for v in pick]


POLICIES = ["beamer", "topdown"]


@pytest.mark.cuda
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("layout", ["csr", "sell"])
def test_cuda_stamps_change_no_output(rmat20_cuda, layout, policy):
    """Frontier, visited, depths, layers and stats bitwise with stamps
    on and off; P bitwise where two untraced launches agree bitwise (the
    walks' parent writes race by design), else the same vertices
    marked."""
    _, graph, state, kw, launch = _cuda_case(rmat20_cuda, layout, policy)
    off = launch(graph, *state, **kw)
    off2 = launch(graph, *state, **kw)
    added = PHASES.added
    with PHASES.recording():
        on = launch(graph, *state, **kw)
    torch.cuda.synchronize()
    assert PHASES.added == added + 1
    for i in (0, 1, 3, 4, 5):
        assert torch.equal(on[i], off[i])
    if torch.equal(off[2], off2[2]):
        assert torch.equal(on[2], off[2])
    else:
        assert torch.equal(on[2] >= 0, off[2] >= 0)
        assert torch.equal(on[2] != state[2], off[2] != state[2])


@pytest.mark.cuda
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("layout", ["csr", "sell"])
def test_cuda_stamps_are_well_formed(rmat20_cuda, layout, policy):
    _, graph, state, kw, launch = _cuda_case(rmat20_cuda, layout, policy)
    with PHASES.recording():
        out = launch(graph, *state, **kw)
    torch.cuda.synchronize()
    x = PHASES.launches[-1]
    assert x.kernel == ("traversal_fused" if layout == "csr"
                        else "sell_traversal_fused")
    layers = int(out[4][0])
    raw = x.stamps.cpu().numpy()
    n = stamp_count(layers)
    assert (raw[:n] > 0).all() and (raw[n:] == 0).all()
    assert (np.diff(raw[:n]) >= 0).all()
    p = read_phases(x)
    assert p.layers == layers and p.ctas == x.grid
    assert (p.wait_cycles <= p.cta_cycles).all()
    assert p.wait_total <= p.cta_cycles
    waits = x.waits.cpu().numpy().view(np.uint64)
    assert (waits[4 * layers:4 * x.max_layers] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["csr", "sell"])
def test_cuda_stamps_lie_inside_the_kernel_event(rmat20_cuda, layout):
    """Under the profiler, through ``run_batched``: one launch recorded
    a call, and each launch's stamps, placed at its kernel event's start,
    end before the event does (within two %globaltimer steps)."""
    ct, *_ = _cuda_case(rmat20_cuda, layout, "beamer")
    roots = _roots(rmat20_cuda, 32, skip=1)
    ct.run_batched(roots[:8])
    torch.cuda.synchronize()
    added = PHASES.added
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(4):
            ct.run_batched(roots[8 * i:8 * i + 8])
        torch.cuda.synchronize()
    assert PHASES.added == added + 4
    name = "sell_traversal_fused_kernel" if layout == "sell" \
        else "traversal_fused_kernel"
    events = sorted(
        (e for e in prof.events()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and name in e.name and (layout == "sell" or "sell_" not in e.name)),
        key=lambda e: e.time_range.start)
    assert len(events) == 4
    phases = [read_phases(x) for x in list(PHASES.launches)[-4:]]
    steps = np.concatenate([np.diff(p.stamps_ns) for p in phases])
    step = int(np.gcd.reduce(steps[steps > 0]))
    for e, p in zip(events, phases):
        start, end = e.time_range.start, e.time_range.end    # µs
        aligned = trace.align_us(p, start)
        assert aligned[-1] <= end + 2 * step / 1e3
        assert p.span_ns > 0.5 * (end - start) * 1e3


@pytest.mark.cuda
def test_cuda_trace_run_layer_seconds_are_stamped(rmat20_cuda):
    ct, *_ = _cuda_case(rmat20_cuda, "csr", "beamer")
    tr = ct.trace_run(_roots(rmat20_cuda, 8, skip=2))
    p = read_phases(PHASES.launches[-1])
    assert tr.layer_seconds == p.layer_seconds()
    assert len(tr.layer_seconds) == len(tr.stats) == p.layers
    assert sum(tr.layer_seconds) <= tr.tracer.spans[0].dur_us / 1e6
