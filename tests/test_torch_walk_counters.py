"""K6's bottom-up walk counters (``walked``: each bottom-up layer's
neighbour entries tested and slots walked) on the CPU: the K6 wrapper
hands the kernel a zeroed counter buffer only inside a traced call and
a null pointer otherwise (the C entry point replaced by a recorder),
K10's wrapper never does, `read_phases` decodes the buffer, and
``tools/k6_phases.py`` reports ``examined / slots`` of the bottom-up
layers from it on a synthetic trace.
"""
import importlib.util
from pathlib import Path

import pytest
import torch

import repro_torch.bfs as tbfs
from repro_torch import formats
from repro_torch.core import engine as t_engine
from repro_torch.core import rmat
from repro_torch.core.csr import from_edges
from repro_torch.kernels import _build
from repro_torch.kernels import traversal_fused as t_tf
from repro_torch.obs import trace
from repro_torch.obs.trace import (PHASES, KernelPhases, Launch,
                                   read_phases, stamp_count, walked_count)

ROOT = Path(__file__).resolve().parents[1]
#: the pointer arguments of ``repro_traversal_fused`` before ``walked``:
#: the graph (6), the initial state (3), the outputs (3), the union
#: scratch (8), the loop's buffers (5), stamps and waits
WALKED_ARG = 27


class _Recorder:
    """A stand-in for the kernels' library: records each launch's
    arguments and reports success."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        if name.startswith("repro_"):
            def entry(*args):
                self.calls.setdefault(name, []).append(args)
                return 0
            return entry
        raise AttributeError(name)


@pytest.fixture
def recorder(monkeypatch):
    lib = _Recorder()
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(t_tf, "traversal_fused_grid",
                        lambda g, depth: (4, min(g.tile, 1024)))
    monkeypatch.setattr(t_tf, "sell_traversal_fused_grid",
                        lambda g, depth: 4)
    return lib


def _case(layout):
    csr = from_edges(rmat.generate(5, 9, device="cpu"), device="cpu")
    graph = csr if layout == "csr" else formats.SellFormat.from_csr(csr)
    ct = tbfs.plan(graph, tbfs.TraversalSpec(policy="beamer",
                                             pipeline="persistent"),
                   device="cpu")
    spec = ct.resolved
    roots = torch.tensor([1, 2, 5], dtype=torch.int32)
    state = t_engine._init_batched(roots, ct.fmt.n_vertices,
                                   ct.fmt.n_vertices_padded)
    kw = dict(code=t_engine.encode_policy(spec.policy, ct.fmt.n_vertices,
                                          3, spec.max_layers),
              max_layers=spec.max_layers)
    return ct.fmt.persistent_graph(spec), state, kw


def test_k6_wrapper_hands_walk_counters_only_when_traced(recorder):
    graph, state, kw = _case("csr")
    t_tf.traversal_fused_cuda(graph, *state, **kw)
    (args,) = recorder.calls["repro_traversal_fused"]
    assert len(args) == len(_build.SIGNATURES["repro_traversal_fused"])
    assert args[WALKED_ARG - 2:WALKED_ARG + 1] == (None, None, None)
    added = PHASES.added
    with PHASES.recording():
        t_tf.traversal_fused_cuda(graph, *state, **kw)
    args = recorder.calls["repro_traversal_fused"][-1]
    launch = PHASES.launches[-1]
    assert PHASES.added == added + 1 and launch.kernel == "traversal_fused"
    walked = launch.walked
    assert walked is not None and args[WALKED_ARG] == walked.data_ptr()
    assert args[WALKED_ARG - 2] == launch.stamps.data_ptr()
    assert args[WALKED_ARG - 1] == launch.waits.data_ptr()
    assert walked.dtype == torch.int64
    assert walked.shape == (walked_count(kw["max_layers"]),)
    assert int(walked.abs().sum()) == 0


def test_k10_wrapper_hands_no_walk_counters(recorder):
    graph, state, kw = _case("sell")
    with PHASES.recording():
        t_tf.sell_traversal_fused_cuda(graph, *state, **kw)
    args = recorder.calls["repro_sell_traversal_fused"][-1]
    assert len(args) == len(
        _build.SIGNATURES["repro_sell_traversal_fused"])
    launch = PHASES.launches[-1]
    assert launch.kernel == "sell_traversal_fused" and launch.walked is None
    launch.layers.zero_()                 # the recorder ran no layer
    assert read_phases(launch).walked is None


def _launch(c, modes, walked, max_layers=6, span=(1000, 50)):
    """A K6 launch of ``len(modes)`` layers: stamps ``span[1]`` ns apart,
    its walk counters ``walked`` ((examined, slots) a layer)."""
    layers = len(modes)
    st, wt = c.buffers(max_layers, "cpu")
    n = stamp_count(layers)
    st[:n] = span[0] + span[1] * torch.arange(n)
    wt[4 * (max_layers + 1)] = 1000
    wt[4 * (max_layers + 1) + 1] = 2
    wk = c.walked_buffer(max_layers, "cpu")
    wk[:2 * layers] = torch.as_tensor(walked).reshape(-1)
    stats = torch.zeros((max_layers, 8), dtype=torch.int32)
    stats[:layers, 3] = torch.as_tensor(modes)
    c.add("traversal_fused", 8, 2, max_layers, st, wt, stats,
          torch.tensor([layers], dtype=torch.int32), wk)


def test_read_phases_decodes_walk_counters():
    c = KernelPhases()
    _launch(c, [1, 2, 2], [(0, 0), (30, 400), (5, 100)])
    p = read_phases(c.launches[-1])
    assert p.walked.tolist() == [[0, 0], [30, 400], [5, 100]]
    bare = c.launches[-1]._replace(walked=None)
    assert read_phases(bare).walked is None
    assert Launch(*bare[:8]).walked is None        # old callers: no field


def _k6_phases():
    spec = importlib.util.spec_from_file_location(
        "k6_phases", ROOT / "tools" / "k6_phases.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_k6_phases_reports_examined_over_slots():
    """Three launches, bottom-up at layers 1 and 2 of the first and at
    layer 1 of the others: the column sums each position's counters over
    the launches; top-down layers and the third launch, which carries no
    counters, add nothing."""
    from graphbench.trace import Trace
    tool = _k6_phases()
    c = KernelPhases()
    _launch(c, [1, 2, 2, 1], [(0, 0), (30, 400), (5, 100), (0, 0)])
    _launch(c, [1, 2, 1], [(0, 0), (10, 200), (0, 0)])
    _launch(c, [1, 2], [(0, 0), (0, 0)])
    launches = [read_phases(x) for x in c.launches]
    launches[2] = launches[2]._replace(walked=None)
    ev = "void traversal_fused_kernel<false>(CsrLayer, ...)"
    tr = Trace(1e-3, 0.0, [(100.0 * i, 0.05, ev, "kernel")
                           for i in range(3)], [])
    table = tool.phase_table(tr, launches)
    got = table["bottom_up_walked"]
    assert got["examined"] == 45 and got["slots"] == 700
    assert got["examined_over_slots"] == pytest.approx(45 / 700)
    assert [(r["layer"], r["examined"], r["slots"]) for r in
            got["by_layer"]] == [(1, 40, 600), (2, 5, 100)]
    assert got["by_layer"][0]["examined_over_slots"] == \
        pytest.approx(40 / 600)
    assert table["bottom_up_per_launch"] == pytest.approx(4 / 3)
    assert tool.walk_counts([launches[2]]) is None
    assert tool.walk_counts([]) is None


def test_k6_phases_walk_counts_without_bottom_up_layers():
    tool = _k6_phases()
    c = KernelPhases()
    _launch(c, [1, 1], [(0, 0), (0, 0)])
    got = tool.walk_counts([read_phases(c.launches[-1])])
    assert got == {"examined": 0, "slots": 0, "examined_over_slots": None,
                   "by_layer": []}
    assert trace.walked_count(7) == 14
