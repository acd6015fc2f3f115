"""The readers of K6's phases and of the port's per-call ranges
(``metrics/k6_wait_share.*``, ``k6_walk_share.*``,
``run_idle_share.search1``) on hand-made traces and launches: the share
each computes, None where nothing was collected, and only the last N
launches read for the N K6 events of the trace.  Their entries resolve
as any per-layer metric's do."""
import json
import shutil
from pathlib import Path

import pytest
import torch

from graphbench import cells, run
from graphbench.trace import Trace
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.trace import KernelPhases

ROOT = Path(__file__).resolve().parents[2]
METRICS = ROOT / "graphbench" / "metrics"
K6_EVENT = ("(anonymous namespace)::traversal_fused_kernel((anonymous "
            "namespace)::CsrLayer, bfs::Traversal, bfs::UnionBuffers, "
            "bfs::Policy)")
K10_EVENT = "(anonymous namespace)::sell_traversal_fused_kernel(...)"
#: the per-layer entries of these readers, for the cells they read
ENTRIES = [
    {"name": "k6_wait_share.search", "unit": "ratio", "better": "lower",
     "source": "program_counter", "layer": "kernels", "moves": "gteps",
     "workloads": ["kron-s25.search8", "urand-s25.search8"]},
    {"name": "k6_wait_share.search1", "unit": "ratio", "better": "lower",
     "source": "program_counter", "layer": "kernels",
     "moves": "gteps.search1", "workloads": ["kron-s25.search1"]},
    {"name": "k6_walk_share.search", "unit": "ratio", "better": "higher",
     "source": "program_span", "layer": "kernels", "moves": "gteps",
     "workloads": ["kron-s25.search8", "urand-s25.search8"]},
    {"name": "k6_walk_share.search1", "unit": "ratio", "better": "higher",
     "source": "program_span", "layer": "kernels",
     "moves": "gteps.search1", "workloads": ["kron-s25.search1"]},
    {"name": "run_idle_share.search1", "unit": "ratio", "better": "lower",
     "source": "program_span",
     "layer": "api/plan.py run and core/engine.py (per call)",
     "moves": "gteps.search1", "workloads": ["kron-s25.search1"]},
]


def reader(name):
    return cells.load_reader(METRICS / f"{name}.py")


def launch(c, kernel, stamps, waits, cycles, max_layers=4):
    """Add a launch of ``len(stamps) - 3) / 4`` layers to collector
    ``c``: its stamps, barrier waits by slot and CTA cycles."""
    layers = (len(stamps) - 3) // 4
    st, wt = c.buffers(max_layers, "cpu")
    st[:len(stamps)] = torch.as_tensor(stamps)
    for slot, v in waits.items():
        wt[slot] = v
    wt[4 * (max_layers + 1)] = cycles
    wt[4 * (max_layers + 1) + 1] = 2
    stats = torch.zeros((max_layers, 8), dtype=torch.int32)
    c.add(kernel, 8, 2, max_layers, st, wt, stats,
          torch.tensor([layers], dtype=torch.int32))


@pytest.fixture
def phases(monkeypatch):
    c = KernelPhases()
    monkeypatch.setattr(obs_trace, "PHASES", c)
    return c


def k6_trace(n_k6, window_s=1e-3):
    dev = [(100.0 * i, 50.0, K6_EVENT, "kernel") for i in range(n_k6)]
    dev += [(900.0, 10.0, K10_EVENT, "kernel"),
            (950.0, 10.0, "void at::native::fill", "kernel")]
    return Trace(window_s, 0.0, dev, [(0.0, 1000.0, "graphbench.window")])


def fill(c):
    """A leftover launch, then two: one of 1 layer, one of 2."""
    launch(c, "traversal_fused", [0, 1, 2, 3, 4, 500, 600], {2: 999}, 1000)
    launch(c, "traversal_fused", [0, 10, 20, 30, 40, 70, 100],
           {0: 5, 2: 15, 16: 10}, 200)
    launch(c, "sell_traversal_fused", [0, 1, 2, 3, 4, 5, 6], {0: 9}, 9)
    launch(c, "traversal_fused",
           [0, 10, 20, 25, 30, 50, 60, 61, 62, 92, 100],
           {2: 20, 6: 10, 17: 5}, 300)


@pytest.mark.parametrize("name", ["k6_wait_share.search",
                                  "k6_wait_share.search1"])
def test_wait_share_by_hand(phases, name):
    fill(phases)
    rec = run.Record(trace=k6_trace(2))
    # the last two K6 launches: waits 5 + 15 + 10 and 20 + 10 + 5 over
    # cycles 200 + 300
    assert reader(name)(rec) == pytest.approx(65 / 500)
    # three K6 events: the leftover is read too
    assert reader(name)(run.Record(trace=k6_trace(3))) == \
        pytest.approx((65 + 999) / 1500)


@pytest.mark.parametrize("name", ["k6_walk_share.search",
                                  "k6_walk_share.search1"])
def test_walk_share_by_hand(phases, name):
    fill(phases)
    rec = run.Record(trace=k6_trace(2))
    # walks 70 - 40 = 30 and (50 - 30) + (92 - 62) = 50 over spans 100
    # and 100
    assert reader(name)(rec) == pytest.approx(80 / 200)
    assert reader(name)(run.Record(trace=k6_trace(1))) == \
        pytest.approx(50 / 100)


@pytest.mark.parametrize("name", ["k6_wait_share.search",
                                  "k6_wait_share.search1",
                                  "k6_walk_share.search",
                                  "k6_walk_share.search1"])
def test_k6_readers_none_where_nothing_was_collected(phases, monkeypatch,
                                                     name):
    read = reader(name)
    assert read(run.Record()) is None                   # untraced
    assert read(run.Record(trace=k6_trace(2))) is None  # nothing kept
    fill(phases)
    assert read(run.Record(trace=k6_trace(0))) is None  # no K6 event
    # a program without the collector (the parent of this change)
    monkeypatch.delattr(obs_trace, "PHASES")
    assert read(run.Record(trace=k6_trace(2))) is None


def test_k6_readers_leave_sell_launches_out(phases):
    launch(phases, "sell_traversal_fused", [0, 1, 2, 3, 4, 5, 6], {0: 9},
           9)
    rec = run.Record(trace=k6_trace(1))
    assert reader("k6_wait_share.search")(rec) is None
    assert reader("k6_walk_share.search")(rec) is None


def idle_trace(host):
    dev = [(100.0, 200.0, "k", "kernel"), (600.0, 100.0, "k", "kernel")]
    return Trace(1e-3, 0.0, dev, [(0.0, 1000.0, "graphbench.window")]
                 + host)


def test_run_idle_share_by_hand():
    read = reader("run_idle_share.search1")
    # idle [0, 100], [300, 600], [700, 1000]; inside bfs.run [50, 400]
    # and [500, 650]: 50 + 100 + 100
    host = [(50.0, 350.0, "bfs.run"), (500.0, 150.0, "bfs.run"),
            (60.0, 30.0, "bfs.roots"), (10.0, 900.0, "graphbench.search")]
    assert read(run.Record(trace=idle_trace(host))) == pytest.approx(0.25)
    # a range past the window's end counts only inside it; overlapping
    # ranges count once
    host = [(650.0, 1000.0, "bfs.run"), (660.0, 10.0, "bfs.run")]
    assert read(run.Record(trace=idle_trace(host))) == pytest.approx(0.3)
    # the device idle all through
    t = Trace(1e-3, 0.0, [], [(200.0, 100.0, "bfs.run")])
    assert read(run.Record(trace=t)) == pytest.approx(0.1)


def test_run_idle_share_none_without_ranges():
    read = reader("run_idle_share.search1")
    assert read(run.Record()) is None
    assert read(run.Record(trace=idle_trace(
        [(0.0, 500.0, "graphbench.search")]))) is None


def test_entries_resolve_beside_the_accepted_ones(tmp_path):
    """The readers' entries appended to ``per_layer`` resolve in the
    cells they list, each moving an end-to-end metric of the cell."""
    shutil.copytree(ROOT / "graphbench", tmp_path / "graphbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["per_layer"] += ENTRIES
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for e in ENTRIES:
        assert (METRICS / f"{e['name']}.py").exists()
        for w in e["workloads"]:
            c = cells.resolve(w, root=tmp_path)
            assert e["name"] in c.readers
            assert e["moves"] in {m["name"] for m in c.end_to_end}
    assert len({e["layer"] for e in bench["per_layer"]}) == 4

