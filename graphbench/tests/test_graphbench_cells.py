"""The harness finds every part of a cell by name, a new cell needs only
new files and a ``workloads`` entry, the per-layer readers read what is
there and nothing else, and a run refuses to go on without a GPU or
with the JAX package loaded."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from graphbench import cells, run
from graphbench.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(name):
    c = cells.resolve(name)
    assert c.config["scale"] == 25 and c.traffic["driver"] == "search"
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer and set(c.readers) == {m["name"]
                                              for m in c.per_layer}
    for m in c.per_layer:
        assert m["moves"] in names


def test_contract_shape():
    assert BENCH["command"] == ["python3", "-m", "graphbench.run"]
    assert BENCH["paths"] == ["graphbench"]
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert set(c["reduced"]) <= set(cfg["reduced"])
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_new_cell_is_files_only(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files plus one ``workloads`` entry: nothing existing is edited."""
    shutil.copytree(ROOT / "graphbench", tmp_path / "graphbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((ROOT / "graphbench/configs/kron-s25.json")
                     .read_text())
    (tmp_path / "graphbench/configs/kron-s22.json").write_text(
        json.dumps(dict(cfg, name="kron-s22", scale=22)))
    (tmp_path / "graphbench/traffic/search64.json").write_text(json.dumps(
        {"driver": "search", "batch": 64, "keys": 64, "check": 16}))
    (tmp_path / "graphbench/metrics/calls.search64.py").write_text(
        "def read(rec):\n    return rec.traced.get('calls')\n")
    bench["configs"].append(dict(bench["configs"][0], name="kron-s22",
                                 file="graphbench/configs/kron-s22.json"))
    bench["workloads"].append({"name": "kron-s22.search64",
                               "config": "kron-s22", "traffic": "search64",
                               "chips": 1, "why": "root sharing"})
    bench["end_to_end"][0]["workloads"].append("kron-s22.search64")
    bench["per_layer"].append({"name": "calls.search64", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "gteps",
                               "workloads": ["kron-s22.search64"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = cells.resolve("kron-s22.search64", root=tmp_path)
    assert c.config["scale"] == 22 and c.traffic["batch"] == 64
    assert "calls.search64" in c.readers
    rec = run.Record(traced={"calls": 3})
    assert c.readers["calls.search64"](rec) == 3
    with pytest.raises(KeyError):
        cells.resolve("nope.search1", root=tmp_path)


def trace_of(device, host, window_s=1.0):
    return Trace(window_s, 0.0, device, host)


def test_trace_busy_and_gaps():
    dev = [(0.0, 100.0, "k1", "kernel"), (50.0, 100.0, "k1", "kernel"),
           (400.0, 100.0, "copy", "gpu_memcpy"),
           (900.0, 50.0, "k2", "kernel")]
    host = [(0.0, 1000.0, "graphbench.window"),
            (150.0, 250.0, "graphbench.search"),
            (200.0, 100.0, "cudaStreamSynchronize"),
            (500.0, 400.0, "graphbench.other")]
    t = trace_of(dev, host, window_s=1e-3)
    assert t.busy_s() == pytest.approx(300e-6)
    assert t.device_s() == pytest.approx(350e-6)
    assert t.device_s(("kernel",)) == pytest.approx(250e-6)
    assert t.device_ops()[0] == ["k1", pytest.approx(200e-6)]
    gaps = dict(t.idle_gaps())
    assert gaps == {"graphbench.search/cudaStreamSynchronize":
                    pytest.approx(250e-6),
                    "graphbench.other": pytest.approx(400e-6),
                    "graphbench.window": pytest.approx(50e-6)}
    assert t.busy_s() / t.window_s + sum(gaps.values()) / t.window_s \
        == pytest.approx(1.0)


@pytest.mark.parametrize("name,idle,roofline", [
    ("kron-s25.search8", "idle_share.search", "search_roofline"),
    ("kron-s25.search1", "idle_share.search1", "search1_roofline")])
def test_readers_read_what_is_there(name, idle, roofline):
    tr = trace_of([(0.0, 250.0, "k", "kernel")],
                  [(0.0, 1000.0, "graphbench.window")], window_s=1e-3)
    traced = run.Record(spans={"plan": 1.5}, trace=tr,
                        traced={"calls": np.array([2]), "bytes": 3.35e6})
    r = cells.resolve(name).readers
    assert set(r) == {"plan_s", idle, roofline}
    assert r["plan_s"](traced) == 1.5
    assert r[idle](traced) == pytest.approx(0.75)
    assert r[roofline](traced) == pytest.approx(0.4)
    untraced = run.Record(spans={"plan": 1.0})
    assert r[idle](untraced) is None
    assert r[roofline](untraced) is None
    idle_device = run.Record(trace=trace_of(
        [], [(0.0, 1000.0, "graphbench.window")], window_s=1e-3),
        traced={"bytes": 3.35e6})
    assert r[roofline](idle_device) is None


def _env():
    return dict(os.environ, PYTHONPATH="", CUDA_VISIBLE_DEVICES="")


def test_run_imports_no_jax():
    code = ("import sys; sys.path.insert(0, 'src'); "
            "import graphbench.run as r, graphbench.control; "
            "import graphbench.drivers.search; "
            "import repro_torch.bfs; "
            "print(r.foreign_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_needs_a_gpu():
    out = subprocess.run(
        [sys.executable, "-m", "graphbench.run", "--workload",
         "kron-s25.search8", "--seed", str(2**31 + 3), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=_env(), capture_output=True,
        text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_foreign_modules_by_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", object())
    assert "repro" not in run.foreign_modules() or "repro" in sys.modules
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert "jaxlib" in run.foreign_modules()


def test_sub_seeds_are_stable_and_distinct():
    s = 2**31 + 12345
    assert run.sub_seed(s, 0) == run.sub_seed(s, 0)
    assert len({run.sub_seed(s, k) for k in range(3)}) == 3
    assert 0 <= run.sub_seed(2**40, 1) < 2**63
