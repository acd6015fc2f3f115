"""Find a cell's parts by name: its workload entry in ``BENCHMARK.json``,
its configuration file, its traffic file and the reader of each
per-layer metric that lists it.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in a file of its own, so a new cell is a
``workloads`` entry plus, where needed, new files:
``configs/<config>.json``, ``traffic/<mix>.json`` (read by the driver
it names, under ``drivers/``) and ``metrics/<metric>.py`` (a
``read(record)`` function).
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    readers: dict = field(default_factory=dict)  # metric name -> read()


def _listed(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_reader(path: Path):
    spec = importlib.util.spec_from_file_location(
        "graphbench_metric_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def resolve(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files read
    from ``root/graphbench``.  Raises `KeyError` for an unknown cell."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(by_name)}")
    w = by_name[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((root / conf["file"]).read_text())
    base = root / "graphbench"
    traffic = json.loads((base / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    e2e = [m for m in bench["end_to_end"] if _listed(m, name)]
    layers = [m for m in bench["per_layer"] if _listed(m, name)]
    readers = {m["name"]: load_reader(base / "metrics" / f"{m['name']}.py")
               for m in layers}
    return Cell(name, int(w["chips"]), config, traffic, e2e, layers,
                readers)
