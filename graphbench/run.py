"""Run one cell of the benchmark and print its result line.

    python3 -m graphbench.run --workload kron-s25.search8 --seed 7 \
        --seconds 10 --trace 0

From the checkout's root, on a machine with the cell's GPUs.  Set-up
makes the cell's graph and search keys on the device (the graph's
tuples and its search keys from the configuration's ``graph_seed``,
the vertex labels and the order of the key batches from ``--seed``), has
the port build its structures from them and warms the cell's own
shapes; the window then drives the cell's entry for ``--seconds``
(with ``--trace 1`` a traced stretch of `TRACE_SECONDS` follows it).
Afterwards the plain reference under ``graphbench/reference`` checks a
sample of the delivered parent trees, drawn from the seed.  The last
line of standard output is the result; the numbers compared, each
beside its limit, are the last lines of standard error.
"""
from __future__ import annotations

import os
import time


def _process_start() -> float:
    """The process's start on the `time.perf_counter` clock (Linux: its
    start time in ``/proc/self/stat``), else now."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = time.clock_gettime(time.CLOCK_BOOTTIME) \
            - ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, AttributeError):
        return now
    return now - max(0.0, age)


T_START = _process_start()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

import numpy as np  # noqa: E402

from graphbench import cells, drivers, trace as tr  # noqa: E402
from graphbench.reference import bfs as ref_bfs  # noqa: E402
from graphbench.reference import graph500, rmat  # noqa: E402

T_IMPORTED = time.perf_counter()   # torch comes in with the reference

#: top-level module names the process may not hold (the JAX package
#: and JAX itself): the port is measured alone
FOREIGN = ("jax", "jaxlib", "flax", "repro")
TRACE_SECONDS = 4.0


def foreign_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FOREIGN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sub_seed(seed: int, stream: int) -> int:
    """An independent 63-bit seed for one use of the run's seed."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), stream])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


@dataclass
class Inputs:
    n_vertices: int
    src: object = None
    dst: object = None
    degree: object = None
    keys: np.ndarray = None
    fingerprint: int = 0


def make_edges(config: dict, seed: int, device):
    """The configuration's graph (its tuples drawn from its
    ``graph_seed``) under vertex labels drawn from ``seed``:
    ``(src, dst, n_vertices, labels)``."""
    return rmat.generate(config["graph_seed"], config["scale"],
                         config["edgefactor"], config["initiator"],
                         device=device, label_seed=sub_seed(seed, 0))


def make_inputs(config: dict, traffic: dict, seed: int, device) -> Inputs:
    """The edge list and the search keys: the same keys of the same
    graph for every seed, under that seed's labels."""
    import torch
    src, dst, v, labels = make_edges(config, seed, device)
    degree = graph500.degrees(src, v)
    drawn = graph500.search_keys(sub_seed(config["graph_seed"], 1),
                                 degree[labels.long()],
                                 int(traffic["keys"]))
    keys = labels[torch.as_tensor(drawn, device=labels.device)]
    return Inputs(v, src, dst, degree, keys.long().cpu().numpy(),
                  rmat.checksum(src, dst))


def make_driver(traffic: dict, inputs: Inputs, device, seed: int):
    """The traffic's driver, with its generator drawn from the seed."""
    return drivers.get(traffic["driver"])(
        traffic, inputs, device, np.random.default_rng(sub_seed(seed, 2)))


@dataclass
class Record:
    """What the per-layer readers read (``metrics/<name>.py``)."""
    spans: dict = field(default_factory=dict)   # host seconds
    trace: tr.Trace | None = None               # the traced stretch
    traced: dict = field(default_factory=dict)  # `Driver.traced`


class Graph:
    """The reference's view of the inputs, made again from the seed after
    the window: the edge list (its checksum has to match the first), the
    degrees, and the components, worked out once when first asked."""

    def __init__(self, config: dict, seed: int, device, inputs: Inputs):
        self.src, self.dst, self.n_vertices, _ = make_edges(config, seed,
                                                            device)
        if rmat.checksum(self.src, self.dst) != inputs.fingerprint:
            raise RuntimeError("the edge list made again from the seed "
                               "differs from the first")
        self.degree = inputs.degree
        self._label = self._comp = None

    def label(self):
        if self._label is None:
            self._label = graph500.components(self.src, self.dst,
                                              self.n_vertices)
        return self._label

    def comp_edges(self):
        if self._comp is None:
            self._comp = graph500.component_edges(self.label(), self.degree)
        return self._comp

    def tree_errors(self, delivered) -> dict:
        """Summed `reference.bfs.tree_errors` of the delivered trees."""
        import torch
        adj = ref_bfs.adjacency(self.src, self.dst, self.n_vertices)
        errors = {"reach": 0, "parent": 0}
        for root, parent in delivered:
            got = ref_bfs.tree_errors(adj, torch.as_tensor(parent), root,
                                      ref_bfs.bfs_depths(adj, root))
            for k in errors:
                errors[k] += got[k]
        return errors


def execute(cell: cells.Cell, seed: int, seconds: float, trace: bool,
            device="cuda", after_setup=None) -> dict:
    import torch
    from repro_torch.core.rmat import EdgeList
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    traffic = cell.traffic
    rec = Record()
    spans = rec.spans
    # interpreter, imports and the device check, from process start
    spans["start"] = time.perf_counter() - T_START
    t = time.perf_counter()
    torch.zeros(1, device=device)
    sync()
    spans["cuda_init"] = time.perf_counter() - t

    t = time.perf_counter()
    inputs = make_inputs(cell.config, traffic, seed, device)
    sync()
    spans["generate"] = time.perf_counter() - t

    driver = make_driver(traffic, inputs, device, seed)
    t = time.perf_counter()
    info = driver.build(EdgeList(inputs.src, inputs.dst, inputs.n_vertices))
    sync()
    spans["plan"] = time.perf_counter() - t
    inputs.src = inputs.dst = None
    t = time.perf_counter()
    driver.warm(sync)
    spans["warm"] = time.perf_counter() - t
    setup_peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    if cuda:
        # the window's peak: what the traffic holds, not the build
        torch.cuda.reset_peak_memory_stats()
    if after_setup is not None:
        after_setup()
    setup_s = time.perf_counter() - T_START
    log(f"setup: {setup_s:.4f} s (" + ", ".join(
        f"{k} {v:.4f}" for k, v in spans.items()) + f"); peak device "
        f"memory {setup_peak} B; {info}")

    t = time.perf_counter()
    driver.run(seconds, sync)
    window_s = time.perf_counter() - t
    counts = driver.counts()
    if trace:
        rec.trace = tr.profile(
            lambda: driver.run(TRACE_SECONDS, lambda: None, traced=True),
            sync)
        after = driver.counts()
        stretch = {k: after[k] - counts[k] for k in after}
    outcome = driver.outcome()
    memory_peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    delivered = driver.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    graph = Graph(cell.config, seed, device, inputs)
    errors = graph.tree_errors(delivered)
    measured = driver.end_to_end(seconds, window_s, counts, graph)
    if trace:
        rec.traced = driver.traced(stretch, graph)
    del driver, graph
    spans["reference"] = time.perf_counter() - t
    log(f"window: {window_s:.4f} s, {outcome}; the window's peak device "
        f"memory {memory_peak} B; reference {spans['reference']:.4f} s "
        f"over {len(delivered)} trees")

    checks = {"reach_errors": {"value": errors["reach"], "limit": 0},
              "parent_errors": {"value": errors["parent"], "limit": 0},
              "trees_checked": {"value": len(delivered), "min": 1}}
    correct = all(c["value"] <= c["limit"] if "limit" in c
                  else c["value"] >= c["min"] for c in checks.values())
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": 1, "memory_peak_bytes": memory_peak}
    metrics = {}
    out = {"correct": bool(correct), "attempted": outcome["attempted"],
           "failed": outcome["failed"], "metrics": metrics, "device": dev}
    if trace:
        for m in cell.per_layer:
            value = cell.readers[m["name"]](rec)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        dev["busy_s"] = rec.trace.busy_s()
        dev["window_s"] = rec.trace.window_s
        out["breakdown"] = {"device_ops": rec.trace.device_ops(),
                            "idle_gaps": rec.trace.idle_gaps()}
    else:
        measured["setup_s"] = (setup_s, "s")
        for m in cell.end_to_end:
            # ``<quantity>.<cells>`` is the driver's ``<quantity>``
            got = measured.get(m["name"],
                               measured.get(m["name"].split(".")[0]))
            if got is None:
                log(f"the run measured no {m['name']}: nothing was "
                    f"delivered")
                continue
            value, unit = got
            metrics[m["name"]] = {"value": value, "unit": unit}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = cells.resolve(args.workload)
    sys.path.insert(0, str(cells.ROOT / "src"))
    t = time.perf_counter()
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        log(f"this cell needs {cell.chips} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"start: interpreter and imports {T_IMPORTED - T_START:.4f} s, "
        f"device check {time.perf_counter() - t:.4f} s")

    def guard():
        found = foreign_modules()
        if found:
            raise SystemExit(f"the process holds {found}: the benchmark "
                             f"measures the port alone")

    out = execute(cell, args.seed, args.seconds, bool(args.trace),
                  after_setup=guard)
    guard()
    for name, c in out["checks"].items():
        log(f"check {name}: {c['value']} "
            + (f"(at most {c['limit']})" if "limit" in c
               else f"(at least {c['min']})"))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
