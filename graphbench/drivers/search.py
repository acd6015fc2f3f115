"""Searches back to back from one caller: `plan(edges)` and then
``run_batched`` over ``batch`` search keys a call (``run(root)`` where
``batch`` is 1), cycling through the run's ``keys`` Graph500 search keys.
The keys fall into batches in the order they were drawn, so every seed
runs the same batches; the seed orders them.

Nothing of the benchmark runs on the device inside the window: each
call's edges are counted after it from the keys alone
(`reference.graph500.traversed_edges`), and the trees checked are those
of the first ``check // batch`` batches in the seed's order, of which
the last delivery is kept.
"""
from __future__ import annotations

import time

import numpy as np

from graphbench.reference import graph500
from graphbench.trace import span


class Driver:
    def __init__(self, traffic: dict, inputs, device, rng):
        self.batch = int(traffic["batch"])
        keys = inputs.keys
        if len(keys) % self.batch:
            raise ValueError(f"{len(keys)} keys do not fill batches of "
                             f"{self.batch}")
        self.batches = keys.reshape(-1, self.batch)[
            rng.permutation(len(keys) // self.batch)]
        # the first batches in the seed's order: a sample drawn from the
        # seed, and the first to run in the window
        n_check = max(1, int(traffic["check"]) // self.batch)
        self.sampled = set(range(min(n_check, len(self.batches))))
        self.device = device
        self.calls = np.zeros(len(self.batches), dtype=np.int64)
        self.kept: dict[int, object] = {}
        self.n = 0
        self.ct = None

    def build(self, edges):
        from repro_torch import bfs
        self.ct = bfs.plan(edges, device=self.device)
        return {"spec": repr(self.ct.resolved),
                "format": self.ct.fmt.name}

    def _call(self, j: int):
        roots = self.batches[j]
        if self.batch == 1:
            return self.ct.run(int(roots[0])).state.parent[None]
        return self.ct.run_batched(roots).state.parent

    def warm(self, sync):
        self._call(0)
        sync()

    def run(self, seconds: float, sync, traced: bool = False):
        """Call back to back until ``seconds`` have passed, then wait for
        the device."""
        t0 = time.perf_counter()
        nb = len(self.batches)
        while time.perf_counter() - t0 < seconds:
            j = self.n % nb
            with span("search", traced):
                parent = self._call(j)
            if j in self.sampled:
                self.kept[j] = parent
            self.calls[j] += 1
            self.n += 1
        sync()

    def counts(self) -> dict:
        return {"calls": self.calls.copy()}

    def outcome(self) -> dict:
        return {"attempted": int(self.calls.sum()) * self.batch,
                "failed": 0}

    def end_to_end(self, seconds, window_s, counts, graph) -> dict:
        """``gteps``: the Graph500 edges of the window's searches over
        its seconds."""
        edges = graph500.traversed_edges(graph.label(), graph.comp_edges(),
                                         self.batches.reshape(-1))
        per_call = edges.reshape(-1, self.batch).sum(1)
        return {"gteps": (float((counts["calls"] * per_call).sum())
                          / window_s / 1e9, "GTEPS")}

    def traced(self, counts, graph) -> dict:
        """The traced stretch's calls and the bytes they cannot move
        less of."""
        label = graph.label()
        per_call = np.asarray([
            graph500.floor_bytes(graph500.batch_reached(label, b), len(b),
                                 len(np.unique(b)))
            for b in self.batches], dtype=np.float64)
        return {"calls": counts["calls"],
                "bytes": float((counts["calls"] * per_call).sum())}

    def checked_roots(self) -> list[int]:
        """The roots of the trees the check compares."""
        return [int(r) for j in sorted(self.sampled)
                for r in self.batches[j]]

    def release(self) -> list:
        """Drop the program's state; return the sampled deliveries as
        ``(root, parent row)`` pairs."""
        out = [(int(r), p[i]) for j, p in sorted(self.kept.items())
               for i, r in enumerate(self.batches[j])]
        self.ct = None
        self.kept = {}
        return out
