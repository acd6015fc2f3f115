"""repro_torch.bfs — the public BFS surface of the port.

    import repro_torch.bfs as bfs

    spec = bfs.TraversalSpec(policy="beamer", max_layers=128)
    ct = bfs.plan(csr, spec)          # device="cuda" by default
    res = ct.run(17)                  # or ct.run_batched([3, 7, 11])
    ct.resolved                       # the concrete spec that ran
    ct.stats(res)                     # Table 1 per-layer counters

The same contracts as ``repro.bfs`` for the main path.  ``__all__`` is
its subset so far: the legacy ``traverse`` shim, ``SpanTracer``,
``TraceRun`` and ``trace_run`` arrive with later slices (ROADMAP items
6 and 10).
"""
from __future__ import annotations

from repro_torch.api.plan import (CompiledTraversal, cache_info as
                                  plan_cache_info, clear_cache as
                                  clear_plan_cache, plan)
from repro_torch.api.spec import POLICIES, TraversalSpec
from repro_torch.core.bfs_parallel import parents_graph500
from repro_torch.core.engine import (BeamerHybrid, BfsState, EngineResult,
                                     LayerStats, PaperLiteralLayers,
                                     ThresholdSimd, TopDown,
                                     direction_log, layer_stats)

__all__ = [
    "BeamerHybrid",
    "BfsState",
    "CompiledTraversal",
    "EngineResult",
    "LayerStats",
    "POLICIES",
    "PaperLiteralLayers",
    "ThresholdSimd",
    "TopDown",
    "TraversalSpec",
    "clear_plan_cache",
    "direction_log",
    "layer_stats",
    "parents_graph500",
    "plan",
    "plan_cache_info",
]
