"""Direction-optimizing (hybrid) BFS [Beamer 2012], vectorized both
ways.

A thin wrapper over the engine's `BeamerHybrid` policy: top-down ->
bottom-up when the frontier's out-edges exceed the unexplored edges /
``alpha``, back when the frontier shrinks below V / ``beta`` (Beamer's
14 and 24).  The bottom-up step tests each unvisited vertex's
neighbours against the frontier with the same kernels.
"""
from __future__ import annotations

from repro_torch.core import engine
from repro_torch.core.csr import Csr
from repro_torch.device import DEFAULT_DEVICE


def run_bfs_hybrid(csr: Csr, root, *, alpha: float = 14.0,
                   beta: float = 24.0, tile: int | None = None,
                   collect_stats: bool = False, max_layers: int = 1024,
                   device=DEFAULT_DEVICE):
    """Direction-optimizing BFS.  Returns the final state, with
    ``collect_stats`` also the direction log ("topdown"/"bottomup" per
    layer)."""
    from repro_torch.api.plan import plan
    policy = engine.BeamerHybrid(float(alpha), float(beta))
    spec = engine.make_spec(policy=policy, tile=tile,
                            max_layers=max_layers)
    res = plan(csr, spec, device=device).run(root)
    if collect_stats:
        return res.state, engine.direction_log(res)
    return res.state
