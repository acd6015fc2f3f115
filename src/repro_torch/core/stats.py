"""Graph500 experimental harness — paper §5.3 (a port of
``repro.core.stats``).

64 BFS executions from randomly chosen start vertices; per-run wall
time and TEPS (Traversed Edges Per Second, with the Graph500 edge
count: half the sum of reached vertices' directed degrees); harmonic
mean across runs.

The paper reports the harmonic mean *without filtering* unconnected
start vertices and notes the artifact this causes.  A zero-TEPS run
makes the true harmonic mean zero (1/teps diverges), so like most
Graph500 submissions we report BOTH: ``hmean_teps`` over connected
runs, plus ``n_zero_runs`` so the unfiltered picture is recoverable —
the deviation is deliberate and documented here.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.bfs_parallel import parents_graph500
from repro_torch.core.csr import Csr, traversed_edges
from repro_torch.core.validate import validate


@dataclass
class RunResult:
    root: int
    seconds: float
    edges: int
    teps: float
    reached: int
    valid: bool | None = None


@dataclass
class HarnessResult:
    runs: list[RunResult] = field(default_factory=list)

    @property
    def n_zero_runs(self) -> int:
        return sum(1 for r in self.runs if r.edges == 0)

    @property
    def hmean_teps(self) -> float:
        ts = [r.teps for r in self.runs if r.teps > 0]
        if not ts:
            return 0.0
        return len(ts) / sum(1.0 / t for t in ts)

    @property
    def max_teps(self) -> float:
        return max((r.teps for r in self.runs), default=0.0)

    @property
    def mean_seconds(self) -> float:
        return float(np.mean([r.seconds for r in self.runs]))

    def summary(self) -> str:
        return (f"runs={len(self.runs)} hmean_teps={self.hmean_teps:.3e} "
                f"max_teps={self.max_teps:.3e} zero_runs={self.n_zero_runs} "
                f"mean_s={self.mean_seconds:.4f}")


def _generator(seed) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator().manual_seed(int(seed))


def choose_roots(seed, n_vertices: int, n_roots: int = 64,
                 degrees=None, require_connected: bool = False
                 ) -> np.ndarray:
    """Random start vertices. Paper: unfiltered; Graph500 ref filters
    degree-0 roots — both available.

    The contract is the reference's: ``4 * n_roots`` uniform draws in
    ``[0, n_vertices)``, the degree > 0 filter when
    ``require_connected`` and ``degrees`` are given, then the first
    ``n_roots``.  The draws differ: the reference draws from
    ``jax.random.randint(key, ...)``, which this package cannot
    reproduce without jax; here ``seed`` is an int or a CPU
    `torch.Generator` and the draws come from ``torch.randint``.  Tests
    that compare the two pass ``roots=`` explicitly."""
    gen = _generator(seed)
    roots = torch.randint(0, int(n_vertices), (4 * n_roots,),
                          generator=gen).numpy()
    if require_connected and degrees is not None:
        deg = (degrees.cpu().numpy() if isinstance(degrees, torch.Tensor)
               else np.asarray(degrees))
        roots = roots[deg[roots] > 0]
    return roots[:n_roots]


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def run_harness(csr: Csr, bfs_fn, seed=None, n_roots: int = 64,
                validate_runs: bool = False,
                reference_depths_fn=None,
                roots=None) -> HarnessResult:
    """Time ``bfs_fn(csr, root) -> BfsState`` over ``n_roots`` roots.

    ``bfs_fn`` must return a ``BfsState`` (or any object with
    ``.parent``).  One warm-up run (the kernels' first launch) is
    excluded from timing; each timed run ends in a device sync.
    ``seed`` feeds `choose_roots` (an int or a `torch.Generator`);
    ``roots`` overrides the random draw (deterministic tests; the
    paper's unfiltered-root artifact is reproducible by passing a
    degree-0 vertex explicitly).
    """
    if roots is None:
        if seed is None:
            raise ValueError("run_harness needs a seed or explicit roots")
        roots = choose_roots(seed, csr.n_vertices, n_roots)
    else:
        roots = np.asarray(roots)
    result = HarnessResult()

    # warm-up on the first root (the kernels' build and first launch)
    _sync(bfs_fn(csr, int(roots[0])).parent)

    for root in roots:
        root = int(root)
        t0 = time.perf_counter()
        state = bfs_fn(csr, root)
        _sync(state.parent)
        dt = time.perf_counter() - t0

        p = parents_graph500(state, csr.n_vertices).to(csr.device)
        reached = p >= 0
        edges = int(traversed_edges(csr, reached))
        teps = edges / dt if dt > 0 else 0.0
        ok = None
        if validate_runs:
            ref = (reference_depths_fn(root)
                   if reference_depths_fn else None)
            ok = validate(csr, p, root, reference_depth=ref).ok
        result.runs.append(RunResult(
            root=root, seconds=dt, edges=edges, teps=teps,
            reached=int(reached.sum()), valid=ok))
    return result
