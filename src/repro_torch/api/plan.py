"""plan / run — configure once per graph, run many roots.

    import repro_torch.bfs as bfs
    ct = bfs.plan(csr, bfs.TraversalSpec(policy="beamer"))
    res = ct.run(17)                    # single root
    res = ct.run_batched([3, 7, 11])    # leading root axis
    ct.resolved                         # the fully-concrete spec

`plan` validates the graph, resolves the spec's ``"auto"`` fields once
and binds a cached `_Executable`: the tile-padded rows, the degree
matrix and the per-mode steps, built once per (format, geometry,
resolved spec).  The format part of the key is the identity of the
graph's arrays, which the cache entry holds, so two graphs of equal
geometry never share padded rows.

``device=`` (default ``"cuda"``) names where the traversal runs; the
graph is moved there if it lies elsewhere, and without CUDA the default
raises (pass ``device="cpu"`` for the plain torch path).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api.spec import TraversalSpec
from repro_torch.core import engine as _engine
from repro_torch.core.csr import Csr, check_structure
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.errors import GraphValidationError
from repro_torch.formats.csr_format import CsrFormat


def check_roots(roots, n_vertices: int) -> None:
    """Admission-time root validation: every root must be an integer in
    ``[0, n_vertices)``.  Raises `GraphValidationError`."""
    if isinstance(roots, torch.Tensor):
        roots = roots.cpu()
    arr = np.asarray(roots)
    if arr.dtype.kind == "f":
        if np.any(~np.isfinite(arr)) or np.any(arr != np.floor(arr)):
            raise GraphValidationError(
                f"roots must be integers in [0, {n_vertices}), got "
                f"non-integral/NaN values {arr!r}")
    elif arr.dtype.kind not in "iu":
        raise GraphValidationError(
            f"roots must be integers in [0, {n_vertices}), got dtype "
            f"{arr.dtype}")
    if arr.size and (int(arr.min()) < 0
                     or int(arr.max()) >= n_vertices):
        bad = int(arr.min()) if int(arr.min()) < 0 else int(arr.max())
        raise GraphValidationError(
            f"root {bad} is outside [0, n_vertices={n_vertices}); "
            f"roots index real vertices (the sentinel/padding region "
            f"would return a wrong tree, not an error)")


def as_format(graph) -> CsrFormat:
    """View a `Csr` (or an already-built `CsrFormat`) as the engine's
    format."""
    if isinstance(graph, CsrFormat):
        return graph
    if isinstance(graph, Csr):
        return CsrFormat.from_csr(graph)
    raise TypeError(
        f"cannot plan a traversal over {type(graph).__name__}; expected "
        f"a Csr or CsrFormat (other layouts: ROADMAP item 8)")


class _Executable:
    """The cached unit: steps (with the padded rows) and the degree
    matrix for one (format, geometry, resolved spec)."""

    def __init__(self, fmt: CsrFormat, spec: TraversalSpec):
        self.fmt = fmt
        self.spec = spec
        self.steps = fmt.make_steps(spec)
        self.deg_mat = fmt.degree_matrix()

    def run(self, roots: torch.Tensor) -> _engine.EngineResult:
        return _engine._traverse_impl(self.fmt, roots, self.spec,
                                      steps=self.steps,
                                      deg_mat=self.deg_mat)


_CACHE: dict[tuple, _Executable] = {}
_STATS = {"hits": 0, "misses": 0}


def _key(fmt: CsrFormat, spec: TraversalSpec) -> tuple:
    geometry = (type(fmt).__name__, fmt.n_vertices, fmt.n_edges,
                tuple(fmt.rows.shape), str(fmt.device))
    arrays = (id(fmt.rows), id(fmt.colstarts))
    # ``merge`` is read only by the distributed path
    return geometry + arrays + (spec.replace(merge="auto"),)


def _executable(fmt: CsrFormat, spec: TraversalSpec) -> _Executable:
    key = _key(fmt, spec)
    ex = _CACHE.get(key)
    if ex is None:
        _STATS["misses"] += 1
        ex = _CACHE[key] = _Executable(fmt, spec)
    else:
        _STATS["hits"] += 1
    return ex


def cache_info() -> dict:
    """Plan-cache counters: {size, hits, misses}."""
    return {"size": len(_CACHE), **_STATS}


def clear_cache() -> None:
    """Drop every cached executable (and the graphs they hold)."""
    _CACHE.clear()
    _STATS.update(hits=0, misses=0)


class CompiledTraversal:
    """A graph bound to a fully-resolved `TraversalSpec` and its cached
    executable (shared, by identity, across plans of the same graph
    arrays and spec)."""

    def __init__(self, fmt: CsrFormat, resolved: TraversalSpec,
                 executable: _Executable, *, batch: int | None = None):
        self.fmt = fmt
        self.resolved = resolved
        self.executable = executable
        self.batch = batch

    def _roots(self, roots) -> torch.Tensor:
        check_roots(roots, self.fmt.n_vertices)
        return torch.as_tensor(np.asarray(
            roots.cpu() if isinstance(roots, torch.Tensor) else roots),
            dtype=torch.int32).reshape(-1).to(self.fmt.device)

    def run(self, roots) -> _engine.EngineResult:
        """One root (int: unbatched result arrays) or a sequence of
        roots (leading root axis)."""
        single = np.ndim(roots.cpu() if isinstance(roots, torch.Tensor)
                         else roots) == 0
        res = self.run_batched(roots)
        if single:
            st = res.state
            return _engine.EngineResult(
                _engine.BfsState(st.frontier[0], st.visited[0],
                                 st.parent[0], st.layer),
                res.depths[0], res.stats)
        return res

    def run_batched(self, roots) -> _engine.EngineResult:
        """Run a (B,) root batch in one traversal.  A plan built with
        ``batch=N`` pads smaller batches up to N (repeating the last
        root) and slices the results back; the stats buffer then counts
        the padded batch."""
        r = self._roots(roots)
        n = int(r.shape[0])
        if n == 0:
            raise ValueError("run_batched needs at least one root")
        if self.batch is not None and n > self.batch:
            raise ValueError(
                f"root batch of {n} exceeds this plan's fixed "
                f"batch={self.batch}; chunk the roots or plan with a "
                f"larger batch")
        if self.batch is not None and n < self.batch:
            res = self.executable.run(torch.cat(
                [r, r[-1:].expand(self.batch - n)]))
            st = res.state
            return _engine.EngineResult(
                _engine.BfsState(st.frontier[:n], st.visited[:n],
                                 st.parent[:n], st.layer),
                res.depths[:n], res.stats)
        return self.executable.run(r)

    def stats(self, result) -> list[_engine.LayerStats]:
        """Decode a result's stats buffer (Table 1 rows)."""
        return _engine.layer_stats(result)

    def direction_log(self, result) -> list[str]:
        """Per-layer direction strings from a result's stats buffer."""
        return _engine.direction_log(result)

    def __repr__(self) -> str:
        return f"CompiledTraversal({self.fmt!r}, spec={self.resolved})"


def plan(graph, spec: TraversalSpec | None = None, *,
         batch: int | None = None,
         device=DEFAULT_DEVICE) -> CompiledTraversal:
    """Validate the graph, resolve the spec once and bind the cached
    executable on ``device``.

    Args:
      graph: a `Csr` or `CsrFormat`.
      spec: a `TraversalSpec` (default: all ``"auto"``).
      batch: optional fixed batch width (`run_batched` pads up to it).
      device: where the traversal runs (default ``"cuda"``; raises
        without CUDA).
    """
    dev = resolve_device(device)
    if isinstance(graph, Csr):
        check_structure(graph)
    fmt = as_format(graph).to(dev)
    fmt.validate_structure()
    spec = spec if spec is not None else TraversalSpec()
    resolved = spec.resolve(fmt)
    return CompiledTraversal(fmt, resolved, _executable(fmt, resolved),
                             batch=batch)
