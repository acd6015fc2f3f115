"""plan / run — configure once per graph, run many roots.

    import repro_torch.bfs as bfs
    ct = bfs.plan(csr, bfs.TraversalSpec(policy="beamer"))
    res = ct.run(17)                    # single root
    res = ct.run_batched([3, 7, 11])    # leading root axis
    ct.resolved                         # the fully-concrete spec

The graph is a `Csr`, an `EdgeList` (built into a CSR on the plan's
device) or any built `formats.GraphFormat` (CSR, SELL-C-σ, bitmap):
``plan(formats.build(csr, "auto"), spec)`` runs the layout the
autotuner picks.  `plan` validates the graph, resolves the spec's
``"auto"`` fields once and binds a cached `_Executable`: the format's
padded arrays, the degree matrix and the per-mode steps (or, for
``pipeline="persistent"``, the whole-traversal kernel's loop
constants), built once per (format, geometry, resolved spec).  The key
holds the resolved spec, so each pipeline and prefetch depth has its
own entry.  The format part of the key is the identity of the format's
arrays, which the cache entry holds, so two graphs of equal geometry
never share padded arrays.  `CompiledTraversal.layer_step` advances a
state by one layer through the same steps (the serve tick), and
`CompiledTraversal.trace_run` times each such layer.

A spec whose ``algorithm`` is in the semiring portfolio (``sssp``,
``cc``, ``ksource_bfs``: `TraversalSpec.is_semiring`) binds the
format's semiring step instead and runs `algorithms.traversal.
traverse_semiring`; its results carry ``values``.

``device=`` (default ``"cuda"``) names where the traversal runs; the
graph is moved there if it lies elsewhere, and without CUDA the default
raises (pass ``device="cpu"`` for the plain torch path).

``mesh=`` (a `torch.distributed.device_mesh.DeviceMesh`, called on
every rank) binds the plan to the distributed per-shard program of
`core.bfs_distributed` instead: ``run(root)`` partitions the graph once,
at the first run, and returns ``(parent, layers)``; no single-chip
executable is built, and `run_batched` / `layer_step` raise.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api.spec import TraversalSpec, warn_mesh_ignored_fields
from repro_torch.core import engine as _engine
from repro_torch.core.csr import Csr, check_structure, from_edges
from repro_torch.core.rmat import EdgeList
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.errors import GraphValidationError
from repro_torch.formats.base import GraphFormat
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


def as_format(graph) -> GraphFormat:
    """View a `Csr` as a `CsrFormat`; a built `GraphFormat` is taken as
    it is (an `EdgeList` is built into a `Csr` first, by `plan`)."""
    if isinstance(graph, GraphFormat):
        return graph
    if isinstance(graph, Csr):
        return CsrFormat.from_csr(graph)
    raise TypeError(
        f"cannot plan a traversal over {type(graph).__name__}; expected "
        f"a Csr, EdgeList or repro_torch.formats GraphFormat")


class _Executable:
    """The cached unit: steps (with the padded arrays) and the degree
    matrix for one (format, geometry, resolved spec).  The persistent
    pipeline builds its loop constants here (kept on the format) and
    its per-layer (megakernel) steps only when they first run: for a
    degrade or a `CompiledTraversal.layer_step` tick.  A semiring spec
    binds the format's one relax step."""

    def __init__(self, fmt: GraphFormat, spec: TraversalSpec):
        self.fmt = fmt
        self.spec = spec
        self.semiring_step = None
        self._steps = None
        if spec.is_semiring:
            from repro_torch.algorithms import semiring
            self.semiring_step = fmt.make_semiring_step(
                spec, semiring.get(spec.algorithm))
        elif spec.pipeline == "persistent":
            fmt.persistent_graph(spec)
        else:
            self._steps = fmt.make_steps(spec)
        self.deg_mat = fmt.degree_matrix()

    def steps(self) -> dict:
        """The per-mode layer steps, built once."""
        if self._steps is None:
            self._steps = self.fmt.make_steps(self.spec)
        return self._steps

    def run(self, roots: torch.Tensor) -> _engine.EngineResult:
        spec = self.spec
        if spec.is_semiring:
            from repro_torch.algorithms.traversal import traverse_semiring
            return traverse_semiring(self.fmt, roots, spec,
                                     step=self.semiring_step,
                                     deg_mat=self.deg_mat)
        if spec.pipeline == "persistent":
            spec = _engine.persistent_fallback(self.fmt,
                                               int(roots.shape[0]), spec)
            if spec is None:
                return _engine._traverse_persistent(self.fmt, roots,
                                                    self.spec)
        return _engine._traverse_impl(self.fmt, roots, spec,
                                      steps=self.steps(),
                                      deg_mat=self.deg_mat)


_CACHE: dict[tuple, _Executable] = {}
_STATS = {"hits": 0, "misses": 0}


def _key(fmt: GraphFormat, spec: TraversalSpec) -> tuple:
    tensors = fmt.tensors()
    geometry = (type(fmt).__name__, fmt.n_vertices, fmt.n_edges,
                tuple(tuple(t.shape) for t in tensors), str(fmt.device))
    arrays = tuple(id(t) for t in tensors)
    # ``merge`` is read only by the distributed path
    return geometry + arrays + (spec.replace(merge="auto"),)


def _executable(fmt: GraphFormat, spec: TraversalSpec) -> _Executable:
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
    arrays and spec), or, bound to a ``mesh``, to the distributed
    program (``executable`` None)."""

    def __init__(self, fmt: GraphFormat, resolved: TraversalSpec,
                 executable: _Executable | None, *,
                 batch: int | None = None, mesh=None):
        self.fmt = fmt
        self.resolved = resolved
        self.executable = executable      # None iff mesh-bound
        self.batch = batch
        self.mesh = mesh
        self._partition = None            # mesh path: built once, lazily

    def _roots(self, roots) -> torch.Tensor:
        check_roots(roots, self.fmt.n_vertices)
        return torch.as_tensor(np.asarray(
            roots.cpu() if isinstance(roots, torch.Tensor) else roots),
            dtype=torch.int32).reshape(-1).to(self.fmt.device)

    def run(self, roots) -> _engine.EngineResult:
        """One root (int: unbatched result arrays) or a sequence of
        roots (leading root axis).  On a mesh-bound plan, runs the
        distributed program for one root and returns its ``(parent,
        layers)`` pair."""
        if self.mesh is not None:
            check_roots(roots, self.fmt.n_vertices)
            return self._run_distributed(roots)
        single = np.ndim(roots.cpu() if isinstance(roots, torch.Tensor)
                         else roots) == 0
        res = self.run_batched(roots)
        if single:
            st = res.state
            return _engine.EngineResult(
                _engine.BfsState(st.frontier[0], st.visited[0],
                                 st.parent[0], st.layer),
                res.depths[0], res.stats,
                None if res.values is None else res.values[0])
        return res

    def run_batched(self, roots) -> _engine.EngineResult:
        """Run a (B,) root batch in one traversal.  A plan built with
        ``batch=N`` pads smaller batches up to N (repeating the last
        root) and slices the results back; the stats buffer then counts
        the padded batch."""
        if self.mesh is not None:
            raise NotImplementedError(
                "mesh-bound plans run one root per launch via .run(); "
                "batched multi-root distributed search is not wired up")
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
                res.depths[:n], res.stats,
                None if res.values is None else res.values[:n])
        return self.executable.run(r)

    def layer_step(self, state, visited=None, parent=None):
        """Advance every root of a (B, ...) state by exactly one layer
        (the serve tick): the spec's SIMD step for ``algorithm="simd"``,
        its scalar step for ``"nonsimd"``; a ``persistent`` plan ticks
        through its megakernel steps.  Takes a `BfsState` (returns one
        with ``layer + 1``) or the bare ``(frontier, visited, parent)``
        triple (returns the triple).  P is updated in place."""
        if self.mesh is not None:
            raise NotImplementedError(
                "mesh-bound plans have no single-layer tick; the "
                "distributed program runs whole searches via .run()")
        spec = self.resolved
        if spec.is_semiring:
            raise NotImplementedError(
                f"semiring algorithm {spec.algorithm!r} has no "
                f"single-layer tick: the portfolio's traversal loop owns the "
                f"value/frontier carry — use run()/run_batched() for "
                f"whole traversals")
        step = self.executable.steps()[
            _engine.MODE_SIMD if spec.algorithm == "simd"
            else _engine.MODE_SCALAR]
        if visited is None:
            f, v, p, _ = step(state.frontier, state.visited, state.parent)
            return _engine.BfsState(f, v, p, state.layer + 1)
        return step(state, visited, parent)[:3]

    def trace_run(self, roots, *, tracer=None, sync: bool = True,
                  profile_logdir: str | None = None):
        """Instrumented traversal: host-steps this plan's ``layer_step``
        recording per-layer wall-clock spans — the opt-in timing mode
        (`repro_torch.obs.trace.trace_run`); ``run`` is untouched.
        Returns a `repro_torch.obs.trace.TraceRun`."""
        from repro_torch.obs.trace import trace_run as _trace_run
        return _trace_run(self, roots, tracer=tracer, sync=sync,
                          profile_logdir=profile_logdir)

    def _run_distributed(self, root):
        from repro_torch.core import bfs_distributed as dist
        if np.ndim(root.cpu() if isinstance(root, torch.Tensor)
                   else root) != 0:
            raise ValueError("the distributed program runs one root "
                             "per launch; pass a scalar root")
        if self._partition is None:
            to_csr = getattr(self.fmt, "to_csr", None)
            if to_csr is None:
                raise TypeError(
                    f"mesh-bound plans need a CSR-recoverable format; "
                    f"{type(self.fmt).__name__} has no to_csr()")
            # partition once, at the first run — the host-side O(E)
            # split is the mesh path's "compile" step; later roots reuse
            # this rank's shard on its device
            csr = to_csr()
            axis_names = tuple(self.mesh.mesh_dim_names)
            rows_sh, colstarts_sh = dist.partition_csr(
                csr, dist.mesh_axis_size(self.mesh, axis_names))
            self._partition = (csr.n_vertices, axis_names) \
                + dist.local_shard(rows_sh, colstarts_sh, self.mesh,
                                   axis_names)
        n_vertices, axis_names, rows_l, colstarts_l = self._partition
        parent, layers = dist._run_local(
            self.mesh, axis_names, n_vertices, self.resolved.max_layers,
            self.resolved.merge, rows_l, colstarts_l, int(root))
        return parent[:n_vertices], layers

    def stats(self, result) -> list[_engine.LayerStats]:
        """Decode a result's stats buffer (Table 1 rows)."""
        return _engine.layer_stats(result)

    def direction_log(self, result) -> list[str]:
        """Per-layer direction strings from a result's stats buffer."""
        return _engine.direction_log(result)

    def __repr__(self) -> str:
        return f"CompiledTraversal({self.fmt!r}, spec={self.resolved})"


def plan(graph, spec: TraversalSpec | None = None, *,
         batch: int | None = None, device=DEFAULT_DEVICE,
         mesh=None) -> CompiledTraversal:
    """Validate the graph, resolve the spec once and bind the cached
    executable on ``device``.

    Args:
      graph: a `Csr`, an `EdgeList` (built into a CSR on ``device``) or
        a built `formats.GraphFormat`.
      spec: a `TraversalSpec` (default: all ``"auto"``).
      batch: optional fixed batch width (`run_batched` pads up to it).
      device: where the traversal runs (default ``"cuda"``; raises
        without CUDA); with ``mesh``, it must be the mesh's device type.
      mesh: optional `torch.distributed.device_mesh.DeviceMesh` — ``run``
        then executes the distributed per-shard program derived from the
        same resolved spec (``merge``/``max_layers``).
    """
    dev = resolve_device(device)
    if mesh is not None and dev.type != mesh.device_type:
        raise ValueError(
            f"device={str(device)!r} disagrees with the mesh's device "
            f"type {mesh.device_type!r}; a mesh-bound plan runs on the "
            f"mesh's devices")
    if isinstance(graph, EdgeList):
        graph = from_edges(graph, device=dev)
    if isinstance(graph, Csr):
        check_structure(graph)
    fmt = as_format(graph).to(dev)
    fmt.validate_structure()
    spec = spec if spec is not None else TraversalSpec()
    if mesh is not None:
        # the contract of run_bfs_distributed(spec=): flag explicitly
        # set fields the fixed per-shard program cannot honor, and skip
        # the autotune policy measurement it would never read
        warn_mesh_ignored_fields(spec, "mesh-bound plan")
        if spec.policy == "auto":
            spec = spec.replace(policy="topdown")
    resolved = spec.resolve(fmt)
    # a mesh-bound plan never runs the single-chip executable
    ex = None if mesh is not None else _executable(fmt, resolved)
    return CompiledTraversal(fmt, resolved, ex, batch=batch, mesh=mesh)
