"""Graph-format contract — the paper's §4.2 layout axis, in torch.

A port of ``repro.formats.base``.  `GraphFormat` is what the engine
and the plan layer read from a layout:

* **build** — ``from_graph`` (Csr, EdgeList or a built format) and each
  layout's ``from_csr``, on the graph's device;
* **geometry** — vertex and edge counts, the padded vertex count, the
  sentinel, ``degrees`` (the Table 1 counter input);
* **steps** — ``make_steps(spec)`` returns the per-mode layer steps of a
  resolved `TraversalSpec`; ``resolve_tile`` is the layout's tile rule;
  ``persistent_fits`` / ``persistent_run`` are the whole-traversal
  kernel, where the layout has one;
* **semiring step** — ``make_semiring_step(spec, semiring)`` returns
  the per-layer relax step of the algorithm portfolio, where the
  layout lists the algorithm in ``supported_semirings``;
* **capabilities** — the class flags ``supports_prefetch``,
  ``supports_megakernel``, ``supports_persistent``,
  ``persistent_algorithms`` and ``supported_semirings``, which
  `TraversalSpec.validate` reads;
* **accounting** — ``footprint`` and the analytic bytes-moved model
  (``edge_slots``, ``layer_bytes``, ``tile_bytes``, ``plan_bytes``),
  summed by `traversal_bytes` and `membership_bytes`.

Formats hold torch tensors; ``tensors()`` names them for the plan
cache's key and ``to(device)`` moves them.
"""
from __future__ import annotations

import abc
from typing import ClassVar, NamedTuple

import torch

from repro_torch.core import bitmap as bm
from repro_torch.core.csr import (Csr, from_edges as csr_from_edges,
                                  padded_vertex_count)
from repro_torch.core.rmat import EdgeList
from repro_torch.errors import GraphValidationError


class Footprint(NamedTuple):
    """Device-memory report for one built format."""
    format: str
    arrays: tuple[tuple[str, int], ...]   # (array name, bytes)

    @property
    def total_bytes(self) -> int:
        return sum(b for _, b in self.arrays)

    def summary(self) -> str:
        parts = ", ".join(f"{n}={b/2**20:.2f}MiB" for n, b in self.arrays)
        return (f"{self.format}: {self.total_bytes/2**20:.2f} MiB "
                f"({parts})")


def nbytes(t: torch.Tensor) -> int:
    return int(t.numel()) * t.element_size()


def csr_to_edges(csr: Csr) -> EdgeList:
    """The (sorted, symmetrized) COO edge list of a CSR: the first
    ``n_edges`` entries of ``rows`` are the real destinations."""
    deg = (csr.colstarts[1:] - csr.colstarts[:-1]).to(torch.int64)
    src = torch.repeat_interleave(
        torch.arange(csr.n_vertices, dtype=torch.int32,
                     device=csr.device), deg, output_size=csr.n_edges)
    return EdgeList(src=src, dst=csr.rows[:csr.n_edges],
                    n_vertices=csr.n_vertices)


class GraphFormat(abc.ABC):
    """Abstract adjacency layout consumed by the traversal engine."""

    name: ClassVar[str]

    #: whether the layout streams tiles a prefetch ring can run ahead of
    #: (``prefetch_depth > 0``); `TraversalSpec.validate` rejects it
    #: where False
    supports_prefetch: ClassVar[bool] = True
    #: whether the layout has a whole-layer kernel (``megakernel``)
    supports_megakernel: ClassVar[bool] = False
    #: whether the layout has a whole-traversal kernel (``persistent``)
    supports_persistent: ClassVar[bool] = False
    #: scalar algorithms the whole-traversal kernel honours
    persistent_algorithms: ClassVar[tuple] = ()
    #: semiring ``TraversalSpec.algorithm`` values the layout can relax
    #: over ("sssp", "cc", "ksource_bfs"): opt-in through
    #: `_build_semiring_step`; a layout with no per-edge stream keeps the
    #: empty default, which `TraversalSpec.validate` rejects
    supported_semirings: ClassVar[tuple] = ()

    # -- construction ----------------------------------------------------
    @classmethod
    @abc.abstractmethod
    def from_csr(cls, csr: Csr, **kwargs) -> "GraphFormat":
        """Build the layout from a CSR, on the CSR's device."""

    @classmethod
    def from_edges(cls, edges: EdgeList, **kwargs) -> "GraphFormat":
        return cls.from_csr(csr_from_edges(edges, device=edges.src.device),
                            **kwargs)

    @classmethod
    def from_graph(cls, graph, **kwargs) -> "GraphFormat":
        """Build from an EdgeList, a Csr, a format of this class
        (passthrough) or a built format that can give back its CSR."""
        if isinstance(graph, cls):
            return graph
        if isinstance(graph, GraphFormat):
            to_csr = getattr(graph, "to_csr", None)
            if to_csr is None:
                raise TypeError(
                    f"cannot re-lay-out a built {type(graph).__name__} "
                    f"as {cls.__name__}; pass the Csr or EdgeList it "
                    f"was built from")
            graph = to_csr()
        if isinstance(graph, Csr):
            return cls.from_csr(graph, **kwargs)
        if isinstance(graph, EdgeList):
            return cls.from_edges(graph, **kwargs)
        raise TypeError(
            f"cannot build {cls.__name__} from {type(graph).__name__}")

    @abc.abstractmethod
    def tensors(self) -> tuple[torch.Tensor, ...]:
        """The layout's arrays (the plan cache keys on their identity)."""

    @abc.abstractmethod
    def to(self, device) -> "GraphFormat":
        """The same layout on ``device`` (self when already there)."""

    # -- static geometry -------------------------------------------------
    @property
    @abc.abstractmethod
    def n_vertices(self) -> int:
        """Real vertex count V (the sentinel id)."""

    @property
    @abc.abstractmethod
    def n_edges(self) -> int:
        """Real directed edge count (un-padded)."""

    @property
    def n_vertices_padded(self) -> int:
        return padded_vertex_count(self.n_vertices)

    @property
    def sentinel(self) -> int:
        return self.n_vertices

    @property
    def device(self) -> torch.device:
        return self.tensors()[0].device

    # -- engine contract -------------------------------------------------
    @abc.abstractmethod
    def degrees(self) -> torch.Tensor:
        """(V,) int32 out-degrees — the Table 1 workload counter input."""

    def degree_matrix(self) -> torch.Tensor:
        """The (W, 32) word-aligned degree matrix (built once)."""
        if getattr(self, "_deg_mat", None) is None:
            self._deg_mat = bm.degree_matrix(self.degrees(),
                                             self.n_vertices_padded)
        return self._deg_mat

    def make_steps(self, spec) -> dict:
        """``{MODE_SCALAR: fn, MODE_SIMD: fn, MODE_BOTTOMUP: fn}`` for a
        *resolved* `TraversalSpec`; each ``fn(frontier, visited,
        parent)`` advances every root of the batch by one layer and
        returns ``(out, visited, parent, engine.StepAux)``."""
        if not spec.is_resolved:
            autos = [f for f in spec.field_names()
                     if getattr(spec, f) == "auto"]
            why = (f"fields still 'auto': {autos}" if autos
                   else f"policy is the name {spec.policy!r}, not a "
                        f"policy object")
            raise ValueError(
                f"{type(self).__name__}.make_steps needs a *resolved* "
                f"TraversalSpec ({why}); call spec.resolve(fmt) — or "
                f"repro_torch.bfs.plan, which resolves once and caches "
                f"the executable")
        spec._validate_for(self)
        return self._build_steps(spec)

    @abc.abstractmethod
    def _build_steps(self, spec) -> dict:
        """Format-owned step construction from a resolved spec."""

    def make_semiring_step(self, spec, semiring):
        """One batched per-layer semiring relaxation step for a resolved
        ``spec`` whose algorithm the layout lists in
        ``supported_semirings``; ``semiring`` is the registered
        `algorithms.semiring.Semiring`.  Returns ``fn(frontier, vals,
        dense) -> (new_vals, p_layer, engine.StepAux)``: ``frontier``
        (B, W) words, ``vals`` (B, V_pad) values, ``dense`` (B,) bool
        selecting the full work-list (the CC endgame's dense arm), and
        ``p_layer`` the per-layer min-id parent scatter the driver
        merges under the improved mask."""
        spec._validate_for(self)
        return self._build_semiring_step(spec, semiring)

    def _build_semiring_step(self, spec, semiring):
        """Format-owned semiring step construction; formats that list
        nothing in ``supported_semirings`` never reach here (validate
        rejects first), so the default is a hard error."""
        raise NotImplementedError(
            f"{type(self).__name__} declares no supported_semirings")

    def resolve_tile(self, tile: int | None) -> int:
        """The layout's tile rule; the default accepts any and returns 1."""
        return int(tile) if tile else 1

    # -- persistent (whole-traversal) contract ---------------------------
    def persistent_fits(self, n_roots: int, spec) -> bool:
        """Whether the whole-traversal kernel's budget fits this geometry
        under the resolved ``spec``; layouts without one never fit."""
        return False

    def persistent_budget(self, spec) -> int:
        """Shared memory per CTA the whole-traversal kernel needs."""
        raise NotImplementedError(
            f"{type(self).__name__} has no whole-traversal kernel")

    def persistent_graph(self, spec):
        """The whole-traversal kernel's loop constants at ``spec``'s tile
        (built once, kept on the format)."""
        raise NotImplementedError(
            f"{type(self).__name__} has no whole-traversal kernel")

    def persistent_run(self, frontier, visited, parent, spec):
        """The whole multi-root traversal in one launch, from the
        `engine._init_batched` state; returns ``(frontier, visited,
        parent, depths, layers, stats)`` with the launches column 1 on
        layer 0."""
        raise NotImplementedError(
            f"{type(self).__name__} has no whole-traversal persistent "
            f"kernel (supports_persistent=False)")

    # -- accounting ------------------------------------------------------
    @abc.abstractmethod
    def footprint(self) -> Footprint:
        """Per-array device bytes."""

    @property
    @abc.abstractmethod
    def edge_slots(self) -> int:
        """Edge-stream slots one SIMD layer examines (padding included)."""

    def layer_bytes(self) -> int:
        """Bytes one materialized SIMD layer streams: the (nbr, cand,
        valid) triple at 4 B/slot."""
        return 3 * 4 * self.edge_slots

    def tile_bytes(self, tile: int) -> int:
        """Bytes one active tile moves, in the format's tile units."""
        return 4 * tile

    def tile_count(self, tile: int) -> int:
        """Tiles of ``tile`` grid units in one full sweep (CSR: edge
        slots; SELL: slabs; the bitmap: one per root sweep)."""
        return -(-self.edge_slots // max(tile, 1))

    def mask_bytes(self, packed: bool = True) -> int:
        """Per-layer frontier/visited/next membership bytes: 3 V_pad/8
        packed, 3 * 4 V_pad as dense int32 masks."""
        w_bytes = self.n_vertices_padded // 8
        return 3 * w_bytes if packed else 3 * 4 * self.n_vertices_padded

    def plan_mask_bytes(self, packed: bool = True) -> int:
        """Active-set bytes the planning pass reads per layer."""
        if packed:
            return self.n_vertices_padded // 8
        return 4 * self.n_vertices_padded

    def plan_bytes(self, tile: int, packed: bool = True) -> int:
        """Per-layer bytes of the planning pass: the active-set read and
        the work-list round trip."""
        return self.plan_mask_bytes(packed) + 2 * 4 * self.tile_count(tile)

    # -- admission-time validation ---------------------------------------
    def validate_structure(self) -> "GraphFormat":
        """Raise `GraphValidationError` where the layout could give a
        wrong traversal; the default checks the shared geometry."""
        if self.n_vertices < 1:
            raise GraphValidationError(
                "n_vertices must be >= 1 (a BFS needs at least a root "
                "vertex); got 0")
        if self.n_edges < 0:
            raise GraphValidationError(
                f"n_edges must be >= 0, got {self.n_edges}")
        return self

    def __repr__(self) -> str:
        return (f"{type(self).__name__}(V={self.n_vertices}, "
                f"E={self.n_edges}, device={self.device})")


def traversal_bytes(fmt: GraphFormat, stats, *, tile: int,
                    pipeline: str = "fused_gather",
                    packed: bool = True) -> int:
    """Analytic bytes a whole traversal's expansion layers moved:
    ``stats`` is `engine.layer_stats(result)`; the fused pipeline
    charges each layer its measured active tiles plus the planning
    pass, the materialized one the full stream."""
    if pipeline == "materialized":
        return fmt.layer_bytes() * len(stats)
    return sum(fmt.tile_bytes(tile) * s.active_tiles
               + fmt.plan_bytes(tile, packed) for s in stats)


def membership_bytes(fmt: GraphFormat, stats, *,
                     packed: bool = True) -> int:
    """Analytic frontier/visited/next membership bytes of a traversal:
    the three state bitmaps plus the planning read, per layer."""
    per_layer = fmt.mask_bytes(packed) + fmt.plan_mask_bytes(packed)
    return per_layer * len(stats)
