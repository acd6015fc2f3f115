"""CsrFormat — the §3.3.1 CSR as a registered `GraphFormat`.

An adapter around `core/csr.py`: geometry, ``degrees``, the CSR tile
rule (`resolve_tile`), the per-mode steps of `engine._make_steps` (the
union planner, K3/K4 and K1 for ``fused_gather``; K2, the apportioned
stream, K7 and K1 for ``materialized``; K5 for ``megakernel``; under
``packed=False`` the dense-mask planning and queues in place of the
planner and K2), the
whole-traversal kernel K6 (``persistent_graph`` / ``persistent_fits`` /
``persistent_run``) and the semiring relax step (the union planner +
K11).  The baseline every other layout is measured against.
"""
from __future__ import annotations

import torch

from repro_torch.core.csr import Csr, check_structure
from repro_torch.formats.base import Footprint, GraphFormat, nbytes
from repro_torch.formats.registry import register

DEFAULT_TILE = 1024   # rows slots per block (the fused pipeline's unit)
MIN_TILE = 128        # one lane set: small graphs keep several blocks


@register
class CsrFormat(GraphFormat):
    name = "csr"
    # the whole-layer (K5) and whole-traversal (K6) kernels run on the
    # CSR rows-block schedule; K6's in-kernel layer loop blends the
    # scalar mode into its racy sweep, so both scalar algorithms' reached
    # sets are honoured
    supports_megakernel = True
    supports_persistent = True
    persistent_algorithms = ("simd", "nonsimd")
    supported_semirings = ("sssp", "cc", "ksource_bfs")

    def __init__(self, colstarts: torch.Tensor, rows: torch.Tensor,
                 n_vertices: int, n_edges: int):
        self.colstarts = colstarts
        self.rows = rows
        self._n_vertices = int(n_vertices)
        self._n_edges = int(n_edges)
        self._structure_ok = False
        self._deg_mat = None
        self._fused: dict = {}

    @classmethod
    def from_csr(cls, csr: Csr) -> "CsrFormat":
        return cls(csr.colstarts, csr.rows, csr.n_vertices, csr.n_edges)

    def to_csr(self) -> Csr:
        return Csr(rows=self.rows, colstarts=self.colstarts,
                   n_vertices=self._n_vertices, n_edges=self._n_edges)

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return (self.rows, self.colstarts)

    def validate_structure(self) -> "CsrFormat":
        # memoized per instance: the checks read every edge once
        if not self._structure_ok:
            check_structure(self.to_csr())
            self._structure_ok = True
        return self

    def to(self, device) -> "CsrFormat":
        if self.rows.device == torch.device(device):
            return self
        return CsrFormat(self.colstarts.to(device), self.rows.to(device),
                         self._n_vertices, self._n_edges)

    # -- static geometry -------------------------------------------------
    @property
    def n_vertices(self) -> int:
        return self._n_vertices

    @property
    def n_edges(self) -> int:
        return self._n_edges

    @property
    def n_edges_padded(self) -> int:
        return int(self.rows.shape[0])

    # -- engine contract -------------------------------------------------
    def degrees(self) -> torch.Tensor:
        return self.colstarts[1:] - self.colstarts[:-1]

    def resolve_tile(self, tile: int | None) -> int:
        """The CSR tile rule (`engine._resolve_tile_csr`): ``tile``
        (floored at 128) or, for auto, the affinity table's value for
        this graph (1024 without a row) capped at ``e_pad / 8`` so
        small graphs keep >= 8 blocks to skip, and never past the edge
        stream itself."""
        from repro_torch.core import engine
        return engine._resolve_tile_csr(tile, self.n_edges_padded,
                                        fmt=self)

    def _build_steps(self, spec) -> dict:
        from repro_torch.core import engine
        return engine._make_steps(self.colstarts, self.rows,
                                  self.degree_matrix().reshape(-1),
                                  self._n_vertices, self.n_vertices_padded,
                                  self.n_edges_padded, spec.algorithm,
                                  spec.tile, pipeline=spec.pipeline,
                                  prefetch_depth=spec.prefetch_depth,
                                  packed=spec.packed)

    def _build_semiring_step(self, spec, semiring):
        """The union planner lists the frontier's rows-blocks, K11 relaxes
        them.  Dense arm (the CC endgame): a root whose ``dense`` flag is
        set lists every block — the planner still runs and is charged, as
        in the reference."""
        from repro_torch.core import engine
        from repro_torch.kernels import ops
        graph = self.fused_graph(spec)

        def step(frontier, vals, dense):
            with ops.count_launches() as c:
                plan = ops.plan_union(graph, frontier, dense=dense)
                new_vals, p_layer = ops.gather_relax_batched(
                    plan, graph.rows, graph.colstarts, frontier, vals,
                    n_vertices=graph.n_vertices, tile=graph.tile,
                    unit=semiring.unit, weighted=semiring.weighted)
            return new_vals, p_layer, engine.StepAux(
                plan.na.sum(), 0, c.count)

        return step

    def n_blocks(self, tile: int) -> int:
        return -(-self.n_edges_padded // tile)

    def fused_graph(self, spec):
        """The fused kernels' loop constants at ``spec.tile`` (built once
        per tile)."""
        if spec.tile not in self._fused:
            from repro_torch.core import engine
            from repro_torch.kernels.layer_fused import fused_csr
            rows_t = engine._pad_rows_to_tile(self.rows.contiguous(),
                                              self._n_vertices, spec.tile)
            self._fused[spec.tile] = fused_csr(
                self.colstarts.contiguous(), rows_t, self._n_vertices,
                spec.tile, self.n_vertices_padded)
        return self._fused[spec.tile]

    def persistent_graph(self, spec):
        """K6's loop constants; refuses a prefetch ring no CTA can hold."""
        from repro_torch.core import engine
        engine.check_prefetch(spec.tile, spec.prefetch_depth,
                              self.n_blocks(spec.tile))
        return self.fused_graph(spec)

    def persistent_budget(self, spec) -> int:
        from repro_torch.kernels import ops
        return ops.megakernel_budget(spec.tile, spec.prefetch_depth,
                                     self.n_blocks(spec.tile))

    def persistent_fits(self, n_roots: int, spec) -> bool:
        """Whether K6's per-CTA budget fits (batch-independent: its
        batch state lives in device memory)."""
        from repro_torch.kernels import ops
        return ops.persistent_fits(spec.tile, spec.prefetch_depth,
                                   self.n_blocks(spec.tile))

    def persistent_run(self, frontier, visited, parent, spec):
        from repro_torch.core import engine
        from repro_torch.kernels import ops
        code = engine.encode_policy(spec.policy, self._n_vertices,
                                    int(frontier.shape[0]),
                                    spec.max_layers)
        return ops.traversal_fused_batched(
            self.fused_graph(spec), frontier, visited, parent, code=code,
            max_layers=spec.max_layers, prefetch_depth=spec.prefetch_depth)

    # -- accounting ------------------------------------------------------
    def footprint(self) -> Footprint:
        return Footprint(self.name,
                         (("rows", nbytes(self.rows)),
                          ("colstarts", nbytes(self.colstarts))))

    @property
    def edge_slots(self) -> int:
        return self.n_edges_padded

    def layer_bytes(self) -> int:
        # the materialized stream is written then read back
        return 2 * 3 * 4 * self.edge_slots

    def plan_bytes(self, tile: int, packed: bool = True) -> int:
        # the planner also reads colstarts
        return (4 * (self.n_vertices + 1)
                + super().plan_bytes(tile, packed))
