"""CsrFormat — the §3.3.1 CSR as the engine's graph format.

A minimal adapter around `core/csr.py` with the contract the engine
and the plan layer read: geometry, ``degrees``, the CSR tile rule
(`resolve_tile`), ``make_steps`` and the whole-traversal kernel's
``fused_graph`` / ``persistent_fits``.  The format registry, SELL-C-σ
and the bitmap layout arrive with the formats slice.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitmap as bm
from repro_torch.core.csr import Csr, check_structure, padded_vertex_count

DEFAULT_TILE = 1024   # rows slots per block (the fused pipeline's unit)
MIN_TILE = 128        # one lane set: small graphs keep several blocks


class CsrFormat:
    name = "csr"
    # the whole-layer (K5) and whole-traversal (K6) kernels run on the
    # CSR rows-block schedule; K6's in-kernel layer loop blends the
    # scalar mode into its racy sweep, so both scalar algorithms' reached
    # sets are honoured
    supports_megakernel = True
    supports_persistent = True
    persistent_algorithms = ("simd", "nonsimd")

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

    def validate_structure(self) -> "CsrFormat":
        # memoized per instance: the checks read every edge once
        if not self._structure_ok:
            check_structure(self.to_csr())
            self._structure_ok = True
        return self

    def to(self, device) -> "CsrFormat":
        """The same graph on ``device`` (self when already there)."""
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

    @property
    def n_vertices_padded(self) -> int:
        return padded_vertex_count(self._n_vertices)

    @property
    def device(self) -> torch.device:
        return self.rows.device

    # -- engine contract -------------------------------------------------
    def degrees(self) -> torch.Tensor:
        return self.colstarts[1:] - self.colstarts[:-1]

    def degree_matrix(self) -> torch.Tensor:
        """The (W, 32) word-aligned degree matrix (built once)."""
        if self._deg_mat is None:
            self._deg_mat = bm.degree_matrix(self.degrees(),
                                             self.n_vertices_padded)
        return self._deg_mat

    def resolve_tile(self, tile: int | None) -> int:
        """The CSR tile rule: ``tile`` (floored at 128) or, for auto,
        1024 capped at ``e_pad / 8`` so small graphs keep >= 8 blocks
        to skip, and never past the edge stream itself."""
        e_pad = self.n_edges_padded
        if tile is None:
            tile = max(MIN_TILE, min(DEFAULT_TILE, max(e_pad // 8,
                                                       MIN_TILE)))
            tile = min(tile, max(e_pad, MIN_TILE))
        return max(int(tile), MIN_TILE)

    def make_steps(self, spec) -> dict:
        from repro_torch.core import engine
        return engine._make_steps(self.colstarts, self.rows,
                                  self._n_vertices, self.n_vertices_padded,
                                  self.n_edges_padded, spec.algorithm,
                                  spec.tile, pipeline=spec.pipeline,
                                  prefetch_depth=spec.prefetch_depth)

    def n_blocks(self, tile: int) -> int:
        return -(-self.n_edges_padded // tile)

    def fused_graph(self, spec):
        """The whole-traversal kernel's loop constants at ``spec.tile``
        (built once per tile)."""
        if spec.tile not in self._fused:
            from repro_torch.core import engine
            from repro_torch.kernels.layer_fused import fused_csr
            rows_t = engine._pad_rows_to_tile(self.rows.contiguous(),
                                              self._n_vertices, spec.tile)
            self._fused[spec.tile] = fused_csr(
                self.colstarts.contiguous(), rows_t, self._n_vertices,
                spec.tile, self.n_vertices_padded)
        return self._fused[spec.tile]

    def persistent_fits(self, spec) -> bool:
        """Whether K6's per-CTA budget fits (batch-independent: its
        batch state lives in device memory)."""
        from repro_torch.kernels import ops
        return ops.persistent_fits(spec.tile, spec.prefetch_depth,
                                   self.n_blocks(spec.tile))

    def __repr__(self) -> str:
        return (f"CsrFormat(n_vertices={self._n_vertices}, "
                f"n_edges={self._n_edges}, device={self.device})")
