"""BitmapCompressedFormat — word-compressed adjacency for the dense
regime (a port of ``repro.formats.bitmap_format``, plain torch).

Vertex u's adjacency list is row u of a (V_pad, W) word bitmap: one bit
per potential neighbour.  Quadratic in V, so only small or dense graphs
qualify (the autotuner gates on a byte budget and a density floor).
One layer is the word sweep ``adj & frontier``: every vertex with a
frontier neighbour is found without gather, scatter or race, so no
restoration is needed; the parent is the lowest-id frontier neighbour,
which is deterministic.  The same sweep is the scalar, SIMD and
bottom-up step.  The reference has no Pallas kernel here either.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitmap as bm
from repro_torch.core.csr import Csr
from repro_torch.formats.base import Footprint, GraphFormat, nbytes
from repro_torch.formats.registry import register


@register
class BitmapCompressedFormat(GraphFormat):
    name = "bitmap"
    supports_prefetch = False    # dense word sweep: no edge stream
    # the word sweep stores bits, not neighbour ids: there is no
    # per-edge candidate stream to relax a semiring over, so the
    # portfolio is rejected by `TraversalSpec.validate`
    supported_semirings = ()

    def __init__(self, adj: torch.Tensor, deg: torch.Tensor,
                 n_vertices: int, n_edges: int):
        self.adj = adj              # (V_pad, W) int32 adjacency rows
        self.deg = deg              # (V,) int32
        self._n_vertices = int(n_vertices)
        self._n_edges = int(n_edges)
        self._deg_mat = None

    @classmethod
    def from_csr(cls, csr: Csr) -> "BitmapCompressedFormat":
        v, v_pad = csr.n_vertices, csr.n_vertices_padded
        w = v_pad // bm.BITS_PER_WORD
        dev = csr.device
        deg = (csr.colstarts[1:] - csr.colstarts[:-1]).to(torch.int64)
        src = torch.repeat_interleave(
            torch.arange(v, dtype=torch.int64, device=dev), deg,
            output_size=csr.n_edges)
        dst = csr.rows[:csr.n_edges].to(torch.int64)
        # OR of each (src, dst) bit: distinct pairs, so a sum is an OR
        pairs = torch.unique(src * v_pad + dst)
        src, dst = pairs // v_pad, pairs % v_pad
        acc = torch.zeros((v_pad * w,), dtype=torch.int64, device=dev)
        acc.index_add_(0, src * w + (dst >> bm.WORD_SHIFT),
                       torch.ones_like(dst) << (dst & bm.WORD_MASK))
        return cls(bm._wrap_i32(acc).reshape(v_pad, w),
                   deg.to(torch.int32), v, csr.n_edges)

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return (self.adj, self.deg)

    def to(self, device) -> "BitmapCompressedFormat":
        if self.adj.device == torch.device(device):
            return self
        return BitmapCompressedFormat(self.adj.to(device),
                                      self.deg.to(device),
                                      self._n_vertices, self._n_edges)

    # -- static geometry -------------------------------------------------
    @property
    def n_vertices(self) -> int:
        return self._n_vertices

    @property
    def n_edges(self) -> int:
        return self._n_edges

    # -- engine contract -------------------------------------------------
    def degrees(self) -> torch.Tensor:
        return self.deg

    def _sweep(self, frontier, visited, parent):
        """One exact dense layer of a (B, W) batch: the word AND of every
        adjacency row with the frontier; the parent of a discovered
        vertex is its lowest-id frontier neighbour."""
        inter = self.adj[None] & frontier[:, None, :]      # (B, V_pad, W)
        nonzero = inter != 0
        new_words = bm.pack_bool(nonzero.any(dim=2)) & ~visited
        mask = bm.unpack_bool(new_words)
        # first set bit of the row: first nonzero word, then its lsb
        widx = torch.argmax(nonzero.to(torch.uint8), dim=2)
        word = torch.gather(inter, 2, widx[..., None])[..., 0]
        lsb = word & -word
        bit = bm.popcount32(lsb - 1).to(torch.int32)
        parent_id = bm.bit2vertex(widx, bit)
        parent = torch.where(mask, parent_id, parent)
        return new_words, visited | new_words, parent

    def _build_steps(self, spec) -> dict:
        # no stream to prefetch (rejected by validation) and no tiles to
        # skip: every pipeline is the same sweep, one "tile" per root
        from repro_torch.core import engine

        def step(frontier, visited, parent):
            out, vis, par = self._sweep(frontier, visited, parent)
            return out, vis, par, engine.StepAux(frontier.shape[0], 0, 0)

        return {engine.MODE_SCALAR: step, engine.MODE_SIMD: step,
                engine.MODE_BOTTOMUP: step}

    # -- accounting ------------------------------------------------------
    def footprint(self) -> Footprint:
        return Footprint(self.name,
                         (("adj", nbytes(self.adj)),
                          ("degrees", nbytes(self.deg))))

    @property
    def edge_slots(self) -> int:
        # one sweep examines every potential edge, one bit per slot
        return int(self.adj.numel()) * bm.BITS_PER_WORD

    def layer_bytes(self) -> int:
        return nbytes(self.adj)       # the sweep streams the adj matrix

    def tile_bytes(self, tile: int) -> int:
        return nbytes(self.adj)       # one "tile" per root sweep

    def tile_count(self, tile: int) -> int:
        return 1

    def plan_bytes(self, tile: int, packed: bool = True) -> int:
        return 0                      # nothing to plan

    def plan_mask_bytes(self, packed: bool = True) -> int:
        return 0                      # no plan read
