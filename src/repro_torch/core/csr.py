"""Compressed Sparse Row graph representation — paper §3.3.1, in torch.

``rows`` holds the concatenated (sorted) adjacency lists and
``colstarts[u]`` / ``colstarts[u+1]`` delimit vertex ``u``'s
neighbors.  The §4.2 padding convention is the reference's:

* ``rows`` is padded to a multiple of ``LANES`` (=128) with the
  **sentinel vertex** ``V``;
* every vertex-indexed array (bitmaps, P) is sized for
  ``padded_vertex_count(V)`` vertices;
* padding vertices are pre-marked *visited* at BFS init, so padding
  lanes flow through every mask and always filter out.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import bitmap as bm
from repro_torch.core.rmat import EdgeList
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.errors import GraphValidationError

LANES = 128  # the reference's TPU lane count; kept so layouts match


def round_up(x: int, m: int) -> int:
    return (int(x) + m - 1) // m * m


def padded_vertex_count(n_vertices: int) -> int:
    """Vertex-array size: V real vertices + sentinel V + lane padding."""
    return round_up(n_vertices + 1, LANES)


class Csr(NamedTuple):
    rows: torch.Tensor       # (n_edges_padded,) int32, sentinel-padded
    colstarts: torch.Tensor  # (n_vertices + 1,) int32
    n_vertices: int          # real vertex count V (sentinel id == V)
    n_edges: int             # real directed edge count (un-padded)

    @property
    def n_vertices_padded(self) -> int:
        return padded_vertex_count(self.n_vertices)

    @property
    def n_edges_padded(self) -> int:
        return int(self.rows.shape[0])

    @property
    def sentinel(self) -> int:
        return self.n_vertices

    @property
    def device(self) -> torch.device:
        return self.rows.device

    def degrees(self) -> torch.Tensor:
        return self.colstarts[1:] - self.colstarts[:-1]

    def out_degree(self, u) -> torch.Tensor:
        return self.colstarts[u + 1] - self.colstarts[u]


def from_edges(edges: EdgeList, device=DEFAULT_DEVICE) -> Csr:
    """Build a padded CSR from a COO edge list (Graph500 kernel 2).

    Edges are sorted lexicographically by (src, dst) through one int64
    composite key, so the result equals the reference's two stable
    passes array for array."""
    dev = resolve_device(device)
    v = int(edges.n_vertices)
    n_edges = int(edges.src.shape[0])
    assert v < 2**31 and n_edges < 2**31, \
        "int32 representation requires V, E < 2^31"
    src = torch.as_tensor(edges.src).to(dev, torch.int64)
    key = src * v + torch.as_tensor(edges.dst).to(dev, torch.int64)
    del src
    key, _ = torch.sort(key)
    src = key // v
    dst = (key - src * v).to(torch.int32)
    del key
    counts = torch.bincount(src, minlength=v)
    del src
    colstarts = torch.cat([
        torch.zeros((1,), dtype=torch.int64, device=dev),
        torch.cumsum(counts, 0)]).to(torch.int32)
    pad = round_up(n_edges, LANES) - n_edges
    rows = torch.cat([dst, torch.full((pad,), v, dtype=torch.int32,
                                      device=dev)]) if pad else dst
    return Csr(rows=rows, colstarts=colstarts, n_vertices=v,
               n_edges=n_edges)


def padding_premarked_visited(n_vertices: int,
                              device=DEFAULT_DEVICE) -> torch.Tensor:
    """Visited bitmap with every padding vertex pre-marked — the single
    home of the convention that replaces the paper's peel/remainder
    loops."""
    dev = resolve_device(device)
    v_pad = padded_vertex_count(n_vertices)
    pad_ids = torch.arange(n_vertices, v_pad, dtype=torch.int32,
                           device=dev)
    return bm.set_bits_exact(bm.zeros(v_pad, device=dev), pad_ids)


def init_visited(csr: Csr) -> torch.Tensor:
    """`padding_premarked_visited` for a built CSR."""
    return padding_premarked_visited(csr.n_vertices, device=csr.device)


def _as_count(name: str, value) -> int:
    """Coerce a geometry scalar to a non-negative int or raise
    `GraphValidationError`."""
    if isinstance(value, bool):
        raise GraphValidationError(
            f"{name} must be a non-negative integer, got the bool "
            f"{value!r}; pass a vertex/edge count")
    if isinstance(value, float):
        if math.isnan(value) or math.isinf(value) \
                or value != int(value):
            raise GraphValidationError(
                f"{name} must be a non-negative integer, got {value!r} "
                f"(NaN/inf/fractional geometry would silently mis-size "
                f"every vertex-indexed array); pass an exact int")
        value = int(value)
    if not isinstance(value, (int, np.integer)):
        raise GraphValidationError(
            f"{name} must be a non-negative integer, got "
            f"{type(value).__name__} {value!r}")
    value = int(value)
    if value < 0:
        raise GraphValidationError(
            f"{name} must be >= 0, got {value}")
    return value


def check_structure(csr: Csr) -> Csr:
    """Strict admission-time structural validation.

    Raises `GraphValidationError` (IS-A ``ValueError``) when the CSR
    could produce a *wrong traversal* rather than an error; the
    messages are the reference's, except that the dtype fix names
    ``.to(torch.int32)``.  The checks run as torch reductions on the
    arrays' own device.  Returns ``csr`` so call sites can chain.
    """
    v = _as_count("n_vertices", csr.n_vertices)
    e = _as_count("n_edges", csr.n_edges)
    if v < 1:
        raise GraphValidationError(
            "n_vertices must be >= 1 (a BFS needs at least a root "
            "vertex); got 0")
    rows = torch.as_tensor(csr.rows)
    colstarts = torch.as_tensor(csr.colstarts)
    for name, arr in (("rows", rows), ("colstarts", colstarts)):
        if arr.ndim != 1:
            raise GraphValidationError(
                f"{name} must be 1-D, got shape {tuple(arr.shape)}")
        if arr.dtype.is_floating_point or arr.dtype.is_complex \
                or arr.dtype == torch.bool:
            raise GraphValidationError(
                f"{name} must have an integer dtype (vertex ids), got "
                f"{arr.dtype}; cast with .to(torch.int32)")
    if colstarts.shape[0] != v + 1:
        raise GraphValidationError(
            f"colstarts must have n_vertices+1 = {v + 1} entries "
            f"(one past-the-end offset per vertex), got "
            f"{colstarts.shape[0]}")
    if int(colstarts[0]) != 0:
        raise GraphValidationError(
            f"colstarts[0] must be 0 (offsets index into rows from the "
            f"start), got {int(colstarts[0])}")
    neg = torch.diff(colstarts.to(torch.int64)) < 0
    if bool(neg.any()):
        bad = int(torch.argmax(neg.to(torch.int8)))
        raise GraphValidationError(
            f"colstarts must be non-decreasing (adjacency extents "
            f"cannot have negative length); colstarts[{bad}]="
            f"{int(colstarts[bad])} > colstarts[{bad + 1}]="
            f"{int(colstarts[bad + 1])}")
    if int(colstarts[-1]) != e:
        raise GraphValidationError(
            f"colstarts[-1] ({int(colstarts[-1])}) must equal n_edges "
            f"({e}); the offsets and the declared edge count disagree")
    if rows.shape[0] < e:
        raise GraphValidationError(
            f"rows has {rows.shape[0]} entries but colstarts addresses "
            f"{e} edges; the adjacency array is truncated")
    if e:
        real = rows[:e]
        lo, hi = int(real.min()), int(real.max())
        if lo < 0 or hi >= v:
            bad_val = lo if lo < 0 else hi
            raise GraphValidationError(
                f"rows contains neighbor id {bad_val} outside "
                f"[0, n_vertices={v}); every real adjacency entry must "
                f"name an existing vertex (the sentinel {v} is only "
                f"legal in the padding tail)")
    if rows.shape[0] > e:
        pad = rows[e:]
        if bool(((pad < 0) | (pad > v)).any()):
            raise GraphValidationError(
                f"rows padding tail contains ids outside [0, "
                f"sentinel={v}]; pad with the sentinel vertex id {v}")
    return csr


def traversed_edges(csr: Csr, reached: torch.Tensor) -> torch.Tensor:
    """Graph500 edge count for TEPS: Σ degrees of reached vertices / 2.

    ``reached`` is a (V,) bool mask of the vertices in the BFS tree; the
    halving turns symmetrized directed edges into undirected ones."""
    deg = csr.degrees().to(torch.int64)
    return (torch.where(reached, deg, 0).sum() // 2).to(torch.int32)
