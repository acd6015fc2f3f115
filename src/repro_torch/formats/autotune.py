"""Format autotuner: pick a layout from graph statistics (a port of
``repro.formats.autotune``, with its thresholds and reason strings).

* **density** E / V² — small dense graphs take the word-compressed
  adjacency (``bitmap``): the whole matrix fits a byte budget and one
  layer is a word sweep;
* **degree skew** max / mean degree — skewed (power-law, R-MAT) graphs
  take SELL-C-σ (``sell``): degree sorting keeps the per-slice padding
  small exactly when degrees are skewed;
* otherwise CSR (``csr``): near-uniform, sparse graphs, where
  frontier-proportional work beats any whole-adjacency sweep.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import bitmap as bm
from repro_torch.core.csr import Csr, from_edges as csr_from_edges, \
    padded_vertex_count
from repro_torch.core.rmat import EdgeList
from repro_torch.formats import registry
from repro_torch.formats.base import GraphFormat

# decision thresholds (see module docstring)
BITMAP_BUDGET_BYTES = 4 << 20     # adjacency-bitmap cap
DENSITY_THRESHOLD = 0.05          # E/V^2 floor for the dense regime
SKEW_THRESHOLD = 4.0              # max_deg/mean_deg floor for SELL


class GraphStats(NamedTuple):
    n_vertices: int
    n_edges: int
    mean_degree: float
    max_degree: int
    degree_skew: float            # max_degree / mean_degree
    density: float                # n_edges / n_vertices^2
    bitmap_bytes: int             # what BitmapCompressedFormat would pin


class Choice(NamedTuple):
    format: str
    reason: str
    stats: GraphStats


def _as_csr(graph) -> Csr:
    if isinstance(graph, Csr):
        return graph
    if isinstance(graph, EdgeList):
        return csr_from_edges(graph, device=graph.src.device)
    raise TypeError(f"cannot autotune over {type(graph).__name__}")


def measure(graph) -> GraphStats:
    """Degree/density statistics from a Csr, EdgeList or GraphFormat.
    The mean is the exact degree sum over V, as the reference's float64
    mean of int64 degrees."""
    if isinstance(graph, GraphFormat):
        deg = graph.degrees()
        v, e = graph.n_vertices, graph.n_edges
    else:
        csr = _as_csr(graph)
        deg = csr.degrees()
        v, e = csr.n_vertices, csr.n_edges
    mean = int(deg.sum(dtype=torch.int64)) / v if v else 0.0
    mx = int(deg.max()) if v else 0
    v_pad = padded_vertex_count(v)
    return GraphStats(
        n_vertices=v, n_edges=e, mean_degree=mean, max_degree=mx,
        degree_skew=(mx / mean) if mean > 0 else 0.0,
        density=(e / (v * v)) if v else 0.0,
        bitmap_bytes=v_pad * (v_pad // bm.BITS_PER_WORD) * 4)


def choose(graph, *,
           bitmap_budget_bytes: int = BITMAP_BUDGET_BYTES,
           density_threshold: float = DENSITY_THRESHOLD,
           skew_threshold: float = SKEW_THRESHOLD) -> Choice:
    """Pick a registered format name for this graph."""
    s = measure(graph)
    if (s.bitmap_bytes <= bitmap_budget_bytes
            and s.density >= density_threshold):
        return Choice("bitmap",
                      f"dense regime: density {s.density:.3f} >= "
                      f"{density_threshold} and adjacency bitmap "
                      f"{s.bitmap_bytes/2**20:.2f} MiB fits budget", s)
    if s.degree_skew >= skew_threshold:
        return Choice("sell",
                      f"skewed degrees: max/mean {s.degree_skew:.1f} >= "
                      f"{skew_threshold} — σ-sorted slices absorb the "
                      f"skew (SlimSell)", s)
    return Choice("csr",
                  f"near-uniform degrees (skew {s.degree_skew:.1f}), "
                  f"sparse (density {s.density:.4f}): frontier-"
                  f"proportional gather wins", s)


def build(graph, name: str = "auto", **choose_kwargs) -> GraphFormat:
    """Build the chosen (or named) format, on the graph's device.

    ``name="auto"`` runs `choose`; any registered name forces that
    layout.  A built format is kept as it is under "auto" or its own
    name (re-laying it out needs its ``to_csr``)."""
    if isinstance(graph, GraphFormat) and name in ("auto", graph.name):
        return graph
    if name == "auto":
        name = choose(graph, **choose_kwargs).format
    return registry.get(name).from_graph(graph)
