"""Pluggable graph formats (paper §4.2's layout axis), in torch.

``import repro_torch.formats`` registers every built-in layout:

* ``csr``    — the §3.3.1 CSR (K1-K6);
* ``sell``   — SELL-C-σ sliced ELLPACK (SlimSell), on the slab kernels
  K8-K10;
* ``bitmap`` — word-compressed adjacency for the dense regime (plain
  torch, as in the reference).

Entry points: `build(graph, name)` ("auto" = the autotuner),
`autotune.choose(graph)` for the decision and its reason, and
``repro_torch.bfs.plan(fmt, spec)`` to run any layout.
"""
from repro_torch.formats import autotune, registry
from repro_torch.formats.base import Footprint, GraphFormat, csr_to_edges, \
    membership_bytes, traversal_bytes
from repro_torch.formats.bitmap_format import BitmapCompressedFormat
from repro_torch.formats.csr_format import CsrFormat
from repro_torch.formats.registry import available, build, get
from repro_torch.formats.sell import SellFormat

__all__ = [
    "autotune", "registry", "available", "build", "get",
    "Footprint", "GraphFormat", "csr_to_edges", "membership_bytes",
    "traversal_bytes",
    "CsrFormat", "SellFormat", "BitmapCompressedFormat",
]
