"""The semiring algorithm portfolio: one engine, sssp / cc / ksource_bfs.

`semiring` holds the (⊕, ⊗) record and the registered instances;
`traversal` is the whole-traversal driver `plan` routes the portfolio's
``TraversalSpec.algorithm`` values through.  This ``__init__``
re-exports only the semiring layer, as the reference's does: the
driver imports the kernel stack, and the kernels import `semiring` for
the edge weights, so a thin package root keeps the imports acyclic.
"""
from repro_torch.algorithms.semiring import (SEMIRING_ALGORITHMS,
                                             SEMIRINGS, Semiring,
                                             edge_weight, edge_weight_np,
                                             get)

__all__ = [
    "SEMIRING_ALGORITHMS",
    "SEMIRINGS",
    "Semiring",
    "edge_weight",
    "edge_weight_np",
    "get",
]
