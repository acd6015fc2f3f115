"""The paper's own workload configs: Graph500 RMAT graphs (§5.2) — a
copy of ``repro.configs.bfs_graph500``.

SCALE 18/19/20 with edgefactor 16 are the paper's measured points
(Fig. 10 a-c); larger scales size the on-card runs (``rmat-22`` is
``chip_smoke.py``'s main path).
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class GraphConfig:
    name: str
    scale: int
    edgefactor: int = 16
    n_roots: int = 64          # paper §5.3 experimental design
    graph_format: str = "auto"  # repro_torch.formats layout ("auto" = tuner)

    @property
    def n_vertices(self) -> int:
        return 1 << self.scale

    @property
    def n_edges_directed(self) -> int:
        return 2 * self.n_vertices * self.edgefactor


@dataclass(frozen=True)
class BfsServeConfig:
    """Defaults for the batched BFS query service.

    ``batch_slots`` is the fixed multi-root width (engine launch and
    serve batch alike); 8 is the reported configuration.
    ``graph_format`` is the preprocess-on-load layout choice
    (`repro_torch.formats`): "auto" runs the autotuner on the resident
    graph's degree statistics.
    """
    batch_slots: int = 8
    max_layers: int = 64
    algorithm: str = "simd"
    graph_format: str = "auto"


@dataclass(frozen=True)
class FormatSweepConfig:
    """The format-sweep grid: every registered layout x a
    representative policy subset, on the paper's skewed RMAT workload
    (where SELL-C-σ is expected to at least match CSR)."""
    formats: tuple = ("csr", "sell", "bitmap")
    policies: tuple = ("topdown", "threshold", "hybrid")
    simd_threshold: int = 2048   # ThresholdSimd knee at bench scales


GRAPHS = {
    f"rmat-{s}": GraphConfig(f"rmat-{s}", scale=s)
    for s in (10, 12, 14, 16, 18, 19, 20, 22, 24, 27)
}
PAPER_GRAPHS = ("rmat-18", "rmat-19", "rmat-20")
SERVE = BfsServeConfig()
FORMAT_SWEEP = FormatSweepConfig()
