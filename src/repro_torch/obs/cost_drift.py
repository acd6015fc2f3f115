"""The analytic bytes model of one full-sweep layer (the analytic half
of ``repro.obs.cost_drift``).

The reference compares `analytic_layer_bytes` against what XLA compiled
(``cost_analysis`` and its HLO analyzer); neither has a torch
counterpart, so ``measure_drift`` and ``cost_analysis_bytes`` are not
here yet.  What is here is the model side and the row format: a
`Drift` record, `analytic_layer_bytes`, and `drift_rows`, so a measured
byte source can be set beside the model once the port has one.
"""
from __future__ import annotations

from typing import NamedTuple


class Drift(NamedTuple):
    """One (format, pipeline) comparison row."""
    format: str
    pipeline: str
    analytic_bytes: int        # full-sweep per-layer model
    compiled_bytes: float      # the measured byte count
    hlo_bytes: float           # a second measured byte count
    tile: int

    @property
    def ratio(self) -> float:
        """measured / analytic — the drift figure."""
        return (self.compiled_bytes / self.analytic_bytes
                if self.analytic_bytes else float("nan"))

    @property
    def hlo_ratio(self) -> float:
        return (self.hlo_bytes / self.analytic_bytes
                if self.analytic_bytes else float("nan"))


def analytic_layer_bytes(fmt, *, pipeline: str, tile: int,
                         packed: bool = True) -> int:
    """The model's bytes for one FULL-SWEEP layer of ``fmt``.

    ``materialized`` streams the whole apportioned edge stream
    (`layer_bytes`); the fused pipelines stream every tile plus the
    planning pass (``tile_bytes * n_blocks + plan_bytes``) — the
    all-tiles-active ceiling of a dense layer."""
    from repro_torch.api.spec import PIPELINES
    if pipeline not in PIPELINES:
        raise ValueError(f"unknown pipeline {pipeline!r}; expected one of "
                         f"{PIPELINES}")
    if pipeline == "materialized":
        return fmt.layer_bytes()
    n_blocks = -(-fmt.edge_slots // max(tile, 1))
    return fmt.tile_bytes(tile) * n_blocks + fmt.plan_bytes(tile, packed)


def drift_rows(drifts: list[Drift], prefix: str = "obs.cost_drift"
               ) -> dict:
    """Rows ``{prefix}.{format}.{pipeline}`` -> {analytic_bytes,
    compiled_bytes, hlo_bytes, ratio, hlo_ratio, tile}."""
    rows = {}
    for d in drifts:
        rows[f"{prefix}.{d.format}.{d.pipeline}"] = {
            "analytic_bytes": d.analytic_bytes,
            "compiled_bytes": d.compiled_bytes,
            "hlo_bytes": d.hlo_bytes,
            "ratio": d.ratio,
            "hlo_ratio": d.hlo_ratio,
            "tile": d.tile,
        }
    return rows
