"""The analytic bytes model against what the port's single-layer tick
moves (a port of ``repro.obs.cost_drift``).

The repo's byte gates compare *analytic* per-layer byte models
(`formats.base.layer_bytes` / `tile_bytes` / `plan_bytes`) against
each other; nothing else checks them against what the layer really
runs.  `measure_drift` closes that loop: for each (format, pipeline) it
runs the plan's single-layer tick (`CompiledTraversal.layer_step`, the
step `run`, `layer_step` and the serve tier share) once under
`roofline.hlo_analyze.Analyzer` and reads two byte counts of it:

* ``compiled_bytes`` (`cost_analysis_bytes`): every op's operands and
  results, each kernel wrapper counted as one op with its tensor
  arguments and results (the reference's XLA ``cost_analysis`` "bytes
  accessed");
* ``hlo_bytes``: the same call with each distinct storage counted once
  (the tighter model, the reference's HLO analyzer's place).

against the analytic *full-sweep* per-layer model.  The reference
compiles a data-independent program; the port runs the layer of a
zero-root batch, so the counts are of that layer (every kernel's
arguments are its full arrays, whatever the frontier).  The ratio
``compiled / analytic`` is not expected to be 1.0: the layer also moves
state bitmaps, work-lists and plans; what a gate pins is its stability.
"""
from __future__ import annotations

from typing import NamedTuple

from repro_torch.device import DEFAULT_DEVICE


class Drift(NamedTuple):
    """One (format, pipeline) comparison row."""
    format: str
    pipeline: str
    analytic_bytes: int        # full-sweep per-layer model
    compiled_bytes: float      # the analyzer's bytes: every op's I/O
    hlo_bytes: float           # the same, each storage counted once
    tile: int

    @property
    def ratio(self) -> float:
        """compiled / analytic — the drift figure."""
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
    planning pass (``tile_bytes * tile_count + plan_bytes``) — the
    all-tiles-active ceiling of a dense layer.

    The reference counts the tiles as ``ceil(edge_slots / tile)`` for
    every format.  That is CSR's unit; SELL's tile is in slabs of
    ``W_QUANT * SLICE_C`` edge slots, and the bitmap's one tile is the
    whole matrix, so the reference's SELL and bitmap figures are those
    factors too large (1024x for SELL).  The port counts each format's
    tiles in its own unit (`GraphFormat.tile_count`); its CSR figure is
    the reference's."""
    from repro_torch.api.spec import PIPELINES
    if pipeline not in PIPELINES:
        raise ValueError(f"unknown pipeline {pipeline!r}; expected one of "
                         f"{PIPELINES}")
    if pipeline == "materialized":
        return fmt.layer_bytes()
    return fmt.tile_bytes(tile) * fmt.tile_count(tile) \
        + fmt.plan_bytes(tile, packed)


def cost_analysis_bytes(cost) -> float:
    """The "bytes accessed" of an analysed call: its `Cost`'s bytes,
    every op's operands and results."""
    return float(cost.bytes)


def measure_drift(graph, spec=None, *,
                  pipelines=("fused_gather", "materialized"),
                  batch: int = 1, device=DEFAULT_DEVICE) -> list[Drift]:
    """Run the single-layer tick once per pipeline under the analyzer and
    compare its byte counts with the model.

    Args:
      graph: Csr/EdgeList/GraphFormat (same contract as ``plan``).
      spec: base `TraversalSpec`; its ``pipeline`` field is overridden
        per entry of ``pipelines``.
      pipelines: which pipeline flavours to run (the caller skips
        flavours the format rejects, e.g. megakernel on SELL).
      batch: root-batch width of the tick (1 = the analytic model's
        single-root accounting); every root is vertex 0.
      device: where the tick runs (the card by default).
    """
    import torch

    from repro_torch.api.plan import plan as _plan
    from repro_torch.api.spec import TraversalSpec
    from repro_torch.core import engine as _engine
    from repro_torch.roofline.hlo_analyze import Analyzer

    spec = spec if spec is not None else TraversalSpec()
    out: list[Drift] = []
    for pipeline in pipelines:
        ct = _plan(graph, spec.replace(pipeline=pipeline), device=device)
        fmt, rspec = ct.fmt, ct.resolved
        roots = torch.zeros((batch,), dtype=torch.int32, device=fmt.device)
        f, v, p = _engine._init_batched(roots, fmt.n_vertices,
                                        fmt.n_vertices_padded)
        with Analyzer() as an:
            ct.layer_step(f, v, p)
        out.append(Drift(
            format=type(fmt).name,
            pipeline=pipeline,
            analytic_bytes=analytic_layer_bytes(
                fmt, pipeline=pipeline, tile=rspec.tile,
                packed=rspec.packed),
            compiled_bytes=cost_analysis_bytes(an.cost),
            hlo_bytes=float(an.cost.distinct_bytes),
            tile=rspec.tile))
    return out


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
