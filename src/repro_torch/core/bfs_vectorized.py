"""The paper's §4 vectorized BFS: the SIMD kernels on the fat layers.

A thin wrapper over the engine: the *layer-adaptive* switch of §4.1
runs the SIMD path only on layers examining at least
``simd_threshold`` edges (`engine.ThresholdSimd`), or on the explicit
``simd_layers`` (`engine.PaperLiteralLayers`, the paper's literal
"first two [fat] layers"); scalar layers elsewhere.
"""
from __future__ import annotations

from repro_torch.core import engine
from repro_torch.core.csr import Csr
from repro_torch.device import DEFAULT_DEVICE


def run_bfs_vectorized(csr: Csr, root, *, simd_threshold: int = 16_384,
                       simd_layers: tuple[int, ...] | None = None,
                       tile: int | None = None,
                       collect_stats: bool = False,
                       max_layers: int = 1024, device=DEFAULT_DEVICE):
    """Top-down BFS with the vectorized fat layers (``simd_layers``,
    when given, overrides the threshold).  Returns the final state,
    with ``collect_stats`` also its `LayerStats`."""
    from repro_torch.api.plan import plan
    if simd_layers is not None:
        policy = engine.PaperLiteralLayers(tuple(int(l)
                                                 for l in simd_layers))
    else:
        policy = engine.ThresholdSimd(int(simd_threshold))
    spec = engine.make_spec(policy=policy, tile=tile,
                            max_layers=max_layers)
    res = plan(csr, spec, device=device).run(root)
    if collect_stats:
        return res.state, engine.layer_stats(res)
    return res.state
