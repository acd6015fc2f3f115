"""Architecture + shape registry: every (arch x shape) dry-run cell.

``--arch <id>`` resolution for launchers, the assigned input-shape set,
and the applicability matrix (which cells run / why some are N/A).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.models.config import ModelConfig
from repro_torch.configs import (arctic_480b, granite_20b, h2o_danube,
                                 hymba_1p5b, llama4_maverick, paligemma_3b,
                                 phi3_mini, qwen3_14b, rwkv6_3b,
                                 seamless_m4t)

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in [
        qwen3_14b.CONFIG, phi3_mini.CONFIG, h2o_danube.CONFIG,
        granite_20b.CONFIG, llama4_maverick.CONFIG, arctic_480b.CONFIG,
        hymba_1p5b.CONFIG, seamless_m4t.CONFIG, paligemma_3b.CONFIG,
        rwkv6_3b.CONFIG,
    ]
}

# short aliases for --arch
ALIASES = {
    "qwen3": "qwen3-14b", "phi3": "phi3-mini-3.8b",
    "danube": "h2o-danube-1.8b", "granite": "granite-20b",
    "llama4": "llama4-maverick-400b-a17b", "arctic": "arctic-480b",
    "hymba": "hymba-1.5b", "seamless": "seamless-m4t-medium",
    "paligemma": "paligemma-3b", "rwkv6": "rwkv6-3b",
}


def get(name: str, reduced: bool = False) -> ModelConfig:
    cfg = ARCHS[ALIASES.get(name, name)]
    return cfg.reduced() if reduced else cfg


@dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str      # "train" | "prefill" | "decode"


SHAPES: dict[str, Shape] = {
    "train_4k": Shape("train_4k", 4_096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32_768, 128, "decode"),
    "long_500k": Shape("long_500k", 524_288, 1, "decode"),
}


def cell_status(cfg: ModelConfig, shape: Shape) -> str:
    """'run' or a skip reason — the 40-cell applicability matrix."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return "skip: pure full attention at 500k (quadratic); " \
               "per assignment, run only for SSM/hybrid/linear-attn"
    return "run"


def all_cells():
    """Yield (arch, shape, status) for all 40 cells."""
    for cfg in ARCHS.values():
        for shape in SHAPES.values():
            yield cfg, shape, cell_status(cfg, shape)
