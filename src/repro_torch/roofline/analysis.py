"""Roofline analysis of dry-run cells (a port of
``repro.roofline.analysis``).

Three terms per (arch x shape x mesh), all in seconds per step on the
constants of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates at
its full 700 W power limit; a card set below it runs slower):

  compute    = flops_per_rank / 989.4e12      (bf16 tensor cores)
  memory     = bytes_per_rank / 3.35e12       (HBM3)
  collective = wire_bytes_per_rank / 450e9    (NVLink, per direction)

Flops, bytes and collective payloads come from
`roofline.hlo_analyze.analyze`, which counts the ops one rank's call
dispatches (the counterpart of the reference's post-SPMD per-device
module).  The collective term describes a multi-card NVLink mesh; the
machine this port is measured on has one card, so on it the term is a
prediction only.  Collective wire bytes apply the ring-algorithm factor
over the op's group size g:

  all-reduce      2 * (g-1)/g * bytes      (reduce-scatter + all-gather)
  all-gather      (g-1)/g * bytes          (bytes = full output)
  reduce-scatter  (g-1)/g * bytes
  all-to-all      (g-1)/g * bytes
  collective-permute  bytes

The reference also parses collectives out of HLO text
(``parse_collectives``).  Torch has no HLO: the analyzer reads each
collective's payload and group off the op's own arguments as it is
dispatched, so that parser has no counterpart here.

Caveats: "bytes" counts operands plus results of every op, which
over-counts HBM traffic for values a fused kernel keeps on chip, so the
memory term is an upper bound; the collective term assumes ring
scheduling over one NVLink direction, and is conservative too.
"""
from __future__ import annotations

from dataclasses import dataclass, field

#: NVIDIA H100 SXM (80 GB HBM3), 700 W: dense bf16 tensor-core peak
PEAK_FLOPS = 989.4e12
#: its HBM3 bandwidth, bytes/s
HBM_BW = 3.35e12
#: NVLink 4 per card, bytes/s in one direction (900 GB/s both ways)
NVLINK_BW = 450e9

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def _wire_factor(op: str, g: int) -> float:
    if g <= 1:
        return 0.0
    frac = (g - 1) / g
    return {"all-reduce": 2 * frac, "all-gather": frac,
            "reduce-scatter": frac, "all-to-all": frac,
            "collective-permute": 1.0}[op]


@dataclass
class CollectiveStats:
    ops: dict = field(default_factory=dict)      # op -> count
    payload_bytes: int = 0
    wire_bytes: float = 0.0

    def to_dict(self):
        return {"ops": self.ops, "payload_bytes": self.payload_bytes,
                "wire_bytes": self.wire_bytes}


@dataclass
class Roofline:
    flops: float
    bytes_accessed: float
    wire_bytes: float
    n_chips: int
    model_flops: float = 0.0          # 6*N*D (or 2*N*D decode)
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    link_bw: float = NVLINK_BW

    @property
    def t_compute(self) -> float:
        return self.flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / self.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.wire_bytes / self.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (chips * counted flops): remat/redundancy waste."""
        denom = self.flops * self.n_chips
        return (self.model_flops / denom) if denom else 0.0

    @property
    def mfu_bound(self) -> float:
        """Roofline-bounded MFU: useful flops / peak at t_bound."""
        if self.t_bound == 0:
            return 0.0
        return self.model_flops / (self.n_chips * self.peak_flops
                                   * self.t_bound)

    def to_dict(self):
        return {
            "flops_per_chip": self.flops,
            "bytes_per_chip": self.bytes_accessed,
            "wire_bytes_per_chip": self.wire_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_bound": self.mfu_bound,
        }


def model_flops_for(kind: str, n_params_active: float, n_tokens: float,
                    n_embedding: float = 0.0) -> float:
    """6ND training / 2ND inference, excluding embedding lookups."""
    body = n_params_active - n_embedding
    per_tok = 6.0 * body if kind == "train" else 2.0 * body
    return per_tok * n_tokens


def embedding_params(cfg) -> int:
    """The embedding parameters `model_flops_for` leaves out, as the
    reference's dry run counts them: both tables when untied."""
    return cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
