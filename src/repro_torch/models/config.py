"""Model configuration — one dataclass covering the assigned pool.

Families: dense / moe / hybrid (attn+SSM) / ssm (rwkv) / audio
(enc-dec) / vlm (prefix-LM).  Every knob corresponds to a concrete
architecture requirement from the assignment table; configs/<id>.py
instantiates them exactly.

A copy of the reference's ``models/config.py``.  ``remat`` makes the
port's `transformer.stack_seq` and `lm.chunked_ce` recompute each block
and each cross-entropy chunk in the backward pass, as the reference's
``jax.checkpoint`` does; ``scan_layers`` and ``seq_parallel`` steer the
reference's jitted stacks, and the port reads them nowhere (its stacks
run layer by layer).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int | None = None          # default d_model // n_heads
    qk_norm: bool = False                # qwen3
    sliding_window: int | None = None    # h2o-danube SWA
    rope_theta: float = 10_000.0
    mlp: str = "swiglu"                  # swiglu | geglu
    tie_embeddings: bool = True

    # MoE (llama4-maverick, arctic)
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    moe_stride: int = 1                  # llama4: MoE every Nth layer
    capacity_factor: float = 1.25
    dense_residual: bool = False         # arctic: dense MLP + MoE in parallel
    dense_residual_ff: int | None = None # hidden of the parallel dense MLP
    moe_group_size: int = 512            # tokens per dispatch group
    moe_dispatch: str = "einsum"         # einsum (GShard) | sort (SPerf)

    # hybrid (hymba): parallel attention + SSM heads per layer
    ssm: bool = False
    ssm_state: int = 16
    ssm_conv: int = 4

    # rwkv6
    attn_free: bool = False

    # encoder-decoder (seamless-m4t)
    encoder_layers: int = 0
    cross_attention: bool = False

    # modality frontend stubs (paligemma patches / seamless frames)
    prefix_len: int = 0                  # stub embeddings prepended
    frontend: str | None = None          # "siglip_stub" | "audio_stub"

    norm_eps: float = 1e-6
    dtype: str = "bfloat16"          # activation/compute dtype
    param_dtype: str = "float32"     # master weights (bf16: 400B-class)
    remat: bool = True
    attn_q_chunk: int = 2048             # memory-efficient attention tiles
    attn_kv_chunk: int = 1024
    vocab_chunk: int = 16_384            # chunked cross-entropy
    scan_layers: bool = True             # lax.scan over stacked layers
    seq_parallel: bool = False           # shard seq over "model" between
                                         # blocks (Megatron-SP: RS+AG
                                         # replaces TP all-reduce)

    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run the long_500k decode shape?"""
        return (self.attn_free or self.ssm
                or self.sliding_window is not None)

    @property
    def is_decoder(self) -> bool:
        return True  # all pool archs have a decoder (enc-dec included)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family/features, tiny sizes."""
        return self.with_(
            name=self.name + "-reduced",
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=16,
            d_ff=128,
            vocab_size=512,
            n_experts=min(self.n_experts, 8) if self.moe else 0,
            dense_residual_ff=64 if self.dense_residual else None,
            moe_group_size=64,
            encoder_layers=2 if self.encoder_layers else 0,
            prefix_len=8 if self.prefix_len else 0,
            sliding_window=32 if self.sliding_window else None,
            attn_q_chunk=16,
            attn_kv_chunk=16,
            vocab_chunk=256,
        )


# Parameter counting (for MODEL_FLOPS = 6*N*D roofline term) -----------------

def param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """Analytic parameter count; active_only counts top-k experts only."""
    d, hd = cfg.d_model, cfg.resolved_head_dim()
    attn = d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * hd * d
    glu = 3 * d * cfg.d_ff
    per_layer = attn + 2 * d   # + norms
    if cfg.moe:
        n_e = cfg.top_k if active_only else cfg.n_experts
        moe_frac = 1.0 / cfg.moe_stride        # llama4: every 2nd layer
        per_layer += moe_frac * (n_e * 3 * d * cfg.d_ff
                                 + d * cfg.n_experts)  # router
        per_layer += (1 - moe_frac) * glu      # interleaved dense MLPs
        if cfg.dense_residual:
            per_layer += 3 * d * (cfg.dense_residual_ff or cfg.d_ff)
    elif cfg.attn_free:
        # rwkv: r,k,v,g,o projections + decay lora, no attention
        per_layer = 5 * d * d + 2 * d * 64 + 2 * d
        per_layer += 3 * d * cfg.d_ff // 1   # channel-mix (ffn)
    else:
        per_layer += glu
    if cfg.ssm:
        d_in = d
        per_layer += 2 * d * d_in + d_in * cfg.ssm_conv \
            + 2 * d_in * cfg.ssm_state + d_in * d
    total = cfg.n_layers * per_layer
    if cfg.encoder_layers:
        enc_layer = attn + glu + 2 * d
        total += cfg.encoder_layers * (enc_layer + attn + 2 * d)  # +cross
    total += cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    return int(total)
