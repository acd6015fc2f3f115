"""llama4-maverick-400b-a17b [moe]: 48L d5120 40H (GQA kv=8) ff8192
vocab202048, MoE 128 experts top-1.

Per [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].  MoE layers
interleave with dense layers (moe_stride=2, the Llama-4 pattern) —
24 MoE layers x 128 experts x 3 x 5120 x 8192 = 387B expert params,
matching the 400B total / 17B active advertised by the name; with
moe_stride=1 the model would be 1.2T, contradicting its own name.
The shared-expert variant of the HF release is out of assignment
scope (noted in DESIGN.md).  Full attention => long_500k skipped
("early fusion" multimodality enters as tokens).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab_size=202048, head_dim=128,
    moe=True, n_experts=128, top_k=1, moe_stride=2,
    capacity_factor=1.25,
    tie_embeddings=False,
)
