"""arctic-480b [moe]: 35L d7168 56H (GQA kv=8) ff4864 vocab32000,
MoE 128 experts top-2 + dense residual.

Snowflake arctic dense-MoE hybrid per [hf:Snowflake/snowflake-arctic-
base; hf]: a dense MLP runs in parallel (residual) with the 128-expert
top-2 MoE in every layer. head_dim 128 (56*128=7168).
Full attention => long_500k skipped.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab_size=32000, head_dim=128,
    moe=True, n_experts=128, top_k=2, capacity_factor=1.25,
    dense_residual=True, dense_residual_ff=4864,
    tie_embeddings=False,
)
