"""qwen3-14b [dense]: 40L d5120 40H (GQA kv=8) ff17408 vocab151936.

qk_norm + GQA per [hf:Qwen/Qwen3-8B; hf]. head_dim 128 (40*128=5120).
Pure full attention => long_500k is skipped (DESIGN.md §Arch-applicability).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=17408, vocab_size=151936, head_dim=128,
    qk_norm=True, rope_theta=1_000_000.0, tie_embeddings=False,
)
