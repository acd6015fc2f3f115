"""phi3-mini-3.8b [dense]: 32L d3072 32H (GQA kv=32) ff8192 vocab32064.

RoPE + SwiGLU + GQA (kv=32 == MHA) per [arXiv:2404.14219; unverified].
Pure full attention => long_500k skipped.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32064, head_dim=96,
    tie_embeddings=False,
)
