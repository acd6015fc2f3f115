"""paligemma-3b [vlm]: 18L d2048 8H (MQA kv=1) ff16384 vocab257216
per [arXiv:2407.07726; hf].

SigLIP vision tower is a STUB — input_specs() provides 256 precomputed
patch embeddings (B, 256, d_model) prepended as a prefix (gemma
head_dim 256, GeGLU).  Full attention => long_500k skipped.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
    d_ff=16384, vocab_size=257216, head_dim=256,
    mlp="geglu", prefix_len=256, frontend="siglip_stub",
    tie_embeddings=True,
)
