"""seamless-m4t-medium [audio]: enc-dec 12L d1024 16H (kv=16) ff4096
vocab256206 per [arXiv:2308.11596; hf].

Transformer backbone only (assignment): 12 encoder + 12 decoder layers
with cross-attention.  The audio frontend is a STUB — input_specs()
provides precomputed frame embeddings (B, frames, d_model).
Encoder-decoder with full attention => long_500k skipped; decode
shapes run (it has a decoder).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=256206, head_dim=64,
    encoder_layers=12, cross_attention=True, frontend="audio_stub",
    tie_embeddings=False,
)
