"""rwkv6-3b [ssm]: 32L d2560 (attention-free) ff8960 vocab65536 —
Finch, data-dependent per-channel decay [arXiv:2404.05892; hf].

40 WKV heads of 64 (2560/64); chunked-parallel linear attention for
train/prefill, O(1) state decode.  Attention-free => RUNS long_500k.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=8960, vocab_size=65536, head_dim=64,
    attn_free=True, tie_embeddings=False,
)
