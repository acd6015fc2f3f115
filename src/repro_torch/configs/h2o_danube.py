"""h2o-danube-1.8b [dense]: 24L d2560 32H (GQA kv=8) ff6912 vocab32000.

llama+mistral mix with sliding-window attention per
[arXiv:2401.16818; hf] (window 4096).  SWA caps the KV cache, so this
arch RUNS the long_500k decode shape (sub-quadratic).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=6912, vocab_size=32000, head_dim=80,
    sliding_window=4096, tie_embeddings=False,
)
