"""hymba-1.5b [hybrid]: 32L d1600 25H (GQA kv=5) ff5504 vocab32001,
ssm_state=16 — parallel attention + mamba heads per layer
[arXiv:2411.13676; hf].

Each layer runs GQA attention and a selective SSM on the same normed
input and averages their (re-normed) outputs — the Hymba parallel-head
fusion.  Meta-tokens from the paper are out of assignment scope (noted
in DESIGN.md).  Hybrid SSM => RUNS long_500k (attention path uses a
sliding window at that length via serve config).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab_size=32001, head_dim=64,
    ssm=True, ssm_state=16, sliding_window=2048,
    tie_embeddings=True,
)
