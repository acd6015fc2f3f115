"""granite-20b [dense]: 52L d6144 48H (MQA kv=1) ff24576 vocab49152.

llama-arch code model per [arXiv:2405.04324; hf]. head_dim 128.
Pure full attention => long_500k skipped.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab_size=49152, head_dim=128,
    tie_embeddings=False,
)
