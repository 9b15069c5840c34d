"""gemma-2b [dense] — arXiv:2403.08295. GeGLU, head_dim=256, MQA (kv=1)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256_000,
    act="gelu",
    tie_embeddings=True,
    source="arXiv:2403.08295; hf",
)

SMOKE = CONFIG.reduced(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=512,
)
