"""recurrentgemma-2b [hybrid] — arXiv:2402.19427 (Griffin). RG-LRU recurrent
blocks + local (sliding-window) MQA, pattern 2 recurrent : 1 attention.
head_dim=256, GeGLU. The flagship wavefront-scheduling arch (DESIGN §6)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    block_pattern=("rglru", "rglru", "attn"),
    sliding_window=2048,
    lru_width=2560,
    act="gelu",
    tie_embeddings=True,
    scan_layers=False,       # heterogeneous 1:2 pattern -> python loop
    source="arXiv:2402.19427; hf",
)

SMOKE = CONFIG.reduced(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=512, sliding_window=16, lru_width=64,
)
