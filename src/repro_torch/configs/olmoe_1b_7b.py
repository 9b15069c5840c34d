"""olmoe-1b-7b [moe] — arXiv:2409.02060. 64 experts, top-8, MHA (kv=16)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50_304,
    n_experts=64,
    top_k=8,
    act="silu",
    source="arXiv:2409.02060; hf",
)

SMOKE = CONFIG.reduced(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=32,
    vocab_size=512, n_experts=8, top_k=2,
)
