"""yi-9b [dense] — arXiv:2403.04652. llama-arch GQA (kv=4), SwiGLU."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64_000,
    act="silu",
    source="arXiv:2403.04652; hf",
)

SMOKE = CONFIG.reduced(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160, vocab_size=512,
)
