"""command-r-plus-104b [dense] — hf:CohereForAI. GQA kv=8, no-bias,
parallel attention+FFN blocks (the width-2 graph the scheduler exploits)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab_size=256_000,
    parallel_block=True,
    act="silu",
    source="hf:CohereForAI/c4ai-command-r-v01; unverified",
)

SMOKE = CONFIG.reduced(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=512,
)
