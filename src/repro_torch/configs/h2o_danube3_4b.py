"""h2o-danube-3-4b [dense] — arXiv:2401.16818. llama+mistral mix, SWA.

head_dim = 3840/32 = 120 (not 128-aligned — noted in the roofline table).
Sliding-window attention makes the arch sub-quadratic -> long_500k runs.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab_size=32_000,
    sliding_window=4096,
    act="silu",
    source="arXiv:2401.16818; unverified",
)

SMOKE = CONFIG.reduced(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, sliding_window=16,
)
