"""falcon-mamba-7b [ssm] — arXiv:2410.05355. Mamba-1 architecture, attn-free.
d_inner = 2*d_model = 8192, ssm_state=16, conv kernel 4, dt_rank = d/16."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=65_024,
    block_pattern=("ssm",),
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
    source="arXiv:2410.05355; unverified",
)

SMOKE = CONFIG.reduced(
    n_layers=2, d_model=64, vocab_size=512, ssm_state=4,
)
