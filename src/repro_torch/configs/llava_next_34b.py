"""llava-next-34b [vlm] — hf:llava-hf/llava-v1.6. Backbone only; the anyres
vision tower is a STUB: input_specs() provides precomputed patch embeddings
(n_image_tokens of them) that are concatenated ahead of the token embeds."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64_000,
    act="silu",
    frontend="vision",
    n_image_tokens=2880,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
)

SMOKE = CONFIG.reduced(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, n_image_tokens=8,
)
