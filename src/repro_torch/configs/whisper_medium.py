"""whisper-medium [audio] — arXiv:2212.04356. Encoder-decoder transformer
backbone; the conv frontend is a STUB (input_specs() provides precomputed
frame embeddings for the encoder). Decoder has cross-attention."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,            # decoder layers
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51_865,
    act="gelu",
    cross_attention=True,
    frontend="audio",
    encoder_len=1500,
    rope_theta=0.0,         # whisper uses learned/sinusoidal positions
    source="arXiv:2212.04356; unverified",
)

SMOKE = CONFIG.reduced(
    n_layers=2, n_encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=512, encoder_len=16,
)
