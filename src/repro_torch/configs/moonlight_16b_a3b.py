"""moonlight-16b-a3b [moe] — hf:moonshotai/Moonlight-16B-A3B (``deepseek_v3``).

The DeepSeek-V3 block: latent attention (MLA: 16 heads, no query latent, a
512-wide key / value latent, q / k heads of 128 + 64 rope dims, v heads of
128), one leading dense layer of FFN 11264, then 26 MoE layers of 64 routed
experts of width 1408 (top-6, sigmoid scores, a choice-only correction
bias, gates renormalised and scaled by 2.446) and 2 shared experts.

The correction bias is the one a trained model holds to balance its
experts' load; random weights have none, and at 8K context their attention
gives every token a large shared part, so most tokens would choose the
same experts.  So the bias starts at zero and sigmoid routing's choice
subtracts each expert's mean score over the step's tokens
(``models.moe.route``): the load a trained bias gives.

``CONFIG`` is one card's share of an 8-card expert-parallel node: it holds
experts 0..7 of each layer's 64 (``n_experts``) and routes over all of them
(``n_routed_experts``); attention, the dense layer, the shared experts and
the embedding are whole on every card.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonlight-16b-a3b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163_840,
    rope_theta=50_000.0,
    norm_eps=1e-5,
    n_experts=8,
    n_routed_experts=64,
    top_k=6,
    n_shared_experts=2,
    router_scoring="sigmoid",
    routed_scaling=2.446,
    first_dense_layers=1,
    dense_d_ff=11_264,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    act="silu",
    source="hf:moonshotai/Moonlight-16B-A3B; 8 of 64 experts held (expert parallelism 8)",
)

# the same kinds of parts at a CPU size: a dense layer, then MoE layers
# holding 4 of 8 experts, with shared experts and latent attention
SMOKE = CONFIG.reduced(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=32, vocab_size=512,
    n_experts=4, n_routed_experts=8, top_k=2, dense_d_ff=96,
    kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
)
