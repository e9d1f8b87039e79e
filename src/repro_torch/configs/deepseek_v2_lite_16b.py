"""DeepSeek-V2-Lite 16B — MLA attention + fine-grained MoE.

[moe] 27L d_model=2048 16H (MLA) d_ff=1408 vocab=102400,
MLA kv_lora=512, MoE top-6 with 2 shared experts. [arXiv:2405.04434]

Pool-line note: the assignment says "MoE 64e top-6" and also
"2 shared+160 routed top-6". DeepSeek-V2-*Lite* has 64 routed experts
(160 belongs to full V2); we follow "64e top-6" + 2 shared and record
the discrepancy here and in DESIGN.md.
First layer uses a dense FFN (first_k_dense=1), as in the release.
"""
from repro_torch.configs.base import ModelConfig, FULL_ATTN

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,          # MLA: latent KV; kept for bookkeeping
    head_dim=192,             # qk_nope(128) + qk_rope(64)
    d_ff=10944,               # dense FFN width for first_k_dense layers
    vocab_size=102400,
    layer_pattern=(FULL_ATTN,),
    num_experts=64,
    num_experts_per_tok=6,
    num_shared_experts=2,
    moe_d_ff=1408,
    first_k_dense=1,
    use_mla=True,
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    source="MLA kv_lora=512, 2 shared + 64 routed top-6 [arXiv:2405.04434]",
)
