"""Qwen3-30B-A3B — MoE, 128 experts top-8.

[moe] 48L d_model=2048 32H (GQA kv=4) d_ff=768 vocab=151936, MoE 128e top-8
[hf:Qwen/Qwen3-30B-A3B]
"""
from repro_torch.configs.base import ModelConfig, FULL_ATTN

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,                 # per-expert width (pool spec d_ff)
    vocab_size=151936,
    layer_pattern=(FULL_ATTN,),
    num_experts=128,
    num_experts_per_tok=8,
    num_shared_experts=0,
    moe_d_ff=768,
    rope_theta=1_000_000.0,
    source="128 experts top-8 [hf:Qwen/Qwen3-30B-A3B]",
)
