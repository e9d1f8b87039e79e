"""Qwen1.5-110B — large dense model with QKV bias.

[dense] 80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064
[hf:Qwen/Qwen1.5-0.5B] (QKV-bias family trait)
"""
from repro_torch.configs.base import ModelConfig, FULL_ATTN

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=49152,
    vocab_size=152064,
    layer_pattern=(FULL_ATTN,),
    attn_bias=True,
    source="QKV bias [hf:Qwen/Qwen1.5-0.5B]",
)
