"""Mamba2-2.7B — SSD (state-space duality), attention-free.

[ssm] 64L d_model=2560 (attn-free) d_ff=0 vocab=50280, ssm_state=128
d_inner = 2*2560 = 5120, head_dim 64 -> 80 SSD heads. [arXiv:2405.21060]
"""
from repro_torch.configs.base import ModelConfig, SSD

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    layer_pattern=(SSD,),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=128,
    source="SSD (state-space duality) [arXiv:2405.21060]",
)
