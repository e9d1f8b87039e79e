"""RecurrentGemma-9B — Griffin: RG-LRU + local attention, 1:2 ratio.

[hybrid] 38L d_model=4096 16H (GQA kv=1 == MQA) d_ff=12288 vocab=256000
Pattern: (rglru, rglru, local_attn) cycled. [arXiv:2402.19427]
"""
from repro_torch.configs.base import ModelConfig, RGLRU, LOCAL_ATTN

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    layer_pattern=(RGLRU, RGLRU, LOCAL_ATTN),
    sliding_window=2048,
    lru_width=4096,
    conv1d_width=4,
    source="RG-LRU + local attn, 1:2 [arXiv:2402.19427]",
)
