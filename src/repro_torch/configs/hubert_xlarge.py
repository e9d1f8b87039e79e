"""HuBERT-XLarge — encoder-only audio transformer backbone.

[audio] 48L d_model=1280 16H (kv=16, MHA) d_ff=5120 vocab=504
Conv feature extractor / mel frontend STUBBED per spec: ``input_specs()``
feeds precomputed frame embeddings (B, T, 512). [arXiv:2106.07447]
Encoder-only => no decode shapes (noted in DESIGN.md).
"""
from repro_torch.configs.base import ModelConfig, FULL_ATTN

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    layer_pattern=(FULL_ATTN,),
    causal=False,             # bidirectional encoder
    frontend_dim=512,         # stub conv-extractor output dim
    source="encoder-only, w2v2 arch [arXiv:2106.07447]",
)
