"""InternVL2-26B language backbone (InternLM2-20B-chat derived).

[vlm] 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553
InternViT-6B vision encoder + MLP projector are STUBBED per spec:
``input_specs()`` feeds pre-projected patch embeddings. [arXiv:2404.16821]
"""
from repro_torch.configs.base import ModelConfig, FULL_ATTN

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    layer_pattern=(FULL_ATTN,),
    rope_theta=1_000_000.0,
    frontend_dim=1024,      # stub ViT/projector output dim
    num_patches=256,        # vision tokens per sample
    source="InternViT + InternLM2 [arXiv:2404.16821]",
)
