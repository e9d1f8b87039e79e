"""SmolLM-360M — llama-arch small dense model.

[dense] 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152
[hf:HuggingFaceTB/SmolLM-135M]
"""
from repro_torch.configs.base import ModelConfig, FULL_ATTN

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    layer_pattern=(FULL_ATTN,),
    tie_embeddings=True,
    source="llama-arch small [hf:HuggingFaceTB/SmolLM-135M]",
)
