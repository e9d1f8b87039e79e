"""Config system for the repro framework.

A single frozen dataclass describes every architecture family in the zoo
(dense / moe / ssm / hybrid / audio / vlm).  Family-specific fields default
to "off" values so dense configs stay small.  ``reduced()`` derives the
CPU-smoke-test variant mandated by the spec (≤2 layers, d_model ≤ 512,
≤4 experts).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# Layer kinds used in per-layer patterns.
FULL_ATTN = "full_attn"      # causal full attention (or bidirectional for encoders)
LOCAL_ATTN = "local_attn"    # sliding-window attention
RGLRU = "rglru"              # RecurrentGemma gated linear recurrence block
SSD = "ssd"                  # Mamba-2 state-space duality block


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    source: str = ""                  # citation from the assignment pool

    # --- attention ---
    attn_bias: bool = False           # qwen1.5: bias on q/k/v
    rope_theta: float = 10_000.0
    sliding_window: int = 4096        # window for LOCAL_ATTN layers / long-ctx variant
    causal: bool = True               # False for encoder-only (hubert)

    # --- per-layer pattern (cycled to num_layers). Default: all full attn.
    layer_pattern: Tuple[str, ...] = (FULL_ATTN,)

    # --- MoE ---
    num_experts: int = 0              # routed experts (0 = dense FFN)
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0                 # per-expert FFN width
    first_k_dense: int = 0            # leading dense-FFN layers (deepseek)
    router_aux_coef: float = 0.01     # load-balance loss coefficient
    moe_impl: str = "ragged"          # "ragged" (exact, dropless; CPU) |
    #                                   "capacity" (GShard-style, TPU path)
    moe_capacity_factor: float = 1.25

    # --- MLA (deepseek-v2) ---
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128

    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0                # N
    ssm_head_dim: int = 64            # P
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_conv: int = 4

    # --- RG-LRU (recurrentgemma) ---
    lru_width: int = 0                # recurrence width (== d_model usually)
    conv1d_width: int = 4

    # --- modality frontend stubs (audio / vlm) ---
    frontend_dim: int = 0             # stub embedding dim fed by input_specs()
    num_patches: int = 0              # vlm: vision tokens per sample

    # --- misc ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"           # backbone dtype

    # ------------------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def is_encoder(self) -> bool:
        return not self.causal

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim if self.ssm_head_dim else 0

    def layer_kinds(self) -> Tuple[str, ...]:
        """Resolved per-layer kind list of length num_layers."""
        kinds = []
        for i in range(self.num_layers):
            kinds.append(self.layer_pattern[i % len(self.layer_pattern)])
        return tuple(kinds)

    def supports_decode(self) -> bool:
        return self.causal

    def subquadratic(self) -> bool:
        """True if no layer needs O(ctx) full-attention KV at decode."""
        return all(k in (RGLRU, SSD, LOCAL_ATTN) for k in self.layer_kinds())

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """CPU smoke-test variant of the same family (spec: ≤2 layers,
        d_model ≤ 512, ≤4 experts)."""
        pat = self.layer_pattern
        n_layers = max(2, min(2, self.num_layers))
        # keep one full cycle of the pattern if it is hybrid, capped at 3
        if len(pat) > 1:
            n_layers = min(len(pat), 3)
        d_model = min(self.d_model, 256)
        head_dim = 32
        n_heads = max(2, d_model // head_dim // 2)
        n_kv = max(1, n_heads // 2) if self.num_kv_heads < self.num_heads else n_heads
        kw = dict(
            name=self.name + "-reduced",
            num_layers=n_layers,
            d_model=d_model,
            num_heads=n_heads,
            num_kv_heads=n_kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            sliding_window=64,
        )
        if self.num_experts:
            kw.update(
                num_experts=4,
                num_experts_per_tok=min(2, self.num_experts_per_tok),
                num_shared_experts=min(1, self.num_shared_experts),
                moe_d_ff=128,
                first_k_dense=min(1, self.first_k_dense),
            )
        if self.use_mla:
            kw.update(kv_lora_rank=64, qk_rope_dim=16, qk_nope_dim=32,
                      v_head_dim=32, head_dim=48)  # head_dim = nope+rope
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=32)
        if self.lru_width:
            kw.update(lru_width=d_model)
        if self.frontend_dim:
            kw.update(frontend_dim=min(self.frontend_dim, 128))
        if self.num_patches:
            kw.update(num_patches=16)
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class InputShape:
    """One of the four assigned workload shapes."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # "train" | "prefill" | "decode"
    sliding_window_variant: bool = False   # decode long-ctx via ring-buffer window


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",   524_288, 1,   "decode",
                              sliding_window_variant=True),
}


def smoke_shape(kind: str = "train") -> InputShape:
    """Tiny shape for CPU smoke tests."""
    if kind == "decode":
        return InputShape("smoke_decode", 64, 2, "decode")
    return InputShape("smoke_train", 32, 2, "train")
