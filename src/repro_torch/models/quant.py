"""Quantized frozen backbone: symmetric per-channel int8 (port of
``repro.models.quant``; the reference's DESIGN.md §14).

LoRA never updates base weights, so the frozen backbone can be stored in
int8: half the resident bytes and half the weight bytes every step
streams.  Adapters and optimizer state never quantize.

Format — ``QuantTensor``: a plain dataclass of two tensors

  * ``q``     int8  ``(..., d_in, d_out)`` — rounded weight codes,
  * ``scale`` f32   ``(..., d_out)``       — one amax/127 scale PER
    OUTPUT CHANNEL, so the scale commutes with the matmul:
    ``x @ (q*s) == (x @ q) * s[None, :]``, and the dequant rides the
    kernel's epilogue.

A scanned segment's stacked leaf carries the leading layer axis on both
tensors; ``models/model._tree_map`` slices them together.

``quantize_params`` converts only the dense projection weights that the
fused-LoRA contract targets (``TARGET_LEAVES``); embeddings, the head,
norms, biases, the MoE router and the MoE expert slabs stay as they are.

Dispatch — ``qdot(x, w)`` is the matmul of every consuming site
(``core/lora.proj``, ``models/layers.swiglu``): a plain tensor takes
``@``; a ``QuantTensor`` goes to ``kernels/ops.dequant_matmul`` under the
process-wide impl (``set_dequant_impl``): "cuda" (default) launches the
hand-written dequant-matmul kernel (B10, ``kernels/csrc/dequant.cu``)
forward and backward, "torch" is the plain-PyTorch mirror of the
reference's "xla" expression, which recomputes in the backward instead
of keeping a dequantized copy.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


@dataclasses.dataclass
class QuantTensor:
    """Int8 codes + f32 per-output-channel scales for one weight."""
    q: torch.Tensor          # int8, (..., d_in, d_out)
    scale: torch.Tensor      # f32,  (..., d_out)

    @property
    def shape(self):
        return self.q.shape

    @property
    def ndim(self):
        return self.q.ndim


def quantize_array(w: torch.Tensor) -> QuantTensor:
    """Symmetric per-output-channel int8: scale = amax(|w|, contraction
    axis)/127, codes = round(w/scale) (half to even) clipped to
    [-127, 127].  All in f32, as the reference, so the codes agree bit
    for bit."""
    wf = w.float()
    amax = wf.abs().amax(dim=-2)
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.round(wf / scale.unsqueeze(-2)).clamp(-127, 127)
    return QuantTensor(q=q.to(torch.int8), scale=scale)


def asarray(w: Any, dtype: Optional[torch.dtype] = None) -> Any:
    """A dequantized copy (small uses only — the training and serving
    paths go through ``qdot``).  Plain tensors pass through untouched."""
    if not isinstance(w, QuantTensor):
        return w
    out = w.q.float() * w.scale.unsqueeze(-2)
    return out.to(dtype) if dtype is not None else out


# Leaf names eligible for quantization (2-D per layer; scanned stacks
# carry a leading layer axis).  MoE expert slabs reuse w_in/w_out but
# sit next to a "router" leaf — excluded by the walk below.
TARGET_LEAVES = frozenset({
    "wq", "wk", "wv", "wo",        # attention / MLA head projections
    "w_kv_a", "w_kv_b",            # MLA latent down/up
    "gate", "up", "down",          # swiglu / gelu FFN (incl. MoE shared)
    "w_x", "w_gate",               # RGLRU input / gate projections
    "w_in", "w_out",               # SSD in/out (MoE slabs excluded)
})


def _quantize_leaf(name: str, v: Any, in_moe: bool) -> Any:
    if isinstance(v, QuantTensor):
        return v                           # idempotent
    if in_moe and name in ("w_in", "w_out"):
        return v                           # expert slabs stay dense
    if name in TARGET_LEAVES and getattr(v, "ndim", 0) >= 2:
        return quantize_array(v)
    return v


def _walk(node: Any) -> Any:
    if isinstance(node, dict):
        in_moe = "router" in node          # a MoE param dict
        return {k: _walk(v) if isinstance(v, (dict, list))
                else _quantize_leaf(k, v, in_moe)
                for k, v in node.items()}
    if isinstance(node, list):
        return [_walk(v) for v in node]
    return node


def quantize_params(params: dict, mode: Optional[str] = "int8") -> dict:
    """Quantize a frozen backbone tree.  ``mode=None`` is the identity;
    only "int8" is implemented.  Idempotent on already-quantized trees
    (their ``QuantTensor``s are reused, not copied)."""
    if mode is None:
        return params
    if mode != "int8":
        raise ValueError(f"unknown quantization mode {mode!r}")
    return _walk(params)


def leaves(node: Any):
    """Every leaf of nested dicts and lists; a QuantTensor is one leaf."""
    if isinstance(node, dict):
        for v in node.values():
            yield from leaves(v)
    elif isinstance(node, (list, tuple)):
        for v in node:
            yield from leaves(v)
    else:
        yield node


def is_quantized(params: dict) -> bool:
    return any(isinstance(leaf, QuantTensor) for leaf in leaves(params))


def backbone_dtype(params: Optional[dict]) -> str:
    """Calibration-bucket tag for the backbone storage dtype."""
    return "int8" if params is not None and is_quantized(params) else "bf16"


# ------------------------------------------------------------- dispatch
_DEQUANT_IMPL = "cuda"


def set_dequant_impl(impl: str) -> None:
    """Select the dequant-matmul impl process-wide ("cuda" | "torch").
    Both evaluate a full-contraction product accumulated in f32, scaled
    per output channel and rounded once."""
    global _DEQUANT_IMPL
    if impl not in ("cuda", "torch"):
        raise ValueError(f"unknown dequant impl {impl!r}")
    _DEQUANT_IMPL = impl


def get_dequant_impl() -> str:
    return _DEQUANT_IMPL


def qdot(x: torch.Tensor, w: Any) -> torch.Tensor:
    """``x @ w`` for a plain tensor or a QuantTensor (fused dequant)."""
    if not isinstance(w, QuantTensor):
        return x @ w
    from repro_torch.kernels import ops      # lazy, as in the reference
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    y = ops.dequant_matmul(x2, w.q, w.scale, impl=_DEQUANT_IMPL)
    return y.reshape(*lead, w.q.shape[-1])
