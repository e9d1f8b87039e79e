"""Common building blocks (port of ``repro.models.layers``).  Params are
plain nested dicts of tensors; backbone weights live in ``cfg.dtype``,
norms accumulate in f32.

Two activations follow JAX's definitions, not PyTorch's defaults:
``gelu`` is the tanh form (``jax.nn.gelu``'s default; ``F.gelu``'s
default is the erf form), and ``softplus`` is the exact log(1 + e^x)
(``jax.nn.softplus``), where ``F.softplus`` returns x itself above 20.
In float32 the two softplus forms agree above 20 (log1p(e^-20) < 2.1e-9
is under half an ulp of 20, and so is the gradient's 1 - sigmoid); below
it they differ by rounding only."""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.quant import QuantTensor, qdot

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# ---------------------------------------------------------------- init
def dense_init(d_in: int, d_out: int, dtype, *, generator: torch.Generator,
               device="cuda", layers: int = 1) -> torch.Tensor:
    """(layers, d_in, d_out) weights ~ N(0, 1/d_in), drawn in f32."""
    w = torch.randn((layers, d_in, d_out), generator=generator, device=device)
    return (w * (1.0 / d_in) ** 0.5).to(dtype)


def embed_init(vocab: int, d: int, dtype, *, generator: torch.Generator,
               device="cuda") -> torch.Tensor:
    w = torch.randn((vocab, d), generator=generator, device=device)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """``gamma`` is stored as (gamma - 1), so zeros == identity scale."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + gamma.float())
    return out.to(x.dtype)


# ---------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)           # (hd/2,)
    ang = positions[..., :, None, None].float() * freqs     # (...,S,1,hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- dense
def dense(x: torch.Tensor, w: Any,
          row_block: Optional[int] = None) -> torch.Tensor:
    """``qdot(x, w)``.  With *row_block* (the serving decode path on the
    card), a plain tensor's product runs on that many rows of x at a
    time: cuBLAS picks its algorithm, and with it a row's summation
    order, by the row count, so blocks of a solo batch's row count give
    a fused batch's rows the solo bits.  The int8 kernel's order does not
    depend on the row count: a QuantTensor's product runs whole."""
    x2 = x.reshape(-1, x.shape[-1])
    if (row_block is None or isinstance(w, QuantTensor)
            or x2.shape[0] <= row_block):
        return qdot(x, w)
    y = torch.empty((x2.shape[0], w.shape[-1]), dtype=x.dtype,
                    device=x.device)
    for i in range(0, x2.shape[0], row_block):
        torch.mm(x2[i:i + row_block], w, out=y[i:i + row_block])
    return y.reshape(*x.shape[:-1], w.shape[-1])


# ---------------------------------------------------------------- mlp
def swiglu_init(d: int, d_ff: int, dtype, *, generator: torch.Generator,
                device="cuda", layers: int = 1) -> dict:
    kw = dict(generator=generator, device=device, layers=layers)
    return {"gate": dense_init(d, d_ff, dtype, **kw),
            "up": dense_init(d, d_ff, dtype, **kw),
            "down": dense_init(d_ff, d, dtype, **kw)}


def swiglu(params: dict, x: torch.Tensor,
           row_block: Optional[int] = None) -> torch.Tensor:
    # qdot: fused int8 dequant when the FFN mats are QuantTensors
    g = dense(x, params["gate"], row_block)
    u = dense(x, params["up"], row_block)
    h = F.silu(g.float()).to(x.dtype) * u
    return dense(h, params["down"], row_block)


def gelu_mlp_init(d: int, d_ff: int, dtype, *, generator: torch.Generator,
                  device="cuda", layers: int = 1) -> dict:
    kw = dict(generator=generator, device=device, layers=layers)
    return {"up": dense_init(d, d_ff, dtype, **kw),
            "down": dense_init(d_ff, d, dtype, **kw)}


def gelu_mlp(params: dict, x: torch.Tensor,
             row_block: Optional[int] = None) -> torch.Tensor:
    """up -> tanh GELU in f32 -> down (no config of the registry uses it;
    the reference's module has it)."""
    h = dense(x, params["up"], row_block)
    h = gelu(h.float()).to(x.dtype)
    return dense(h, params["down"], row_block)


# ---------------------------------------------------------- activations
def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh GELU (``jax.nn.gelu``'s default)."""
    return F.gelu(x, approximate="tanh")


def softplus(x: torch.Tensor) -> torch.Tensor:
    """Exact log(1 + e^x) (``jax.nn.softplus``)."""
    return torch.logaddexp(x, x.new_zeros(()))


# ------------------------------------------------------------- grad cast
class _GradCast(torch.autograd.Function):
    """Identity whose cotangent is cast to the input's dtype (the
    reference's ``grad_cast`` custom VJP: an f32 cotangent chain must not
    force f32 backward products or storage)."""

    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype)


def grad_cast(x: torch.Tensor) -> torch.Tensor:
    return _GradCast.apply(x)


# ---------------------------------------------------------------- losses
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask=None) -> torch.Tensor:
    """Token-level CE in f32. logits (..., V); labels (...,) int.

    Returns the per-token loss (...,), zero where ``mask`` is 0."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels.long()[..., None])[..., 0]
    loss = lse - picked
    if mask is not None:
        loss = loss * mask.float()
    return loss
