"""RG-LRU recurrent block (RecurrentGemma / Griffin), port of
``repro.models.rglru`` [arXiv:2402.19427].

Real-gated linear recurrent unit:
    r_t = sigmoid(W_a x_t + b_a)          recurrence gate
    i_t = sigmoid(W_i x_t + b_i)          input gate
    a_t = exp(-c * softplus(Lambda) * r_t),  c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Training and prefill run the elementwise linear recurrence as a
log-depth scan in plain PyTorch (``_lru_scan``, Hillis-Steele: log2 S
steps over the whole sequence, where a loop over the tokens would launch
S times a layer); the reference runs ``jax.lax.associative_scan``,
which sums in another tree, so the two agree to f32 rounding.  Decode
carries (h, conv tail): O(1) a token, written IN PLACE into the caller's
cache.

Block: x -> [W_x -> causal conv -> RG-LRU] * gelu(W_gate x) -> W_out,
gelu in its tanh form (``layers.gelu``).  LoRA targets: ``rg_in``,
``rg_gate``, ``rg_out``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.lora import MultiLoRA, proj
from repro_torch.models.layers import dense_init, dtype_of, gelu, softplus
from repro_torch.models.ssd import _causal_conv

_C = 8.0


class RGLRUCache(NamedTuple):
    h: torch.Tensor       # (L?, B, width) f32
    conv: torch.Tensor    # (L?, B, cw - 1, width)

    @staticmethod
    def init(batch, cfg, layers: Optional[int] = None, device="cuda"):
        w = cfg.lru_width
        ls = (layers,) if layers is not None else ()
        return RGLRUCache(
            torch.zeros(ls + (batch, w), device=device),
            torch.zeros(ls + (batch, cfg.conv1d_width - 1, w),
                        dtype=dtype_of(cfg), device=device))


def rglru_init(cfg, dtype, *, generator: torch.Generator, device="cuda",
               layers: int = 1) -> dict:
    """The reference's distributions, stacked over *layers*: Lambda drawn
    so that a^c lies in (0.9, 0.999) (Griffin's appendix; lam is its
    inverse softplus), gate biases 0, conv weights N(0, 0.2^2)."""
    d, w = cfg.d_model, cfg.lru_width
    kw = dict(generator=generator, device=device, layers=layers)
    lo, hi = 0.9 ** 2, 0.999 ** 2
    lam = torch.rand((layers, w), generator=generator,
                     device=device) * (hi - lo) + lo
    lam = torch.log(torch.exp(-torch.log(lam) / (2 * _C)) - 1.0)
    return {"w_x": dense_init(d, w, dtype, **kw),
            "w_gate": dense_init(d, w, dtype, **kw),
            "w_out": dense_init(w, d, dtype, **kw),
            "conv_w": (torch.randn((layers, cfg.conv1d_width, w),
                                   generator=generator, device=device)
                       * 0.2).to(dtype),
            "lam": lam,
            "w_a": dense_init(w, w, dtype, **kw),
            "b_a": torch.zeros((layers, w), device=device),
            "w_i": dense_init(w, w, dtype, **kw),
            "b_i": torch.zeros((layers, w), device=device)}


def _lru_scan(a: torch.Tensor, b: torch.Tensor,
              h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over axis 1, from h_{-1} = h0 (or 0).

    Hillis-Steele inclusive scan with the reference's combine
    ``(a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2)``: at distance d each
    position folds in the one d before it, d = 1, 2, 4, ..."""
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    if h0 is not None:
        b = b + a * h0[:, None, :]
    return b


def rglru_block(cfg, params: dict, x: torch.Tensor, *,
                lora: Optional[MultiLoRA] = None,
                lora_ab: Optional[dict] = None,
                cache: Optional[RGLRUCache] = None
                ) -> Tuple[torch.Tensor, Optional[RGLRUCache]]:
    """x: (B, S, d) -> (y, cache).  With a cache: S = 1 is one recurrent
    step, S > 1 a scan from the cached state; the cache is updated in
    place."""
    B, S, _ = x.shape
    la = lora_ab or {}
    u = proj(x, params["w_x"], None, lora, la.get("rg_in"))
    gate = proj(x, params["w_gate"], None, lora, la.get("rg_gate"))

    new_conv = None
    if cache is not None:
        new_conv = torch.cat([cache.conv.to(u.dtype), u],
                             dim=1)[:, -(cfg.conv1d_width - 1):]
        u = _causal_conv(u, params["conv_w"], cache.conv)
    else:
        u = _causal_conv(u, params["conv_w"])

    uf = u.float()
    r = torch.sigmoid(uf @ params["w_a"].float() + params["b_a"])
    i = torch.sigmoid(uf @ params["w_i"].float() + params["b_i"])
    log_a = -_C * softplus(params["lam"])[None, None, :] * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    b = beta * (i * uf)

    if cache is not None and S == 1:
        h = a[:, 0] * cache.h + b[:, 0]
        y = h[:, None]
    else:
        y = _lru_scan(a, b, cache.h if cache is not None else None)
        h = y[:, -1]
    if cache is not None:
        cache.h.copy_(h)
        cache.conv.copy_(new_conv)

    y = y.to(x.dtype) * gelu(gate.float()).to(x.dtype)
    out = proj(y, params["w_out"], None, lora, la.get("rg_out"))
    return out, cache
