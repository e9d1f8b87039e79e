"""Mixture-of-Experts FFN (Qwen3-MoE, DeepSeek-V2 style; port of
``repro.models.moe``).

Router in f32, softmax, top-k with the weights renormalized, and a
Switch-style load-balance auxiliary loss ``coef · E · Σ_e f_e · P_e``.
Two single-device dispatches, the reference's:

  * "ragged" (the default) — dropless: the T·k (token, expert) pairs
    sorted by expert into contiguous segments, one weight slab a segment.
    The reference's ``jax.lax.ragged_dot`` is an XLA op outside any
    Pallas kernel; here it is ``torch._grouped_mm`` (``_ExpertMM``), one
    call for all experts with the segment offsets on the device, so no
    host sync per layer;
  * "capacity" — GShard/Switch capacity dispatch: pairs scatter into an
    (E, C, d) buffer (C = T·k/E · capacity_factor, overflow dropped), a
    dense per-expert product, combine.

The reference's expert-parallel path (``_expert_parallel_moe``, the
capacity dispatch over a device mesh) is multi-device: refused here
(``MOE_NO_MESH``).  The token combine ``zeros.at[tok].add`` becomes
``_combine``: the sorted pairs copied back to token-major order and
summed over each token's k slots in f32, so no atomic adds and the same
bits on every run.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import swiglu, swiglu_init

MOE_NO_MESH = ("the MoE over a device mesh (capacity dispatch over a mesh, "
               "expert parallelism) is not ported yet (ROADMAP A3, old "
               "A7d: multi-GPU MoE)")


def moe_init(cfg, dtype, *, generator: torch.Generator, device="cuda",
             layers: int = 1, d_model: int | None = None) -> dict:
    """Router (layers, d, E) f32 ~ N(0, 0.02²); expert slabs w_in
    (layers, E, d, 2·ff) (gate and up fused on the last dim) and w_out
    (layers, E, ff, d) in *dtype*, ~ N(0, 1/fan_in); shared experts a
    SwiGLU of width ff · num_shared_experts."""
    d = d_model or cfg.d_model
    E, ff = cfg.num_experts, cfg.moe_d_ff
    kw = dict(generator=generator, device=device)

    def slab(shape, fan_in):
        # one layer's f32 draw at a time: deepseek-v2-lite-16b's 26
        # stacked w_in slabs would take a 38 GB f32 temporary at once
        w = torch.empty((layers,) + shape, dtype=dtype, device=device)
        for i in range(layers):
            w[i] = torch.randn(shape, **kw) * (1.0 / fan_in) ** 0.5
        return w

    p = {"router": torch.randn((layers, d, E), **kw) * 0.02,
         "w_in": slab((E, d, 2 * ff), d),
         "w_out": slab((E, ff, d), ff)}
    if cfg.num_shared_experts:
        p["shared"] = swiglu_init(d, ff * cfg.num_shared_experts, dtype,
                                  layers=layers, **kw)
    return p


class _ExpertMM(torch.autograd.Function):
    """y = x_sorted · w[e] on each expert's contiguous segment of rows
    (``offs``: the segments' cumulative ends, int32 on the device), the
    reference's ``ragged_dot``.  The expert slabs are frozen backbone, so
    the backward returns dx only: dy · w[e]ᵀ through the same grouped
    product."""

    @staticmethod
    def forward(ctx, x, w, offs):
        ctx.save_for_backward(w, offs)
        return torch._grouped_mm(x, w, offs=offs)

    @staticmethod
    def backward(ctx, dy):
        w, offs = ctx.saved_tensors
        return (torch._grouped_mm(dy.contiguous(), w.transpose(-1, -2),
                                  offs=offs), None, None)


# Rows of every router product (``_router_logits``).
ROUTER_ROWS = 1024


def _router_logits(xf: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """(T, d) tokens -> (T, E) f32 router logits, ``xf.float() @ router``
    in blocks of ROUTER_ROWS rows, the last one zero-padded to full
    size: cuBLAS picks an f32 product's algorithm, and with it a row's
    summation order, by the row count (at d 2048 and E 64 on the H100,
    12288 rows part from their first 3072), so every product has the one
    shape and a token's logits do not depend on how many tokens share
    its batch (fused and solo serving)."""
    T = xf.shape[0]
    n = -(-T // ROUTER_ROWS)
    x = xf.float()
    if n * ROUTER_ROWS != T:
        x = torch.cat([x, x.new_zeros((n * ROUTER_ROWS - T, x.shape[1]))])
    out = torch.cat([x[i * ROUTER_ROWS:(i + 1) * ROUTER_ROWS] @ router
                     for i in range(n)])
    return out[:T]


def route(cfg, params: dict, xf: torch.Tensor):
    """The f32 router over (T, d) tokens: (probs (T, E), top_w (T, k)
    renormalized to sum 1, top_i (T, k) experts, highest first)."""
    probs = torch.softmax(_router_logits(xf, params["router"]), dim=-1)
    top_w, top_i = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    return probs, top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9), top_i


def moe_ffn(cfg, params: dict, x: torch.Tensor, *, mesh=None,
            row_block: int | None = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d) in x.dtype, aux f32 scalar).
    ``mesh``: the reference's expert-parallel dispatch, refused.
    ``row_block``: rows per product of the shared experts (the serving
    decode, ``layers.dense``); the expert products group a row with
    whatever rows routed to the same expert and take none."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    T = B * S
    xf = x.reshape(T, d)
    probs, top_w, top_i = route(cfg, params, xf)

    flat_e = top_i.reshape(-1)                                   # (T*k,)
    if cfg.moe_impl == "capacity":
        out = _capacity_moe(cfg, params, xf, flat_e, top_w, E, k, T, d,
                            x.dtype, mesh)
    else:
        if mesh is not None:
            raise NotImplementedError(MOE_NO_MESH)
        out = _ragged_moe(params, xf, flat_e, top_w, E, k, T, d, x.dtype)

    # ---- load-balance aux (Switch): E * sum_e f_e * P_e ----
    f_e = _counts(flat_e, E).float() / (T * k)
    p_e = probs.mean(dim=0)
    aux = cfg.router_aux_coef * E * (f_e * p_e).sum()

    if "shared" in params:
        out = out + swiglu(params["shared"], x,
                           row_block).reshape(T, d).float()
    return out.to(x.dtype).reshape(B, S, d), aux


def _counts(flat_e: torch.Tensor, E: int) -> torch.Tensor:
    """Pairs per expert, (E,) int64: ``bincount(flat_e, length=E)``
    without the host sync ``torch.bincount`` makes on a CUDA tensor to
    size its output."""
    return torch.zeros(E, dtype=torch.long, device=flat_e.device) \
        .index_add_(0, flat_e, torch.ones_like(flat_e))


def _ragged_moe(params, xf, flat_e, top_w, E, k, T, d, dtype):
    order = torch.argsort(flat_e, stable=True)
    tok = order // k                                             # source token
    xs = xf[tok]                                                 # (T*k, d)
    offs = torch.cumsum(_counts(flat_e, E), 0).to(torch.int32)

    h = _ExpertMM.apply(xs, params["w_in"], offs)                # (T*k, 2ff)
    g, u = h.chunk(2, dim=-1)
    h = F.silu(g.float()).to(dtype) * u
    y = _ExpertMM.apply(h, params["w_out"], offs)                # (T*k, d)

    w = top_w.reshape(-1)[order]
    return _combine(y.float() * w[:, None], order, T, k)


def _combine(vals: torch.Tensor, order: torch.Tensor, T: int,
             k: int) -> torch.Tensor:
    """(T, d) f32: each token's sum of its k pairs' rows of *vals* (rows
    in the sorted order ``order`` gives), the reference's
    ``zeros.at[tok].add``: the rows go back to token-major order (unique
    destinations) and sum over the k slots."""
    flat = torch.zeros_like(vals).index_copy(0, order, vals)
    return flat.reshape(T, k, -1).sum(dim=1)


def _capacity_moe(cfg, params, xf, flat_e, top_w, E, k, T, d, dtype,
                  mesh=None):
    """The capacity dispatch: over a mesh the reference shards the
    experts (``_expert_parallel_moe``); on one device the dense
    formulation."""
    if mesh is not None:
        return _expert_parallel_moe(cfg, params, xf, flat_e, top_w, E, k, T,
                                    d, dtype, mesh)
    return _capacity_moe_dense(cfg, params, xf, flat_e, top_w, E, k, T, d,
                               dtype)


def _expert_parallel_moe(cfg, params, xf, flat_e, top_w, E, k, T, d, dtype,
                         mesh):
    """The reference's expert-parallel dispatch (each device of the
    mesh's model axis dispatches its slice of the experts, one psum
    combines): multi-device, not in the port."""
    raise NotImplementedError(MOE_NO_MESH)


def _capacity_moe_dense(cfg, params, xf, flat_e, top_w, E, k, T, d, dtype):
    C = int(max(1, (T * k / E) * cfg.moe_capacity_factor))
    order = torch.argsort(flat_e, stable=True)                   # expert-major
    sorted_e = flat_e[order]
    tok = order // k
    # position within expert for sorted stream: i - start_of_expert
    counts = _counts(sorted_e, E)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device=xf.device) - starts[sorted_e]
    keep = pos < C                                               # drop overflow
    dest = sorted_e * C + torch.where(keep, pos, 0)

    xs = xf[tok] * keep[:, None].to(xf.dtype)
    buf = torch.zeros((E * C, d), dtype=xf.dtype,
                      device=xf.device).index_add(0, dest, xs)
    buf = buf.reshape(E, C, d)
    # the reference's preferred_element_type=f32: f32 sums of the
    # storage-dtype products
    h = torch.einsum("ecd,edf->ecf", buf.float(), params["w_in"].float())
    g, u = h.chunk(2, dim=-1)
    h = (F.silu(g) * u).to(dtype)
    y = torch.einsum("ecf,efd->ecd", h.float(),
                     params["w_out"].float()).reshape(E * C, d)

    w = (top_w.reshape(-1)[order] * keep).float()
    return _combine(y[dest] * w[:, None], order, T, k)
