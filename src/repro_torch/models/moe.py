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

Over a mesh.  Under the data-parallel and pipeline steps every rank
routes and dispatches its own rows on one device, as the reference's
fully manual ``shard_map`` does: the capacity C comes from the tokens
the shard (or micro) holds, and the aux from its tokens.  Under tensor
parallelism (``tp``, a ``models/layers.ModelAxis``) with E % m == 0 the
dispatch is expert parallel, the reference's ``_expert_parallel_moe`` /
``_dispatch_local``: every rank holds E/m experts of ``w_in`` and
``w_out``, routes all its tokens with the replicated f32 router and
dispatches only the pairs routed to its experts (the capacity dispatch
with ``e_base = index·E/m``, or the ragged one on its local segments);
one f32 sum over the axis combines the (T, d) partials, the shared
experts' column/row-parallel partial riding in the same sum.  C is taken
from the tokens this data shard holds (the reference's runtime divides
them by the data size once more: ROADMAP C13).  The token combine
``zeros.at[tok].add`` is ``_combine``: the sorted pairs copied back to
token-major order and summed over each token's k slots in f32, so no
atomic adds and the same bits on every run.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ModelAxis, swiglu, swiglu_init


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
    def forward(ctx, x, w, offs, valid=None):
        ctx.save_for_backward(w, offs, valid)
        return _rows(torch._grouped_mm(x, w, offs=offs), valid)

    @staticmethod
    def backward(ctx, dy):
        w, offs, valid = ctx.saved_tensors
        return (_rows(torch._grouped_mm(dy.contiguous(), w.transpose(-1, -2),
                                        offs=offs), valid), None, None, None)


def _rows(y: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
    """*y* with the rows past the last segment zeroed (``valid`` False):
    the grouped product leaves them unwritten (an expert-parallel rank's
    pairs routed to the other ranks' experts sort there)."""
    return y if valid is None else torch.where(valid[:, None], y, 0.0)


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


def moe_ffn(cfg, params: dict, x: torch.Tensor, *,
            row_block: Optional[int] = None, tp: Optional[ModelAxis] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d) in x.dtype, aux f32 scalar).
    ``row_block``: rows per product of the shared experts (the serving
    decode, ``layers.dense``); the expert products group a row with
    whatever rows routed to the same expert and take none.  ``tp``:
    tensor parallelism (training and serving): expert parallel where the
    axis divides E, the shared experts column/row parallel where it
    divides their width; a replicated part runs whole on every rank.  C
    comes from the T tokens of *x*, the data shard's (ROADMAP C13)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    T = B * S
    xf = x.reshape(T, d)
    probs, top_w, top_i = route(cfg, params, xf)

    flat_e = top_i.reshape(-1)                                   # (T*k,)
    shared = params.get("shared")
    ff_sh = cfg.moe_d_ff * cfg.num_shared_experts
    tp_sh = tp if tp is not None and tp.splits(ff_sh) else None
    if tp is not None and tp.splits(E):
        # the dispatch's share of the input and of the routing weights
        # is this rank's: their cotangents are summed over the axis (the
        # router's own path, through the aux, is replicated and is not)
        xm, wm = tp.enter(xf, top_w)
        out = _expert_parallel_moe(cfg, params, xm, flat_e, wm, E, k, T, d,
                                   x.dtype, tp)
        if shared is not None and tp_sh is not None:
            # the shared experts' partial rides in the same sum
            out = out + swiglu(shared, x, row_block, tp=tp_sh,
                               partial=True).reshape(T, d)
            shared = None
        out = tp.sum(out, torch.float32, row_block)
    elif cfg.moe_impl == "capacity":
        out = _capacity_moe_dense(cfg, params, xf, flat_e, top_w, E, k, T, d,
                                  x.dtype)
    else:
        out = _ragged_moe(params, xf, flat_e, top_w, E, k, T, d, x.dtype)

    # ---- load-balance aux (Switch): E * sum_e f_e * P_e ----
    f_e = _counts(flat_e, E).float() / (T * k)
    p_e = probs.mean(dim=0)
    aux = cfg.router_aux_coef * E * (f_e * p_e).sum()

    if shared is not None:
        out = out + swiglu(shared, x, row_block,
                           tp=tp_sh).reshape(T, d).float()
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


def _expert_parallel_moe(cfg, params, xf, flat_e, top_w, E, k, T, d, dtype,
                         tp: ModelAxis) -> torch.Tensor:
    """This rank's (T, d) f32 partial of the expert-parallel dispatch
    (the reference's ``_expert_parallel_moe``'s ``local``): the pairs
    routed to its E/m experts ``[index·E/m, (index+1)·E/m)`` (its slices
    of ``w_in`` and ``w_out``), through the capacity dispatch
    (``_dispatch_local``, C from the T tokens this data shard holds) or
    the ragged one on its local segments; the caller sums the partials
    over the axis."""
    E_loc = E // tp.size
    e_base = tp.index * E_loc
    if cfg.moe_impl == "capacity":
        C = int(max(1, (T * k / E) * cfg.moe_capacity_factor))
        return _dispatch_local(params["w_in"], params["w_out"], xf, flat_e,
                               top_w, k, d, dtype, e_base, E_loc, C)
    return _ragged_local(params, xf, flat_e, top_w, k, T, dtype, e_base,
                         E_loc)


def _local_order(flat_e, e_base: int, E_loc: int):
    """(order, local expert of each sorted pair, this rank's pair counts
    per local expert): the pairs sorted stably by local expert, pairs of
    the other ranks' experts (local expert E_loc) last."""
    mine = (flat_e >= e_base) & (flat_e < e_base + E_loc)
    le = torch.where(mine, flat_e - e_base, E_loc)
    order = torch.argsort(le, stable=True)
    return order, le[order], _counts(le, E_loc + 1)[:E_loc]


def _ragged_local(params, xf, flat_e, top_w, k, T, dtype, e_base: int,
                  E_loc: int) -> torch.Tensor:
    """The ragged dispatch on this rank's experts: its pairs' segments
    through ``_ExpertMM`` over its E/m slabs, the other pairs' rows
    zeroed; combined in ``_combine``'s fixed order."""
    order, se, counts = _local_order(flat_e, e_base, E_loc)
    valid = se < E_loc
    xs = xf[order // k]
    offs = torch.cumsum(counts, 0).to(torch.int32)
    h = _ExpertMM.apply(xs, params["w_in"], offs, valid)
    g, u = h.chunk(2, dim=-1)
    h = F.silu(g.float()).to(dtype) * u
    y = _ExpertMM.apply(h, params["w_out"], offs, valid)
    w = top_w.reshape(-1)[order] * valid
    return _combine(y.float() * w[:, None], order, T, k)


def _dispatch_local(w_in, w_out, xf, flat_e, top_w, k, d, dtype,
                    e_base: int, E_loc: int, C: int) -> torch.Tensor:
    """The reference's ``_dispatch_local``: capacity scatter of the pairs
    routed to experts ``[e_base, e_base + E_loc)`` into an (E_loc, C, d)
    buffer (a pair's slot is its place among its expert's pairs in token
    order; overflow and the other experts' pairs dropped), the dense
    expert products, the combine.  With e_base 0 and E_loc E it is
    ``_capacity_moe_dense``."""
    Tk = flat_e.shape[0]
    order, se, counts = _local_order(flat_e, e_base, E_loc)
    starts = torch.cumsum(counts, 0) - counts
    sc = se.clamp_max(E_loc - 1)
    pos = torch.arange(Tk, device=xf.device) - starts[sc]
    keep = (se < E_loc) & (pos < C)
    dest = sc * C + torch.where(keep, pos, 0)
    tok = order // k

    xs = xf[tok] * keep[:, None].to(xf.dtype)
    buf = torch.zeros((E_loc * C, d), dtype=xf.dtype,
                      device=xf.device).index_add(0, dest, xs)
    buf = buf.reshape(E_loc, C, d)
    h = torch.einsum("ecd,edf->ecf", buf.float(), w_in.float())
    g, u = h.chunk(2, dim=-1)
    h = (F.silu(g) * u).to(dtype)
    y = torch.einsum("ecf,efd->ecd", h.float(),
                     w_out.float()).reshape(E_loc * C, d)
    w = (top_w.reshape(-1)[order] * keep).float()
    return _combine(torch.where(keep[:, None], y[dest] * w[:, None], 0.0),
                    order, xf.shape[0], k)


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
