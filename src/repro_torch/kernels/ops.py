"""Dispatch of the fused multi-LoRA kernels (port of
``repro.kernels.ops``, single device).

``fused_lora`` — the MASKED max-rank family over stacked (K, d, r_pad)
adapters: "cuda" (kernels/fused_lora.py, differentiable through
``_MaskedLoRA``, whose backward launches the grouped product three times
and the grouped wgrad twice), "ref" (gather oracle), "loop" (one GEMM
pair per adapter, the unfused baseline).

``fused_lora_ragged`` — the RAGGED family over packed (d, R)/(R, d)
adapters with per-adapter padded segments: "cuda" (kernels/ragged.py,
true-rank work per token tile, differentiable through ``_RaggedLoRA``,
whose backward launches the dgrad, xa, dxa and wgrad kernels),
"ref"/"loop" (densify, then the oracles; autograd differentiates them).
A batch without a static tile map (a contiguous nano slice) densifies
and takes the masked family.

The "torch" mirror of the reference's bucket-concatenated "xla" path is
queued (ROADMAP A3) and raises here.  Contract for "cuda": tokens sorted
by adapter id, contiguous segments, each segment a multiple of block_t.

``dequant_matmul`` — the int8 frozen backbone's projection: "cuda"
(kernels/fused_lora.py, through ``_DequantMM``, whose backward is a
second launch on q^T) and "torch" (``_DequantTorch``, the plain mirror
of the reference's "xla" expression).

Scaling and rounding follow the reference exactly: the ragged kernel
returns f32 unscaled and is scaled once, then cast; the masked kernel
returns x.dtype unscaled and is scaled in f32, then cast again.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import ragged as rg
from repro_torch.kernels import ref as ref_impl
from repro_torch.kernels.fused_lora import (dequant_matmul_cuda,
                                            dequant_matmul_plain,
                                            fused_lora_cuda,
                                            grouped_matmul_cuda,
                                            grouped_wgrad_cuda)
from repro_torch.kernels.ragged import RaggedMeta


def _tile_map(ids: torch.Tensor, block_t: int) -> torch.Tensor:
    return ids.reshape(ids.shape[0] // block_t, block_t)[:, 0] \
        .to(torch.int32).contiguous()


def _no_torch_impl():
    raise NotImplementedError(
        "the 'torch' mirror of the reference's 'xla' LoRA path is not "
        "ported yet (ROADMAP queue A, item 3)")


class _MaskedLoRA(torch.autograd.Function):
    """The masked "cuda" path with its backward (the reference's
    ``_make_pallas_fn``).  Backward = five launches over the device tile
    map: dxa = dy_s ·g B^T and dx = dxa ·g A^T (grouped products), xa =
    x ·g A (grouped product), dA = Σ_seg x^T·dxa and dB = Σ_seg xa^T·dy_s
    (grouped wgrads).  B^T and A^T are strided views, never copies.
    Rounding points as in the reference: dy_s = bf16(dy · s[ids]) in f32;
    dxa and xa rank-masked in f32, then cast to x.dtype; dA, dB f32, then
    cast to A's and B's dtypes.  ids, ranks and the scalings (alpha / r
    constants, never trained) get no gradient."""

    @staticmethod
    def forward(ctx, x, A, B, ids, ranks, scalings, block_t: int):
        tm = _tile_map(ids, block_t)
        rk = ranks.to(torch.int32).contiguous()
        ctx.save_for_backward(x, A, B, ids, rk, scalings, tm)
        ctx.block_t = block_t
        y = fused_lora_cuda(x, A, B, tm, rk, block_t=block_t)
        return (y.float() * scalings[ids][:, None]).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, A, B, ids, rk, scalings, tm = ctx.saved_tensors
        bt, K = ctx.block_t, A.shape[0]
        dy_s = (dy.float() * scalings[ids][:, None]).to(dy.dtype)
        dxa = grouped_matmul_cuda(dy_s, B.transpose(1, 2), tm, block_t=bt)
        dxa = ref_impl.rank_mask(dxa.float(), ids, rk).to(x.dtype)
        dx = grouped_matmul_cuda(dxa, A.transpose(1, 2), tm, block_t=bt)
        xa = grouped_matmul_cuda(x, A, tm, block_t=bt)
        xa = ref_impl.rank_mask(xa.float(), ids, rk).to(x.dtype)
        dA = grouped_wgrad_cuda(x, dxa, tm, K, block_t=bt)
        dB = grouped_wgrad_cuda(xa, dy_s, tm, K, block_t=bt)
        return (dx.to(x.dtype), dA.to(A.dtype), dB.to(B.dtype), None, None,
                None, None)


class _RaggedLoRA(torch.autograd.Function):
    """The ragged "cuda" path with its backward (the reference's
    ``_make_ragged_pallas_fn``).  Backward = one dgrad launch (dx) + two
    packed launches (xa, dxa) + two wgrad launches (dA, dB), all over the
    active (token tile, rank tile) pairs.  Rounding points as in the
    reference: dy_s = bf16(dy · s[ids]) in f32; dx f32 then cast to
    x.dtype; dA, dB f32 then cast to A's and B's dtypes.  ids and the
    scalings (alpha / r constants, never trained) get no gradient."""

    @staticmethod
    def forward(ctx, x, A, B, ids, scalings, meta: RaggedMeta,
                block_t: int):
        ctx.save_for_backward(x, A, B, ids, scalings)
        ctx.meta, ctx.block_t = meta, block_t
        y = rg.ragged_lora_fwd(x, A, B, meta, block_t=block_t)
        return (y * scalings[ids][:, None]).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, A, B, ids, scalings = ctx.saved_tensors
        meta, bt = ctx.meta, ctx.block_t
        dy_s = (dy.float() * scalings[ids][:, None]).to(dy.dtype)
        dx = rg.ragged_lora_dgrad(dy_s, A, B, meta, block_t=bt)
        xa = rg.ragged_xa(x, A, meta, block_t=bt)
        dxa = rg.ragged_dxa(dy_s, B, meta, block_t=bt).to(x.dtype)
        dA = rg.ragged_wgrad(dxa, x, meta, block_t=bt)         # (R, d_in)
        dB = rg.ragged_wgrad(xa, dy_s, meta, block_t=bt)       # (R, d_out)
        return (dx.to(x.dtype), dA.T.to(A.dtype), dB.to(B.dtype), None,
                None, None, None)


def _tile_jobs_static(rows: Sequence[int], seq_len: int, block_t: int,
                      order: Optional[Sequence[int]] = None
                      ) -> Optional[Tuple[int, ...]]:
    """Static token-tile -> job map of a job-proportional batch (rows
    per job, segments in *order*).  None when any segment is not whole
    token tiles — the caller then falls back to the masked path."""
    order = list(order) if order is not None else list(range(len(rows)))
    out = []
    for j in order:
        toks = rows[j] * seq_len
        if toks % block_t:
            return None
        out.extend([j] * (toks // block_t))
    return tuple(out)


def fused_lora_ragged(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                      ids: torch.Tensor, scalings: torch.Tensor, layout,
                      *, impl: str = "cuda", block_t: int = 128,
                      slice_rows: Optional[Tuple[int, ...]] = None,
                      seq_len: int = 1,
                      ranks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused heterogeneous multi-LoRA over PACKED RAGGED adapters.

    x (T, d_in), A (d_in, R), B (R, d_out) with R = Σ_k r_pad_k
    (``layout``: core/lora.RankLayout).  ``slice_rows`` is the static
    per-job row count of this batch — required for the static tile map
    of the "cuda" kernel; without it the call densifies and takes the
    masked family, whose device tile map handles any tile-aligned layout.
    """
    from repro_torch.core.lora import unpack_dense
    rk = ranks if ranks is not None else torch.tensor(
        layout.ranks, dtype=torch.int32, device=x.device)
    if impl in ("ref", "loop"):
        Af, Bf = unpack_dense(A, B, layout)
        fn = (ref_impl.fused_lora_loop if impl == "loop"
              else ref_impl.fused_lora_ref)
        return fn(x, Af.to(x.dtype), Bf.to(x.dtype), ids, rk, scalings)
    if impl == "torch":
        _no_torch_impl()
    if impl == "cuda":
        T = x.shape[0]
        tile_jobs = None
        if slice_rows is not None and T % block_t == 0:
            tile_jobs = _tile_jobs_static(slice_rows, seq_len, block_t)
        if tile_jobs is None:
            # no static tile map (the contiguous nano split): densify to
            # the layout's widest segment and take the masked family,
            # whose device tile map takes any tile-aligned layout
            Af, Bf = unpack_dense(A, B, layout)
            return _MaskedLoRA.apply(x, Af.to(x.dtype), Bf.to(x.dtype),
                                     ids, rk, scalings, block_t)
        meta = RaggedMeta.build(tile_jobs, layout)
        return _RaggedLoRA.apply(x, A, B, ids, scalings, meta, block_t)
    raise ValueError(f"unknown fused_lora_ragged impl {impl!r}")


def fused_lora(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
               ids: torch.Tensor, ranks: torch.Tensor,
               scalings: torch.Tensor, impl: str = "ref",
               block_t: int = 128) -> torch.Tensor:
    """Fused heterogeneous multi-LoRA: y_t = s_a ((x_t A_a) B_a), a=ids[t].
    x (T, d_in), A (K, d_in, r), B (K, r, d_out) -> (T, d_out)."""
    if impl == "cuda":
        return _MaskedLoRA.apply(x, A, B, ids, ranks, scalings, block_t)
    if impl == "torch":
        _no_torch_impl()
    if impl == "loop":
        return ref_impl.fused_lora_loop(x, A, B, ids, ranks, scalings)
    if impl == "ref":
        return ref_impl.fused_lora_ref(x, A, B, ids, ranks, scalings)
    raise ValueError(f"unknown fused_lora impl {impl!r}")


# ---------------------------------------------------------- dequant mm
class _DequantMM(torch.autograd.Function):
    """The "cuda" dequant-matmul with its backward (the reference's
    ``_make_dequant_pallas_fn``).  The base weight is frozen: only dx
    flows, from a second launch of the same kernel, dx = ((dy · scale)
    rounded to dy.dtype) · q^T with unit scales; q^T is a strided view of
    the codes, never a copy.  Saves q and scale only, never a
    dequantized copy; q and scale get no gradient."""

    @staticmethod
    def forward(ctx, x, q, scale):
        ctx.save_for_backward(q, scale)
        return dequant_matmul_cuda(x.contiguous(), q, scale)

    @staticmethod
    def backward(ctx, dy):
        q, scale = ctx.saved_tensors
        dys = (dy.float() * scale).to(dy.dtype).contiguous()
        return dequant_matmul_cuda(dys, q.T, None), None, None


class _DequantTorch(torch.autograd.Function):
    """The "torch" dequant-matmul: the reference's ``_dequant_xla``
    expression in plain PyTorch, f32-accumulated and scaled per output
    column.  Its backward recomputes from q, as ``jax.checkpoint`` makes
    the reference do, so no dequantized copy of q lives across the
    backward: dx = (dy · scale in f32) · q^T, then cast to dy.dtype."""

    @staticmethod
    def forward(ctx, x, q, scale):
        ctx.save_for_backward(q, scale)
        return dequant_matmul_plain(x, q, scale)

    @staticmethod
    def backward(ctx, dy):
        q, scale = ctx.saved_tensors
        dx = (dy.float() * scale) @ q.T.float()
        return dx.to(dy.dtype), None, None


def dequant_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                   impl: str = "cuda") -> torch.Tensor:
    """y = (x @ q) * scale for an int8 per-output-channel-quantized base
    projection (models/quant.QuantTensor storage).  x: (T, d_in); q:
    (d_in, d_out) int8; scale: (d_out,) f32 -> (T, d_out) in x.dtype.

    Both impls evaluate a full-contraction product of x.dtype operands,
    accumulated in f32 and scaled per output column, and differ only in
    the f32 summation order; their backwards differ in where dy · scale
    is rounded (to dy.dtype before the product for "cuda", as the
    reference's "pallas"; not at all for "torch", as its "xla")."""
    if impl == "cuda":
        return _DequantMM.apply(x, q, scale)
    if impl == "torch":
        return _DequantTorch.apply(x, q, scale)
    raise ValueError(f"unknown dequant_matmul impl {impl!r}")
