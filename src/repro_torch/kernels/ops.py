"""Dispatch of the fused multi-LoRA kernels (port of
``repro.kernels.ops``, single device).

``fused_lora`` — the MASKED max-rank family over stacked (K, d, r_pad)
adapters: "cuda" (kernels/fused_lora.py, differentiable through
``_MaskedLoRA``, whose backward launches the grouped product three times
and the grouped wgrad twice), "torch" (``_MaskedTorch``, the reference's
segment-dense "xla" path in plain PyTorch), "ref" (gather oracle),
"loop" (one GEMM pair per adapter, the unfused baseline).

``fused_lora_ragged`` — the RAGGED family over packed (d, R)/(R, d)
adapters with per-adapter padded segments: "cuda" (kernels/ragged.py,
true-rank work per token tile, differentiable through ``_RaggedLoRA``,
whose backward launches the dgrad, xa, dxa and wgrad kernels), "torch"
(``_RaggedTorch``, the reference's bucket-concatenated "xla" path: one
segment-dense batched GEMM pair per rank bucket), "ref"/"loop" (densify,
then the oracles; autograd differentiates them).  For "cuda", a batch
without a static tile map (a contiguous nano slice) densifies and takes
the masked family; "torch" takes its exact per-bucket one-hot fallback.

The "torch" paths carry the reference's hand-written backward and launch
no kernel of this repository: they are the same-function eager baseline
of the kernels.  With ``equal_segments`` (every adapter owns the same
row count, the SSM's production layout) they run the segment-dense
batched products; otherwise the one-hot fallback, exact for any ids.
Contract for "cuda" and "torch": tokens sorted by adapter id, contiguous
segments, each segment a multiple of block_t.

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
import torch.nn.functional as F

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


# ---------------------------------------------------------------- torch
# The reference's "xla" formulation in plain PyTorch.  jnp.einsum's
# ``preferred_element_type=f32`` over bf16 operands is a product of the
# operands upcast to f32 (the products are exact in f32; only the f32
# summation order may differ), so every product below runs in f32 and
# rounds where the reference rounds: xa masked, then cast to x.dtype;
# scaling in f32; one cast at the end.
def _lane_mask(r_pad: int, ranks: torch.Tensor) -> torch.Tensor:
    """(K, r_pad) bool: lane < the adapter's rank."""
    return torch.arange(r_pad, device=ranks.device)[None, :] < ranks[:, None]


def _masked_forward(x, A, B, ids, ranks, scalings, equal: bool):
    T, d_in = x.shape
    K, _, r_pad = A.shape
    m = _lane_mask(r_pad, ranks)                              # (K, r)
    if equal:
        buf = x.reshape(K, T // K, d_in)                      # adapter-major
        xa = torch.bmm(buf.float(), A.float())
        xa = torch.where(m[:, None, :], xa, 0.0).to(x.dtype)
        y = torch.bmm(xa.float(), B.float())
        y = y * scalings[:, None, None]
        return y.reshape(T, -1).to(x.dtype)
    # fallback: dense over K with a one-hot combine (exact, no scatter)
    onehot = F.one_hot(ids.long(), K).to(x.dtype)             # (T, K)
    xa = torch.einsum("td,kdr->tkr", x.float(), A.float())
    xa = torch.where(m[None, :, :], xa, 0.0).to(x.dtype)
    y = torch.einsum("tkr,kro->tko", xa.float(), B.float())
    y = y * scalings[None, :, None]
    return torch.einsum("tko,tk->to", y, onehot.float()).to(x.dtype)


def _masked_equal_parts(x, A, B, ranks, scalings, dy):
    """(buf, dy_s, xa, dxa) of the equal-segment backward."""
    T, d_in = x.shape
    K, _, r_pad = A.shape
    m = _lane_mask(r_pad, ranks)[:, None, :]
    buf = x.reshape(K, T // K, d_in)
    dy_s = dy.reshape(K, T // K, -1).float() * scalings[:, None, None]
    # recompute the compact intermediate (2·T·d·r flops)
    xa = torch.where(m, torch.bmm(buf.float(), A.float()), 0.0).to(x.dtype)
    dxa = torch.where(m, torch.einsum("kco,kro->kcr", dy_s, B.float()), 0.0)
    return buf, dy_s, xa, dxa


def _masked_fallback_parts(x, A, B, ids, ranks, scalings, dy):
    """(dy_k, xa, dxa) of the dense-over-K backward: the one-hot weighting
    in dy_k zeroes foreign-adapter terms, so dxa is segment-sparse and
    dA / dB need no one-hot."""
    K, _, r_pad = A.shape
    m = _lane_mask(r_pad, ranks)[None, :, :]
    onehot = F.one_hot(ids.long(), K).float()
    dy_k = (dy.float()[:, None, :] * onehot[:, :, None]
            * scalings[None, :, None])
    xa = torch.einsum("td,kdr->tkr", x.float(), A.float())
    xa = torch.where(m, xa, 0.0).to(x.dtype)
    dxa = torch.where(m, torch.einsum("tko,kro->tkr", dy_k, B.float()), 0.0)
    return dy_k, xa, dxa


class _MaskedTorch(torch.autograd.Function):
    """The masked "torch" path with the reference's hand-written backward
    (``_make_xla_fn``).  Equal segments: a reshape (T, d) -> (K, T/K, d)
    and batched GEMM pairs, with segment-dense wgrads dA[k] = buf[k]ᵀ·
    dxa[k], dB[k] = xa[k]ᵀ·dy_s[k]; otherwise the dense-over-K one-hot
    fallback, whose wgrads stay exact without a one-hot of their own.
    ids, ranks and the scalings (alpha / r constants, never trained) get
    no gradient."""

    @staticmethod
    def forward(ctx, x, A, B, ids, ranks, scalings, equal: bool):
        equal = equal and x.shape[0] % A.shape[0] == 0
        ctx.save_for_backward(x, A, B, ids, ranks, scalings)
        ctx.equal = equal
        return _masked_forward(x, A, B, ids, ranks, scalings, equal)

    @staticmethod
    def backward(ctx, dy):
        x, A, B, ids, ranks, scalings = ctx.saved_tensors
        T, d_in = x.shape
        Af = A.float()
        if ctx.equal:
            buf, dy_s, xa, dxa = _masked_equal_parts(x, A, B, ranks,
                                                     scalings, dy)
            dx = torch.einsum("kcr,kdr->kcd", dxa, Af).reshape(T, d_in)
            dA = torch.einsum("kcd,kcr->kdr", buf.float(), dxa)
            dB = torch.einsum("kcr,kco->kro", xa.float(), dy_s)
        else:
            dy_k, xa, dxa = _masked_fallback_parts(x, A, B, ids, ranks,
                                                   scalings, dy)
            dx = torch.einsum("tkr,kdr->td", dxa, Af)
            dA = torch.einsum("td,tkr->kdr", x.float(), dxa)
            dB = torch.einsum("tkr,tko->kro", xa.float(), dy_k)
        return (dx.to(x.dtype), dA.to(A.dtype), dB.to(B.dtype), None, None,
                None, None)


def fused_lora_torch(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                     ids: torch.Tensor, ranks: torch.Tensor,
                     scalings: torch.Tensor,
                     equal_segments: bool = False) -> torch.Tensor:
    """Segment-dense grouped GEMM pair over stacked (K, d, r_pad)
    adapters (the reference's ``fused_lora_xla``); see ``_MaskedTorch``."""
    return _MaskedTorch.apply(x, A, B, ids, ranks, scalings,
                              bool(equal_segments))


def _contiguous(jobs) -> bool:
    return all(b == a + 1 for a, b in zip(jobs, jobs[1:]))


def _pick(t: torch.Tensor, jobs) -> torch.Tensor:
    """The *jobs* entries of t's leading axis: one slice when they are a
    consecutive range, else a stack of slices (an index tensor would be a
    host-to-device copy)."""
    if _contiguous(jobs):
        return t[jobs[0]:jobs[-1] + 1]
    return torch.stack([t[k] for k in jobs])


def _bucket_params(A, B, layout):
    """Per-bucket dense views of a packed ragged pair: for each padded
    width rp, its member jobs and their stacked (K_b, d, rp) / (K_b, rp,
    d_out) slabs.  Consecutive members own a contiguous packed column
    range, so their slab is a strided view of one slice."""
    out = []
    for rp, jobs in layout.buckets:
        if _contiguous(jobs):
            o0, n = layout.offsets[jobs[0]], len(jobs)
            Ab = A[:, o0:o0 + rp * n].reshape(A.shape[0], n, rp) \
                .permute(1, 0, 2)
            Bb = B[o0:o0 + rp * n].reshape(n, rp, B.shape[-1])
        else:
            Ab = torch.stack([A[:, layout.offsets[k]:layout.offsets[k] + rp]
                              for k in jobs])
            Bb = torch.stack([B[layout.offsets[k]:layout.offsets[k] + rp]
                              for k in jobs])
        out.append((rp, jobs, Ab, Bb))
    return out


def _bucket_rank_mask(layout, rp, jobs, device) -> Optional[torch.Tensor]:
    """(K_b, rp) bool lane mask, or None when every member fills its
    padded width (no masking work at all).  The static ranks compare one
    by one, so that no host table is copied to the device."""
    ranks = tuple(layout.ranks[k] for k in jobs)
    if all(r == rp for r in ranks):
        return None
    lane = torch.arange(rp, device=device)
    return torch.stack([lane < r for r in ranks])


def _bucket_onehot(ids, jobs) -> torch.Tensor:
    """(T, K_b) f32: token t belongs to the bucket's i-th job (all zero
    for the other buckets' tokens, the reference's one_hot of a miss)."""
    return torch.stack([ids == k for k in jobs], dim=1).float()


def _ragged_equal_forward(x, A, B, scalings, layout):
    """One segment-dense batched GEMM pair per rank bucket: Σ_k 2·C·d·rp_k
    flops, the true-rank ideal."""
    T, d_in = x.shape
    K = layout.num_jobs
    buf = x.reshape(K, T // K, d_in)
    pieces = [None] * K
    for rp, jobs, Ab, Bb in _bucket_params(A, B, layout):
        xa = torch.bmm(_pick(buf, jobs).float(), Ab.float())
        m = _bucket_rank_mask(layout, rp, jobs, x.device)
        if m is not None:
            xa = torch.where(m[:, None, :], xa, 0.0)
        y = torch.bmm(xa.to(x.dtype).float(), Bb.float())
        y = y * _pick(scalings, jobs)[:, None, None]
        for i, k in enumerate(jobs):
            pieces[k] = y[i]
    return torch.stack(pieces).reshape(T, -1).to(x.dtype)


def _ragged_equal_bwd(x, A, B, scalings, layout, dy):
    """dx, dA, dB from one evaluation of the per-bucket intermediates."""
    T, d_in = x.shape
    K = layout.num_jobs
    C = T // K
    buf, dyb = x.reshape(K, C, d_in), dy.reshape(K, C, -1)
    dx_p, dA_p, dB_p = [None] * K, [None] * K, [None] * K
    for rp, jobs, Ab, Bb in _bucket_params(A, B, layout):
        buf_b = _pick(buf, jobs)
        dy_s = _pick(dyb, jobs).float() * _pick(scalings, jobs)[:, None, None]
        xa = torch.bmm(buf_b.float(), Ab.float())
        dxa = torch.einsum("kco,kro->kcr", dy_s, Bb.float())
        m = _bucket_rank_mask(layout, rp, jobs, x.device)
        if m is not None:
            xa = torch.where(m[:, None, :], xa, 0.0)
            dxa = torch.where(m[:, None, :], dxa, 0.0)
        xa = xa.to(x.dtype)
        dx_b = torch.einsum("kcr,kdr->kcd", dxa, Ab.float())
        dA_b = torch.einsum("kcd,kcr->kdr", buf_b.float(), dxa)
        dB_b = torch.einsum("kcr,kco->kro", xa.float(), dy_s)
        for i, k in enumerate(jobs):
            dx_p[k], dA_p[k], dB_p[k] = dx_b[i], dA_b[i], dB_b[i]
    return (torch.stack(dx_p).reshape(T, d_in), torch.cat(dA_p, dim=-1),
            torch.cat(dB_p, dim=0))


def _ragged_fallback_forward(x, A, B, ids, scalings, layout):
    """Dense-over-BUCKET fallback for batches without equal segments (nano
    slices, test batches): exact for any ids and still rank-aware, each
    bucket densified over its own members at its own width."""
    y = torch.zeros((x.shape[0], B.shape[-1]), dtype=torch.float32,
                    device=x.device)
    for rp, jobs, Ab, Bb in _bucket_params(A, B, layout):
        onehot = _bucket_onehot(ids, jobs)
        xa = torch.einsum("td,kdr->tkr", x.float(), Ab.float())
        m = _bucket_rank_mask(layout, rp, jobs, x.device)
        if m is not None:
            xa = torch.where(m[None, :, :], xa, 0.0)
        yb = torch.einsum("tkr,kro->tko", xa.to(x.dtype).float(), Bb.float())
        yb = yb * _pick(scalings, jobs)[None, :, None]
        y = y + torch.einsum("tko,tk->to", yb, onehot)
    return y.to(x.dtype)


def _ragged_fallback_bwd(x, A, B, ids, scalings, layout, dy):
    """dx, dA, dB of the fallback: dy_k carries the bucket's one-hot, so
    dxa is segment-sparse and the wgrads need no further masking."""
    K = layout.num_jobs
    dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    dA_p, dB_p = [None] * K, [None] * K
    for rp, jobs, Ab, Bb in _bucket_params(A, B, layout):
        onehot = _bucket_onehot(ids, jobs)
        dy_k = (dy.float()[:, None, :] * onehot[:, :, None]
                * _pick(scalings, jobs)[None, :, None])
        xa = torch.einsum("td,kdr->tkr", x.float(), Ab.float())
        dxa = torch.einsum("tko,kro->tkr", dy_k, Bb.float())
        m = _bucket_rank_mask(layout, rp, jobs, x.device)
        if m is not None:
            xa = torch.where(m[None, :, :], xa, 0.0)
            dxa = torch.where(m[None, :, :], dxa, 0.0)
        xa = xa.to(x.dtype)
        dx = dx + torch.einsum("tkr,kdr->td", dxa, Ab.float())
        dA_b = torch.einsum("td,tkr->kdr", x.float(), dxa)
        dB_b = torch.einsum("tkr,tko->kro", xa.float(), dy_k)
        for i, k in enumerate(jobs):
            dA_p[k], dB_p[k] = dA_b[i], dB_b[i]
    return dx, torch.cat(dA_p, dim=-1), torch.cat(dB_p, dim=0)


class _RaggedTorch(torch.autograd.Function):
    """The ragged "torch" path with the reference's hand-written backward
    (``_make_ragged_xla_fn``): equal segments take one batched GEMM pair
    per rank bucket, anything else the per-bucket one-hot fallback; the
    wgrads are bucket-dense at true-rank widths.  ids and the scalings get
    no gradient."""

    @staticmethod
    def forward(ctx, x, A, B, ids, scalings, layout, equal: bool):
        equal = equal and x.shape[0] % layout.num_jobs == 0
        ctx.save_for_backward(x, A, B, ids, scalings)
        ctx.layout, ctx.equal = layout, equal
        if equal:
            return _ragged_equal_forward(x, A, B, scalings, layout)
        return _ragged_fallback_forward(x, A, B, ids, scalings, layout)

    @staticmethod
    def backward(ctx, dy):
        x, A, B, ids, scalings = ctx.saved_tensors
        if ctx.equal:
            dx, dA, dB = _ragged_equal_bwd(x, A, B, scalings, ctx.layout, dy)
        else:
            dx, dA, dB = _ragged_fallback_bwd(x, A, B, ids, scalings,
                                              ctx.layout, dy)
        return (dx.to(x.dtype), dA.to(A.dtype), dB.to(B.dtype), None, None,
                None, None)


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
                      equal_segments: bool = False,
                      slice_rows: Optional[Tuple[int, ...]] = None,
                      seq_len: int = 1,
                      ranks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused heterogeneous multi-LoRA over PACKED RAGGED adapters.

    x (T, d_in), A (d_in, R), B (R, d_out) with R = Σ_k r_pad_k
    (``layout``: core/lora.RankLayout).  ``slice_rows`` is the static
    per-job row count of this batch — required for the static tile map
    of the "cuda" kernel; without it the call densifies and takes the
    masked family, whose device tile map handles any tile-aligned layout.
    ``equal_segments`` (every job owns T / K tokens) sends "torch" down
    its per-bucket batched path; "torch" ignores ``slice_rows`` and takes
    its exact one-hot fallback for any other batch, as the reference's
    "xla" does.
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
        return _RaggedTorch.apply(x, A, B, ids, scalings, layout,
                                  bool(equal_segments))
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
               block_t: int = 128,
               equal_segments: bool = False) -> torch.Tensor:
    """Fused heterogeneous multi-LoRA: y_t = s_a ((x_t A_a) B_a), a=ids[t].
    x (T, d_in), A (K, d_in, r), B (K, r, d_out) -> (T, d_out).
    ``equal_segments``: every adapter owns T / K consecutive tokens (the
    "torch" impl's batched path)."""
    if impl == "cuda":
        return _MaskedLoRA.apply(x, A, B, ids, ranks, scalings, block_t)
    if impl == "torch":
        return fused_lora_torch(x, A, B, ids, ranks, scalings,
                                equal_segments)
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
