"""Dispatch of the fused multi-LoRA kernels (port of
``repro.kernels.ops``).

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

Shard-local variants (data-parallel sharded execution, ``core/ssm``):
given a ``Shard``, the four Functions run the forward and dx on this
rank's rows only, then reassemble x, the cotangent and the ids at full
shape in solo order (``gather_solo``) and run the SAME wgrad code as on
one device, once per rank, so the adapter gradient every rank holds is
replicated and equal to the single-device one given the same operands.
"ref" and "loop" have no hand-written backward to localize and refuse a
``Shard`` (the sharded step's ``grad_sync="psum"`` serves them).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
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


# ---------------------------------------------------------- shard-local
def gather_solo(t: torch.Tensor, group, solo_pos: torch.Tensor,
                total: int) -> torch.Tensor:
    """Reassemble a (total, ...) tensor in SOLO order from every shard's
    rows: one all-gather of the shards' (n, ...) pieces
    (shard-major, in the group's rank order), then a copy of row p to
    solo position ``solo_pos[p]``; *solo_pos* (D·n,) holds the solo
    position of every gathered row, which every rank knows (the shard
    layout is static).  Rows no shard holds (a nano slice's other
    slices) are exact zeros.  Bit-preserving: every value is copied,
    none is summed.  The reference scatters into zeros and sums with a
    psum because its partial-auto ``shard_map`` had no all-gather; the
    gather moves each row once, 1/D of that traffic.  A group of one
    rank (a pipeline stage of D = 1) gathers nothing: its rows are the
    buffer."""
    D = dist.get_world_size(group)
    shape = tuple(t.shape[1:])
    if D == 1:
        buf = t.contiguous()
    else:
        buf = t.new_empty((D * t.shape[0],) + shape)
        dist.all_gather_into_tensor(buf, t.contiguous(), group=group)
    make = torch.empty if buf.shape[0] == total else torch.zeros
    out = make((total,) + shape, dtype=t.dtype, device=t.device)
    return out.index_copy_(0, solo_pos, buf)


class Shard(NamedTuple):
    """What a shard-local Function needs to reassemble its operands: the
    data-parallel process group, the solo token position of every
    shard's tokens (shard-major), the fused batch's token count, and the
    adapter of every token of the full batch in solo order (job-major
    segments, each whole token tiles: the masked wgrads' tile map)."""
    group: object
    solo_pos: torch.Tensor
    total: int
    solo_ids: Optional[torch.Tensor] = None

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        return gather_solo(t, self.group, self.solo_pos, self.total)


def _no_shard_vjp(impl: str) -> ValueError:
    return ValueError(
        f"impl {impl!r} has no shard-local VJP; use impl='torch'/'cuda' "
        "or grad_sync='psum'")


class _MaskedLoRA(torch.autograd.Function):
    """The masked "cuda" path with its backward (the reference's
    ``_make_pallas_fn``).  Backward = five launches over the device tile
    map: dxa = dy_s ·g B^T and dx = dxa ·g A^T (grouped products), xa =
    x ·g A (grouped product), dA = Σ_seg x^T·dxa and dB = Σ_seg xa^T·dy_s
    (grouped wgrads).  B^T and A^T are strided views, never copies.
    Rounding points as in the reference: dy_s = bf16(dy · s[ids]) in f32;
    dxa and xa rank-masked in f32, then cast to x.dtype; dA, dB f32, then
    cast to A's and B's dtypes.  ids, ranks and the scalings (alpha / r
    constants, never trained) get no gradient.

    Shard-local (``shard`` given, the reference's
    ``_make_pallas_sharded_fn``): the forward and the two dx launches run
    over this rank's tiles; x, dy_s and dxa (rank-wide) are gathered in
    solo order, and xa and the two grouped wgrads run over the full
    batch's tile map (``Shard.solo_ids``).  A nano slice gathers into a
    buffer whose other slices' rows are zeros: they add exact zeros to
    whichever adapter the full batch's map gives them, so one map serves
    every slice (the kernels take any tile map)."""

    @staticmethod
    def forward(ctx, x, A, B, ids, ranks, scalings, block_t: int,
                shard: Optional[Shard] = None):
        tm = _tile_map(ids, block_t)
        rk = ranks.to(torch.int32).contiguous()
        ctx.save_for_backward(x, A, B, ids, rk, scalings, tm)
        ctx.block_t, ctx.shard = block_t, shard
        y = fused_lora_cuda(x, A, B, tm, rk, block_t=block_t)
        return (y.float() * scalings[ids][:, None]).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, A, B, ids, rk, scalings, tm = ctx.saved_tensors
        bt, K, sh = ctx.block_t, A.shape[0], ctx.shard
        dy_s = (dy.float() * scalings[ids][:, None]).to(dy.dtype)
        dxa = grouped_matmul_cuda(dy_s, B.transpose(1, 2), tm, block_t=bt)
        dxa = ref_impl.rank_mask(dxa.float(), ids, rk).to(x.dtype)
        dx = grouped_matmul_cuda(dxa, A.transpose(1, 2), tm, block_t=bt)
        if sh is not None:
            # a row's dxa is the same whatever tiles it is computed in
            # (one summation order): gathered, not recomputed
            x, dy_s, dxa = sh.gather(x), sh.gather(dy_s), sh.gather(dxa)
            ids = sh.solo_ids
            tm = _tile_map(ids, bt)
        xa = grouped_matmul_cuda(x, A, tm, block_t=bt)
        xa = ref_impl.rank_mask(xa.float(), ids, rk).to(x.dtype)
        dA = grouped_wgrad_cuda(x, dxa, tm, K, block_t=bt)
        dB = grouped_wgrad_cuda(xa, dy_s, tm, K, block_t=bt)
        return (dx.to(x.dtype), dA.to(A.dtype), dB.to(B.dtype), None, None,
                None, None, None)


class _RaggedLoRA(torch.autograd.Function):
    """The ragged "cuda" path with its backward (the reference's
    ``_make_ragged_pallas_fn``).  Backward = one dgrad launch (dx) + two
    packed launches (xa, dxa) + two wgrad launches (dA, dB), all over the
    active (token tile, rank tile) pairs.  Rounding points as in the
    reference: dy_s = bf16(dy · s[ids]) in f32; dx f32 then cast to
    x.dtype; dA, dB f32 then cast to A's and B's dtypes.  ids and the
    scalings (alpha / r constants, never trained) get no gradient.

    Shard-local (``shard`` given, the reference's
    ``_make_ragged_pallas_sharded_fn``): the forward and the dgrad run
    over this rank's (token tile, rank tile) pairs (``meta``); x and
    dy_s are gathered in solo order, and xa, dxa and the two wgrads run
    over the full batch under the solo metadata ``meta_solo``.  The solo
    metadata holds for a nano slice too: the other slices' rows are
    zeros, which add exact zeros to whatever segment the map gives
    them."""

    @staticmethod
    def forward(ctx, x, A, B, ids, scalings, meta: RaggedMeta,
                block_t: int, shard: Optional[Shard] = None,
                meta_solo: Optional[RaggedMeta] = None):
        ctx.save_for_backward(x, A, B, ids, scalings)
        ctx.meta, ctx.block_t = meta, block_t
        ctx.shard, ctx.meta_solo = shard, meta_solo
        y = rg.ragged_lora_fwd(x, A, B, meta, block_t=block_t)
        return (y * scalings[ids][:, None]).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, A, B, ids, scalings = ctx.saved_tensors
        meta, bt = ctx.meta, ctx.block_t
        dy_s = (dy.float() * scalings[ids][:, None]).to(dy.dtype)
        dx = rg.ragged_lora_dgrad(dy_s, A, B, meta, block_t=bt)
        if ctx.shard is not None:
            x, dy_s = ctx.shard.gather(x), ctx.shard.gather(dy_s)
            meta = ctx.meta_solo
        xa = rg.ragged_xa(x, A, meta, block_t=bt)
        dxa = rg.ragged_dxa(dy_s, B, meta, block_t=bt).to(x.dtype)
        dA = rg.ragged_wgrad(dxa, x, meta, block_t=bt)         # (R, d_in)
        dB = rg.ragged_wgrad(xa, dy_s, meta, block_t=bt)       # (R, d_out)
        return (dx.to(x.dtype), dA.T.to(A.dtype), dB.to(B.dtype), None,
                None, None, None, None, None)


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


def _masked_torch_bwd(x, A, B, ids, ranks, scalings, dy, equal: bool,
                      want_dx: bool = True, want_w: bool = True):
    """(dx, dA, dB) of the masked "torch" backward, each None where not
    wanted: one evaluation of the parts, so that one device and the
    shard-local variant run literally the same expressions."""
    T, d_in = x.shape
    Af = A.float()
    dx = dA = dB = None
    if equal:
        buf, dy_s, xa, dxa = _masked_equal_parts(x, A, B, ranks, scalings,
                                                 dy)
        if want_dx:
            dx = torch.einsum("kcr,kdr->kcd", dxa, Af).reshape(T, d_in)
        if want_w:
            dA = torch.einsum("kcd,kcr->kdr", buf.float(), dxa)
            dB = torch.einsum("kcr,kco->kro", xa.float(), dy_s)
        return dx, dA, dB
    dy_k, xa, dxa = _masked_fallback_parts(x, A, B, ids, ranks, scalings,
                                           dy)
    if want_dx:
        dx = torch.einsum("tkr,kdr->td", dxa, Af)
    if want_w:
        dA = torch.einsum("td,tkr->kdr", x.float(), dxa)
        dB = torch.einsum("tkr,tko->kro", xa.float(), dy_k)
    return dx, dA, dB


class _MaskedTorch(torch.autograd.Function):
    """The masked "torch" path with the reference's hand-written backward
    (``_make_xla_fn``).  Equal segments: a reshape (T, d) -> (K, T/K, d)
    and batched GEMM pairs, with segment-dense wgrads dA[k] = buf[k]ᵀ·
    dxa[k], dB[k] = xa[k]ᵀ·dy_s[k]; otherwise the dense-over-K one-hot
    fallback, whose wgrads stay exact without a one-hot of their own.
    ids, ranks and the scalings (alpha / r constants, never trained) get
    no gradient.  Shard-local (``shard`` given, the reference's
    ``_make_xla_sharded_fn``): dx from this rank's rows, the wgrads from
    x, dy and the ids gathered in solo order."""

    @staticmethod
    def forward(ctx, x, A, B, ids, ranks, scalings, equal: bool,
                shard: Optional[Shard] = None):
        equal = equal and x.shape[0] % A.shape[0] == 0
        ctx.save_for_backward(x, A, B, ids, ranks, scalings)
        ctx.equal, ctx.shard = equal, shard
        return _masked_forward(x, A, B, ids, ranks, scalings, equal)

    @staticmethod
    def backward(ctx, dy):
        x, A, B, ids, ranks, scalings = ctx.saved_tensors
        sh = ctx.shard
        dx, dA, dB = _masked_torch_bwd(x, A, B, ids, ranks, scalings, dy,
                                       ctx.equal, want_w=sh is None)
        if sh is not None:
            _, dA, dB = _masked_torch_bwd(
                sh.gather(x), A, B, sh.gather(ids), ranks, scalings,
                sh.gather(dy), ctx.equal, want_dx=False)
        return (dx.to(x.dtype), dA.to(A.dtype), dB.to(B.dtype), None, None,
                None, None, None)


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


def _ragged_equal_bwd(x, A, B, scalings, layout, dy, want_dx: bool = True,
                      want_w: bool = True):
    """(dx, dA, dB), each None where not wanted, from one evaluation of
    the per-bucket intermediates."""
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
        if want_dx:
            dx_b = torch.einsum("kcr,kdr->kcd", dxa, Ab.float())
        if want_w:
            dA_b = torch.einsum("kcd,kcr->kdr", buf_b.float(), dxa)
            dB_b = torch.einsum("kcr,kco->kro", xa.float(), dy_s)
        for i, k in enumerate(jobs):
            if want_dx:
                dx_p[k] = dx_b[i]
            if want_w:
                dA_p[k], dB_p[k] = dA_b[i], dB_b[i]
    return (torch.stack(dx_p).reshape(T, d_in) if want_dx else None,
            torch.cat(dA_p, dim=-1) if want_w else None,
            torch.cat(dB_p, dim=0) if want_w else None)


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


def _ragged_fallback_bwd(x, A, B, ids, scalings, layout, dy,
                         want_dx: bool = True, want_w: bool = True):
    """(dx, dA, dB) of the fallback, each None where not wanted: dy_k
    carries the bucket's one-hot, so dxa is segment-sparse and the
    wgrads need no further masking."""
    K = layout.num_jobs
    dx = (torch.zeros(x.shape, dtype=torch.float32, device=x.device)
          if want_dx else None)
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
        if want_dx:
            dx = dx + torch.einsum("tkr,kdr->td", dxa, Ab.float())
        if want_w:
            dA_b = torch.einsum("td,tkr->kdr", x.float(), dxa)
            dB_b = torch.einsum("tkr,tko->kro", xa.float(), dy_k)
            for i, k in enumerate(jobs):
                dA_p[k], dB_p[k] = dA_b[i], dB_b[i]
    return (dx, torch.cat(dA_p, dim=-1) if want_w else None,
            torch.cat(dB_p, dim=0) if want_w else None)


class _RaggedTorch(torch.autograd.Function):
    """The ragged "torch" path with the reference's hand-written backward
    (``_make_ragged_xla_fn``): equal segments take one batched GEMM pair
    per rank bucket, anything else the per-bucket one-hot fallback; the
    wgrads are bucket-dense at true-rank widths.  ids and the scalings get
    no gradient.  Shard-local (``shard`` given, the reference's
    ``_make_ragged_xla_sharded_fn``): dx from this rank's rows, the
    wgrads from x, dy and the ids gathered in solo order."""

    @staticmethod
    def forward(ctx, x, A, B, ids, scalings, layout, equal: bool,
                shard: Optional[Shard] = None):
        equal = equal and x.shape[0] % layout.num_jobs == 0
        ctx.save_for_backward(x, A, B, ids, scalings)
        ctx.layout, ctx.equal, ctx.shard = layout, equal, shard
        if equal:
            return _ragged_equal_forward(x, A, B, scalings, layout)
        return _ragged_fallback_forward(x, A, B, ids, scalings, layout)

    @staticmethod
    def backward(ctx, dy):
        x, A, B, ids, scalings = ctx.saved_tensors
        sh, lay = ctx.shard, ctx.layout

        def bwd(x, ids, dy, **kw):
            if ctx.equal:
                return _ragged_equal_bwd(x, A, B, scalings, lay, dy, **kw)
            return _ragged_fallback_bwd(x, A, B, ids, scalings, lay, dy,
                                        **kw)
        dx, dA, dB = bwd(x, ids, dy, want_w=sh is None)
        if sh is not None:
            _, dA, dB = bwd(sh.gather(x), sh.gather(ids), sh.gather(dy),
                            want_dx=False)
        return (dx.to(x.dtype), dA.to(A.dtype), dB.to(B.dtype), None, None,
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
                      equal_segments: bool = False,
                      slice_rows: Optional[Tuple[int, ...]] = None,
                      seq_len: int = 1,
                      nano_order: Optional[Tuple[int, ...]] = None,
                      solo_rows: Tuple[int, ...] = (),
                      shard: Optional[Shard] = None,
                      ranks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused heterogeneous multi-LoRA over PACKED RAGGED adapters.

    x (T, d_in), A (d_in, R), B (R, d_out) with R = Σ_k r_pad_k
    (``layout``: core/lora.RankLayout).  ``slice_rows`` is the static
    per-job row count of this batch when it is job-proportional (the
    full fused batch, or a sharded step's job-wise nano slice, whose
    segments come in ``nano_order``) — required for the static tile map
    of the "cuda" kernel; without it the call densifies and takes the
    masked family, whose device tile map handles any tile-aligned layout.
    ``solo_rows`` is the per-job rows of the batch the wgrads run over:
    the full (local) batch, or with a ``shard`` the full fused batch in
    solo order.  ``equal_segments`` (every job owns T / K tokens) sends
    "torch" down its per-bucket batched path; "torch" ignores
    ``slice_rows`` and takes its exact one-hot fallback for any other
    batch, as the reference's "xla" does.
    """
    from repro_torch.core.lora import unpack_dense
    rk = ranks if ranks is not None else torch.tensor(
        layout.ranks, dtype=torch.int32, device=x.device)
    if impl in ("ref", "loop"):
        if shard is not None:
            raise _no_shard_vjp(impl)
        Af, Bf = unpack_dense(A, B, layout)
        fn = (ref_impl.fused_lora_loop if impl == "loop"
              else ref_impl.fused_lora_ref)
        return fn(x, Af.to(x.dtype), Bf.to(x.dtype), ids, rk, scalings)
    if impl == "torch":
        return _RaggedTorch.apply(x, A, B, ids, scalings, layout,
                                  bool(equal_segments), shard)
    if impl == "cuda":
        T = x.shape[0]
        tile_jobs = None
        if slice_rows is not None and T % block_t == 0:
            is_slice = tuple(slice_rows) != tuple(solo_rows)
            tile_jobs = _tile_jobs_static(
                slice_rows, seq_len, block_t,
                order=nano_order if is_slice else None)
        if tile_jobs is None:
            # no static tile map (the contiguous nano split of one
            # device): densify to the layout's widest segment and take
            # the masked family, whose device tile map takes any
            # tile-aligned layout
            assert shard is None, \
                "sharded ragged cuda needs a job-proportional batch"
            Af, Bf = unpack_dense(A, B, layout)
            return _MaskedLoRA.apply(x, Af.to(x.dtype), Bf.to(x.dtype),
                                     ids, rk, scalings, block_t)
        meta = RaggedMeta.build(tile_jobs, layout)
        meta_solo = None
        if shard is not None:
            solo_tiles = _tile_jobs_static(solo_rows, seq_len, block_t)
            assert solo_tiles is not None, (solo_rows, seq_len, block_t)
            meta_solo = RaggedMeta.build(solo_tiles, layout)
        return _RaggedLoRA.apply(x, A, B, ids, scalings, meta, block_t,
                                 shard, meta_solo)
    raise ValueError(f"unknown fused_lora_ragged impl {impl!r}")


def fused_lora(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
               ids: torch.Tensor, ranks: torch.Tensor,
               scalings: torch.Tensor, impl: str = "ref",
               block_t: int = 128, equal_segments: bool = False,
               shard: Optional[Shard] = None) -> torch.Tensor:
    """Fused heterogeneous multi-LoRA: y_t = s_a ((x_t A_a) B_a), a=ids[t].
    x (T, d_in), A (K, d_in, r), B (K, r, d_out) -> (T, d_out).
    ``equal_segments``: every adapter owns T / K consecutive tokens (the
    "torch" impl's batched path).  ``shard`` selects the shard-local
    variant (x and ids are this rank's tokens)."""
    if impl == "cuda":
        return _MaskedLoRA.apply(x, A, B, ids, ranks, scalings, block_t,
                                 shard)
    if impl == "torch":
        return _MaskedTorch.apply(x, A, B, ids, ranks, scalings,
                                  bool(equal_segments), shard)
    if shard is not None:
        raise _no_shard_vjp(impl)
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


def dequant_matmul_f32(x: torch.Tensor, q: torch.Tensor,
                       scale: torch.Tensor, impl: str = "cuda"
                       ) -> torch.Tensor:
    """(x @ q) * scale accumulated in f32 and not rounded, no gradient: a
    model rank's partial of a row-parallel int8 product
    (``models/layers.ModelAxis.row`` sums the ranks' partials and rounds
    once, as the whole product rounds).  "cuda": the kernel with its f32
    epilogue; "torch": the plain expression."""
    if impl == "cuda":
        return dequant_matmul_cuda(x.contiguous(), q, scale, out_f32=True)
    if impl == "torch":
        return dequant_matmul_plain(x, q, scale, out_f32=True)
    raise ValueError(f"unknown dequant_matmul impl {impl!r}")


def dequant_dx_f32(dy: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                   impl: str = "cuda") -> torch.Tensor:
    """The dx of ``dequant_matmul(x, q, scale, impl)`` for the output
    cotangent *dy*, in f32 and not rounded: dy · scale (rounded to dy's
    dtype for "cuda", as ``_DequantMM.backward``; not for "torch", as
    ``_DequantTorch.backward``) times q^T.  A model rank's partial of a
    column-parallel int8 product's dx, which the ranks sum."""
    if impl == "cuda":
        dys = (dy.float() * scale).to(dy.dtype).contiguous()
        return dequant_matmul_cuda(dys, q.T, None, out_f32=True)
    if impl == "torch":
        return (dy.float() * scale) @ q.T.float()
    raise ValueError(f"unknown dequant_matmul impl {impl!r}")


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
