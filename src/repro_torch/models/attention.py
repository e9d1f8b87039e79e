"""GQA attention and KV caches (port of ``repro.models.attention``).

  * train / prefill — q at position 0 over its own S keys: ``_Flash``,
               the counterpart of the reference's flash custom VJP
               (``_make_flash``).  Without a window its forward is the
               flash kernel (kernels/flash_attention.py) on a CUDA tensor
               and the chunked online-softmax scan on a CPU tensor; with
               a sliding window (local attention) it is the chunk scan on
               every device, as the reference routes windowed attention
               around its Pallas kernel.  Its backward re-walks the key
               chunks in plain PyTorch, recomputing p from the saved lse
               under the same masks, as the reference does outside any
               Pallas kernel.  Prefill into a full cache reads the first
               S cache columns, which is the reference's scan over the
               whole ``buf``-wide cache with ``kv_len = S``, the same
               function;
  * decode   — q (S=1..n) over the cache with per-row positions: the
               online-softmax chunk scan in plain PyTorch (the reference
               runs it outside any Pallas kernel too), over key chunks of
               a fixed width (``DECODE_CHUNK``), so that a row's sums do
               not depend on the cache width of the batch it decodes in;
  * ring     — a sliding-window cache of ``min(buf, window)`` slots
               indexed modulo its width (``ring_attention``): one token
               writes its slot, then attends over every filled slot,
               count-masked, as in the reference; a prompt of S > 1
               tokens attends causally with the ring's window over the
               keys still in the ring and its own, as the cacheless
               forward does, and leaves its last ``min(S, slots)`` keys
               in the ring.  (The reference attends a prompt with its
               single-token rule, so every prompt token sees the ones
               after it: ROADMAP C6.)

KV caches are updated IN PLACE (the reference returns new arrays): one
buffer per segment for the whole request batch, no copy per step.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.lora import MultiLoRA, proj
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.models.layers import apply_rope, dense_init

NEG_BIG = -1e30
# Keys per chunk of the decode scan.  Fixed, not cut to the cache width:
# the width follows the batch's longest prompt, and a chunk as wide as
# the cache would make each row's f32 sums (p.sum, p·v) run over another
# number of terms, fused and solo.  Chunks past a row's kv_len add an
# exact 0 and rescale by exp(0) = 1.  ``KVCache.init`` makes caches of
# whole chunks, and ``decode_attention`` takes no other width.
DECODE_CHUNK = 256


def _is_vec(a) -> bool:
    return isinstance(a, torch.Tensor) and a.ndim == 1


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, q_offset, kv_len, causal: bool,
                      window: Optional[int], chunk: int = 1024,
                      row_block: Optional[int] = None) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Skv, KV, hd). Returns (B, Sq, H, hd).

    q_offset: absolute position of q[0] — an int or a per-row (B,) tensor.
    kv_len:   number of valid kv entries (<= Skv), int or per-row (B,).

    window:   if set, keys with qpos - kpos >= window are masked out.

    Static geometry with q at position 0 over exactly Sq keys (training,
    prefill) goes through ``_Flash``; everything else takes the chunk
    scan (decode, never differentiated), its chunk products on
    *row_block* rows at a time when given (``_rows_einsum``).
    """
    if (isinstance(q_offset, int) and q_offset == 0
            and isinstance(kv_len, int) and kv_len == q.shape[1]):
        return _Flash.apply(q, k[:, :kv_len], v[:, :kv_len], causal, chunk,
                            window)
    out, _ = _chunked_attention_fwd(q, k, v, q_offset=q_offset,
                                    kv_len=kv_len, causal=causal,
                                    window=window, chunk=chunk,
                                    row_block=row_block)
    return out


def _flash_kernel(q, k, v, causal: bool):
    """(B, Sq, H, hd) q over (B, Skv, KV, hd) k/v through the flash
    kernel's flat layout; returns (out (B, Sq, H, hd), lse (B, H, Sq))."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    qf = q.transpose(1, 2).reshape(B * H, Sq, hd)
    kf = k.transpose(1, 2).reshape(B * KV, Skv, hd)
    vf = v.transpose(1, 2).reshape(B * KV, Skv, -1)
    out, lse = flash_attention_fwd(qf.contiguous(), kf.contiguous(),
                                   vf.contiguous(), causal=causal,
                                   kv_groups=H // KV)
    return (out.reshape(B, H, Sq, -1).transpose(1, 2),
            lse.reshape(B, H, Sq))


class _Flash(torch.autograd.Function):
    """Flash attention with a hand-written backward, static geometry
    (q at position 0, kv_len = Skv), with or without a sliding window:
    the reference's ``_make_flash``.  Forward: the flash kernel on a CUDA
    tensor without a window, else the chunk scan; it saves (q, k, v,
    out, lse), never the (Sq x Skv) scores.  Backward re-walks the key
    chunks, recomputing p = exp(s - lse) under the forward's masks, with
    the reference's rounding points: p rounded to q.dtype for dv, ds
    rounded to q.dtype for dq and dk, every product of those
    storage-dtype values accumulated in f32, and the GQA head broadcast
    folded back by a sum over the groups."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, chunk: int,
                window: Optional[int] = None):
        if q.is_cuda and window is None:
            out, lse = _flash_kernel(q, k, v, causal)
        else:
            out, lse = _chunked_attention_fwd(
                q, k, v, q_offset=0, kv_len=k.shape[1], causal=causal,
                window=window, chunk=chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.chunk, ctx.window = causal, chunk, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        B, Sq, H, hd = q.shape
        Skv, KV = k.shape[1], k.shape[2]
        vd = v.shape[-1]
        G = H // KV
        ck = min(ctx.chunk, Skv)
        n_chunks = (Skv + ck - 1) // ck
        pad = n_chunks * ck - Skv
        if pad:
            k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
            v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        scale = hd ** -0.5
        dev = q.device
        qpos = torch.arange(Sq, device=dev)
        # the cotangent in the storage dtype, as the reference takes it
        dout = dout.to(q.dtype).float()
        qf = q.float()
        # D_i = sum_d dout_i * out_i  (flash-2 backward identity)
        D = torch.einsum("bshd,bshd->bhs", dout, out.float())
        dq = torch.zeros((B, Sq, H, hd), dtype=torch.float32, device=dev)
        dks, dvs = [], []
        for ci in range(n_chunks):
            sl = slice(ci * ck, (ci + 1) * ck)
            kH = k[:, sl].repeat_interleave(G, dim=2).float()
            vH = v[:, sl].repeat_interleave(G, dim=2).float()
            kpos = ci * ck + torch.arange(ck, device=dev)
            s = torch.einsum("bshd,bchd->bhsc", qf, kH) * scale
            valid = kpos[None, :] < Skv
            if ctx.causal:
                valid = valid & (kpos[None, :] <= qpos[:, None])
            if ctx.window is not None:
                valid = valid & (kpos[None, :] > qpos[:, None] - ctx.window)
            s = torch.where(valid[None, None], s, NEG_BIG)
            p = torch.exp(s - lse[..., None])                   # (B,H,Sq,c)
            pb = p.to(q.dtype).float()
            dvH = torch.einsum("bhsc,bshd->bchd", pb, dout)
            dp = torch.einsum("bshd,bchd->bhsc", dout, vH)
            ds = (p * (dp - D[..., None]) * scale).to(q.dtype).float()
            dq += torch.einsum("bhsc,bchd->bshd", ds, kH)
            dkH = torch.einsum("bhsc,bshd->bchd", ds, qf)
            dks.append(dkH.reshape(B, ck, KV, G, hd).sum(dim=3))
            dvs.append(dvH.reshape(B, ck, KV, G, vd).sum(dim=3))
        dk = torch.cat(dks, dim=1)[:, :Skv]
        dv = torch.cat(dvs, dim=1)[:, :Skv]
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def _rows_einsum(eq: str, a: torch.Tensor, b: torch.Tensor,
                 row_block: Optional[int]) -> torch.Tensor:
    """``torch.einsum(eq, a, b)`` with a leading row dim on both operands
    and the output, *row_block* rows at a time (None: all at once):
    cuBLAS picks a batched product's algorithm, and with it a row's
    summation order, by the batch count (on the H100, 64 decode rows
    part from 16 in both chunk products); the elementwise work and the
    reductions around them do not depend on it and stay whole."""
    if row_block is None or a.shape[0] <= row_block:
        return torch.einsum(eq, a, b)
    return torch.cat([torch.einsum(eq, a[i:i + row_block],
                                   b[i:i + row_block])
                      for i in range(0, a.shape[0], row_block)])


def _chunked_attention_fwd(q, k, v, *, q_offset, kv_len, causal: bool,
                           window: Optional[int], chunk: int = 1024,
                           row_block: Optional[int] = None):
    """Online-softmax chunk scan; returns (out (B,Sq,H,vd), lse (B,H,Sq)).

    Per-row geometry (batched serving decode): (B,) q_offset / kv_len
    give every row its own causal frontier; masked keys contribute an
    exact 0.0, so a padded fused batch reproduces each row's solo
    attention.  Scores and p·v run on f32 copies of the storage-dtype
    operands (f32 accumulation of exactly the reference's products)."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    vd = v.shape[-1]
    G = H // KV
    chunk = min(chunk, Skv)
    n_chunks = (Skv + chunk - 1) // chunk
    scale = hd ** -0.5
    dev = q.device
    ar = torch.arange(Sq, device=dev)
    per_row = _is_vec(q_offset) or _is_vec(kv_len)
    if per_row:
        qo = torch.as_tensor(q_offset, device=dev).reshape(-1, 1)
        qpos = (qo + ar).expand(B, Sq)                         # (B, Sq)
        kv_len_b = torch.as_tensor(kv_len, device=dev).reshape(-1, 1) \
            .expand(B, 1)
    else:
        qpos = q_offset + ar

    # query head h = n * G + g reads kv head n: group the query heads
    # instead of repeating k/v G times (same products, G x fewer bytes)
    qg = q.float().reshape(B, Sq, KV, G, hd)
    m = torch.full((B, H, Sq), NEG_BIG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Sq, H, vd), dtype=torch.float32, device=dev)
    for ci in range(n_chunks):
        k_c = k[:, ci * chunk:(ci + 1) * chunk].float()
        v_c = v[:, ci * chunk:(ci + 1) * chunk].float()
        c = k_c.shape[1]
        kpos = ci * chunk + torch.arange(c, device=dev)
        s = _rows_einsum("bsngd,bcnd->bngsc", qg, k_c, row_block).reshape(
            B, H, Sq, c) * scale
        if per_row:
            valid = kpos[None, None, :] < kv_len_b[:, :, None]
            if causal:
                valid = valid & (kpos[None, None, :] <= qpos[:, :, None])
            if window is not None:
                valid = valid & (kpos[None, None, :]
                                 > qpos[:, :, None] - window)
            s = torch.where(valid[:, None], s, NEG_BIG)       # (B,H,Sq,c)
        else:
            valid = kpos[None, :] < kv_len
            if causal:
                valid = valid & (kpos[None, :] <= qpos[:, None])
            if window is not None:
                valid = valid & (kpos[None, :] > qpos[:, None] - window)
            s = torch.where(valid[None, None], s, NEG_BIG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = _rows_einsum("bngsc,bcnd->bsngd",
                          p.to(q.dtype).float().reshape(B, KV, G, Sq, c),
                          v_c, row_block).reshape(B, Sq, H, vd)
        acc = acc * corr.transpose(1, 2)[..., None] + pv
        m = m_new
    lden = torch.where(l == 0, 1.0, l)
    out = acc / lden.transpose(1, 2)[..., None]
    lse = m + torch.log(lden)
    return out.to(q.dtype), lse


# ----------------------------------------------------------------- caches
class KVCache(NamedTuple):
    """Full or ring KV cache for one attention segment.

    k/v: (L?, B, buf, KV, hd) — leading layer axis when stacked.  A full
    cache's ``init`` rounds buf up to whole ``DECODE_CHUNK``-key chunks;
    a ring holds exactly its ``buf`` slots (a key's slot is its position
    modulo buf), so the rounding never changes which keys it holds."""
    k: torch.Tensor
    v: torch.Tensor

    @staticmethod
    def init(batch, buf, kv_heads, hd, dtype, layers: Optional[int] = None,
             device="cuda", ring: bool = False):
        if not ring:
            buf = -(-buf // DECODE_CHUNK) * DECODE_CHUNK
        shape = (batch, buf, kv_heads, hd)
        if layers is not None:
            shape = (layers,) + shape
        return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device))


def cache_update(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                 pos, ring: bool = False) -> KVCache:
    """Write k/v (B, S, KV, hd) at absolute position *pos*, in place.

    ``pos`` may be a per-row ``(B,)`` tensor (batched serving decode:
    each right-padded request writes at its own head) for a full cache;
    a ring takes a shared int position and keeps the last ``min(S,
    slots)`` of the S keys, each in slot position % slots."""
    S = k_new.shape[1]
    if ring:
        if _is_vec(pos):
            raise ValueError("per-row cache positions need a full "
                             "(non-ring) buffer")
        slots = cache.k.shape[1]
        m = min(S, slots)
        idx = torch.arange(pos + S - m, pos + S,
                           device=cache.k.device) % slots
        cache.k[:, idx] = k_new[:, S - m:].to(cache.k.dtype)
        cache.v[:, idx] = v_new[:, S - m:].to(cache.v.dtype)
    elif _is_vec(pos):
        rows = torch.arange(cache.k.shape[0], device=pos.device)[:, None]
        cols = pos.long()[:, None] + torch.arange(S, device=pos.device)
        cache.k[rows, cols] = k_new.to(cache.k.dtype)
        cache.v[rows, cols] = v_new.to(cache.v.dtype)
    else:
        cache.k[:, pos:pos + S] = k_new.to(cache.k.dtype)
        cache.v[:, pos:pos + S] = v_new.to(cache.v.dtype)
    return cache


def decode_attention(q: torch.Tensor, cache: KVCache, pos, *,
                     window: Optional[int],
                     row_block: Optional[int] = None) -> torch.Tensor:
    """q: (B, S=1.., H, hd) attending over the cache after update at pos.

    ``pos`` int or per-row ``(B,)``: kv_len and the causal frontier then
    mask per row, so a fused batch of requests at different depths
    attends exactly like each would solo: the cache is whole
    ``DECODE_CHUNK``-key chunks, so the chunk that holds a row's
    frontier holds the same keys in any batch, and with *row_block* (a
    solo batch's row count) the chunk products go that many rows at a
    time (``_rows_einsum``), so every product has the solo shape."""
    if cache.k.shape[1] % DECODE_CHUNK:
        raise ValueError(f"decode_attention: a cache of {cache.k.shape[1]} "
                         f"keys; it takes whole chunks of {DECODE_CHUNK} "
                         "(KVCache.init)")
    kv_len = pos + q.shape[1]
    return chunked_attention(q, cache.k, cache.v, q_offset=pos,
                             kv_len=kv_len, causal=True, window=window,
                             chunk=DECODE_CHUNK, row_block=row_block)


def ring_attention(q: torch.Tensor, k_new: torch.Tensor,
                   v_new: torch.Tensor, cache: KVCache, pos: int, *,
                   chunk: int = 1024) -> torch.Tensor:
    """S new tokens at *pos* through a ring of ``slots`` keys: returns
    their attention output and leaves the ring updated in place.

    S = 1: the reference's ring decode: write the slot, then attend over
    the ``min(pos + 1, slots)`` filled slots, count-masked (attention
    does not depend on the keys' order).  S > 1 (a prompt, or several
    tokens at once): causal attention with window ``slots`` over the
    ring's keys of positions pos - min(pos, slots) .. pos - 1, in order,
    then the S new ones; then the last ``min(S, slots)`` new keys go into
    the ring.  At pos = 0 that is the cacheless forward's attention over
    the prompt wherever S <= slots or the layer's window is the ring's."""
    if _is_vec(pos):
        raise ValueError("per-row cache positions need a full (non-ring) "
                         "buffer")
    S, slots = q.shape[1], cache.k.shape[1]
    if S == 1:
        cache_update(cache, k_new, v_new, pos, ring=True)
        kv_len = min(pos + 1, slots)
        out, _ = _chunked_attention_fwd(
            q, cache.k, cache.v, q_offset=kv_len - 1, kv_len=kv_len,
            causal=False, window=None, chunk=DECODE_CHUNK)
        return out
    prev = min(pos, slots)
    idx = torch.arange(pos - prev, pos, device=cache.k.device) % slots
    k = torch.cat([cache.k[:, idx], k_new.to(cache.k.dtype)], dim=1)
    v = torch.cat([cache.v[:, idx], v_new.to(cache.v.dtype)], dim=1)
    out = chunked_attention(q, k, v, q_offset=prev, kv_len=prev + S,
                            causal=True, window=slots, chunk=chunk)
    cache_update(cache, k_new, v_new, pos, ring=True)
    return out


# ----------------------------------------------------------------- block
def attn_init(cfg, dtype, *, generator: torch.Generator, device="cuda",
              layers: int = 1) -> dict:
    kw = dict(generator=generator, device=device, layers=layers)
    p = {"wq": dense_init(cfg.d_model, cfg.q_dim, dtype, **kw),
         "wk": dense_init(cfg.d_model, cfg.kv_dim, dtype, **kw),
         "wv": dense_init(cfg.d_model, cfg.kv_dim, dtype, **kw),
         "wo": dense_init(cfg.q_dim, cfg.d_model, dtype, **kw)}
    if cfg.attn_bias:
        for name, d in (("bq", cfg.q_dim), ("bk", cfg.kv_dim),
                        ("bv", cfg.kv_dim)):
            p[name] = torch.zeros((layers, d), device=device)
    return p


def attn_block(cfg, params: dict, x: torch.Tensor, *,
               positions: torch.Tensor,
               lora: Optional[MultiLoRA] = None,
               lora_ab: Optional[dict] = None,
               cache: Optional[KVCache] = None,
               cache_pos=None,
               local: bool = False,
               ring: bool = False,
               chunk: int = 1024,
               row_block: Optional[int] = None
               ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """GQA attention with optional fused multi-LoRA on q/k/v/o.

    x: (B, S, d). Returns (out, cache).  ``local``: sliding-window
    attention (``cfg.sliding_window``); ``ring``: the cache is a ring
    (``ring_attention``).  ``row_block``: rows per base product and per
    decode chunk product (``layers.dense``)."""
    B, S, _ = x.shape
    la = lora_ab or {}
    rb = row_block
    q = proj(x, params["wq"], params.get("bq"), lora, la.get("q"), rb)
    k = proj(x, params["wk"], params.get("bk"), lora, la.get("k"), rb)
    v = proj(x, params["wv"], params.get("bv"), lora, la.get("v"), rb)
    q = q.reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    if cfg.causal:  # rope only for decoder archs
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    window = cfg.sliding_window if local else None
    if cache is not None and ring:
        out = ring_attention(q, k, v, cache, cache_pos, chunk=chunk)
    elif cache is not None:
        cache = cache_update(cache, k, v, cache_pos)
        out = decode_attention(q, cache, cache_pos, window=window,
                               row_block=rb)
    else:
        out = chunked_attention(q, k, v, q_offset=0, kv_len=S,
                                causal=cfg.causal, window=window,
                                chunk=chunk)
    out = out.reshape(B, S, cfg.q_dim)
    y = proj(out, params["wo"], None, lora, la.get("o"), rb)
    return y, cache
