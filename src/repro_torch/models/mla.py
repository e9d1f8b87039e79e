"""Multi-head Latent Attention (DeepSeek-V2), with absorbed decode (port
of ``repro.models.mla``).

Train/prefill: expand the compressed KV latent to full per-head K/V and
attend through ``chunked_attention`` (``_Flash``: on the card the flash
kernel at q/k width nope + rope and v width ``v_head_dim``, 192 / 128 for
deepseek-v2-lite-16b).  Decode: the *absorbed* formulation — scores
against the (B, S, kv_lora) latent cache, in f32 einsums.  LoRA targets:
q, kv_a (the d -> kv_lora + rope down-projection) and o.

Caches are updated IN PLACE, as the port's ``KVCache`` is (the reference
returns new arrays).  A prefill of S > 1 tokens into a cache attends over
its own S tokens only, as the reference's does (so it starts at
position 0); a ring keeps the last ``min(S, slots)`` of them, each in
slot position % slots.  The absorbed decode runs over key chunks of
``DECODE_CHUNK`` with an online softmax (the reference takes one softmax
over the whole cache: the same function), and a full cache holds whole
chunks (``MLACache.init``): a row's sums then do not depend on the cache
width, which follows the batch's longest prompt, so a fused batch
decodes each row as it would decode alone (ROADMAP C9, as C1 for GQA).

Tensor parallelism (``tp``: ``models/layers.ModelAxis``): a model rank
runs H/m heads.  ``wq`` and ``w_kv_b`` are column parallel by whole
heads, ``wo`` row parallel.  The latent down-projection ``w_kv_a`` is
held whole on every rank (its 512 latent + 64 rope columns: an m-th of
them would split the latent that ``kv_norm`` normalizes whole), so
every rank computes the latent and the rope key itself, and the caches
stay whole; their cotangent, which each rank's heads give only a part
of, is summed over the axis (``_enter_latent``).  The absorbed decode
absorbs the rank's heads of ``w_kv_b``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.lora import MultiLoRA, column_proj, proj, row_proj
from repro_torch.models import quant
from repro_torch.models.attention import (DECODE_CHUNK, NEG_BIG, _is_vec,
                                          _rows_einsum, chunked_attention)
from repro_torch.models.layers import apply_rope, dense_init, rms_norm


class MLACache(NamedTuple):
    latent: torch.Tensor     # (L?, B, buf, kv_lora)
    rope: torch.Tensor       # (L?, B, buf, qk_rope_dim)

    @staticmethod
    def init(batch, buf, cfg, dtype, layers: Optional[int] = None,
             device="cuda", ring: bool = False):
        """A full cache rounds *buf* up to whole ``DECODE_CHUNK``-key
        chunks (the absorbed decode's chunk scan); a ring holds exactly
        its *buf* slots."""
        if not ring:
            buf = -(-buf // DECODE_CHUNK) * DECODE_CHUNK
        ls = (layers,) if layers is not None else ()
        return MLACache(
            torch.zeros(ls + (batch, buf, cfg.kv_lora_rank), dtype=dtype,
                        device=device),
            torch.zeros(ls + (batch, buf, cfg.qk_rope_dim), dtype=dtype,
                        device=device))


def mla_init(cfg, dtype, *, generator: torch.Generator, device="cuda",
             layers: int = 1) -> dict:
    kw = dict(generator=generator, device=device, layers=layers)
    H = cfg.num_heads
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    return {
        "wq": dense_init(cfg.d_model, H * qk, dtype, **kw),
        "w_kv_a": dense_init(cfg.d_model,
                             cfg.kv_lora_rank + cfg.qk_rope_dim, dtype, **kw),
        "kv_norm": torch.zeros((layers, cfg.kv_lora_rank), device=device),
        "w_kv_b": dense_init(cfg.kv_lora_rank,
                             H * (cfg.qk_nope_dim + cfg.v_head_dim), dtype,
                             **kw),
        "wo": dense_init(H * cfg.v_head_dim, cfg.d_model, dtype, **kw),
    }


def _enter_latent(tp, kv_a: torch.Tensor) -> torch.Tensor:
    """The latent and rope key every rank computes whole, entering the
    rank's heads: identity; the cotangent summed over the axis."""
    return tp.enter(kv_a)


def _project_qkv_a(cfg, params, x, positions, lora, la, row_block,
                   tp=None):
    """Shared front: q heads (the rank's, under *tp*) + compressed latent
    + shared rope key."""
    B, S, _ = x.shape
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    if tp is None:
        q = proj(x, params["wq"], None, lora, la.get("q"), row_block)
    else:
        q = column_proj(tp, x, params["wq"], None, lora, la.get("q"),
                        row_block=row_block)
    q = q.reshape(B, S, -1, qk)
    q_nope, q_rope = q.split([cfg.qk_nope_dim, cfg.qk_rope_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    kv_a = proj(x, params["w_kv_a"], None, lora, la.get("kv_a"), row_block)
    if tp is not None:
        kv_a = _enter_latent(tp, kv_a)
    latent, k_rope = kv_a.split([cfg.kv_lora_rank, cfg.qk_rope_dim], dim=-1)
    latent = rms_norm(latent, params["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, latent, k_rope


def _expand_attend(cfg, params, q_nope, q_rope, latent, k_rope, chunk):
    """Expand the latent to per-head K/V (the heads of ``w_kv_b`` given:
    a rank's under tensor parallelism) and attend causally (the flash
    path: q/k of nope + rope against v of ``v_head_dim``)."""
    B, S = latent.shape[:2]
    H = q_nope.shape[2]
    kv = quant.qdot(latent, params["w_kv_b"])   # fused dequant if int8
    kv = kv.reshape(B, S, H, cfg.qk_nope_dim + cfg.v_head_dim)
    k_nope, v = kv.split([cfg.qk_nope_dim, cfg.v_head_dim], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, cfg.qk_rope_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    return chunked_attention(q, k, v, q_offset=0, kv_len=S, causal=True,
                             window=None, chunk=chunk)


def _write(cache: MLACache, latent, k_rope, pos, ring: bool) -> None:
    """Write S tokens' latent and rope key at *pos*, in place: a ring
    keeps the last ``min(S, slots)`` in slot position % slots (a shared
    int position); a full cache takes an int or a per-row (B,) pos."""
    S = latent.shape[1]
    lat, rop = (t.to(cache.latent.dtype) for t in (latent, k_rope))
    if ring:
        slots = cache.latent.shape[1]
        m = min(S, slots)
        idx = torch.arange(pos + S - m, pos + S,
                           device=lat.device) % slots
        cache.latent[:, idx] = lat[:, S - m:]
        cache.rope[:, idx] = rop[:, S - m:]
    elif _is_vec(pos):
        rows = torch.arange(lat.shape[0], device=lat.device)[:, None]
        cols = pos.long()[:, None] + torch.arange(S, device=lat.device)
        cache.latent[rows, cols] = lat
        cache.rope[rows, cols] = rop
    else:
        cache.latent[:, pos:pos + S] = lat
        cache.rope[:, pos:pos + S] = rop


def mla_block(cfg, params: dict, x: torch.Tensor, *,
              positions: torch.Tensor,
              lora: Optional[MultiLoRA] = None,
              lora_ab: Optional[dict] = None,
              cache: Optional[MLACache] = None, cache_pos=None,
              ring: bool = False, chunk: int = 1024,
              row_block: Optional[int] = None, tp=None
              ) -> Tuple[torch.Tensor, Optional[MLACache]]:
    """x: (B, S, d). Returns (out, cache).  Without a cache: the expand
    path (training, prefill).  With a cache and S > 1: the prompt goes
    into the cache and attends through the expand path.  With a cache
    and one token: the absorbed decode at an int position, a per-row (B,)
    position (full cache) or through a ring (int position).
    ``row_block``: rows per base product and per absorbed-decode product
    (``layers.dense``, ``attention._rows_einsum``).  ``tp``: the model
    rank's H/m heads (module docstring)."""
    B, S, _ = x.shape
    H = cfg.num_heads // (1 if tp is None else tp.size)
    la = lora_ab or {}
    rb = row_block
    q_nope, q_rope, latent, k_rope = _project_qkv_a(
        cfg, params, x, positions, lora, la, rb, tp)

    if cache is not None and ring and _is_vec(cache_pos):
        raise ValueError("ring decode needs a shared int position")
    if cache is None or S > 1:
        # ---- train / prefill: expand latent to per-head K/V, flash attn
        if cache is not None:
            _write(cache, latent, k_rope, cache_pos, ring)
        out = _expand_attend(cfg, params, q_nope, q_rope, latent, k_rope,
                             chunk)
    else:
        # ---- absorbed decode (S == 1): score against the latent cache
        _write(cache, latent, k_rope, cache_pos, ring)
        out = _absorbed_attend(cfg, params, q_nope, q_rope, cache,
                               cache_pos, ring, rb).to(x.dtype)

    out = out.reshape(B, S, H * cfg.v_head_dim)
    if tp is not None:
        return row_proj(tp, out, params["wo"], lora, la.get("o"), rb), cache
    y = proj(out, params["wo"], None, lora, la.get("o"), rb)
    return y, cache


def _absorbed_attend(cfg, params, q_nope, q_rope, cache: MLACache, pos,
                     ring: bool, rb: Optional[int]) -> torch.Tensor:
    """The absorbed decode's attention, f32: W_kb absorbed into q, scores
    against the latent and rope caches, masked at the row's positions
    (or count-masked in a ring), softmax, context over the latent, W_vb
    out; over key chunks of ``DECODE_CHUNK`` with an online softmax
    (chunks past a row's keys add exact zeros and rescale by 1).
    Returns (B, S, H, v_head_dim) f32 (H: the heads of ``w_kv_b`` and
    *q_nope*, a rank's under tensor parallelism)."""
    B, S, H = q_nope.shape[:3]
    buf = cache.latent.shape[1]
    dev = q_nope.device
    # a small dequantized f32 copy of W_kv_b (the absorb einsums are f32
    # anyway; S == 1, so this is cheap)
    w_kv_b = quant.asarray(params["w_kv_b"]).reshape(
        cfg.kv_lora_rank, H, cfg.qk_nope_dim + cfg.v_head_dim).float()
    w_k = w_kv_b[..., :cfg.qk_nope_dim]              # (kvr, H, nope)
    w_v = w_kv_b[..., cfg.qk_nope_dim:]              # (kvr, H, v)
    # absorb W_kb into q:  q' = q_nope @ W_k^T  -> (B, S, H, kvr)
    q_lat = _rows_einsum("bshn,chn->bshc", q_nope.float(), w_k, rb,
                         shared_b=True)
    q_r = q_rope.float()
    scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    if ring:
        # the ring holds the last `buf` tokens; attention does not
        # depend on the keys' order, so count-masking suffices
        kv_len, qpos = min(pos + S, buf), None
    elif _is_vec(pos):
        qpos = pos.long()[:, None] + torch.arange(S, device=dev)  # (B, S)
        kv_len = qpos[:, -1:] + 1                                  # (B, 1)
    else:
        qpos = (pos + torch.arange(S, device=dev))[None]           # (1, S)
        kv_len = pos + S
    m = torch.full((B, H, S), NEG_BIG, device=dev)
    l = torch.zeros((B, H, S), device=dev)
    acc = torch.zeros((B, S, H, cfg.kv_lora_rank), device=dev)
    for c0 in range(0, buf, DECODE_CHUNK):
        lat = cache.latent[:, c0:c0 + DECODE_CHUNK].float()
        rop = cache.rope[:, c0:c0 + DECODE_CHUNK].float()
        t = c0 + torch.arange(lat.shape[1], device=dev)
        s = (_rows_einsum("bshc,btc->bhst", q_lat, lat, rb)
             + _rows_einsum("bshr,btr->bhst", q_r, rop, rb)) * scale
        if ring:
            valid = (t < kv_len)[None, None, None, :]
        elif _is_vec(pos):
            valid = ((t[None, None, :] < kv_len[:, :, None])
                     & (t[None, None, :] <= qpos[:, :, None]))[:, None]
        else:
            valid = ((t[None, :] < kv_len)
                     & (t[None, :] <= qpos[0][:, None]))[None, None]
        s = torch.where(valid, s, NEG_BIG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = (acc * corr.transpose(1, 2)[..., None]
               + _rows_einsum("bhst,btc->bshc", p, lat, rb))
        m = m_new
    ctx = acc / l.transpose(1, 2)[..., None]
    return _rows_einsum("bshc,chv->bshv", ctx, w_v, rb, shared_b=True)
