"""Model assembly, forward, loss and decode (port of
``repro.models.model`` for the decoder families whose blocks are "attn"
or "local_attn" (sliding window, ring caches), "ssd" (Mamba-2) or
"rglru" (Griffin's recurrence), each with a "swiglu" FFN or none).

A config's ``layer_pattern`` resolves into per-layer ``LayerSpec``s,
segmented into ``[unrolled head] + [cycles] + [unrolled remainder]``.
The parameter trees keep the reference's structure — ``segments/i/j/
attn/wq`` with the cycle segment's leaves stacked on a leading
``n_cycles`` axis — so weights carry across (models/convert.py).  The
reference scans the cycles with ``lax.scan``; here they are a Python
loop over that axis, and ``remat`` (the reference's ``jax.checkpoint``
of each cycle) wraps each cycle in ``torch.utils.checkpoint``.  Frozen
backbone params and the packed ragged adapter tree are separate trees,
as in the reference.  A backbone tree may hold int8 ``QuantTensor``s
(models/quant.py); the tree walks slice their codes and scales together.
Caches (KV, ring, SSD and RG-LRU state) are layer-stacked per segment
and written IN PLACE through each layer's slice: the blocks return the
cache they were given, and the segment loop keeps no other copy.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (FULL_ATTN, LOCAL_ATTN, RGLRU, SSD,
                                      ModelConfig)
from repro_torch.core.lora import MultiLoRA, RankLayout, init_adapter_pair
from repro_torch.models.attention import KVCache, attn_block, attn_init
from repro_torch.models.layers import (cross_entropy, dense, dense_init,
                                       dtype_of, embed_init, rms_norm,
                                       swiglu, swiglu_init)
from repro_torch.models.quant import QuantTensor
from repro_torch.models.rglru import RGLRUCache, rglru_block, rglru_init
from repro_torch.models.ssd import SSDCache, ssd_block, ssd_init


# ----------------------------------------------------------------- specs
@dataclass(frozen=True)
class LayerSpec:
    mixer: str        # "attn" | "local_attn" | "mla" | "ssd" | "rglru"
    ffn: str          # "swiglu" | "moe" | "none"

    @property
    def lora_targets(self) -> Tuple[str, ...]:
        return {
            "attn": ("q", "k", "v", "o"),
            "local_attn": ("q", "k", "v", "o"),
            "mla": ("q", "kv_a", "o"),
            "ssd": ("ssd_in", "ssd_out"),
            "rglru": ("rg_in", "rg_gate", "rg_out"),
        }[self.mixer]


@dataclass(frozen=True)
class Segment:
    specs: Tuple[LayerSpec, ...]   # one cycle
    repeats: int                   # n_cycles
    scanned: bool


def layer_specs(cfg: ModelConfig) -> List[LayerSpec]:
    specs = []
    for i, kind in enumerate(cfg.layer_kinds()):
        if kind in (FULL_ATTN, LOCAL_ATTN):
            mixer = "mla" if cfg.use_mla else (
                "local_attn" if kind == LOCAL_ATTN else "attn")
        elif kind == SSD:
            mixer = "ssd"
        elif kind == RGLRU:
            mixer = "rglru"
        else:
            raise ValueError(kind)
        if mixer == "ssd":
            ffn = "none"
        elif cfg.num_experts and i >= cfg.first_k_dense:
            ffn = "moe"
        else:
            ffn = "swiglu"
        specs.append(LayerSpec(mixer, ffn))
    return specs


def segment_plan(cfg: ModelConfig) -> List[Segment]:
    """Head (first_k_dense) unrolled, then scanned cycles + remainder."""
    specs = layer_specs(cfg)
    segs: List[Segment] = []
    head = cfg.first_k_dense
    if head:
        segs.append(Segment(tuple(specs[:head]), 1, False))
        specs = specs[head:]
    cl = len(cfg.layer_pattern)
    n_full = len(specs) // cl
    if n_full:
        segs.append(Segment(tuple(specs[:cl]), n_full, True))
    rem = specs[n_full * cl:]
    if rem:
        segs.append(Segment(tuple(rem), 1, False))
    return segs


# Where each mixer/FFN family that the port does not run yet is queued.
OTHER_FAMILIES = "ROADMAP queue A: the other model families"
_NOT_PORTED = {
    "mla": f"models/mla.py ({OTHER_FAMILIES})",
    "moe": f"models/moe.py ({OTHER_FAMILIES})",
}


def _check_ported(spec: LayerSpec) -> None:
    for part in (spec.mixer, spec.ffn):
        if part in _NOT_PORTED:
            raise NotImplementedError(
                f"{part!r} is not in the port yet: {_NOT_PORTED[part]}")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family in ("audio", "vlm") or cfg.frontend_dim:
        raise NotImplementedError(
            f"modality front ends are not in the port yet ({OTHER_FAMILIES})")
    for spec in layer_specs(cfg):
        _check_ported(spec)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (KVCache, SSDCache, RGLRUCache)):
        return type(tree)(*(fn(t) for t in tree))
    if isinstance(tree, QuantTensor):
        # codes and scales share the leading (layer) axes: slice together
        return QuantTensor(fn(tree.q), fn(tree.scale))
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


# ----------------------------------------------------------------- init
def _block_init(cfg: ModelConfig, spec: LayerSpec, layers: int, *,
                generator: torch.Generator, device) -> dict:
    _check_ported(spec)
    dt = dtype_of(cfg)
    kw = dict(generator=generator, device=device, layers=layers)
    p: Dict[str, Any] = {"ln1": torch.zeros((layers, cfg.d_model),
                                            device=device)}
    if spec.mixer in ("attn", "local_attn"):
        p["attn"] = attn_init(cfg, dt, **kw)
    elif spec.mixer == "ssd":
        p["ssd"] = ssd_init(cfg, dt, **kw)
    else:
        p["rg"] = rglru_init(cfg, dt, **kw)
    if spec.ffn != "none":        # mixer-only blocks (mamba2) have no ln2
        p["ln2"] = torch.zeros((layers, cfg.d_model), device=device)
        p["ffn"] = swiglu_init(cfg.d_model, cfg.d_ff, dt, **kw)
    return p


def _unstack(tree):
    """Drop the leading layer axis of an unrolled segment's leaves."""
    return _tree_map(lambda t: t[0], tree)


def init_model(cfg: ModelConfig, *, seed: int = 0,
               device="cuda") -> dict:
    """Frozen backbone parameter tree, drawn on *device* from a seeded
    ``torch.Generator`` (the reference's distributions, not its draws)."""
    _check_family(cfg)
    g = torch.Generator(device=device).manual_seed(seed)
    dt = dtype_of(cfg)
    p: Dict[str, Any] = {
        "embed": embed_init(cfg.vocab_size, cfg.d_model, dt, generator=g,
                            device=device),
        "ln_f": torch.zeros((cfg.d_model,), device=device),
        "segments": [],
    }
    for seg in segment_plan(cfg):
        tree = {}
        for j, spec in enumerate(seg.specs):
            blk = _block_init(cfg, spec, seg.repeats, generator=g,
                              device=device)
            tree[str(j)] = blk if seg.scanned else _unstack(blk)
        p["segments"].append(tree)
    if not cfg.tie_embeddings:
        p["head"] = dense_init(cfg.d_model, cfg.vocab_size, dt, generator=g,
                               device=device)[0]
    return p


def _lora_dims(cfg: ModelConfig, spec: LayerSpec
               ) -> Dict[str, Tuple[int, int]]:
    """(d_in, d_out) of every LoRA target of a *spec* layer, every mixer
    family included (the reference's ``_block_adapter_init`` table)."""
    dims = dict(q=(cfg.d_model, cfg.q_dim), k=(cfg.d_model, cfg.kv_dim),
                v=(cfg.d_model, cfg.kv_dim), o=(cfg.q_dim, cfg.d_model),
                ssd_in=(cfg.d_model, 2 * cfg.ssm_d_inner
                        + 2 * 8 * cfg.ssm_state + cfg.ssm_nheads),
                ssd_out=(cfg.ssm_d_inner, cfg.d_model),
                rg_in=(cfg.d_model, cfg.lru_width),
                rg_gate=(cfg.d_model, cfg.lru_width),
                rg_out=(cfg.lru_width, cfg.d_model))
    if spec.mixer == "mla":
        qk = cfg.qk_nope_dim + cfg.qk_rope_dim
        dims.update(q=(cfg.d_model, cfg.num_heads * qk),
                    kv_a=(cfg.d_model, cfg.kv_lora_rank + cfg.qk_rope_dim),
                    o=(cfg.num_heads * cfg.v_head_dim, cfg.d_model))
    return {t: dims[t] for t in spec.lora_targets}


def adapter_param_count(cfg: ModelConfig, ranks: Sequence[int]) -> int:
    """Exact trainable-parameter count (un-padded ranks), for every
    family the configs name: the pricing needs no ported layers."""
    total = 0
    for seg in segment_plan(cfg):
        for spec in seg.specs:
            for d_in, d_out in _lora_dims(cfg, spec).values():
                total += seg.repeats * sum(int(r) * (d_in + d_out)
                                           for r in ranks)
    return total


def init_adapters(cfg: ModelConfig, ranks: Sequence[int], *, seed: int = 0,
                  r_pad: Optional[int] = None,
                  layout: Optional[RankLayout] = None,
                  device="cuda") -> dict:
    """Adapter tree mirroring the segment structure, leaves packed ragged
    — (n_cycles, d, R)/(n_cycles, R, d), R = Σ_k r_pad_k — per *layout*
    (default: per-adapter ``pad_rank``; ``r_pad`` forces a uniform
    width).  A ~ N(0, 1/r_pad_k) with dead lanes zero, B = 0."""
    _check_family(cfg)
    if layout is None:
        rk = tuple(int(r) for r in ranks)
        layout = RankLayout.uniform(rk, r_pad) if r_pad else RankLayout(rk)
    segs = []
    for i, seg in enumerate(segment_plan(cfg)):
        seg_tree = {}
        for j, spec in enumerate(seg.specs):
            blk = {}
            dims = _lora_dims(cfg, spec)
            for t in spec.lora_targets:
                # one generator per (segment, layer, target), seeded by a
                # stable crc32 of its path: a leaf's draw does not depend
                # on which other leaves exist
                key = zlib.crc32(f"{seed}/{i}/{j}/{t}".encode())
                g = torch.Generator(device=device).manual_seed(key)
                blk[t] = init_adapter_pair(layout, *dims[t], generator=g,
                                           layers=seg.repeats,
                                           device=device)
            seg_tree[str(j)] = blk if seg.scanned else _unstack(blk)
        segs.append(seg_tree)
    return {"segments": segs}


# ----------------------------------------------------------------- caches
def init_block_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     buf: int, ring: bool, layers: Optional[int] = None,
                     device="cuda"):
    """One layer's (or a stack's) cache: attention keeps a full KV cache
    of *buf* keys, or a ring of ``min(buf, sliding_window)`` slots for a
    local-attention layer or when *ring* is asked for; the recurrent
    mixers keep their state and conv tail."""
    _check_ported(spec)
    if spec.mixer in ("attn", "local_attn"):
        is_ring = ring or spec.mixer == "local_attn"
        b = min(buf, cfg.sliding_window) if is_ring else buf
        return KVCache.init(batch, b, cfg.num_kv_heads, cfg.head_dim,
                            dtype_of(cfg), layers=layers, device=device,
                            ring=is_ring)
    if spec.mixer == "ssd":
        return SSDCache.init(batch, cfg, layers=layers, device=device)
    return RGLRUCache.init(batch, cfg, layers=layers, device=device)


def init_caches(cfg: ModelConfig, batch: int, buf: int, ring: bool = False,
                *, device="cuda") -> list:
    """Per-segment cache stacks matching segment_plan structure."""
    caches = []
    for seg in segment_plan(cfg):
        seg_c = {}
        for j, spec in enumerate(seg.specs):
            seg_c[str(j)] = init_block_cache(
                cfg, spec, batch, buf, ring,
                layers=seg.repeats if seg.scanned else None, device=device)
        caches.append(seg_c)
    return caches


# ----------------------------------------------------------------- blocks
def apply_block(cfg: ModelConfig, spec: LayerSpec, p: dict, ad: dict,
                lora: Optional[MultiLoRA], x: torch.Tensor, positions,
                cache, cache_pos, row_block: Optional[int] = None,
                ring: bool = False):
    """One pre-norm block. Returns (x, cache); the cache is updated in
    place.  A local-attention layer with a cache decodes through a ring
    whatever *ring* says, as in the reference.  ``row_block``: rows per
    dense product of the attention and FFN blocks (``layers.dense``; the
    serving engine's decode, which takes no recurrent mixer)."""
    _check_ported(spec)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if spec.mixer in ("attn", "local_attn"):
        local = spec.mixer == "local_attn"
        out, cache = attn_block(cfg, p["attn"], h, positions=positions,
                                lora=lora, lora_ab=ad, cache=cache,
                                cache_pos=cache_pos, local=local,
                                ring=ring or (local and cache is not None),
                                row_block=row_block)
    elif spec.mixer == "ssd":
        out, cache = ssd_block(cfg, p["ssd"], h, lora=lora, lora_ab=ad,
                               cache=cache)
    else:
        out, cache = rglru_block(cfg, p["rg"], h, lora=lora, lora_ab=ad,
                                 cache=cache)
    x = x + out
    if spec.ffn == "none":
        return x, cache
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + swiglu(p["ffn"], h2, row_block), cache


def _apply_segment(cfg, seg: Segment, p: dict, ad: dict,
                   lora: Optional[MultiLoRA], x, positions, caches,
                   cache_pos, remat: bool = False,
                   row_block: Optional[int] = None, ring: bool = False):
    """Apply one segment; caches are updated in place.  ``remat``
    recomputes each cycle of a scanned segment in the backward instead of
    keeping its activations (the reference's ``jax.checkpoint``)."""
    def cycle(x, layer_p, layer_ad, layer_c):
        for j, spec in enumerate(seg.specs):
            c = layer_c.get(str(j)) if layer_c else None
            x, _ = apply_block(cfg, spec, layer_p[str(j)],
                               layer_ad.get(str(j), {}), lora, x, positions,
                               c, cache_pos, row_block=row_block, ring=ring)
        return x

    if not seg.scanned:
        return cycle(x, p, ad, caches)
    for i in range(seg.repeats):
        sl = lambda t: _tree_map(lambda v: v[i], t)
        if remat:
            x = checkpoint(cycle, x, sl(p), sl(ad), None,
                           use_reentrant=False)
        else:
            x = cycle(x, sl(p), sl(ad), sl(caches) if caches else None)
    return x


# ----------------------------------------------------------------- forward
def _logits(cfg, params, x, row_block: Optional[int] = None):
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    return dense(x, head, row_block)


def forward(cfg: ModelConfig, params: dict, adapters: Optional[dict],
            lora: Optional[MultiLoRA], batch: dict, *,
            caches: Optional[list] = None, cache_pos=None,
            remat: bool = False, row_block: Optional[int] = None,
            ring: bool = False) -> torch.Tensor:
    """Token-input model forward.  Returns logits (B, S, vocab).

    ``cache_pos``: None (no caches), an int, or a per-row (B,) tensor
    (batched serving decode: every request at its own depth).  ``remat``
    (training, no caches) recomputes each layer cycle in the backward.
    ``row_block``: rows per dense product and per decode-attention chunk
    product (``layers.dense``; the serving decode path on the card).
    ``ring``: every attention cache is a ring (the sliding-window
    serving variant); local-attention caches are rings regardless."""
    assert not (remat and caches is not None), "remat is for training"
    _check_family(cfg)
    tokens = batch["tokens"]
    x = params["embed"][tokens.long()]
    B, S, _ = x.shape
    ar = torch.arange(S, device=x.device)
    if isinstance(cache_pos, torch.Tensor) and cache_pos.ndim == 1:
        positions = cache_pos.long()[:, None] + ar[None, :]
    else:
        positions = ((cache_pos or 0) + ar)[None, :].expand(B, S)

    ad_segs = (adapters["segments"] if adapters
               else [{} for _ in segment_plan(cfg)])
    for i, seg in enumerate(segment_plan(cfg)):
        c = caches[i] if caches is not None else None
        x = _apply_segment(cfg, seg, params["segments"][i], ad_segs[i], lora,
                           x, positions, c, cache_pos, remat=remat,
                           row_block=row_block, ring=ring)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return _logits(cfg, params, x, row_block)


def loss_fn(cfg: ModelConfig, params: dict, adapters: dict,
            lora: Optional[MultiLoRA], batch: dict, *, remat: bool = True,
            per_job_denom: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Per-job-separated LM loss over a fused batch (lossless contract).

    Each job's loss is normalized over *its own* token count
    (``per_job_denom``, the full batch's, when given), so the gradient
    w.r.t. job j's adapter is the one training j alone gives.  Returns
    (total = Σ_j loss_j, {"per_job", "aux", "per_job_count"})."""
    logits = forward(cfg, params, adapters, lora, batch, remat=remat)
    labels = batch["labels"]
    if cfg.causal:
        logits = logits[:, :-1]
        labels = labels[:, 1:]
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = mask[:, -labels.shape[-1]:]
    tok_loss = cross_entropy(logits, labels, mask=mask)         # (B, S')
    seq_loss = tok_loss.sum(dim=-1)                             # (B,)
    seq_count = (torch.full(seq_loss.shape, float(labels.shape[-1]),
                            device=seq_loss.device)
                 if mask is None else mask.float().sum(-1))
    aux = torch.zeros((), device=seq_loss.device)    # no MoE: no aux
    if lora is not None:
        onehot = F.one_hot(lora.adapter_ids.long(),
                           lora.num_adapters).float()              # (B, K)
        denom = (per_job_denom if per_job_denom is not None
                 else (onehot.T @ seq_count).clamp_min(1))
        per_job = (onehot.T @ seq_loss) / denom
        return per_job.sum() + aux, {"per_job": per_job, "aux": aux,
                                     "per_job_count": onehot.T @ seq_count}
    total = seq_loss.sum() / seq_count.sum().clamp_min(1) + aux
    return total, {"per_job": total[None], "aux": aux}


def decode_step(cfg: ModelConfig, params: dict, adapters: Optional[dict],
                lora: Optional[MultiLoRA], token: torch.Tensor, pos,
                caches: list, row_block: Optional[int] = None,
                ring: bool = False):
    """One decode step. token: (B, 1..S) int; pos: int position or a
    per-row (B,) tensor (full caches only).  Returns (logits (B, S, V),
    caches).  ``row_block``: rows per dense and chunk product; ``ring``:
    as ``forward``."""
    logits = forward(cfg, params, adapters, lora, {"tokens": token},
                     caches=caches, cache_pos=pos, row_block=row_block,
                     ring=ring)
    return logits, caches
