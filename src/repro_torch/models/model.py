"""Model assembly, forward, loss and decode (port of
``repro.models.model``): every family of the registry — blocks of "attn"
or "local_attn" (sliding window, ring caches), "mla" (latent attention,
absorbed decode), "ssd" (Mamba-2) or "rglru" (Griffin's recurrence), each
with a "swiglu" or "moe" FFN or none, and the audio and VLM front ends
(``embed_inputs``: projected frames plus a sinusoid, or projected
patches before the text).

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
from repro_torch.models.layers import (ModelAxis, cross_entropy, dense,
                                       dense_init, dtype_of, embed_init,
                                       rms_norm, swiglu, swiglu_init,
                                       vocab_cross_entropy)
from repro_torch.models.mla import MLACache, mla_block, mla_init
from repro_torch.models.moe import moe_ffn, moe_init
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


def mixer_runs_whole(cfg: ModelConfig, mixer: str, model: int) -> bool:
    """Whether a *mixer* layer runs whole on every rank of a model axis
    of *model* ranks: where the axis would split a head.  Attention:
    query heads the axis does not divide, or kv heads it neither divides
    nor is a multiple of (where m is a multiple of KV, m / KV ranks hold
    the same kv head); MLA: its heads; SSD: its heads, or B/C groups it
    neither divides nor is a multiple of; RG-LRU: its channels.  The
    reference's rules cut such a layer's weights through a head where
    the dim divides; the port keeps its weights, LoRA deltas and caches
    whole on every rank, and it makes no collective (its input, the
    residual stream, is the same on every rank)."""
    if model <= 1:
        return False
    H, KV = cfg.num_heads, cfg.num_kv_heads
    if mixer in ("attn", "local_attn"):
        return bool(H % model or (KV % model and model % KV))
    if mixer == "mla":
        return bool(H % model)
    if mixer == "ssd":
        from repro_torch.models.ssd import NGROUPS
        return bool(cfg.ssm_nheads % model
                    or (NGROUPS % model and model % NGROUPS))
    return bool(cfg.lru_width % model)


def whole_mixers(cfg: ModelConfig, model: int) -> Tuple[str, ...]:
    """The mixer kinds of *cfg* that run whole over a model axis of
    *model* ranks (``mixer_runs_whole``), sorted."""
    return tuple(sorted({s.mixer for s in layer_specs(cfg)
                         if mixer_runs_whole(cfg, s.mixer, model)}))


def mixer_axis(cfg: ModelConfig, mixer: str, tp: Optional[ModelAxis]
               ) -> Optional[ModelAxis]:
    """*tp* for a mixer the axis splits, None for one that runs whole."""
    if tp is None or mixer_runs_whole(cfg, mixer, tp.size):
        return None
    return tp


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


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (KVCache, MLACache, SSDCache, RGLRUCache)):
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
    dt = dtype_of(cfg)
    kw = dict(generator=generator, device=device, layers=layers)
    p: Dict[str, Any] = {"ln1": torch.zeros((layers, cfg.d_model),
                                            device=device)}
    if spec.mixer in ("attn", "local_attn"):
        p["attn"] = attn_init(cfg, dt, **kw)
    elif spec.mixer == "mla":
        p["attn"] = mla_init(cfg, dt, **kw)
    elif spec.mixer == "ssd":
        p["ssd"] = ssd_init(cfg, dt, **kw)
    else:
        p["rg"] = rglru_init(cfg, dt, **kw)
    if spec.ffn != "none":        # mixer-only blocks (mamba2) have no ln2
        p["ln2"] = torch.zeros((layers, cfg.d_model), device=device)
        p["ffn"] = (moe_init(cfg, dt, **kw) if spec.ffn == "moe"
                    else swiglu_init(cfg.d_model, cfg.d_ff, dt, **kw))
    return p


def _unstack(tree):
    """Drop the leading layer axis of an unrolled segment's leaves."""
    return _tree_map(lambda t: t[0], tree)


def init_model(cfg: ModelConfig, *, seed: int = 0,
               device="cuda") -> dict:
    """Frozen backbone parameter tree, drawn on *device* from a seeded
    ``torch.Generator`` (the reference's distributions, not its draws).
    A config with a front end (audio frames, VLM patches) gets its
    ``frontend`` projection (frontend_dim, d_model).  On ``device="meta"``
    the tree holds shapes only (no generator, nothing allocated): a
    full-size config's structure for the sharding rules."""
    g = (None if torch.device(device).type == "meta"
         else torch.Generator(device=device).manual_seed(seed))
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
    if cfg.frontend_dim:
        # modality-frontend stub: project precomputed embeddings to d_model
        p["frontend"] = dense_init(cfg.frontend_dim, cfg.d_model, dt,
                                   generator=g, device=device)[0]
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
    width).  A ~ N(0, 1/r_pad_k) with dead lanes zero, B = 0.  On
    ``device="meta"`` the tree holds shapes only, as ``init_model``'s."""
    meta = torch.device(device).type == "meta"
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
                g = (None if meta else
                     torch.Generator(device=device).manual_seed(key))
                blk[t] = init_adapter_pair(layout, *dims[t], generator=g,
                                           layers=seg.repeats,
                                           device=device)
            seg_tree[str(j)] = blk if seg.scanned else _unstack(blk)
        segs.append(seg_tree)
    return {"segments": segs}


# ----------------------------------------------------------------- caches
def init_block_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     buf: int, ring: bool, layers: Optional[int] = None,
                     device="cuda", tp: Optional[ModelAxis] = None):
    """One layer's (or a stack's) cache: attention keeps a full KV cache
    of *buf* keys, or a ring of ``min(buf, sliding_window)`` slots for a
    local-attention layer or when *ring* is asked for; MLA keeps its
    latent and rope key, *buf* wide (whole decode chunks) or a ring of
    ``min(buf, sliding_window)`` slots; the recurrent mixers keep their
    state and conv tail.  Under ``tp`` an attention cache holds the
    rank's kv heads (``ModelAxis.kv_local``), a recurrent mixer's its
    heads or channels; MLA's latent cache stays whole, and so does the
    cache of a mixer that runs whole (``mixer_runs_whole``)."""
    tp = mixer_axis(cfg, spec.mixer, tp)
    if spec.mixer == "mla":
        b = min(buf, cfg.sliding_window) if ring else buf
        return MLACache.init(batch, b, cfg, dtype_of(cfg), layers=layers,
                             device=device, ring=ring)
    if spec.mixer in ("attn", "local_attn"):
        is_ring = ring or spec.mixer == "local_attn"
        b = min(buf, cfg.sliding_window) if is_ring else buf
        kv = (cfg.num_kv_heads if tp is None
              else tp.kv_local(cfg.num_kv_heads))
        return KVCache.init(batch, b, kv, cfg.head_dim, dtype_of(cfg),
                            layers=layers, device=device, ring=is_ring)
    if spec.mixer == "ssd":
        return SSDCache.init(batch, cfg, layers=layers, device=device, tp=tp)
    return RGLRUCache.init(batch, cfg, layers=layers, device=device, tp=tp)


def init_caches(cfg: ModelConfig, batch: int, buf: int, ring: bool = False,
                *, device="cuda", tp: Optional[ModelAxis] = None) -> list:
    """Per-segment cache stacks matching segment_plan structure (under
    ``tp``, this model rank's: its kv heads)."""
    caches = []
    for seg in segment_plan(cfg):
        seg_c = {}
        for j, spec in enumerate(seg.specs):
            seg_c[str(j)] = init_block_cache(
                cfg, spec, batch, buf, ring,
                layers=seg.repeats if seg.scanned else None, device=device,
                tp=tp)
        caches.append(seg_c)
    return caches


# ----------------------------------------------------------------- blocks
def apply_block(cfg: ModelConfig, spec: LayerSpec, p: dict, ad: dict,
                lora: Optional[MultiLoRA], x: torch.Tensor, positions,
                cache, cache_pos, row_block: Optional[int] = None,
                ring: bool = False, tp: Optional[ModelAxis] = None):
    """One pre-norm block. Returns (x, cache, aux); the cache is updated
    in place, aux is the MoE FFN's load-balance loss (0 for the other
    FFNs).  A local-attention layer with a cache decodes through a ring
    whatever *ring* says, as in the reference.  ``row_block``: rows per
    dense product of the blocks (``layers.dense``; the serving decode).
    ``tp``: tensor parallelism over the model axis (every mixer the axis
    does not split through a head, ``mixer_axis``; the MLP where the
    axis divides d_ff, the MoE)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    aux = torch.zeros((), device=x.device)
    ffn_tp, tp = tp, mixer_axis(cfg, spec.mixer, tp)
    if spec.mixer in ("attn", "local_attn"):
        local = spec.mixer == "local_attn"
        out, cache = attn_block(cfg, p["attn"], h, positions=positions,
                                lora=lora, lora_ab=ad, cache=cache,
                                cache_pos=cache_pos, local=local,
                                ring=ring or (local and cache is not None),
                                row_block=row_block, tp=tp)
    elif spec.mixer == "mla":
        out, cache = mla_block(cfg, p["attn"], h, positions=positions,
                               lora=lora, lora_ab=ad, cache=cache,
                               cache_pos=cache_pos, ring=ring,
                               row_block=row_block, tp=tp)
    elif spec.mixer == "ssd":
        out, cache = ssd_block(cfg, p["ssd"], h, lora=lora, lora_ab=ad,
                               cache=cache, row_block=row_block, tp=tp)
    else:
        out, cache = rglru_block(cfg, p["rg"], h, lora=lora, lora_ab=ad,
                                 cache=cache, row_block=row_block, tp=tp)
    x = x + out
    if spec.ffn == "none":
        return x, cache, aux
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    if spec.ffn == "moe":
        # the row blocks reach the shared experts; the expert products
        # group a row with whatever rows routed to the same expert
        out2, aux = moe_ffn(cfg, p["ffn"], h2, row_block=row_block,
                            tp=ffn_tp)
    else:
        out2 = swiglu(p["ffn"], h2, row_block,
                      tp=ffn_tp if ffn_tp is not None
                      and ffn_tp.splits(cfg.d_ff) else None)
    return x + out2, cache, aux


def _apply_segment(cfg, seg: Segment, p: dict, ad: dict,
                   lora: Optional[MultiLoRA], x, positions, caches,
                   cache_pos, remat: bool = False,
                   row_block: Optional[int] = None, ring: bool = False,
                   tp: Optional[ModelAxis] = None):
    """Apply one segment; returns (x, aux summed over its layers); caches
    are updated in place.  ``remat`` recomputes each cycle of a scanned
    segment in the backward instead of keeping its activations (the
    reference's ``jax.checkpoint``); under ``tp`` the recomputation
    makes the forward's collectives again, in the same order on every
    rank."""
    def cycle(x, layer_p, layer_ad, layer_c):
        aux = torch.zeros((), device=x.device)
        for j, spec in enumerate(seg.specs):
            c = layer_c.get(str(j)) if layer_c else None
            x, _, a = apply_block(cfg, spec, layer_p[str(j)],
                                  layer_ad.get(str(j), {}), lora, x,
                                  positions, c, cache_pos,
                                  row_block=row_block, ring=ring, tp=tp)
            aux = aux + a
        return x, aux

    if not seg.scanned:
        return cycle(x, p, ad, caches)
    aux = torch.zeros((), device=x.device)
    for i in range(seg.repeats):
        sl = lambda t: _tree_map(lambda v: v[i], t)
        if remat:
            x, a = checkpoint(cycle, x, sl(p), sl(ad), None,
                              use_reentrant=False)
        else:
            x, a = cycle(x, sl(p), sl(ad), sl(caches) if caches else None)
        aux = aux + a
    return x, aux


# ----------------------------------------------------------------- embed
def _sinusoid(S: int, d: int, offset=0, device=None) -> torch.Tensor:
    pos = (offset + torch.arange(S, device=device))[:, None].float()
    dim = torch.arange(0, d, 2, device=device)[None, :].float()
    ang = pos / torch.pow(10_000.0, dim / d)
    pe = torch.zeros((S, d), device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe


def embed_inputs(cfg: ModelConfig, params: dict, batch: dict,
                 pos_offset=0, tp: Optional[ModelAxis] = None,
                 row_block: Optional[int] = None
                 ) -> Tuple[torch.Tensor, int]:
    """Resolve modality inputs to (B, S, d) activations.  Returns (x,
    text_offset): logits and labels align from text_offset on (the
    patches' count for a VLM batch with patches, else 0).  Under ``tp``
    the front end's projection (frames, patches) is the rank's block of
    its d_model columns gathered whole, where the axis divides d_model,
    and the token lookup the rank's block of the embedding's rows
    (``_embed_ids``), where it divides the vocab.  ``row_block``: rows
    per front-end product (``layers.dense``; the serving path)."""
    dt = dtype_of(cfg)
    if cfg.family == "audio":
        x = _frontend(cfg, params, batch["frames"].to(dt), tp, row_block)
        S = x.shape[1]
        x = x + _sinusoid(S, cfg.d_model, pos_offset,
                          device=x.device).to(dt)[None]
        return x, 0
    if cfg.family == "vlm" and "patches" in batch:
        pe = _frontend(cfg, params, batch["patches"].to(dt), tp, row_block)
        te = _embed_ids(cfg, params, batch["tokens"].long(), tp)
        return torch.cat([pe, te], dim=1), pe.shape[1]
    return _embed_ids(cfg, params, batch["tokens"].long(), tp), 0


def _frontend(cfg: ModelConfig, params: dict, feats: torch.Tensor,
              tp: Optional[ModelAxis],
              row_block: Optional[int] = None) -> torch.Tensor:
    """The front end's projection of precomputed frames or patches; under
    ``tp`` with d_model split, the rank's columns of it, gathered whole
    (the inputs take no gradient: one all-gather)."""
    x = dense(feats, params["frontend"], row_block)
    if tp is not None and tp.splits(cfg.d_model):
        x = tp.whole(x)
    return x


def _embed_ids(cfg: ModelConfig, params: dict, ids: torch.Tensor,
               tp: Optional[ModelAxis]) -> torch.Tensor:
    """The embedding's rows of *ids*; under ``tp`` with a vocab the axis
    divides, the rank holds its block of the rows: its lookup is masked
    to the ids in the block and summed over the axis (exact: one term is
    not zero)."""
    if tp is not None and tp.splits(cfg.vocab_size):
        V = params["embed"].shape[0]
        loc = ids - tp.index * V
        inside = (loc >= 0) & (loc < V)
        x = params["embed"][torch.where(inside, loc, 0)]
        return tp.sum(torch.where(inside[..., None], x, 0).detach())
    return params["embed"][ids]


# ----------------------------------------------------------------- forward
def _logits(cfg, params, x, row_block: Optional[int] = None,
            tp: Optional[ModelAxis] = None, whole: bool = False):
    """The head's logits; under ``tp`` with a vocab the axis divides,
    this rank's vocab block of them (its head columns, or a tied
    embedding's rows), or with *whole* (the serving path) the whole
    vocab on every rank: the blocks in one all-gather."""
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    if tp is not None and tp.splits(cfg.vocab_size):
        y = tp.column(x, head, row_block)
        return tp.whole(y) if whole else y
    return dense(x, head, row_block)


def forward(cfg: ModelConfig, params: dict, adapters: Optional[dict],
            lora: Optional[MultiLoRA], batch: dict, *,
            caches: Optional[list] = None, cache_pos=None,
            remat: bool = False, row_block: Optional[int] = None,
            ring: bool = False, tp: Optional[ModelAxis] = None,
            last: bool = False):
    """Full model.  batch keys: tokens / frames / patches (+ tokens).

    Returns (logits, aux, caches, text_offset), the reference's tuple:
    logits (B, S, vocab) — for a VLM batch with patches S covers patches
    + text (slice from text_offset) —, aux the MoE layers' summed
    load-balance loss, and the caches passed in (updated in place).

    ``cache_pos``: None (no caches), an int, or a per-row (B,) tensor
    (batched serving decode: every request at its own depth; token
    inputs only).  ``remat`` (training, no caches) recomputes each layer
    cycle in the backward.  ``row_block``: rows per dense product and per
    decode-attention chunk product (``layers.dense``; the serving decode
    path on the card).  ``ring``: every attention cache is a ring (the
    sliding-window serving variant); local-attention caches are rings
    regardless.  ``tp``: tensor parallelism over the model axis
    (``apply_block``, ``embed_inputs``, ``_logits``): in training the
    logits are this rank's vocab block, on the serving path (with
    caches) the whole vocab on every rank.  ``last``: the logits of the
    last position only (B, 1, V) (the prefill step under a model axis,
    whose caller reads no other: the head and its gather run on one
    column)."""
    assert not (remat and caches is not None), "remat is for training"
    vec_pos = isinstance(cache_pos, torch.Tensor) and cache_pos.ndim == 1
    if vec_pos and cfg.family == "audio":
        raise ValueError("per-row cache positions need token inputs")
    x, text_off = embed_inputs(cfg, params, batch,
                               pos_offset=0 if vec_pos else cache_pos or 0,
                               tp=tp, row_block=row_block)
    B, S, _ = x.shape
    ar = torch.arange(S, device=x.device)
    if vec_pos:
        positions = cache_pos.long()[:, None] + ar[None, :]
    else:
        positions = ((cache_pos or 0) + ar)[None, :].expand(B, S)

    ad_segs = (adapters["segments"] if adapters
               else [{} for _ in segment_plan(cfg)])
    aux = torch.zeros((), device=x.device)
    for i, seg in enumerate(segment_plan(cfg)):
        c = caches[i] if caches is not None else None
        x, a = _apply_segment(cfg, seg, params["segments"][i], ad_segs[i],
                              lora, x, positions, c, cache_pos, remat=remat,
                              row_block=row_block, ring=ring, tp=tp)
        aux = aux + a
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    if last:
        x = x[:, -1:]
    # serving (caches, or the prefill's last column): the whole vocab
    whole = caches is not None or last
    return (_logits(cfg, params, x, row_block, tp, whole=whole), aux, caches,
            text_off)


def loss_fn(cfg: ModelConfig, params: dict, adapters: dict,
            lora: Optional[MultiLoRA], batch: dict, *, remat: bool = True,
            per_job_denom: Optional[torch.Tensor] = None,
            tp: Optional[ModelAxis] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Per-job-separated LM loss over a fused batch (lossless contract).

    Each job's loss is normalized over *its own* token count
    (``per_job_denom``, the full batch's, when given), so the gradient
    w.r.t. job j's adapter is the one training j alone gives — up to the
    MoE load-balance aux, which the reference adds over the whole fused
    batch (ROADMAP §C).  Logits align with the labels from the text
    offset on (VLM patches carry no labels); an encoder (non-causal)
    predicts every position.  Returns (total = Σ_j loss_j + aux,
    {"per_job", "aux", "per_job_count"}).  ``tp``: tensor parallelism
    (``forward``); every rank of the model axis computes the same
    loss."""
    logits, aux, _, off = forward(cfg, params, adapters, lora, batch,
                                  remat=remat, tp=tp)
    return job_losses(cfg, logits, off, aux, lora, batch, per_job_denom,
                      tp=tp)


def job_losses(cfg: ModelConfig, logits: torch.Tensor, off: int,
               aux: torch.Tensor, lora: Optional[MultiLoRA], batch: dict,
               per_job_denom: Optional[torch.Tensor] = None,
               tp: Optional[ModelAxis] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``loss_fn`` from the logits on: the per-job-separated loss of
    *logits* (text offset *off*, the layers' summed *aux*) against
    *batch*'s labels.  The pipeline step's last stage calls it on the
    logits it computed from the stages' handoff.  Under ``tp`` with a
    vocab the axis divides the logits are the rank's vocab block
    (``layers.vocab_cross_entropy``)."""
    labels = batch["labels"]
    if off:
        logits = logits[:, off:]
    if cfg.causal:
        logits = logits[:, :-1]
        labels = labels[:, 1:]
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = mask[:, -labels.shape[-1]:]
    if tp is not None and tp.splits(cfg.vocab_size):
        tok_loss = vocab_cross_entropy(logits, labels, tp, mask=mask)
    else:
        tok_loss = cross_entropy(logits, labels, mask=mask)     # (B, S')
    seq_loss = tok_loss.sum(dim=-1)                             # (B,)
    seq_count = (torch.full(seq_loss.shape, float(labels.shape[-1]),
                            device=seq_loss.device)
                 if mask is None else mask.float().sum(-1))
    if lora is not None:
        K = lora.num_adapters
        onehot = F.one_hot(lora.adapter_ids.long(), K).float()     # (B, K)
        denom = (per_job_denom if per_job_denom is not None
                 else (onehot.T @ seq_count).clamp_min(1))
        per_job = (onehot.T @ seq_loss) / denom
        total = per_job.sum() + aux
        if lora.group is not None and lora.grad_sync == "gather":
            # sharded exact mode: the gradient flows through the LOCAL
            # partial above (its per-row cotangents are the 1/denom
            # scalars of one device, and the kernels' shard-local
            # backwards make the wgrads exact); the REPORTED per-job
            # losses are recomputed at full shape from the per-row
            # losses gathered in solo row order, as one device sums them
            from repro_torch.kernels.ops import gather_solo
            with torch.no_grad():
                rows = torch.stack([seq_loss, seq_count,
                                    lora.adapter_ids.float()], dim=1)
                g = gather_solo(rows, lora.group, lora.row_solo_pos,
                                sum(lora.solo_rows))
                oh_g = F.one_hot(g[:, 2].long(), K).float()
                per_job = (oh_g.T @ g[:, 0]) / denom
            return total, {"per_job": per_job, "aux": aux,
                           "per_job_count": oh_g.T @ g[:, 1]}
        return total, {"per_job": per_job, "aux": aux,
                       "per_job_count": onehot.T @ seq_count}
    total = seq_loss.sum() / seq_count.sum().clamp_min(1) + aux
    return total, {"per_job": total[None], "aux": aux}


def decode_step(cfg: ModelConfig, params: dict, adapters: Optional[dict],
                lora: Optional[MultiLoRA], token: torch.Tensor, pos,
                caches: list, row_block: Optional[int] = None,
                ring: bool = False, tp: Optional[ModelAxis] = None):
    """One decode step. token: (B, 1..S) int; pos: int position or a
    per-row (B,) tensor (full caches only).  Returns (logits (B, S, V),
    caches).  ``row_block``: rows per dense and chunk product; ``ring``,
    ``tp``: as ``forward`` (the caches the rank's, ``init_caches(tp=)``;
    the logits whole on every rank)."""
    logits, _, caches, _ = forward(cfg, params, adapters, lora,
                                   {"tokens": token}, caches=caches,
                                   cache_pos=pos, row_block=row_block,
                                   ring=ring, tp=tp)
    return logits, caches
