"""Name-driven parameter sharding rules (port of
``repro.sharding.rules``, without JAX).

Rules are keyed by a leaf's *name* (its last dict key) and apply to the
trailing dims, right-aligned: leading stack axes (the cycle axis, an
adapter's K) stay unsharded.  An axis that does not divide its dim is
dropped (smollm's 15 heads, ...).  A spec is a plain tuple of mesh axis
names, one entry a dim (a name, a tuple of names, or None), trailing
Nones trimmed: the reference's ``PartitionSpec`` as a tuple.

Weight layout: up-projections shard the output dim over "model",
down-projections the input dim (Megatron 1-D tensor parallelism: the
activation stays sharded through the pair, one all-reduce after the
down-projection).  MoE expert stacks shard the expert dim (expert
parallelism), embeddings the vocab dim, the router and the norms
replicate; LoRA adapters and their optimizer state replicate.  The
dry-run layout adds a "data" axis on the other matmul dim (FSDP); the
executing runtime drops it (``runtime_param_specs``, the reference's
``runtime_param_shardings``): Megatron 1-D TP x DP.

``shard_params`` cuts a backbone tree to one model rank's slices under
the runtime specs (the placement GSPMD makes of
``runtime_param_shardings`` in the reference), except that where the
model axis is wider than the kv heads (m a multiple of KV) a rank's
wk/wv/bk/bv are its one kv head whole, shared by m / KV ranks: the
rules' m-way split of those columns would cut a head.

Caches: ``cache_specs`` are the reference's ``_cache_spec`` /
``cache_shardings`` over the ``init_caches`` structure (the dry-run
layout: batch over the batch axes, kv heads over "model", or, where
"model" does not divide them, the head dim); ``runtime_cache_specs`` is
the layout the port's serve steps execute: the batch over ("pod",
"data") where it divides, kv heads over "model" where m divides them,
else ``KVShare`` (each rank one head whole).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

# leaf-name -> (trailing-dims spec), applied right-aligned.
# "M" = model axis, "D" = data axis (FSDP-style second weight axis),
# "B" = batch axes (pod, data), None = replicated.
W_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    # embeddings / heads
    "embed": ("M", "D"),
    "head": ("D", "M"),
    "frontend": ("D", "M"),
    # attention
    "wq": ("D", "M"), "wk": ("D", "M"), "wv": ("D", "M"),
    "wo": ("M", "D"),
    "bq": ("M",), "bk": ("M",), "bv": ("M",),
    # MLA
    "w_kv_a": ("D", "M"), "w_kv_b": ("D", "M"),
    # dense FFN
    "gate": ("D", "M"), "up": ("D", "M"), "down": ("M", "D"),
    # MoE: expert dim sharded (expert parallelism) + d over data
    "router": (None, None),
    "w_in": ("M", "D", None), "w_out": ("M", None, "D"),
    # SSD (mamba2): w_in/w_out shadowed by the MoE names; SSD's are 2-D
    "conv_w": (None, "M"),
    # RG-LRU
    "w_x": ("D", "M"), "w_gate": ("D", "M"),
    "w_a": ("D", "M"), "w_i": ("D", "M"),
}
# the tags the executing runtime drops (rows over "data" are manual)
RUNTIME_DROP = ("D", "B")

Spec = Tuple[Any, ...]


def _resolve(axis_sizes, tag) -> Tuple[str, ...]:
    if tag == "M":
        return ("model",) if "model" in axis_sizes else ()
    if tag == "D":
        return ("data",) if "data" in axis_sizes else ()
    if tag == "B":
        return tuple(a for a in ("pod", "data") if a in axis_sizes)
    return ()


def spec_of_shape(axis_sizes, shape: Sequence[int],
                  tags: Sequence) -> Spec:
    """Right-aligned *tags* over *shape* -> spec tuple, dropping an axis
    that does not divide its dim (the reference's ``_spec``)."""
    entries = [None] * len(shape)
    for i, tag in enumerate(tags):
        dim_idx = len(shape) - len(tags) + i
        if dim_idx < 0 or tag is None:
            continue
        axes = _resolve(axis_sizes, tag)
        if not axes:
            continue
        size = math.prod(axis_sizes.get(a, 1) for a in axes)
        if shape[dim_idx] % size == 0 and shape[dim_idx] > 0:
            entries[dim_idx] = axes if len(axes) > 1 else axes[0]
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def leaf_spec(axis_sizes, path: Sequence[str], shape: Sequence[int],
              drop: Tuple[str, ...] = ()) -> Spec:
    """The spec of the leaf at key *path* (its dict keys and list
    indices as strings) of *shape*: named by its last dict key; an
    SSD block's ``w_in``/``w_out`` are 2-D tensor-parallel projections,
    not expert stacks."""
    name = next((k for k in reversed(path) if not k.isdigit()), "")
    tags = W_RULES.get(name)
    if name in ("w_in", "w_out") and "ssd" in path:
        tags = ("D", "M") if name == "w_in" else ("M", "D")
    if tags is None:
        return ()
    if drop:
        tags = tuple(None if t in drop else t for t in tags)
    return spec_of_shape(axis_sizes, shape, tags)


def _is_shape(x) -> bool:
    return isinstance(x, (tuple, torch.Size)) and all(
        isinstance(v, int) for v in x)


def _walk(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_shape(tree):
        return [_walk(v, fn, path + (str(i),)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf) if _is_shape(leaf) else tuple(leaf.shape)


def param_specs(axis_sizes, params, *, drop: Tuple[str, ...] = ()) -> Any:
    """Spec tree of a backbone tree (tensors, ``meta`` tensors, or shape
    tuples as leaves) against a ``{axis_name: size}`` geometry.  MoE
    ``w_in``/``w_out`` are 3-D (E, d, f) stacks -> expert parallel; SSD's
    are 2-D -> tensor parallel.  ``drop`` removes rule tags
    (``drop=("D", "B")``: the executing runtime's pure TP specs)."""
    return _walk(params, lambda path, leaf: leaf_spec(
        axis_sizes, path, _shape(leaf), drop))


def runtime_param_specs(axis_sizes, params) -> Any:
    """The executing runtime's placement: the same rules with the data
    and batch tags dropped (Megatron 1-D TP x DP)."""
    return param_specs(axis_sizes, params, drop=RUNTIME_DROP)


@dataclass(frozen=True)
class KVShare:
    """A runtime spec entry for a kv-heads dim the model axis is wider
    than (m a multiple of KV): each rank holds one head whole, rank i
    head i // (m / KV), so m / KV ranks share it."""
    axis: str = "model"


def local_shape(shape: Sequence[int], spec: Spec, axis_sizes) -> Tuple[int, ...]:
    """One rank's share of *shape* under *spec*."""
    out = list(shape)
    for i, entry in enumerate(spec):
        if isinstance(entry, KVShare):
            out[i] = 1
            continue
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        out[i] //= math.prod(axis_sizes.get(a, 1) for a in axes)
    return tuple(out)


# the leaves laid out as kv heads (columns of wk/wv, the biases bk/bv)
KV_LEAVES = ("wk", "wv", "bk", "bv")


def shard_params(params, full, model: int, index: int, *, kv_heads: int):
    """Model rank *index*'s slices (of *model*) of the backbone tree
    *params*, under the runtime specs of the FULL tree *full* (the same
    structure; shapes, ``meta`` tensors or the tensors themselves): a
    leaf split over "model" is cut to its *index*-th contiguous block
    along that dim and copied (no view keeps the whole leaf alive); a
    leaf already of its share's shape is kept as it is, so cutting twice
    is cutting once.  Every other leaf is the caller's, shared.

    ``kv_heads`` (the config's KV, required: attention assumes whole
    heads) with a model axis wider than them (m a multiple of KV):
    ``KV_LEAVES`` are cut to the rank's one kv head whole, head index //
    (m / KV), not to the rules' n/m columns (a slice of a head)."""
    sizes = {"data": 1, "model": int(model)}
    specs = runtime_param_specs(sizes, full)
    shared = 0 < kv_heads < model and model % kv_heads == 0

    def cut(path, leaf):
        spec = _get(specs, path)
        want = _shape(_get(full, path))
        dim = next((i for i, e in enumerate(spec) if e == "model"), None)
        name = next((k for k in reversed(path) if not k.isdigit()), "")
        if shared and name in KV_LEAVES:
            dim, w = len(want) - 1, want[-1] // kv_heads
            start = (index // (model // kv_heads)) * w
        elif dim is None or model == 1:
            return leaf
        else:
            w = want[dim] // model
            start = index * w
        have = tuple(leaf.shape)
        loc = want[:dim] + (w,) + want[dim + 1:]
        if have == loc:
            return leaf
        if have != want:
            raise ValueError(f"{'/'.join(path)}: a leaf of shape {have} is "
                             f"neither the whole {want} nor a model "
                             f"rank's {loc}")
        return leaf.narrow(dim, start, w).clone()
    return _walk(params, cut)


# ------------------------------------------------------------- caches
def _cache_leaf_specs(axis_sizes, cache, lead: tuple, runtime: bool):
    """The specs of one cache namedtuple's leaves (the reference's
    ``_cache_spec``): right-aligned over the trailing dims, *lead* for a
    stacked segment's layer axis.  ``runtime``: the port's executed
    layout (``runtime_cache_specs``)."""
    from repro_torch.models.attention import KVCache
    from repro_torch.models.mla import MLACache
    from repro_torch.models.rglru import RGLRUCache
    from repro_torch.models.ssd import SSDCache
    baxes = tuple(a for a in ("pod", "data") if a in axis_sizes)
    b = (baxes if len(baxes) > 1 else baxes[0]) if baxes else None
    bsz = math.prod(axis_sizes[a] for a in baxes) if baxes else 1
    m = "model" if "model" in axis_sizes else None
    msz = axis_sizes.get("model", 1) if m else 1

    def fit(dim, axis, size):
        return axis if (axis is not None and dim % size == 0) else None

    def mfit(dim):          # the model axis on a non-kv dim
        return None if runtime else fit(dim, m, msz)
    shape = _shape
    if isinstance(cache, KVCache):
        B, _, KV, hd = shape(cache.k)[-4:]
        kv_ax = fit(KV, m, msz)
        if runtime:
            if kv_ax is None and m is not None and msz > 1:
                if msz % KV:
                    raise ValueError(f"a model axis of {msz} neither "
                                     f"divides nor is divided by {KV} kv "
                                     "heads (ROADMAP A4)")
                kv_ax = KVShare()
            hd_ax = None
        else:
            # the reference's head-dim fallback (rules.py:203-207)
            hd_ax = None if kv_ax is not None else fit(hd, m, msz)
        spec = (*lead, fit(B, b, bsz), None, kv_ax, hd_ax)
        return KVCache(spec, spec)
    if isinstance(cache, MLACache):
        B, _, C = shape(cache.latent)[-3:]
        s1 = (*lead, fit(B, b, bsz), None, mfit(C))
        B, _, R = shape(cache.rope)[-3:]
        s2 = (*lead, fit(B, b, bsz), None, mfit(R))
        return MLACache(s1, s2)
    if isinstance(cache, SSDCache):
        B, H, _, _ = shape(cache.state)[-4:]
        s1 = (*lead, fit(B, b, bsz), mfit(H))
        B, _, C = shape(cache.conv)[-3:]
        s2 = (*lead, fit(B, b, bsz), None, mfit(C))
        return SSDCache(s1, s2)
    if isinstance(cache, RGLRUCache):
        B, W = shape(cache.h)[-2:]
        s1 = (*lead, fit(B, b, bsz), mfit(W))
        B, _, W2 = shape(cache.conv)[-3:]
        s2 = (*lead, fit(B, b, bsz), None, mfit(W2))
        return RGLRUCache(s1, s2)
    raise TypeError(type(cache))


def cache_specs(axis_sizes, caches: list, cfg) -> list:
    """Spec tree of an ``init_caches`` structure (``[{str: cache}]`` per
    segment; tensors, ``meta`` tensors or shape tuples as leaves) against
    a ``{axis_name: size}`` geometry: the reference's ``cache_shardings``
    leaf by leaf, each spec its ``PartitionSpec``'s entries as a tuple
    (untrimmed, as it builds them).  A stacked segment's leaves lead with
    an unsharded layer axis; the batch goes over the batch axes and the
    kv heads (MLA's latent and rope dims, SSD's heads, RG-LRU's width)
    over "model", each only where the axis divides the dim; a KV cache
    whose heads "model" does not divide splits its head dim instead."""
    from repro_torch.models.model import segment_plan
    return [{k: _cache_leaf_specs(axis_sizes, v, (None,) if seg.scanned
                                  else (), runtime=False)
             for k, v in seg_c.items()}
            for seg, seg_c in zip(segment_plan(cfg), caches)]


def runtime_cache_specs(axis_sizes, caches: list, cfg) -> list:
    """The layout the port's serve steps execute over a model axis
    (``core/ssm.make_prefill_step(mesh=)``, ``init_decode_caches``), as
    ``runtime_param_specs`` is for params: the batch over ("pod",
    "data") where it divides the rows (else replicated), a KV cache's
    heads over "model" where m divides them, else ``KVShare`` (each rank
    its one head whole); the head dim is never split.  The other mixers'
    caches (MLA, SSD, RG-LRU) keep their batch entry only: those mixers
    are refused under a model axis (ROADMAP A8c)."""
    from repro_torch.models.model import segment_plan
    return [{k: _cache_leaf_specs(axis_sizes, v, (None,) if seg.scanned
                                  else (), runtime=True)
             for k, v in seg_c.items()}
            for seg, seg_c in zip(segment_plan(cfg), caches)]


def _get(tree, path):
    for k in path:
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree

