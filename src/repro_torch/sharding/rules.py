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
``runtime_param_shardings`` in the reference), except where the port's
executed layout departs from them (``shard_params`` lists each case):
kv heads shared across ranks, int8 ``QuantTensor`` leaves (cut as the
dense leaf they stand for; the rules replicate their codes and scales),
SSD's segment-wise in-projection and conv channels, MLA's replicated
latent projection, and RG-LRU's row-parallel out-projection and
per-channel vectors.

Caches: ``cache_specs`` are the reference's ``_cache_spec`` /
``cache_shardings`` over the ``init_caches`` structure (the dry-run
layout: batch over the batch axes, kv heads over "model", or, where
"model" does not divide them, the head dim); ``runtime_cache_specs`` is
the layout the port's serve steps execute: the batch over ("pod",
"data") where it divides, kv heads over "model" where m divides them,
else ``KVShare`` (each rank one head whole); SSD state by heads and its
conv tail by the segment-wise channels (``Cut``), RG-LRU state and conv
tail by channels, MLA's latent and rope key whole.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.models.quant import QuantTensor

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


def _walk(tree, fn, path=(), quant_leaf=False):
    """*fn*(path, leaf) over a tree; a ``QuantTensor`` is walked into as
    its codes and scales (named "q" and "scale": no rule names them, as
    the reference's pytree keys), or with *quant_leaf* is one leaf."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (str(k),), quant_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_shape(tree):
        return [_walk(v, fn, path + (str(i),), quant_leaf)
                for i, v in enumerate(tree)]
    if isinstance(tree, QuantTensor) and not quant_leaf:
        return QuantTensor(fn(path + ("q",), tree.q),
                           fn(path + ("scale",), tree.scale))
    return fn(path, tree)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf) if _is_shape(leaf) else tuple(leaf.shape)


def param_specs(axis_sizes, params, *, drop: Tuple[str, ...] = ()) -> Any:
    """Spec tree of a backbone tree (tensors, ``meta`` tensors, or shape
    tuples as leaves) against a ``{axis_name: size}`` geometry.  MoE
    ``w_in``/``w_out`` are 3-D (E, d, f) stacks -> expert parallel; SSD's
    are 2-D -> tensor parallel.  ``drop`` removes rule tags
    (``drop=("D", "B")``: the executing runtime's pure TP specs).  An
    int8 ``QuantTensor`` leaf gets a ``QuantTensor`` of two replicated
    specs, as in the reference (its codes and scales match no rule);
    ``shard_params`` cuts them all the same."""
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


@dataclass(frozen=True)
class Cut:
    """A runtime spec entry for a dim the model axis cuts otherwise than
    into m even blocks (SSD's conv tail: the rank's heads' x channels
    beside its B and C groups, a group shared by m / 8 ranks where m is
    a multiple of 8): each rank holds *width* entries of it."""
    width: int
    axis: str = "model"


def local_shape(shape: Sequence[int], spec: Spec, axis_sizes) -> Tuple[int, ...]:
    """One rank's share of *shape* under *spec*."""
    out = list(shape)
    for i, entry in enumerate(spec):
        if isinstance(entry, KVShare):
            out[i] = 1
            continue
        if isinstance(entry, Cut):
            out[i] = entry.width
            continue
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        out[i] //= math.prod(axis_sizes.get(a, 1) for a in axes)
    return tuple(out)


# the leaves laid out as kv heads (columns of wk/wv, the biases bk/bv)
KV_LEAVES = ("wk", "wv", "bk", "bv")


def _block_of(n: int, model: int, index: int) -> Tuple[slice]:
    w = n // model
    return (slice(index * w, (index + 1) * w),)


def _in_whole_mixer(cfg, path: Sequence[str], model: int) -> bool:
    """Whether *path* lies in a layer's mixer block
    (``segments/i/j/attn|ssd|rg``) that runs whole over *model* ranks
    (``models/model.mixer_runs_whole``)."""
    if len(path) < 4 or path[0] != "segments" or \
            path[3] not in ("attn", "ssd", "rg"):
        return False
    from repro_torch.models.model import mixer_runs_whole, segment_plan
    spec = segment_plan(cfg)[int(path[1])].specs[int(path[2])]
    return mixer_runs_whole(cfg, spec.mixer, model)


def executed_cut(path: Sequence[str], want: Tuple[int, ...], block,
                 model: int, index: int, cfg):
    """(dim, slices) of model rank *index*'s share (of *model*) of the
    leaf at *path* of *cfg*'s backbone, whole shape *want* (*block*: the
    whole tree's dict holding it, for a mixer's widths): the rank holds
    the *slices* of dim *dim*, side by side; None where it holds the
    leaf whole.  The runtime specs' even block of the "model" dim,
    except:

    * kv heads shared across ranks (KV < m, m a multiple of KV):
      wk/wv/bk/bv are the rank's one kv head whole (head index //
      (m / KV)), not the rules' n/m columns (a slice of a head);
    * SSD (``models/ssd.tp_columns``): ``w_in``'s columns segment by
      segment, z and x by the rank's heads, B and C by its groups, dt
      whole (80 columns, replicated: the local width stays a multiple of
      16, which the int8 kernel needs); ``conv_w``'s channels likewise
      (x, B, C); ``A_log``, ``D``, ``dt_bias`` and ``gate_norm`` by heads
      (the rules replicate them; a contiguous m-th of ``w_in`` would give
      rank 0 all of z);
    * MLA's ``w_kv_a`` whole (its 512 latent + 64 rope columns: a
      contiguous block would split the latent that ``kv_norm`` needs
      whole; every rank computes the latent, ``models/mla``);
    * RG-LRU's ``w_out`` by rows (row parallel; the rules replicate it:
      right-aligned, the MoE's three tags give a 2-D leaf no model
      split), and ``lam``, ``b_a``, ``b_i`` by channels (no rule names
      them);
    * a mixer block the axis would split through a head
      (``_in_whole_mixer``) whole, where the rules cut any dim it
      divides (smollm-360m's 960 q columns over 16 ranks cut through its
      15 heads)."""
    name = next((k for k in reversed(path) if not k.isdigit()), "")
    nd = len(want)
    if model == 1 or _in_whole_mixer(cfg, path, model):
        return None
    if "ssd" in path:
        from repro_torch.models.ssd import NGROUPS, tp_columns
        H = _shape(block["A_log"])[-1]
        di = _shape(block["gate_norm"])[-1]
        N = (_shape(block["conv_w"])[-1] - di) // (2 * NGROUPS)
        cols = tp_columns(di, N, H, model, index)
        if name in cols:
            return nd - 1, cols[name]
        if name == "w_out":
            return nd - 2, _block_of(want[-2], model, index)
        return None
    if "rg" in path:
        if name == "w_out":
            return nd - 2, _block_of(want[-2], model, index)
        if name in ("lam", "b_a", "b_i"):
            return nd - 1, _block_of(want[-1], model, index)
    if name == "w_kv_a":
        return None
    kv_heads = cfg.num_kv_heads
    if 0 < kv_heads < model and model % kv_heads == 0 and name in KV_LEAVES:
        w = want[-1] // kv_heads
        start = (index // (model // kv_heads)) * w
        return nd - 1, (slice(start, start + w),)
    spec = leaf_spec({"data": 1, "model": model}, path, want, RUNTIME_DROP)
    dim = next((i for i, e in enumerate(spec) if e == "model"), None)
    if dim is None:
        return None
    return dim, _block_of(want[dim], model, index)


def _take(t: torch.Tensor, dim: int, slices) -> torch.Tensor:
    """The *slices* of *t*'s dim *dim* side by side, a fresh copy (no
    view keeps the whole leaf alive)."""
    parts = [t.narrow(dim, s.start, s.stop - s.start) for s in slices]
    return (parts[0] if len(parts) == 1 else torch.cat(parts, dim)).clone()


def shard_params(params, full, model: int, index: int, *, cfg):
    """Model rank *index*'s slices (of *model*) of the backbone tree
    *params*, under the executed layout (``executed_cut``: the runtime
    specs of the FULL tree *full*, the same structure as dense leaves --
    shapes, ``meta`` tensors or the tensors themselves --, and where the
    port departs from them): a leaf the model axis cuts is cut to the
    rank's columns or rows and copied; a leaf already of its share's
    shape is kept as it is, so cutting twice is cutting once.  Every
    other leaf is the caller's, shared.  An int8 ``QuantTensor`` is cut
    as the dense leaf it stands for: its codes likewise, its scales
    (one a column) with the columns, whole for a row cut.

    ``cfg`` (the backbone's config, required) decides where heads would
    be split: with a model axis wider than its kv heads (m a multiple of
    KV) ``KV_LEAVES`` are cut to the rank's one kv head whole, head
    index // (m / KV), not to the rules' n/m columns (a slice of a
    head); a mixer the axis would split through a head is whole on
    every rank (``models/model.mixer_runs_whole``)."""
    model = int(model)

    def cut(path, leaf):
        want = _shape(_get(full, path))
        how = executed_cut(path, want, _get(full, path[:-1]), model, index,
                           cfg)
        if how is None:
            return leaf
        dim, slices = how
        w = sum(s.stop - s.start for s in slices)
        loc = want[:dim] + (w,) + want[dim + 1:]
        have = tuple(leaf.shape)
        if have == loc:
            return leaf
        if have != want:
            raise ValueError(f"{'/'.join(path)}: a leaf of shape {have} is "
                             f"neither the whole {want} nor a model "
                             f"rank's {loc}")
        if isinstance(leaf, QuantTensor):
            rows = dim == len(want) - 2
            return QuantTensor(_take(leaf.q, dim, slices),
                               leaf.scale if rows else
                               _take(leaf.scale, leaf.scale.ndim - 1,
                                     slices))
        return _take(leaf, dim, slices)
    return _walk(params, cut, quant_leaf=True)


# ------------------------------------------------------------- caches
def _cache_leaf_specs(axis_sizes, cache, lead: tuple, runtime: bool,
                      whole: bool = False):
    """The specs of one cache namedtuple's leaves (the reference's
    ``_cache_spec``): right-aligned over the trailing dims, *lead* for a
    stacked segment's layer axis.  ``runtime``: the port's executed
    layout (``runtime_cache_specs``); ``whole``: a mixer that runs whole
    (its cache split over the batch axes only)."""
    if whole:
        axis_sizes = {a: n for a, n in axis_sizes.items() if a != "model"}
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
            # a model axis that does not divide the kv heads is a multiple
            # of them here: any other runs the attention whole
            if kv_ax is None and m is not None and msz > 1:
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
        B, H, P, N = shape(cache.state)[-4:]
        s1 = (*lead, fit(B, b, bsz), mfit(H) if not runtime else
              fit(H, m, msz))
        B, _, C = shape(cache.conv)[-3:]
        c_ax = mfit(C)
        if runtime and m is not None and msz > 1:
            # the rank's heads' x channels beside its B and C groups
            from repro_torch.models.ssd import tp_columns
            cols = tp_columns(H * P, N, H, msz, 0)["conv_w"]
            c_ax = Cut(sum(c.stop - c.start for c in cols))
        s2 = (*lead, fit(B, b, bsz), None, c_ax)
        return SSDCache(s1, s2)
    if isinstance(cache, RGLRUCache):
        B, W = shape(cache.h)[-2:]
        s1 = (*lead, fit(B, b, bsz), fit(W, m, msz) if runtime else mfit(W))
        B, _, W2 = shape(cache.conv)[-3:]
        s2 = (*lead, fit(B, b, bsz), None,
              fit(W2, m, msz) if runtime else mfit(W2))
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
    its one head whole); the head dim is never split.  SSD's state by
    heads and its conv tail by the rank's channels (``Cut``: its heads'
    x beside its B and C groups, ``models/ssd.tp_columns``); RG-LRU's
    state and conv tail by channels; MLA's latent and rope key whole
    (every rank computes them, ``models/mla``).  A mixer the axis would
    split through a head runs whole (``models/model.mixer_runs_whole``):
    its cache is split over the batch axes only."""
    from repro_torch.models.model import mixer_runs_whole, segment_plan
    m = axis_sizes.get("model", 1)
    return [{k: _cache_leaf_specs(
                axis_sizes, v, (None,) if seg.scanned else (), runtime=True,
                whole=mixer_runs_whole(cfg, seg.specs[int(k)].mixer, m))
             for k, v in seg_c.items()}
            for seg, seg_c in zip(segment_plan(cfg), caches)]


def _get(tree, path):
    for k in path:
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree

