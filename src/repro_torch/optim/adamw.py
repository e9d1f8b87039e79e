"""AdamW for LoRA adapter trees (port of ``repro.optim.adamw``; the
backbone is frozen and has no state).

Moments are f32 whatever the parameter dtype.  ``step`` may be a per-job
vector of shape (K,) instead of a scalar; bias correction (and a per-job
lr, if the schedule gives one) then broadcasts over the job axis.  Two
leaf layouts:

  * stacked ``(..., K, d, r_pad)`` / ``(..., K, r_pad, d)`` — the job
    axis is -3 and the (K,) step broadcasts as (K, 1, 1);
  * packed ragged ``(..., d, R)`` / ``(..., R, d)`` with per-adapter
    rank segments (core/lora.RankLayout) — pass ``col_jobs`` (the
    layout's packed-column -> job map) and the per-job step is gathered
    per COLUMN, along the rank axis of each leaf ("A" leaves carry it
    last, "B" leaves second-to-last).

Trees are nested dicts and lists of tensors.  ``update`` returns new
trees, as the reference does; it runs under ``torch.no_grad``.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.lora import rank_axis_is_last


class AdamWState(NamedTuple):
    step: torch.Tensor   # scalar int32, or (K,) int32 per job
    mu: Any
    nu: Any


def tree_map(fn, *trees, path: Tuple[str, ...] = ()):
    """Map *fn* over the leaves of nested dicts and lists (a tuple is a
    leaf); ``fn`` gets the leaf's key path first."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees), path=path + (k,))
                for k in t0}
    if isinstance(t0, list):
        return [tree_map(fn, *(t[i] for t in trees), path=path + (str(i),))
                for i in range(len(t0))]
    return fn(path, *trees)


def init(params, per_job: Optional[int] = None) -> AdamWState:
    """per_job=K builds a (K,) step vector for per-job accounting; pair it
    with ``update(col_jobs=...)`` for packed ragged leaves."""
    zeros = lambda _, p: torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)
    dev = next(iter(tree_leaves(params))).device
    step = (torch.zeros((), dtype=torch.int32, device=dev) if per_job is None
            else torch.zeros((per_job,), dtype=torch.int32, device=dev))
    return AdamWState(step, tree_map(zeros, params), tree_map(zeros, params))


def tree_leaves(tree):
    """The leaves of nested dicts and lists, in ``tree_map`` order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def _col_broadcast(vec: torch.Tensor, col_jobs: torch.Tensor,
                   a_leaf: bool) -> torch.Tensor:
    """Per-job (K,) -> per packed column, on the leaf's rank axis: (R,)
    for A leaves (last axis), (R, 1) for B leaves."""
    cols = vec[col_jobs]
    return cols if a_leaf else cols[:, None]


@torch.no_grad()
def update(grads, state: AdamWState, params, *, lr, b1: float = 0.9,
           b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
           col_jobs: Optional[np.ndarray] = None
           ) -> Tuple[Any, AdamWState]:
    step = state.step + 1
    s = step.float()
    # a scalar lr stays on the host: a CPU scalar multiplies a device
    # tensor without a host-to-device copy (which would synchronize)
    lr_t = torch.as_tensor(lr, dtype=torch.float32)
    if lr_t.ndim:
        lr_t = lr_t.to(s.device)
    per_job = s.ndim >= 1
    ragged = per_job and col_jobs is not None
    if per_job and not ragged:                 # stacked per-job leaves
        s = s.reshape(s.shape + (1, 1))
        if lr_t.ndim >= 1:
            lr_t = lr_t.reshape(lr_t.shape + (1, 1))
    cj = (torch.as_tensor(col_jobs if isinstance(col_jobs, torch.Tensor)
                          else np.asarray(col_jobs), dtype=torch.long,
                          device=s.device) if ragged else None)

    def upd(path, g, m, v, p):
        s_leaf, lr_leaf = s, lr_t
        if ragged:
            a = rank_axis_is_last(path[-1])
            s_leaf = _col_broadcast(s, cj, a)
            if lr_t.ndim >= 1:
                lr_leaf = _col_broadcast(lr_t, cj, a)
        g = g.float()
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mhat = m / (1 - b1 ** s_leaf)
        vhat = v / (1 - b2 ** s_leaf)
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()
        return (p.float() - lr_leaf * delta).to(p.dtype), m, v

    flat = tree_map(upd, grads, state.mu, state.nu, params)
    pick = lambda i: tree_map(lambda _, t: t[i], flat)
    return pick(0), AdamWState(step, pick(1), pick(2))
