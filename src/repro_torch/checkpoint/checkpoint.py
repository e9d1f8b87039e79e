"""Per-job adapter slicing (port of ``_flatten`` / ``slice_job`` from
``repro.checkpoint.checkpoint``).  A job's slices are keyed by adapter
tree path and hold only its ``rank`` live lanes."""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.core.lora import rank_axis_is_last


def _flatten(tree, prefix="") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def slice_job(adapters: dict, offset: int, rank: int) -> dict:
    """Extract a job's un-padded slices from the packed stack: leaves
    {"A": (..., d, R), "B": (..., R, d)}, the job owning ``rank`` packed
    columns/rows from its RankLayout column *offset*."""
    def f(name, leaf):
        if rank_axis_is_last(name):
            return leaf[..., :, offset:offset + rank]
        return leaf[..., offset:offset + rank, :]
    return {k: f(k, v) for k, v in _flatten(adapters).items()}
