"""Logical sharding axes (port of the device-free part of
``repro.sharding.specs``).

The reference's model code calls ``shard(x, "batch", None, "tp")`` with
*logical* axis names; ``logical_to_mesh`` maps them onto the mesh and
``spec_for`` drops axes that do not divide the corresponding dim.  Here
both work on a plain ``{axis_name: size}`` geometry (insertion order is
the mesh's axis order) and return tuples.  The reference's active-mesh
context (``use_mesh``) becomes two arguments: ``manual``, the axes that
are manual inside a surrounding ``shard_map`` (dropped from the
resolution), and ``seq_over_batch`` (the "seq" axis over "data").

Logical axes:
  "batch"  -> ("pod", "data") on multi-pod meshes, ("data",) single-pod
  "seq"    -> ("data",) with ``seq_over_batch``
  "sp"     -> ("data",) with ``seq_over_batch``, then "model"
  "tokens" -> the batch axes and "model" (MoE dispatch)
  "tp", "expert" -> ("model",)

The ``shard`` constraints themselves are layout for GSPMD, not function:
the port's tensor-parallel layers place their tensors explicitly
(``models/layers.ModelAxis``).
"""
from __future__ import annotations

import math
from typing import Any, Sequence, Tuple, Union

LogicalAxis = Union[None, str, Tuple[str, ...]]


def logical_to_mesh(axis_sizes, name: LogicalAxis, *,
                    manual: Tuple[str, ...] = (),
                    seq_over_batch: bool = False) -> Tuple[str, ...]:
    if name is None:
        return ()
    if isinstance(name, tuple):
        out: Tuple[str, ...] = ()
        for n in name:
            out = out + logical_to_mesh(axis_sizes, n, manual=manual,
                                        seq_over_batch=seq_over_batch)
        return out
    axes = tuple(a for a in axis_sizes if a not in manual)
    if name == "batch":
        return tuple(a for a in ("pod", "data") if a in axes)
    if name == "seq":
        return ("data",) if ("data" in axes and seq_over_batch) else ()
    if name == "sp":
        out = ()
        if "data" in axes and seq_over_batch:
            out += ("data",)
        if "model" in axes:
            out += ("model",)
        return out
    if name == "tokens":
        return tuple(a for a in ("pod", "data", "model") if a in axes)
    if name in ("tp", "expert"):
        return ("model",) if "model" in axes else ()
    if name in axes:          # raw mesh axis passthrough
        return (name,)
    return ()


def spec_for(axis_sizes, shape: Sequence[int],
             axes: Sequence[LogicalAxis], **kw) -> Tuple[Any, ...]:
    """A spec tuple for *shape* over logical *axes*, dropping an axis
    that does not divide its dim (``kw``: ``logical_to_mesh``'s)."""
    entries = []
    for dim, name in zip(shape, axes):
        mesh_axes = logical_to_mesh(axis_sizes, name, **kw)
        size = math.prod(axis_sizes[a] for a in mesh_axes) if mesh_axes \
            else 1
        if mesh_axes and dim % size == 0 and dim > 0:
            entries.append(mesh_axes if len(mesh_axes) > 1
                           else mesh_axes[0])
        else:
            entries.append(None)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def batch_specs(axis_sizes, batch: dict, *, seq_axis: bool = False) -> dict:
    """Fused-batch inputs (the reference's ``batch_shardings``): rows
    over (pod, data); else, with *seq_axis*, the sequence over data
    (sequence parallelism for batch=1 long context)."""
    baxes = tuple(a for a in ("pod", "data") if a in axis_sizes)
    size = math.prod(axis_sizes[a] for a in baxes)

    def rule(shape):
        entries = [None] * len(shape)
        if baxes and shape[0] % size == 0:
            entries[0] = baxes if len(baxes) > 1 else baxes[0]
        elif (seq_axis and len(shape) >= 2 and "data" in axis_sizes
                and shape[1] % axis_sizes["data"] == 0):
            entries[1] = "data"
        while entries and entries[-1] is None:
            entries.pop()
        return tuple(entries)
    return {k: rule(tuple(v) if isinstance(v, tuple) else tuple(v.shape))
            for k, v in batch.items()}
