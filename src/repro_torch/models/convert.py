"""Carry weights across: nested dicts/lists of numpy arrays (e.g. the
reference's parameter trees exported with ``np.asarray``) -> the port's
trees of tensors, same structure and dtypes.

bfloat16 arrays arrive as ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` rejects; they go through float32 (exact) and back
to ``torch.bfloat16``."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.quant import QuantTensor


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)    # writable copy


def params_from_numpy(tree, device="cuda"):
    """Backbone tree: dicts stay dicts, lists/tuples become lists, arrays
    become tensors on *device* (bf16 weights, f32 norms kept as given),
    and a quantized weight (the reference's ``QuantTensor`` after
    ``jax.tree.map(np.asarray, ...)``) becomes the port's, its int8 codes
    and f32 scales unchanged."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    if hasattr(tree, "q") and hasattr(tree, "scale"):
        # a quantized weight of either package, recognised by its
        # attributes: the port never imports the reference's class
        return QuantTensor(_tensor(tree.q, device),
                           _tensor(tree.scale, device))
    return _tensor(tree, device)


def adapters_from_numpy(tree, device="cuda"):
    """Packed adapter tree: the same conversion; adapters stay f32 and
    are cast to the activation dtype where they are applied."""
    return params_from_numpy(tree, device)


def opt_state_from_numpy(state, device="cuda"):
    """The reference's ``AdamWState`` (step, mu, nu) as numpy trees -> the
    port's ``optim.adamw.AdamWState``: the (K,) per-job step vector as
    int32, f32 moments in the adapter tree's structure."""
    from repro_torch.optim.adamw import AdamWState
    step, mu, nu = state
    return AdamWState(
        torch.as_tensor(np.asarray(step), dtype=torch.int32, device=device),
        params_from_numpy(mu, device), params_from_numpy(nu, device))


def to_numpy(tree):
    """The port's trees (adapters, moments, params) -> nested dicts and
    lists of numpy arrays, for comparison with the reference's trees;
    bf16 tensors come back as exact float32, a ``QuantTensor`` as one
    holding its numpy codes and scales."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    if isinstance(tree, QuantTensor):
        return QuantTensor(to_numpy(tree.q), to_numpy(tree.scale))
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
