"""Per-job checkpoints (port of ``repro.checkpoint.checkpoint``).

A fused group trains one packed ragged adapter tree; checkpoints stay
*per job*, so a job can leave a group, resume in another one (at another
K, offset or padding) or ship its adapter.  Each job's un-padded (A, B)
slices and Adam moments are saved, keyed by adapter tree path; jobs are
addressed by their packed column offset (``RankLayout.offsets``), so
extraction and re-insertion copy the job's own segment only.

Format: one ``.npz`` per job, the same file as the reference writes:
``adapter/<path>``, ``mu/<path>``, ``nu/<path>`` f32 arrays,
``__step__`` (the job's Adam step), ``__rank__``, ``__job_id__`` and
``__meta_<key>__`` entries (scalars and strings, among them the data
stream's numpy bit-generator state as JSON).  A checkpoint written by
either package loads in the other.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.lora import rank_axis_is_last
from repro_torch.optim.adamw import AdamWState


class CheckpointCorrupt(RuntimeError):
    """A checkpoint file is truncated, unreadable, or missing required
    payload.  ``save_job`` writes atomically, so the previous good file
    survives a crash mid-save: a corrupt file means this restore fails,
    not that the job's state is lost."""

    def __init__(self, path: str, reason: str):
        super().__init__(f"corrupt checkpoint {path}: {reason}")
        self.path = path
        self.reason = reason


# keys every job checkpoint must carry to be restorable at all
_REQUIRED_KEYS = ("__step__", "__rank__", "__job_id__")


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


def _unflatten_into(template, flat: Dict[str, torch.Tensor], prefix=""):
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}/")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        seq = [_unflatten_into(v, flat, f"{prefix}{i}/")
               for i, v in enumerate(template)]
        return type(template)(seq) if isinstance(template, tuple) else seq
    return flat[prefix[:-1]]


def _as_tensor(v, like: torch.Tensor) -> torch.Tensor:
    """A saved slice (numpy or tensor) as a tensor shaped for *like*."""
    if isinstance(v, np.ndarray):
        v = torch.from_numpy(np.array(v, np.float32))   # writable copy
    return v.to(device=like.device, dtype=like.dtype)


def _host(t) -> np.ndarray:
    """A slice as a host f32 numpy array (the file's dtype)."""
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float32).numpy()
    return np.asarray(t, np.float32)


def slice_job(adapters: dict, offset: int, rank: int) -> dict:
    """Extract a job's un-padded slices from the packed stack: leaves
    {"A": (..., d, R), "B": (..., R, d)}, the job owning ``rank`` packed
    columns/rows from its RankLayout column *offset*."""
    def f(name, leaf):
        if rank_axis_is_last(name):
            return leaf[..., :, offset:offset + rank]
        return leaf[..., offset:offset + rank, :]
    return {k: f(k, v) for k, v in _flatten(adapters).items()}


def insert_job(adapters: dict, offset: int, rank: int, flat_slices: dict,
               r_cap: int) -> dict:
    """Write a job's saved slices back into a packed stack (re-fuse) and
    return the new stack; the given one is not modified.

    Slices are un-padded, so re-padding is writing the first ``rank``
    lanes of the destination segment at *offset*; the lanes beyond stay
    zero (the kernels' rank mask gives them zero gradient).  ``r_cap``,
    the destination segment's padded width, is required: the leaf shape
    alone cannot tell this job's lanes from its neighbour's."""
    assert rank <= r_cap, \
        f"cannot insert rank-{rank} job into a {r_cap}-lane segment"
    out = {}
    for k, leaf in _flatten(adapters).items():
        a_leaf = rank_axis_is_last(k)
        width = leaf.shape[-1] if a_leaf else leaf.shape[-2]
        assert offset + rank <= width, \
            f"rank-{rank} insert at offset {offset} overruns R={width} ({k})"
        new = leaf.detach().clone()
        s = _as_tensor(flat_slices[k], new)
        if a_leaf:
            new[..., :, offset:offset + rank] = s
        else:
            new[..., offset:offset + rank, :] = s
        out[k] = new
    return _unflatten_into(adapters, out)


def stream_state(stream) -> str:
    """A JobStream's rng position as JSON: the data half of the lossless
    contract (a restored job sees the tokens it would have seen)."""
    return json.dumps(stream._rng.bit_generator.state)


def restore_stream_state(stream, state: str):
    """Move a fresh JobStream to a serialized rng position."""
    stream._rng.bit_generator.state = json.loads(state)
    return stream


def save_job(path: str, job_id: str, offset: int, rank: int,
             adapters: dict, opt_state: Optional[AdamWState] = None,
             step: int = 0, meta: Optional[dict] = None):
    """Persist the adapter (and Adam moments) of the job at packed
    *offset* to ``path``.  ``meta`` entries land as ``__meta_<key>__``
    arrays (scalars and strings only, no pickling)."""
    payload = {f"adapter/{k}": _host(v)
               for k, v in slice_job(adapters, offset, rank).items()}
    if opt_state is not None:
        payload.update({f"mu/{k}": _host(v) for k, v in
                        slice_job(opt_state.mu, offset, rank).items()})
        payload.update({f"nu/{k}": _host(v) for k, v in
                        slice_job(opt_state.nu, offset, rank).items()})
    payload["__step__"] = np.asarray(step)
    payload["__rank__"] = np.asarray(rank)
    payload["__job_id__"] = np.asarray(job_id)
    for k, v in (meta or {}).items():
        payload[f"__meta_{k}__"] = np.asarray(v)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    # atomic write: a crash mid-save must never destroy the previous good
    # checkpoint, so the payload lands in a same-directory temp file that
    # only an os.replace (atomic on POSIX) publishes under the real name
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_meta(z: dict) -> dict:
    """The ``meta`` dict a checkpoint was saved with."""
    out = {}
    for k, v in z.items():
        if k.startswith("__meta_") and k.endswith("__"):
            name = k[len("__meta_"):-2]
            out[name] = v.item() if v.ndim == 0 else v
    return out


def load_job(path: str) -> dict:
    """Load a per-job checkpoint as numpy arrays, raising typed errors: a
    missing file stays ``FileNotFoundError``; a truncated or unreadable
    file, or one without the required keys, raises
    ``CheckpointCorrupt``."""
    try:
        with np.load(path, allow_pickle=False) as z:
            out = {k: z[k] for k in z.files}
    except FileNotFoundError:
        raise
    except Exception as e:   # zipfile, numpy and OS errors alike
        raise CheckpointCorrupt(path, repr(e)) from e
    missing = [k for k in _REQUIRED_KEYS if k not in out]
    if missing:
        raise CheckpointCorrupt(path, f"missing required keys {missing}")
    return out


def restore_job(path: str, idx: int, offset: int, adapters: dict,
                opt_state: Optional[AdamWState], r_cap: int
                ) -> Tuple[dict, Optional[AdamWState], int]:
    """Insert a saved job checkpoint at stack slot *idx* / packed column
    *offset* (possibly another slot, K or padding than it was saved
    under).  Returns (adapters, opt_state, the job's Adam step)."""
    z = load_job(path)
    rank = int(z["__rank__"])
    ad = {k[len("adapter/"):]: v for k, v in z.items()
          if k.startswith("adapter/")}
    adapters = insert_job(adapters, offset, rank, ad, r_cap)
    if opt_state is not None:
        mu = {k[3:]: v for k, v in z.items() if k.startswith("mu/")}
        nu = {k[3:]: v for k, v in z.items() if k.startswith("nu/")}
        if mu:
            st = opt_state.step
            if st.ndim >= 1:
                # per-job mode: the restored job resumes at its own Adam
                # step (bias correction continuity across migrations)
                st = st.clone()
                st[idx] = int(z["__step__"])
            opt_state = AdamWState(
                st,
                insert_job(opt_state.mu, offset, rank, mu, r_cap),
                insert_job(opt_state.nu, offset, rank, nu, r_cap))
    return adapters, opt_state, int(z["__step__"])
