"""Lossless state migration for elastic regrouping (port of
``repro.elastic.migrate``, paper §3.2/§3.4).

A job's complete training identity is a ``JobTrainState``: its un-padded
adapter slices, its AdamW moments over exactly those slices, its per-job
Adam step (the bias-correction position), its live data stream (the rng
position: the data half of losslessness) and its lifetime step count.

``fuse_states`` packs any set of such states into one group's PACKED
RAGGED adapter tree and optimizer state (core/lora.RankLayout): each job
copies into its own padded segment, so fusing beside a wider-rank member
never re-pads anyone to the group max.  The kernels' rank mask keeps the
padding lanes' gradients, and so their Adam moments, at zero, so pack ->
train -> unpack -> re-pack is exact.

The portable slices are host-resident CPU tensors, so a state moves
between runtimes on any device.  Between processes (the ranks of a
partitioned pool, ``cluster/controller``) it moves whole by
``broadcast_states``: ``pack_states`` lays every slice of a list of
states end to end in one flat tensor beside a small picklable header
(specs, keys, shapes, dtypes, Adam steps, step counts, data streams),
and ``unpack_states`` rebuilds them bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import (CheckpointCorrupt, insert_job,
                                               load_job, load_meta,
                                               restore_stream_state,
                                               slice_job)
from repro_torch.configs.base import ModelConfig
from repro_torch.core.jobs import LoRAJobSpec
from repro_torch.core.lora import RankLayout
from repro_torch.data.pipeline import JobStream
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamWState


def _to_host(flat: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu").clone() for k, v in flat.items()}


@dataclass
class JobTrainState:
    """One job's portable training state (adapter + optimizer + data)."""
    spec: LoRAJobSpec
    adapter: Dict[str, torch.Tensor]  # flat tree path -> un-padded slice
    mu: Dict[str, torch.Tensor]       # AdamW first moments, same keying
    nu: Dict[str, torch.Tensor]       # AdamW second moments
    opt_step: int = 0                 # per-job Adam step (bias correction)
    steps_done: int = 0               # lifetime train steps (accounting)
    stream: Optional[JobStream] = None

    @classmethod
    def fresh(cls, spec: LoRAJobSpec, cfg: ModelConfig, init_seed: int, *,
              r_pad: Optional[int] = None, seed: int = 0
              ) -> "JobTrainState":
        """Standard LoRA init for a newly submitted job, held portably.

        The adapter is drawn by ``models.model.init_adapters`` from the
        port's seeded generators (``init_seed``), where the reference
        draws from a JAX key: the distributions are the reference's, the
        draws are not.  ``r_pad`` (default ``pad_rank(rank)``) sets the
        init scale 1/r_pad, as in the reference; ``seed`` seeds the data
        stream."""
        adapters = M.init_adapters(cfg, [spec.rank], seed=init_seed,
                                   r_pad=r_pad, device="cpu")
        flat = _to_host(slice_job(adapters, 0, spec.rank))
        return cls(spec=spec, adapter=flat,
                   mu={k: torch.zeros_like(v) for k, v in flat.items()},
                   nu={k: torch.zeros_like(v) for k, v in flat.items()},
                   opt_step=0, steps_done=0,
                   stream=JobStream(spec, cfg.vocab_size, seed))

    @classmethod
    def from_checkpoint(cls, path: str, spec: LoRAJobSpec,
                        cfg: ModelConfig, *, seed: int = 0
                        ) -> "JobTrainState":
        """Rehydrate a job from its per-job ``.npz`` checkpoint (written by
        this package or by the reference).  The data-stream position
        saved by ``GroupRuntime.save_checkpoints`` resumes the exact token
        sequence; a checkpoint without it starts a fresh stream."""
        z = load_job(path)
        saved_id = str(np.asarray(z["__job_id__"]))
        assert saved_id == spec.job_id, (saved_id, spec.job_id)
        assert int(z["__rank__"]) == spec.rank, (int(z["__rank__"]),
                                                 spec.rank)

        def part(prefix):
            return {k[len(prefix):]: torch.from_numpy(np.array(v, np.float32))
                    for k, v in z.items() if k.startswith(prefix)}
        adapter, mu, nu = part("adapter/"), part("mu/"), part("nu/")
        if not (adapter and mu and nu):
            raise CheckpointCorrupt(
                path, "lacks adapter slices or optimizer moments")
        meta = load_meta(z)
        opt_step = int(z["__step__"])
        stream = JobStream(spec, cfg.vocab_size, seed)
        if "stream" in meta:
            restore_stream_state(stream, str(meta["stream"]))
        return cls(spec=spec, adapter=adapter, mu=mu, nu=nu,
                   opt_step=opt_step,
                   steps_done=int(meta.get("steps_done", opt_step)),
                   stream=stream)


def zeros_like_fused(cfg: ModelConfig, layout: RankLayout,
                     device="cpu") -> dict:
    """All-zero adapter tree with the destination group's ragged shapes
    (``models.model.init_adapters``'s tree, without drawing it)."""
    R = layout.total
    segs = []
    for seg in M.segment_plan(cfg):
        tree = {}
        for j, spec in enumerate(seg.specs):
            blk = {t: {"A": torch.zeros((seg.repeats, d_in, R),
                                        device=device),
                       "B": torch.zeros((seg.repeats, R, d_out),
                                        device=device)}
                   for t, (d_in, d_out) in M._lora_dims(cfg, spec).items()}
            tree[str(j)] = blk if seg.scanned else M._unstack(blk)
        segs.append(tree)
    return {"segments": segs}


def fuse_states(cfg: ModelConfig, states: Sequence[JobTrainState],
                layout: RankLayout, device="cpu") -> Tuple[dict, AdamWState]:
    """Pack K job states into one ragged fused adapter tree + AdamW state
    on *device*.  Each job copies into its OWN padded segment, lanes
    beyond its rank stay zero; the Adam step is the per-job vector
    ``[s.opt_step for s in states]``."""
    assert layout.num_jobs == len(states)
    assert layout.ranks == tuple(s.spec.rank for s in states), \
        (layout.ranks, [s.spec.rank for s in states])
    adapters = zeros_like_fused(cfg, layout, device)
    mu = nu = adapters
    for idx, s in enumerate(states):
        off, r_cap = layout.slice_of(idx)
        adapters = insert_job(adapters, off, s.spec.rank, s.adapter, r_cap)
        mu = insert_job(mu, off, s.spec.rank, s.mu, r_cap)
        nu = insert_job(nu, off, s.spec.rank, s.nu, r_cap)
    step = torch.tensor([s.opt_step for s in states], dtype=torch.int32,
                        device=device)
    return adapters, AdamWState(step, mu, nu)


def unfuse_state(adapters: dict, opt_state: AdamWState, idx: int,
                 spec: LoRAJobSpec, *, layout: RankLayout,
                 steps_done: int = 0,
                 stream: Optional[JobStream] = None) -> JobTrainState:
    """Extract job *idx* from a ragged fused stack into portable form (the
    inverse of ``fuse_states`` for one member).  Slices come back as host
    copies, so the state is device-neutral and later training of the
    stack cannot change it."""
    step = opt_state.step
    opt_step = int(step[idx]) if step.ndim >= 1 else int(step)
    off, _ = layout.slice_of(idx)
    return JobTrainState(
        spec=spec,
        adapter=_to_host(slice_job(adapters, off, spec.rank)),
        mu=_to_host(slice_job(opt_state.mu, off, spec.rank)),
        nu=_to_host(slice_job(opt_state.nu, off, spec.rank)),
        opt_step=opt_step, steps_done=steps_done, stream=stream)


def diff_grouping(old: Sequence[Sequence[str]],
                  new: Sequence[Sequence[str]]
                  ) -> Dict[str, List[Tuple[str, ...]]]:
    """Classify a regroup decision: which groups survive verbatim (no
    migration, runtime reused) and which must be (re)built."""
    old_sets = {frozenset(g) for g in old}
    keep, build = [], []
    for g in new:
        (keep if frozenset(g) in old_sets else build).append(tuple(g))
    new_sets = {frozenset(n) for n in new}
    dissolved = [tuple(g) for g in old if frozenset(g) not in new_sets]
    return {"keep": keep, "build": build, "dissolve": dissolved}


_PARTS = ("adapter", "mu", "nu")


def pack_states(states: Sequence[JobTrainState]
                ) -> Tuple[List[dict], torch.Tensor]:
    """(headers, flat): every slice of *states* in one flat float32
    tensor, in (state, part, key) order, and per state a header with
    what ``unpack_states`` needs to cut it back out (f32 holds every
    slice dtype the fused trees use, bf16 included, exactly)."""
    heads, flat = [], []
    for st in states:
        layout = []
        for part in _PARTS:
            for k, t in getattr(st, part).items():
                layout.append((part, k, tuple(t.shape), t.dtype))
                flat.append(t.detach().reshape(-1).to("cpu", torch.float32))
        heads.append({"spec": st.spec, "layout": layout,
                      "opt_step": st.opt_step, "steps_done": st.steps_done,
                      "stream": st.stream})
    return heads, (torch.cat(flat) if flat else torch.zeros(0))


def unpack_states(heads: Sequence[dict], flat: torch.Tensor
                  ) -> List[JobTrainState]:
    """The inverse of ``pack_states``: fresh host tensors, owned."""
    out, at = [], 0
    for h in heads:
        parts = {p: {} for p in _PARTS}
        for part, k, shape, dtype in h["layout"]:
            n = int(np.prod(shape)) if shape else 1
            parts[part][k] = flat[at:at + n].reshape(shape).to(dtype).clone()
            at += n
        out.append(JobTrainState(spec=h["spec"], opt_step=h["opt_step"],
                                 steps_done=h["steps_done"],
                                 stream=h["stream"], **parts))
    return out


def broadcast_states(states: Optional[Sequence[JobTrainState]], src: int,
                     group) -> List[JobTrainState]:
    """*states*, held by global rank *src*, on every rank of *group*
    (collective: every rank of the group calls it; the others pass
    None).  The header goes as a pickled object, the slices as one
    float32 tensor on the host (gloo).  *src* gets its own objects
    back."""
    import torch.distributed as dist
    mine = dist.get_rank() == src
    heads, flat = pack_states(states) if mine else (None, None)
    box = [(heads, int(flat.numel())) if mine else None]
    dist.broadcast_object_list(box, src=src, group=group)
    heads, n = box[0]
    if not mine:
        flat = torch.empty(n, dtype=torch.float32)
    dist.broadcast(flat, src=src, group=group)
    return list(states) if mine else unpack_states(heads, flat)
