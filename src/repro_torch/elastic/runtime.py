"""GroupRuntime — one live fused group (port of the single-device subset
of ``repro.elastic.runtime``).

The runtime owns one SSM's training state — frozen backbone, packed
adapter tree, per-job AdamW state, fused batcher, step cache — and
``run(steps)`` advances the whole group in chunks: each chunk stages its
batches on the device in one copy, runs its steps back to back and
reads the metrics back to the host once, at its end.

Not ported yet, and refused where asked for: meshes (ROADMAP queue A,
item 13), the quantized backbone (item 10), AIMD nano-batch adaptation
and nano batches (item 8), and the elastic layer around the runtime —
migration, checkpoints, publishing to a serving pool (item 9).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.jobs import LoRAJobSpec
from repro_torch.core.ssm import NO_MESH, SharedSuperModel
from repro_torch.data.pipeline import FusedBatcher
from repro_torch.optim import adamw
from repro_torch.optim.schedule import constant


@dataclass
class TrainReport:
    steps: int = 0
    samples_per_step: int = 0             # true samples (tile padding excl.)
    losses: List[float] = field(default_factory=list)
    per_job_losses: List[np.ndarray] = field(default_factory=list)
    step_times: List[float] = field(default_factory=list)
    nano_history: List[int] = field(default_factory=list)
    # full metrics of the most recent chunk (host numpy)
    last_metrics: Optional[Dict[str, np.ndarray]] = None

    @property
    def steps_per_sec(self) -> float:
        return 0.0 if not self.step_times else 1.0 / float(
            np.mean(self.step_times[1:] or self.step_times))

    @property
    def samples_per_sec(self) -> float:
        # each step consumes one fused batch of samples_per_step sequences
        return self.steps_per_sec * max(self.samples_per_step, 1)

    @property
    def last_step_time(self) -> float:
        return self.step_times[-1] if self.step_times else 0.0

    def measured_step_time(self, window: int = 8) -> float:
        """Robust recent step time: min over the last *window* steps."""
        if not self.step_times:
            return 0.0
        return float(min(self.step_times[-window:]))


def _clone(tree):
    return adamw.tree_map(lambda _, t: t.detach().clone(), tree)


class GroupRuntime:
    """Owns one fused group's live training state; ``run`` is re-entrant."""

    def __init__(self, cfg: ModelConfig, params, specs: Sequence[LoRAJobSpec],
                 adapters, opt_state: adamw.AdamWState, *,
                 lr: float = 1e-3, lr_fn: Optional[Callable] = None,
                 impl: str = "cuda", block_t: int = 128,
                 nano_batches: int = 1, adaptive_nano: bool = False,
                 remat: bool = True, quantize: Optional[str] = None,
                 weight_decay: float = 0.0, chunk_size: int = 4,
                 mesh=None, seed: int = 0, device="cuda"):
        if mesh is not None:
            raise NotImplementedError(NO_MESH)
        if quantize is not None:
            raise NotImplementedError(
                "the quantized backbone is not ported yet (ROADMAP queue A, "
                "item 10; kernel B10)")
        if adaptive_nano:
            raise NotImplementedError(
                "AIMD nano-batch adaptation is not ported yet (ROADMAP "
                "queue A, item 8)")
        self.cfg = cfg
        self.specs = list(specs)
        self.device = torch.device(device)
        self.ssm = SharedSuperModel(cfg, self.specs, impl=impl,
                                    block_t=block_t)
        self.batcher = FusedBatcher(self.specs, cfg.vocab_size,
                                    block_t=block_t, seed=seed)
        # own (copy) the trainable state: the caller's trees stay as given
        self.params = params
        self.adapters = _clone(adapters)
        self.opt_state = adamw.AdamWState(opt_state.step.clone(),
                                          _clone(opt_state.mu),
                                          _clone(opt_state.nu))
        self.steps_done: Dict[str, int] = {s.job_id: 0 for s in self.specs}
        self.lr_fn = lr_fn or constant(lr)
        self.remat = remat
        self.weight_decay = weight_decay
        self.n = nano_batches
        self.chunk_size = max(1, chunk_size)
        self._step_cache: Dict[tuple, Callable] = {}
        self.report = TrainReport(
            samples_per_step=sum(s.batch_size for s in self.specs))

    @classmethod
    def from_specs(cls, cfg: ModelConfig, specs: Sequence[LoRAJobSpec], *,
                   params=None, adapters=None, seed: int = 0,
                   device="cuda", **kw) -> "GroupRuntime":
        """Fresh fused init from seeded generators on *device*; pre-built
        params/adapters (e.g. carried across from numpy) are used when
        given."""
        if params is None or adapters is None:
            probe = SharedSuperModel(cfg, list(specs),
                                     impl=kw.get("impl", "cuda"),
                                     block_t=kw.get("block_t", 128))
            p, a = probe.init(seed=seed, device=device)
            params = params if params is not None else p
            adapters = adapters if adapters is not None else a
        opt_state = adamw.init(adapters, per_job=len(specs))
        return cls(cfg, params, specs, adapters, opt_state, seed=seed,
                   device=device, **kw)

    @property
    def job_ids(self) -> List[str]:
        return [s.job_id for s in self.specs]

    def _get_step(self, n: int, chunk: int) -> Callable:
        """The chunked step for (nano_batches, chunk length)."""
        key = (n, chunk)
        if key not in self._step_cache:
            self._step_cache[key] = self.ssm.make_train_step(
                lr_fn=self.lr_fn, nano_batches=n, remat=self.remat,
                weight_decay=self.weight_decay, steps=chunk)
        return self._step_cache[key]

    def _stage(self, n: int) -> Dict[str, torch.Tensor]:
        """The next *n* fused batches on the device, one copy per key."""
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.batcher.next_batches(n).items()}

    def run_chunk(self, length: int,
                  log: Optional[Callable[[str], None]] = None
                  ) -> TrainReport:
        """Run one chunk of *length* steps and fold its metrics into the
        report: one host read per chunk."""
        log = log or (lambda s: None)
        rep = self.report
        L = int(length)
        staged = self._stage(L)
        step_fn = self._get_step(self.n, L)
        t0 = time.perf_counter()
        self.adapters, self.opt_state, metrics = step_fn(
            self.params, self.adapters, self.opt_state, staged)
        host = {k: v.detach().cpu().numpy() for k, v in metrics.items()}
        dt = (time.perf_counter() - t0) / L
        losses = np.atleast_1d(np.asarray(host["loss"], np.float64))
        rep.last_metrics = host
        rep.steps += L
        rep.losses.extend(losses.tolist())
        rep.per_job_losses.extend(np.atleast_2d(host["per_job_loss"]))
        rep.step_times.extend([dt] * L)
        rep.nano_history.extend([self.n] * L)
        for jid in self.job_ids:
            self.steps_done[jid] += L
        log(f"steps {rep.steps - L:4d}..{rep.steps - 1:4d} "
            f"loss {losses[-1]:.4f} nano {self.n} dt {dt*1e3:.1f}ms/step")
        return rep

    def run(self, steps: int, log: Optional[Callable[[str], None]] = None,
            chunk_size: Optional[int] = None) -> TrainReport:
        """Advance the whole group by *steps* fused iterations, in chunks
        of ``chunk_size``.  A remainder shorter than a chunk runs one step
        at a time; a call with steps < chunk runs as one chunk of its own
        length (the reference's chunk schedule)."""
        chunk = max(1, chunk_size or self.chunk_size)
        L = min(chunk, steps)
        done = 0
        while done < steps:
            self.run_chunk(L, log=log)
            done += L
            remaining = steps - done
            L = chunk if remaining >= chunk else min(1, remaining)
        return self.report
