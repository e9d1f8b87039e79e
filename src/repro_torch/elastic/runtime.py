"""GroupRuntime — one live fused group (port of the single-device part of
``repro.elastic.runtime``).

The runtime owns one SSM's training state — frozen backbone, packed
adapter tree, per-job AdamW state, fused batcher, AIMD nano-batch
controller, step cache — and advances the whole group in chunks, each
split in two as in the reference:

  * ``dispatch_chunk`` enqueues every launch of a chunk and returns a
    ``PendingChunk`` whose metrics are still device tensors; it makes no
    synchronizing call.  With ``prefetch`` it then builds the next
    chunk's batches on the host while the device runs this one, and
    stages them from pinned memory by copies that do not wait;
  * ``collect_chunk`` makes the chunk's one host read (the metrics), and
    folds it into the report, feeds AIMD and fires the checkpoint and
    publish hooks.

``run(steps)`` is the loop over the two.  State enters and leaves through
``JobTrainState`` (``elastic/migrate.py``): ``from_states`` fuses
members, ``export`` takes one out, ``refresh_member`` overwrites one with
a fresher export before the first step (the replay-exact handoff),
``save_checkpoints`` writes every member's per-job file and
``publish_to`` hands the adapters to a serving ``AdapterPool``.

``quantize="int8"`` stores the frozen backbone as int8 codes with f32
per-channel scales (models/quant), quantized once, before the step is
built; an already quantized tree (a migrated group reusing its donor's
``QuantTensor``s) passes through unchanged.  Adapters and optimizer
state never quantize.

With a ``mesh`` (``launch/mesh``, a ``torch.distributed`` DeviceMesh)
the group runs data-parallel over the mesh's ranks (``tp_mode="dp"``):
every rank is one process holding the replicated backbone, adapters and
Adam state on its ``device``, builds the same union batch from the same
seeds and stages only its own shard-major slice; the step
(``SharedSuperModel._make_sharded_step``) reduces over the mesh's group.
The ranks agree on every decision that would otherwise diverge: AIMD is
fed the all-reduced max of the ranks' chunk times (the step is
synchronous, so the slowest rank's time is the step's), and checkpoints
and publishes are written by the group's rank 0 alone, behind a barrier
after which every rank can restore them.  The mesh may be a 1-D submesh
over part of the world (the controller's slices, ``launch/mesh
.partition_mesh``): the runtime exists only on its ranks and reduces over
the submesh's group.  ``tp_mode`` "auto" and "pipeline" are refused
(ROADMAP A4, A2).
"""
from __future__ import annotations

import copy
import math
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core.jobs import LoRAJobSpec
from repro_torch.core.nanobatch import AIMDController
from repro_torch.core.ssm import (SharedSuperModel, check_tp_mode,
                                  valid_nano_counts)
from repro_torch.data.pipeline import FusedBatcher, JobStream, frontend_inputs
from repro_torch.elastic.migrate import (JobTrainState, fuse_states,
                                         unfuse_state)
from repro_torch.models import quant
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


@dataclass
class PendingChunk:
    """One dispatched, uncollected chunk.  ``metrics`` are device tensors
    whose computation may still be queued on the device; nothing waits
    for them until ``collect_chunk`` reads them."""
    metrics: Dict[str, torch.Tensor]
    length: int
    t0: float
    count_aimd: bool = True
    # stream rng positions as of this chunk's data (taken before any
    # prefetch advances the batcher): what the checkpoint hook persists,
    # so a restore resumes on exactly the next unseen tokens
    stream_states: Optional[List[str]] = None


def _clone(tree):
    return adamw.tree_map(lambda _, t: t.detach().clone(), tree)


class GroupRuntime:
    """Owns one fused group's live training state; ``run`` is re-entrant."""

    def __init__(self, cfg: ModelConfig, params, specs: Sequence[LoRAJobSpec],
                 adapters, opt_state: adamw.AdamWState, *,
                 streams: Optional[Sequence[JobStream]] = None,
                 steps_done: Optional[Dict[str, int]] = None,
                 lr: float = 1e-3, lr_fn: Optional[Callable] = None,
                 impl: str = "cuda", block_t: int = 128,
                 nano_batches: int = 1, adaptive_nano: bool = False,
                 aimd_max_n: int = 16, nano_order: str = "job",
                 remat: bool = True,
                 quantize: Optional[str] = None, weight_decay: float = 0.0,
                 chunk_size: int = 4, mesh=None, data_axis: str = "data",
                 grad_sync: str = "gather", tp_mode: str = "dp",
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 0,
                 publish_pool=None, publish_every: int = 0,
                 seed: int = 0, device="cuda"):
        check_tp_mode(tp_mode)
        assert nano_order in ("job", "rank_desc"), nano_order
        assert grad_sync in ("gather", "psum"), grad_sync
        self.cfg = cfg
        self.specs = list(specs)
        self.device = torch.device(device)
        # sharded execution: rows over every mesh axis ("dp"), the
        # trainable state replicated on every rank
        self.mesh, self.grad_sync = mesh, grad_sync
        self.tp_mode, self.nano_order = tp_mode, nano_order
        if mesh is not None:
            from repro_torch.launch.mesh import data_group
            if grad_sync == "gather" and impl in ("ref", "loop"):
                # fail at construction, not inside the first step
                raise ValueError(
                    f"impl={impl!r} has no shard-local VJP for exact "
                    "gathered wgrads; use impl='torch'/'cuda' or "
                    "grad_sync='psum'")
            # "dp" carries rows over every axis of the mesh: data_axis
            # only names one that must exist (the reference's argument)
            if data_axis not in mesh.mesh_dim_names:
                raise ValueError(f"data_axis {data_axis!r} is not an axis "
                                 f"of the mesh {mesh.mesh_dim_names}")
            self._group, D, self._shard = data_group(mesh)
        else:
            self._group, D, self._shard = None, 1, 0
        self.data_shards = D
        # the frozen backbone in int8, once, before any step is built
        # (idempotent: a quantized tree's QuantTensors are reused)
        self.quantize = quantize
        params = quant.quantize_params(params, quantize)
        self.ssm = SharedSuperModel(cfg, self.specs, impl=impl,
                                    block_t=block_t, data_shards=D)
        self.batcher = FusedBatcher(self.specs, cfg.vocab_size,
                                    block_t=block_t, seed=seed,
                                    streams=streams, shards=D)
        # this rank's rows of the solo batch, in shard-major order
        self._rows = None
        if mesh is not None:
            from repro_torch.data.pipeline import shard_permutation
            perm = shard_permutation(self.batcher.rows_per_job(), D)
            n = perm.size // D
            self._rows = perm[self._shard * n:(self._shard + 1) * n]
        # an audio or VLM config's front-end stub inputs (frames,
        # patches), drawn from *seed* beside the token streams; they are
        # not part of a job's portable stream state
        self._frontend_rng = (np.random.default_rng(seed)
                              if cfg.family in ("audio", "vlm") else None)
        self._staged_frontend = None
        # own (copy) the trainable state: the caller's trees stay as given
        self.params = params
        self.adapters = _clone(adapters)
        self.opt_state = adamw.AdamWState(opt_state.step.clone(),
                                          _clone(opt_state.mu),
                                          _clone(opt_state.nu))
        self.steps_done: Dict[str, int] = dict(
            steps_done or {s.job_id: 0 for s in self.specs})
        self.lr_fn = lr_fn or constant(lr)
        self.remat = remat
        self.weight_decay = weight_decay
        self.n = nano_batches
        if D > 1:
            # sharded: the job-wise nano split needs N to divide every
            # job's per-shard rows, and for "cuda" to keep every job's
            # per-slice tokens whole tiles (the reference's rule)
            rows_loc = [r // D for r in self.batcher.rows_per_job()]
            nano_rows = math.gcd(*rows_loc)
            legal = valid_nano_counts(
                nano_rows, min(nano_rows, aimd_max_n),
                **(dict(seg_rows=rows_loc, seq_len=self.specs[0].seq_len,
                        block_t=block_t) if impl == "cuda" else {}))
        else:
            # The CUDA kernels need every contiguous nano slice to be
            # whole token tiles, (rows / N) * seq_len % block_t == 0; the
            # legal set keeps only such N (the reference leaves it
            # unfiltered on one device and fails inside the step
            # instead; ROADMAP §C).
            nano_rows = self.batcher.total_rows()
            legal = (valid_nano_counts(nano_rows, min(nano_rows, aimd_max_n),
                                       seg_rows=[nano_rows],
                                       seq_len=self.specs[0].seq_len,
                                       block_t=block_t)
                     if impl == "cuda" else None)
        self.aimd = AIMDController(rows=nano_rows, n=self.n,
                                   max_n=min(nano_rows, aimd_max_n),
                                   legal=legal) if adaptive_nano else None
        self.chunk_size = max(1, chunk_size)
        self._step_cache: Dict[tuple, Callable] = {}
        # periodic per-job checkpoints, every N collected chunks
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = int(checkpoint_every)
        self._chunks_collected = 0
        # steps_done at each member's most recent checkpoint write
        self.last_checkpoint_step: Dict[str, int] = {}
        # live serving publish: every N collected chunks the members'
        # host snapshots go to a serve.AdapterPool at the chunk boundary
        self.publish_pool = publish_pool
        self.publish_every = int(publish_every)
        # the prefetched next chunk, and the stream positions before it,
        # so that discard_staged can un-consume it
        self._staged: Optional[Dict[str, torch.Tensor]] = None
        self._staged_len = 0
        self._staged_rewind: List[str] = []
        self.report = TrainReport(
            samples_per_step=sum(s.batch_size for s in self.specs))

    # ------------------------------------------------------- constructors
    @classmethod
    def from_states(cls, cfg: ModelConfig, params,
                    states: Sequence[JobTrainState], *, seed: int = 0,
                    device="cuda", **kw) -> "GroupRuntime":
        """Fuse K portable job states into a live group on *device*
        (join/migrate): each member copies into its own padded segment,
        keeps its Adam step, its data stream and its step count."""
        specs = [s.spec for s in states]
        probe = SharedSuperModel(cfg, specs, impl=kw.get("impl", "cuda"),
                                 block_t=kw.get("block_t", 128))
        adapters, opt_state = fuse_states(cfg, states, probe.layout,
                                          device=device)
        streams = [s.stream if s.stream is not None
                   else JobStream(s.spec, cfg.vocab_size, seed)
                   for s in states]
        return cls(cfg, params, specs, adapters, opt_state, streams=streams,
                   steps_done={s.spec.job_id: s.steps_done for s in states},
                   seed=seed, device=device, **kw)

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

    # ----------------------------------------------------------- training
    @property
    def job_ids(self) -> List[str]:
        return [s.job_id for s in self.specs]

    def index_of(self, job_id: str) -> int:
        return self.job_ids.index(job_id)

    def _get_step(self, n: int, chunk: int) -> Callable:
        """The chunked step for (nano_batches, chunk length)."""
        key = (n, chunk)
        if key not in self._step_cache:
            self._step_cache[key] = self.ssm.make_train_step(
                lr_fn=self.lr_fn, nano_batches=n, remat=self.remat,
                weight_decay=self.weight_decay, steps=chunk, mesh=self.mesh,
                grad_sync=self.grad_sync, tp_mode=self.tp_mode,
                nano_order=self.nano_order)
        return self._step_cache[key]

    def _stage(self, n: int) -> Dict[str, torch.Tensor]:
        """The next *n* fused batches on the device (leading chunk axis).
        On a CUDA device they go through pinned host memory by copies
        enqueued on the current stream without waiting: behind a running
        chunk, the device takes them when it gets there.  The caching
        host allocator records the copy on the stream and hands the
        pinned block out again only after the copy has completed."""
        batches = self.batcher.next_batches(n)
        if self._frontend_rng is not None:
            batches = frontend_inputs(self.cfg, batches, self._frontend_rng)
        if self._rows is not None:
            # every rank built the same union batch; it stages its rows
            batches = {k: np.ascontiguousarray(v[:, self._rows])
                       for k, v in batches.items()}
        if self.device.type != "cuda":
            return {k: torch.from_numpy(v).to(self.device)
                    for k, v in batches.items()}
        return {k: torch.from_numpy(v).pin_memory().to(self.device,
                                                       non_blocking=True)
                for k, v in batches.items()}

    def dispatch_chunk(self, length: Optional[int] = None, *,
                       prefetch: int = 0,
                       count_aimd: Optional[bool] = None) -> PendingChunk:
        """Enqueue one chunk of *length* steps and return at once.

        Returns when every launch of the chunk is enqueued; the metrics
        stay device tensors until ``collect_chunk``.  A batch staged by
        an earlier ``prefetch`` is consumed when its length matches;
        *prefetch* > 0 builds and stages the NEXT chunk's batches right
        after the launches, so host data work overlaps device compute.

        Collect every pending chunk before ``export`` or migration: the
        adapters are already the in-flight result while ``steps_done``
        lags until collection."""
        from repro_torch.checkpoint.checkpoint import stream_state
        L = int(length or self.chunk_size)
        assert L >= 1
        if self._staged is not None:
            # a mismatched prefetch would orphan stream data the batcher
            # already consumed (the lossless contract's data half): a
            # caller bug, so it fails loudly
            assert self._staged_len == L, (self._staged_len, L)
            staged, self._staged = self._staged, None
        else:
            staged = self._stage(L)
        step_fn = self._get_step(self.n, L)
        t0 = time.perf_counter()
        self.adapters, self.opt_state, metrics = step_fn(
            self.params, self.adapters, self.opt_state, staged)
        # stream positions BEFORE the prefetch: the checkpoint hook fires
        # at collect time, after the prefetch has moved the live streams
        # past data this chunk never trained on
        streams = ([stream_state(s) for s in self.batcher.streams]
                   if self.checkpoint_every else None)
        if prefetch > 0:
            self._staged_rewind = [stream_state(s)
                                   for s in self.batcher.streams]
            self._staged_frontend = self._frontend_mark()
            self._staged = self._stage(prefetch)
            self._staged_len = prefetch
        return PendingChunk(metrics=metrics, length=L, t0=t0,
                            count_aimd=L > 1 if count_aimd is None
                            else count_aimd,
                            stream_states=streams)

    def collect_chunk(self, pending: PendingChunk,
                      log: Optional[Callable[[str], None]] = None
                      ) -> TrainReport:
        """Read *pending*'s metrics to the host (the chunk's one host
        read) and fold them into the report; also advances the per-job
        step accounting, feeds AIMD (unless the chunk said not to) and
        fires the periodic checkpoint and publish hooks."""
        log = log or (lambda s: None)
        rep = self.report
        L = pending.length
        keys = list(pending.metrics)
        flat = torch.cat([pending.metrics[k].detach().float().reshape(-1)
                          .to(self.device) for k in keys]).cpu().numpy()
        host, at = {}, 0
        for k in keys:
            n = pending.metrics[k].numel()
            host[k] = flat[at:at + n].reshape(pending.metrics[k].shape)
            at += n
        dt = (time.perf_counter() - pending.t0) / L
        count_aimd = self.aimd is not None and pending.count_aimd
        if count_aimd and self._group is not None:
            # one step time for every rank (AIMD must pick one N)
            dt = self._all_max(dt)
        losses = np.atleast_1d(np.asarray(host["loss"], np.float64))
        rep.last_metrics = host
        rep.steps += L
        rep.losses.extend(losses.tolist())
        rep.per_job_losses.extend(np.atleast_2d(host["per_job_loss"]))
        rep.step_times.extend([dt] * L)
        rep.nano_history.extend([self.n] * L)
        for jid in self.job_ids:
            self.steps_done[jid] += L
        # AIMD (Eq. 2) fed the chunk's mean step time
        if count_aimd:
            self.n = self.aimd.update(dt)
        log(f"steps {rep.steps - L:4d}..{rep.steps - 1:4d} "
            f"loss {losses[-1]:.4f} nano {self.n} dt {dt*1e3:.1f}ms/step")
        self._chunks_collected += 1
        if self.checkpoint_every and \
                self._chunks_collected % self.checkpoint_every == 0:
            self.save_checkpoints(stream_states=pending.stream_states)
        if self.publish_pool is not None and self.publish_every and \
                self._chunks_collected % self.publish_every == 0:
            self.publish_to(self.publish_pool)
        return rep

    def run(self, steps: int, log: Optional[Callable[[str], None]] = None,
            chunk_size: Optional[int] = None) -> TrainReport:
        """Advance the whole group by *steps* fused iterations, in chunks
        of ``chunk_size``, each dispatched with the next one prefetched
        and then collected.  A remainder shorter than a chunk runs one
        step at a time; a call with steps < chunk runs as one chunk of
        its own length (the reference's chunk schedule).  Single-step
        tails inside a longer run do not feed AIMD: their un-amortized
        dispatch would read as a slowdown; with ``chunk_size=1`` every
        step counts."""
        if steps <= 0:
            return self.report
        chunk = max(1, chunk_size or self.chunk_size)

        def next_len(remaining: int) -> int:
            return chunk if remaining >= chunk else min(1, remaining)

        L = min(chunk, steps)
        done = 0
        while done < steps:
            nxt = next_len(steps - done - L)
            pending = self.dispatch_chunk(L, prefetch=nxt,
                                          count_aimd=L > 1 or chunk == 1)
            self.collect_chunk(pending, log=log)
            done += L
            L = nxt if nxt > 0 else L
        return self.report

    def discard_staged(self):
        """Drop a prefetched, undispatched batch and rewind the data
        streams to where they stood before it was staged (a regroup
        fence landing between chunks: the export must not skip data the
        job never trained on)."""
        if self._staged is None:
            return
        from repro_torch.checkpoint.checkpoint import restore_stream_state
        for s, mark in zip(self.batcher.streams, self._staged_rewind):
            restore_stream_state(s, mark)
        self._frontend_restore(self._staged_frontend)
        self._staged = None
        self._staged_len = 0

    def _frontend_mark(self):
        """The front-end inputs' generator state (None without one)."""
        return (copy.deepcopy(self._frontend_rng.bit_generator.state)
                if self._frontend_rng is not None else None)

    def _frontend_restore(self, mark) -> None:
        if mark is not None:
            self._frontend_rng.bit_generator.state = mark

    def warm(self, lengths: Optional[Sequence[int]] = None) -> float:
        """Prepare what the chunks of *lengths* will need before the first
        of them runs: the step closures, the pinned staging path, the
        device constants and the kernels' libraries and geometry tables
        (``SharedSuperModel.warm``).  No compile step exists here.  A
        probe batch is staged and the streams rewound, so warming
        consumes no data.  Returns the wall seconds spent."""
        from repro_torch.checkpoint.checkpoint import (restore_stream_state,
                                                       stream_state)
        lengths = [self.chunk_size] if lengths is None else list(lengths)
        t0 = time.perf_counter()
        for L in lengths:
            L = max(1, int(L))
            if (self.n, L) in self._step_cache:
                continue
            marks = [stream_state(s) for s in self.batcher.streams]
            fmark = self._frontend_mark()
            self._stage(L)
            for s, mark in zip(self.batcher.streams, marks):
                restore_stream_state(s, mark)
            self._frontend_restore(fmark)
            self._get_step(self.n, L)
        self.ssm.warm(self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    def refresh_member(self, state: JobTrainState):
        """Replay-exact handoff of an overlapped migration: overwrite one
        member's packed slices (adapter, Adam moments, per-job Adam step),
        its stream and its step count with a FRESHER export of the same
        job.  A destination built from a stale snapshot (layout and step
        depend only on the specs) becomes, by pure copy, the group a
        stop-the-world rebuild at the fence would have built.  Only legal
        before this runtime's first step and before any staging."""
        assert self.report.steps == 0, \
            "refresh_member after stepping would discard trained state"
        assert self._staged is None, \
            "refresh_member after staging would train on stale data"
        from repro_torch.checkpoint.checkpoint import insert_job
        idx = self.index_of(state.spec.job_id)
        off, r_cap = self.ssm.layout.slice_of(idx)
        r = state.spec.rank
        adapters = insert_job(self.adapters, off, r, state.adapter, r_cap)
        mu = insert_job(self.opt_state.mu, off, r, state.mu, r_cap)
        nu = insert_job(self.opt_state.nu, off, r, state.nu, r_cap)
        step = self.opt_state.step.clone()
        step[idx] = int(state.opt_step)
        self.adapters = adapters
        self.opt_state = adamw.AdamWState(step, mu, nu)
        self.steps_done[state.spec.job_id] = state.steps_done
        if state.stream is not None:
            self.batcher.streams[idx] = copy.deepcopy(state.stream)

    def _all_max(self, value: float) -> float:
        """The max of *value* over the mesh's ranks (an NCCL group takes a
        device tensor, gloo a host one)."""
        dev = (self.device if dist.get_backend(self._group) == "nccl"
               else torch.device("cpu"))
        t = torch.tensor([value], dtype=torch.float64, device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._group)
        return float(t.item())

    def _writer(self) -> bool:
        """Whether this rank writes what the group persists or
        publishes: every rank meshless, the group's rank 0 on a mesh."""
        return self._shard == 0

    # -------------------------------------------------------- checkpoints
    def save_checkpoints(self, directory: Optional[str] = None, *,
                         stream_states: Optional[List[str]] = None
                         ) -> List[str]:
        """Write every member's per-job checkpoint (adapter, Adam moments,
        per-job Adam step, data-stream rng position, steps done) to
        ``<dir>/<job_id>.npz``, the portable format a job restores from
        into any group, in this package or the reference.
        ``stream_states`` overrides the live rng positions: the periodic
        hook passes the chunk's pre-prefetch positions, the ones its
        adapter state was trained to."""
        from repro_torch.checkpoint.checkpoint import save_job, stream_state
        directory = directory or self.checkpoint_dir
        assert directory, "no checkpoint_dir configured"
        if stream_states is None:
            stream_states = [stream_state(s) for s in self.batcher.streams]
        step_vec = np.atleast_1d(self.opt_state.step.detach().cpu().numpy())
        paths = []
        for idx, spec in enumerate(self.specs):
            off, _ = self.ssm.layout.slice_of(idx)
            path = os.path.join(directory, f"{spec.job_id}.npz")
            if self._writer():
                save_job(path, spec.job_id, off, spec.rank, self.adapters,
                         self.opt_state,
                         step=int(step_vec[idx % step_vec.size]),
                         meta={"steps_done": self.steps_done[spec.job_id],
                               "stream": stream_states[idx]})
            self.last_checkpoint_step[spec.job_id] = \
                self.steps_done[spec.job_id]
            paths.append(path)
        if self._group is not None:
            dist.barrier(group=self._group)    # the files exist for all
        return paths

    # ---------------------------------------------------------- migration
    def export(self, job_id: str) -> JobTrainState:
        """Non-destructive snapshot of one member in portable form.  The
        data stream is deep-copied, so the snapshot's rng position stays
        at the snapshotted state while the runtime trains on."""
        idx = self.index_of(job_id)
        return unfuse_state(self.adapters, self.opt_state, idx,
                            self.specs[idx], layout=self.ssm.layout,
                            steps_done=self.steps_done[job_id],
                            stream=copy.deepcopy(self.batcher.streams[idx]))

    def export_all(self) -> List[JobTrainState]:
        return [self.export(jid) for jid in self.job_ids]

    # ----------------------------------------------------------- serving
    def publish_to(self, pool, job_ids: Optional[Sequence[str]] = None
                   ) -> Dict[str, int]:
        """Publish members' host snapshots (``export``) into a serving
        ``AdapterPool`` under their job ids, between chunks; training
        does not pause.  On a mesh the group's rank 0 publishes and the
        others return {}.  Returns {job_id: published version}."""
        if not self._writer():
            return {}
        return {jid: pool.publish_state(self.export(jid))
                for jid in (job_ids if job_ids is not None
                            else self.job_ids)}
