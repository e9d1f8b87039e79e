"""ClusterController — many fused groups at once, on one GPU or on a pool
of ranks carved into per-group submeshes, with a zero-stall control
plane (port of ``repro.cluster.controller``; DESIGN.md §9, §11, §12).

The paper's cluster layer (§3.4, §4.1) runs MANY heterogeneous fused
groups at once.  The controller owns the device pool and them:

  * ``apply_grouping`` partitions the pool into disjoint per-group
    submeshes (``launch/mesh.device_shares`` maps the scheduler's chip
    assignments onto ranks, ``partition_mesh`` carves the meshes) and
    runs one ``ElasticEngine`` per group, all over ONE frozen backbone
    per base model (``_backbone``);
  * execution is event-driven: ``begin`` starts one chunk-pump worker
    per group (cluster/control.GroupWorker — fence-able at chunk
    boundaries, exceptions surfaced, joins bounded), the control thread
    owns arrivals / regroup planning / handoff fences, and ``finish``
    collects; ``run`` is begin+finish.  roundrobin and sequential
    single-thread modes remain;
  * regroups overlap with training: the destination group is
    double-buffered (``prewarm``/``_prepare`` assembles and warms it
    from snapshots while the sources keep stepping), and the handoff
    fences the sources at a chunk boundary, refreshing the prepared
    runtime with their authoritative exports — replay-exact, so
    in-flight migration stays bit-lossless.  Every transition logs a
    ``RegroupEvent`` breakdown (pause/migrate/compile/resume);
  * arrivals and completions trigger ``reschedule`` → pool repartition
    → cross-slice migration, with transition-cost gating;
  * ``supervise`` detects dead and stuck pumps and restores their jobs
    from the periodic checkpoints (quarantine, backoff, poison).

One device.  Without a ``torch.distributed`` world the pool is the one
``device`` (the GPU unless the caller asks for the CPU) and every group
runs meshless on it.  The pumps of the "threads" mode then all launch on
the device's default stream: the card runs their kernels in launch order
while their host work overlaps, so threads, roundrobin and sequential
runs give the same bits.

A pool of ranks (SPMD).  In an initialized world the pool is the world's
ranks: pool index i is rank i, which computes on ``devices[i]``
(``cuda:<local rank>`` when every rank has a GPU, ``cuda:0`` for gloo
ranks sharing the one card, the CPU in the tests).  The reference is one
process driving every device; here every rank runs one process, and
every rank constructs the same controller and calls the same methods in
the same order.  What keeps the ranks together:

  * Every decision is computed from inputs that are equal on every rank:
    the grouping, ``_plan``, regroups, recovery, quarantine and backoff.
    What is local is gathered first over the controller's own gloo
    ``control_group`` (created once, in the constructor): step counts
    and measured step times of live groups (from each slot's first
    rank), the pumps' exceptions and heartbeat ages, whether a pump is
    alive; and the clock is rank 0's (``_now``, ``AgreedClock``).
  * A group's ``ElasticEngine(mesh=submesh)`` and ``GroupRuntime`` exist
    only on its slice's ranks; the other ranks keep the slot's key,
    device ids and ranks for bookkeeping (``GroupSlot.engine`` is None).
    Slices are disjoint, so a rank pumps at most one sharded group.
  * A job's state lives on its group's ranks, replicated.  When a group
    dissolves, its first rank broadcasts the members' exports over the
    control group (``elastic/migrate.broadcast_states``), so every rank
    parks the same state and a regroup can build the job's next group on
    any slice.  ``job_state`` and ``steps_done`` of a live job are
    collectives (the first rank's answer), so every rank gets the same
    one.  Checkpoints are written by a group's first rank, behind a
    barrier on the group (``GroupRuntime.save_checkpoints``).
  * Fences are agreed.  ``GroupWorker`` fences at whichever boundary a
    request reaches; on a sharded group that would leave one rank in a
    collective its peers never join.  So the controller never fences
    such a pump directly: its ``fault_hook`` at the "boundary" seam
    all-reduces (MAX, on the group's own process group, on the pump's
    thread) whether any rank's control thread wants a fence, and every
    rank then sets its pump's fence for the next boundary.  Stops are
    given only to fenced or finished pumps.
  * Failures are agreed.  ``poll_failures``, ``supervise``,
    ``reap_completed`` and ``finish`` gather each rank's view of its
    pumps and every rank applies the same ``_recover``.  A ``FaultPlan``
    fires on every rank of a group at the same step (each rank holds the
    same plan, the ranks the same steps); a stuck pump's peers block in
    its collective and stop beating too, so any rank's verdict is the
    group's.  ``submesh_loss`` quarantines the slice's ranks for good:
    they stay in the world and in every control collective, and get no
    group.  A real single-rank crash blocks its peers until the process
    group's timeout (ROADMAP A1's leftovers).
  * Meshless fallback: when the pool cannot give every group a rank
    (``device_shares`` returns zeros), every available rank runs every
    meshless group identically, so every rank holds its state.  Without
    ``partition`` (a one-rank pool, or ``partition=False``) every group
    runs meshless the same way.  ``fixed_mesh`` runs every group on that
    one mesh; its ranks share one process group, which gloo and NCCL do
    not order between two threads, so its groups run in turn
    ("sequential" or "roundrobin"), never as concurrent pumps.
  * Concurrency: "threads" (the default under partition) pumps each
    slice's group on a thread of its ranks while the main thread
    controls; "sequential" runs the groups in turn, the ranks outside
    the running group waiting at a control-group barrier.  Both give the
    same bits.  ``prewarm_async`` prepares on the calling thread: a
    second control thread would interleave its collectives and
    ``new_group`` calls with the first's.

``tp_mode`` "auto" and "pipeline" stay refused (ROADMAP A4, A2), and so
does a MoE model over a mesh (A3, raised by the sharded step).

An ``OnlineCalibrator`` (core/throughput) can be attached: every
measured step AND every measured regroup stall feeds it (on a pool, the
values every rank agreed on), and the ``AdapterScheduler``s used by
``reschedule`` price merges and transitions with the calibrated
constants.  The tables persist via ``calibration_path``.
"""
from __future__ import annotations

import os
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpoint import CheckpointCorrupt
from repro_torch.cluster.control import (GroupWorker, PreparedGroup,
                                         RegroupEvent, WorkerFailure,
                                         join_workers)
from repro_torch.cluster.faults import FailureRecord, FaultPlan
from repro_torch.configs.base import ModelConfig
from repro_torch.core import throughput as tp
from repro_torch.core.jobs import JobRuntimeState, LoRAJobSpec
from repro_torch.core.lora import pad_rank
from repro_torch.core.scheduler import AdapterScheduler, Group, SchedulerConfig
from repro_torch.elastic.engine import ElasticEngine
from repro_torch.elastic.migrate import JobTrainState, broadcast_states
from repro_torch.elastic.runtime import GroupRuntime, TrainReport
from repro_torch.launch.mesh import (control_group, device_shares,
                                     partition_mesh)
from repro_torch.models import model as M
from repro_torch.models import quant

GroupKey = Tuple[str, ...]
NO_TP_MODES = ("tensor-parallel and pipeline group execution on the "
               "multi-GPU pool (tp_mode 'auto', 'pipeline', pipeline_stages "
               "> 1) is not ported yet (ROADMAP A4, A2)")
NO_SHARED_PUMPS = ("concurrent pumps on one fixed mesh: its ranks share one "
                   "process group, and gloo and NCCL do not order two "
                   "threads' collectives on one group; run the groups in "
                   "turn (concurrency 'sequential' or 'roundrobin')")


def effective_grad_sync(impl: str, mesh, grad_sync: str) -> str:
    """The ONE copy of the sharded-wgrad fallback rule: the autodiffed
    ref/loop oracles have no shard-local VJP for exact gathered wgrads
    (DESIGN.md §8), so on a mesh they fall back to classic-DP psum."""
    if mesh is not None and impl in ("ref", "loop") \
            and grad_sync == "gather":
        return "psum"
    return grad_sync


@dataclass
class GroupSlot:
    """One live group: its engine, submesh and pool bookkeeping.  On a
    pool of ranks only the slot's ``ranks`` hold its engine; elsewhere
    ``engine`` and ``mesh`` are None."""
    base_model: str
    engine: Optional[ElasticEngine]
    mesh: object                      # DeviceMesh or None (meshless)
    device_ids: Tuple[int, ...]       # indices into the controller pool
    chips: int                        # scheduler's abstract assignment
    ranks: Tuple[int, ...] = (0,)     # the ranks that run the group

    def runtime(self, gkey: GroupKey) -> Optional[GroupRuntime]:
        return self.engine.ensure_group(gkey) \
            if self.engine is not None else None


@dataclass
class _Prepared(PreparedGroup):
    """A prepared destination and the ranks it was built on."""
    ranks: Tuple[int, ...] = (0,)


class ModelView:
    """Per-base-model aggregate over a controller's slots + parked/
    finished jobs — the surface ``ExecutionBackend.engine`` exposes."""

    def __init__(self, controller: "ClusterController", base_model: str):
        self._c = controller
        self.base_model = base_model

    @property
    def job_ids(self) -> List[str]:
        return [jid for jid in self._c.active_job_ids
                if self._c.spec_of(jid).base_model == self.base_model]

    @property
    def finished(self) -> Dict[str, JobTrainState]:
        return {jid: st for jid, st in self._c.finished.items()
                if st.spec.base_model == self.base_model}

    def steps_done(self, job_id: str) -> int:
        return self._c.steps_done(job_id)

    @property
    def regroup_events(self) -> int:
        return self._c._regroups.get(self.base_model, 0)


class AgreedClock:
    """A stand-in for the ``time`` module in code that decides by the
    clock on every rank of a pool (the trace harness, ``run_trace``):
    ``monotonic`` is rank 0's reading, broadcast over the controller's
    control group, so every rank takes the same branch.  Each call is a
    collective."""

    def __init__(self, controller: "ClusterController"):
        self._c = controller

    def monotonic(self) -> float:
        return self._c._now()

    @staticmethod
    def sleep(seconds: float) -> None:
        time.sleep(seconds)


def run_trace(runner):
    """``harness.TraceRunner.run`` on every rank of a pool: the harness
    (a copy of the reference's) admits arrivals and reschedules by its
    clock, so it runs with ``AgreedClock`` in place of ``time``."""
    from repro_torch.cluster import harness
    saved = harness.time
    harness.time = AgreedClock(runner.ctl)
    try:
        return runner.run()
    finally:
        harness.time = saved


class ClusterController:
    """Owns the device pool; runs many fused groups concurrently."""

    def __init__(self, cfg_of: Callable[[str], ModelConfig], *,
                 devices: Optional[Sequence] = None,
                 fixed_mesh=None, partition: Optional[bool] = None,
                 sched: Optional[SchedulerConfig] = None,
                 calibrator: Optional[tp.OnlineCalibrator] = None,
                 calibration_path: Optional[str] = None,
                 concurrency: Optional[str] = None,
                 transition_aware: bool = True,
                 join_timeout: Optional[float] = 900.0,
                 impl: str = "cuda", block_t: int = 128, lr: float = 1e-3,
                 lr_fn=None, remat: bool = True,
                 quantize: Optional[str] = None, nano_batches: int = 1,
                 adaptive_nano: bool = False, aimd_max_n: int = 16,
                 nano_order: str = "job", weight_decay: float = 0.0,
                 chunk_size: int = 4, data_axis: str = "data",
                 grad_sync: str = "gather", tp_mode: str = "dp",
                 pipeline_stages: int = 1,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 0, seed: int = 0,
                 fault_plan: Optional[FaultPlan] = None,
                 max_restarts: int = 3, backoff_base_s: float = 0.5,
                 backoff_max_s: float = 30.0,
                 stuck_after: Optional[float] = 300.0,
                 startup_grace_s: float = 120.0, device="cuda"):
        if tp_mode != "dp" or pipeline_stages > 1:
            raise NotImplementedError(NO_TP_MODES)
        self.cfg_of = cfg_of
        # the pool: the world's ranks, pool index i = rank i
        world = dist.is_initialized()
        self._world = dist.get_world_size() if world else 1
        self._rank = dist.get_rank() if world else 0
        if devices is not None and len(devices) != self._world:
            raise ValueError(
                f"the pool is the world's ranks, one device each: "
                f"{len(devices)} devices for a world of {self._world} "
                "rank(s)")
        self.devices = [torch.device(d) for d in devices] if devices \
            else [torch.device(device)] * self._world
        self.device = self.devices[self._rank]
        self.fixed_mesh = fixed_mesh
        # partition mode: per-group submeshes carved from the pool.
        # Disabled under a fixed mesh or a pool too small to split.
        self.partition = (fixed_mesh is None and len(self.devices) > 1) \
            if partition is None else bool(partition)
        assert not (self.partition and fixed_mesh is not None)
        if (self.partition or fixed_mesh is not None) and not world:
            raise ValueError("partitioned pools and fixed meshes need an "
                             "initialized torch.distributed world")
        # the controller's own collectives: a gloo group over the world
        self._ctl = control_group() if self._world > 1 else None
        self._mesh_device = ("cuda" if world and dist.get_backend() == "nccl"
                             else "cpu")
        # the scheduler must price memory with the SAME remat/quantize
        # flags the groups will run with
        self.remat = remat
        self.quantize = quantize
        self.sched_cfg = sched or SchedulerConfig(quantize=quantize,
                                                  remat=remat)
        # calibration warm-start: a persisted table (OnlineCalibrator
        # .save) restores this machine's fits before the first step
        self.calibration_path = calibration_path
        if calibrator is None and calibration_path is not None \
                and os.path.exists(calibration_path):
            calibrator = tp.OnlineCalibrator.load(calibration_path)
        self.calibrator = calibrator
        # threads by default when submeshes are disjoint (the only case
        # with device parallelism to win); sequential otherwise
        self.concurrency = concurrency or \
            ("threads" if self.partition else "sequential")
        assert self.concurrency in ("threads", "roundrobin", "sequential")
        self.transition_aware = transition_aware
        self.join_timeout = join_timeout
        self.data_axis = data_axis
        self.block_t = block_t
        self.seed = seed
        self._impl = impl
        self._grad_sync = grad_sync
        self._engine_kwargs = dict(
            impl=impl, block_t=block_t, lr=lr, lr_fn=lr_fn, remat=remat,
            quantize=quantize,
            nano_batches=nano_batches, adaptive_nano=adaptive_nano,
            aimd_max_n=aimd_max_n, nano_order=nano_order,
            weight_decay=weight_decay, chunk_size=chunk_size,
            data_axis=data_axis, tp_mode=tp_mode,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, seed=seed,
            device=self.device)
        self._chunk_size = chunk_size
        self._cfgs: Dict[str, ModelConfig] = {}
        self._backbones: Dict[str, object] = {}
        self._schedulers: Dict[str, AdapterScheduler] = {}
        self._specs: Dict[str, LoRAJobSpec] = {}
        self._parked: Dict[str, JobTrainState] = {}
        self._slots: Dict[GroupKey, GroupSlot] = {}
        self.finished: Dict[str, JobTrainState] = {}
        # jobs whose parked state came out of a live runtime — the next
        # group build containing one is a migration (regroup event)
        self._had_runtime: set = set()
        self._regroups: Dict[str, int] = {}
        self.repartitions = 0
        # ---------------- event-driven control plane (DESIGN.md §11)
        self._workers: Dict[GroupKey, GroupWorker] = {}   # this rank's
        # groups with a pump in the active run, on every rank (agreed);
        # a dict for its order
        self._pumping: Dict[GroupKey, None] = {}
        self._fence_wanted: set = set()   # sharded slots to fence (agreed)
        self._fail_info: Dict[GroupKey, tuple] = {}
        self._run_target = 0              # per-job step target of begin()
        self._run_base: Dict[str, int] = {}   # steps_done at begin()
        self._run_chunk: Optional[int] = None
        self._run_log: Optional[Callable[[str], None]] = None
        self._run_active = False          # a begin() run is in progress
        self._run_budget = False          # pumps run to each job's budget
        self._prepared: List[_Prepared] = []
        self._prewarm_thread: Optional[threading.Thread] = None
        self.regroup_log: List[RegroupEvent] = []
        # ---------------- supervised fault recovery (DESIGN.md §12)
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.fault_plan = fault_plan
        if fault_plan is not None and checkpoint_dir is not None:
            fault_plan.checkpoint_dir = checkpoint_dir
        self.max_restarts = max_restarts
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.stuck_after = stuck_after
        self.startup_grace_s = startup_grace_s
        self.quarantined: set = set()         # pool ids removed from duty
        self.poisoned: Dict[str, JobTrainState] = {}
        self.failure_log: List[FailureRecord] = []
        self._restarts: Dict[str, int] = {}
        self._backoff_until: Dict[str, float] = {}
        # stuck pumps we abandoned: their devices stay quarantined until
        # the zombie thread actually exits (it may still touch tensors)
        self._zombies: List[Tuple[Optional[GroupWorker],
                                  Tuple[int, ...]]] = []

    # ---------------------------------------------------------- agreement
    def _gather(self, obj) -> list:
        """Every rank's *obj*, in rank order (collective on a pool)."""
        if self._ctl is None:
            return [obj]
        out = [None] * self._world
        dist.all_gather_object(out, obj, group=self._ctl)
        return out

    def _bcast(self, obj, src: int):
        """*src*'s *obj* on every rank (collective on a pool)."""
        if self._ctl is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=src, group=self._ctl)
        return box[0]

    def _any(self, flag) -> bool:
        return any(self._gather(bool(flag)))

    def _barrier(self):
        if self._ctl is not None:
            dist.barrier(group=self._ctl)

    def _now(self) -> float:
        """The controller's clock: rank 0's ``time.monotonic`` on every
        rank of a pool (collective), so that deadlines agree."""
        return self._bcast(time.monotonic(), 0)

    def _member(self, slot) -> bool:
        return self._rank in slot.ranks

    def _agreed(self, slot) -> bool:
        """Whether the slot's pumps pair collectives (a sharded group on
        more than one rank): their fences must then be agreed."""
        return slot.mesh is not None and len(slot.ranks) > 1

    # ------------------------------------------------------------ registry
    def _cfg(self, base_model: str) -> ModelConfig:
        if base_model not in self._cfgs:
            self._cfgs[base_model] = self.cfg_of(base_model)
        return self._cfgs[base_model]

    def register_cfg(self, base_model: str, cfg: ModelConfig):
        """Pin the executable config for a base model (e.g. the
        simulator's reduced variant) ahead of ``cfg_of`` resolution."""
        self._cfgs[base_model] = cfg

    def _backbone(self, base_model: str):
        """ONE frozen backbone per base model, shared by every engine of
        this rank — drawn from the controller seed as a solo
        ``ElasticEngine`` draws it, so cross-engine migration is exact."""
        if base_model not in self._backbones:
            params = M.init_model(self._cfg(base_model), seed=self.seed,
                                  device=self.device)
            # quantize ONCE here (quantize_params is deterministic, so
            # cross-engine migration stays exact); GroupRuntime's own
            # quantize pass is then an idempotent no-op
            self._backbones[base_model] = quant.quantize_params(
                params, self.quantize)
        return self._backbones[base_model]

    def scheduler(self, base_model: str) -> AdapterScheduler:
        if base_model not in self._schedulers:
            self._schedulers[base_model] = AdapterScheduler(
                self._cfg(base_model), self.sched_cfg,
                calibrator=self.calibrator)
        return self._schedulers[base_model]

    # ------------------------------------------------------------- job set
    @property
    def active_job_ids(self) -> List[str]:
        ids = list(self._parked)
        for gkey in self._slots:
            ids.extend(gkey)
        return ids

    def spec_of(self, job_id: str) -> LoRAJobSpec:
        return self._specs[job_id]

    def _init_seed(self, job_id: str) -> int:
        """A job's admission-time init seed: ``ElasticEngine.add_job``'s
        crc32 derivation, so a controller-run job reproduces a solo
        engine's trajectory and a fresh restart replays its init."""
        return self.seed * 2 ** 31 + zlib.crc32(job_id.encode()) % (2 ** 31)

    def _fresh_state(self, spec: LoRAJobSpec) -> JobTrainState:
        return JobTrainState.fresh(
            spec, self._cfg(spec.base_model), self._init_seed(spec.job_id),
            r_pad=pad_rank(spec.rank, multiple=min(self.block_t, 16)),
            seed=self.seed)

    def submit(self, spec: LoRAJobSpec,
               state: Optional[JobTrainState] = None) -> JobTrainState:
        """Admit a job — fresh LoRA init, or existing portable state
        (restored checkpoint / migration from another controller).  On a
        pool every rank submits the same job (the init is seeded)."""
        assert spec.job_id not in self._specs, f"duplicate {spec.job_id}"
        if state is None:
            state = self._fresh_state(spec)
        self._specs[spec.job_id] = spec
        self._parked[spec.job_id] = state
        return state

    def remove_job(self, job_id: str) -> JobTrainState:
        """Decouple a job (its group dissolves; peers park)."""
        st = self._claim(job_id)
        del self._specs[job_id]
        self._had_runtime.discard(job_id)
        return st

    # ------------------------------------------------------ state plumbing
    def _home(self, job_id: str) -> Optional[GroupKey]:
        for gkey in self._slots:
            if job_id in gkey:
                return gkey
        return None

    def _share(self, states: Optional[List[JobTrainState]],
               src: int) -> List[JobTrainState]:
        """*states*, held by rank *src*, on every rank (collective)."""
        if self._ctl is None:
            return states
        return broadcast_states(states, src, self._ctl)

    def _dissolve(self, gkey: GroupKey):
        """Tear a slot down: members leave as portable JobTrainStates
        (the exports are mesh-agnostic), pool devices return to the free
        list.  On a pool the slot's first rank hands the exports to every
        rank, so all of them park the same state."""
        slot = self._slots.pop(gkey)
        states = [slot.engine.remove_job(jid) for jid in gkey] \
            if slot.engine is not None else None
        for st in self._share(states, slot.ranks[0]):
            self._parked[st.spec.job_id] = st
            self._had_runtime.add(st.spec.job_id)

    def _claim(self, job_id: str) -> JobTrainState:
        if job_id in self._parked:
            return self._parked.pop(job_id)
        if job_id in self.finished:
            return self.finished.pop(job_id)
        gkey = self._home(job_id)
        assert gkey is not None, f"unknown job {job_id}"
        self._dissolve(gkey)
        return self._parked.pop(job_id)

    # -------------------------------------------------------- device pool
    def _used_device_ids(self) -> set:
        return {i for s in self._slots.values() for i in s.device_ids}

    def available_device_ids(self) -> List[int]:
        """Pool indices fit for duty: everything not quarantined by the
        supervisor (lost submeshes, stuck pumps still holding tensors)."""
        return [i for i in range(len(self.devices))
                if i not in self.quarantined]

    def _ranks_of(self, device_ids: Tuple[int, ...]) -> Tuple[int, ...]:
        """The ranks that run a group on *device_ids*: the slice itself,
        else every rank of the fixed mesh, else (meshless) every
        available rank, each running the group whole."""
        if device_ids:
            return tuple(int(i) for i in device_ids)
        if self.fixed_mesh is not None:
            return tuple(self.fixed_mesh.mesh.flatten().tolist())
        return tuple(self.available_device_ids()) \
            or tuple(range(self._world))

    def _submesh(self, device_ids: Tuple[int, ...]):
        """The group's mesh: the fixed mesh or None (meshless) for an
        empty slice, else a 1-D submesh over the slice's ranks (every
        rank calls this: ``partition_mesh``; None off the slice)."""
        if not device_ids:
            return self.fixed_mesh          # None in meshless mode
        return partition_mesh([len(device_ids)],
                              [int(i) for i in device_ids],
                              axis=self.data_axis,
                              device_type=self._mesh_device)[0]

    def _alloc_free(self, want: int) -> Tuple[int, ...]:
        """Incremental allocation (ensure_group path): up to *want* free
        pool devices; empty → the group runs meshless/fixed-mesh."""
        if not self.partition:
            return ()
        used = self._used_device_ids()
        free = [i for i in self.available_device_ids() if i not in used]
        return tuple(free[:max(1, want)]) if free else ()

    # ------------------------------------------------------------ grouping
    def current_grouping(self) -> List[GroupKey]:
        return list(self._slots) + [(jid,) for jid in self._parked]

    def _new_engine(self, base: str, mesh) -> ElasticEngine:
        kw = dict(self._engine_kwargs)
        kw["mesh"] = mesh
        kw["grad_sync"] = effective_grad_sync(self._impl, mesh,
                                              self._grad_sync)
        return ElasticEngine(self._cfg(base), params=self._backbone(base),
                             **kw)

    def _count_regroup(self, gkey: GroupKey, base: str):
        if any(jid in self._had_runtime for jid in gkey):
            self._regroups[base] = self._regroups.get(base, 0) + 1
            self._had_runtime.difference_update(gkey)

    def _assemble(self, gkey: GroupKey, states, mesh, ranks,
                  repark: bool = True):
        """The engine and runtime of *gkey* on this rank, built from
        *states* where the rank is one of *ranks* (None elsewhere).  An
        infeasible group fails on every rank; with *repark* the claimed
        states are parked again, so no job's training identity is
        lost."""
        engine = rt = err = None
        if self._rank in ranks:
            engine = self._new_engine(states[0].spec.base_model, mesh)
            for st in states:
                engine.admit(st)
            try:
                rt = engine.ensure_group(gkey)
            except Exception as e:
                err = e
        if self._any(err is not None):
            for st in states if repark else ():
                self._parked[st.spec.job_id] = st
            raise err if err is not None else RuntimeError(
                f"group {gkey} could not be built on its ranks {ranks}")
        return engine, rt

    def _build_slot(self, gkey: GroupKey,
                    device_ids: Optional[Tuple[int, ...]],
                    chips: int) -> Optional[GroupRuntime]:
        states = [self._claim(jid) for jid in gkey]
        if device_ids is None:
            # incremental path: allocate AFTER claiming — claiming just
            # dissolved whatever slots the members came from, so their
            # devices are back in the free pool for this group
            device_ids = self._alloc_free(max(1, chips))
        base = states[0].spec.base_model
        assert all(s.spec.base_model == base for s in states), \
            "groups fuse jobs of one base model"
        mesh = self._submesh(device_ids)
        ranks = self._ranks_of(device_ids)
        engine, rt = self._assemble(gkey, states, mesh, ranks)
        self._count_regroup(gkey, base)
        self._slots[gkey] = GroupSlot(base_model=base, engine=engine,
                                      mesh=mesh, device_ids=device_ids,
                                      chips=chips, ranks=ranks)
        return rt

    def ensure_group(self, job_ids: Sequence[str],
                     chips: Optional[int] = None) -> Optional[GroupRuntime]:
        """Guarantee a live runtime with exactly *job_ids* (incremental
        path — devices come from the free pool; a full-pool layout goes
        through ``apply_grouping``).  Returns the runtime on the ranks
        that run the group, None on the others.

        A matching live group keeps its runtime AND its submesh even if
        *chips* changed; the chips bookkeeping is refreshed and a
        repartition (``apply_grouping``/``reschedule``) applies the new
        width when the layout is actually recomputed."""
        gkey = tuple(job_ids)
        for existing, slot in self._slots.items():
            if frozenset(existing) == frozenset(gkey):
                if chips is not None:
                    slot.chips = chips
                return slot.runtime(existing)
        want = chips if chips is not None else len(gkey)
        return self._build_slot(gkey, None, want)

    def _plan(self, groups: Sequence[GroupKey], chips: Sequence[int]
              ) -> Dict[GroupKey, Tuple[Tuple[int, ...], int]]:
        """Deterministic pool layout: sorted by (base model, members) so
        stable compositions keep stable device slices across calls.
        Slices are carved from the AVAILABLE pool only — quarantined
        devices are skipped, so the same grouping lands on healthy ranks
        after a failure."""
        order = sorted(range(len(groups)),
                       key=lambda i: (self._specs[groups[i][0]].base_model,
                                      groups[i]))
        avail = self.available_device_ids()
        sizes = device_shares([chips[i] for i in order],
                              len(avail)) if self.partition \
            else [0] * len(groups)
        plan: Dict[GroupKey, Tuple[Tuple[int, ...], int]] = {}
        cur = 0
        for pos, i in enumerate(order):
            n = sizes[pos] if sizes else 0
            plan[groups[i]] = (tuple(avail[cur:cur + n]), chips[i])
            cur += n
        return plan

    # -------------------------------------------------------------- fences
    def _fence(self, gkey: GroupKey, timeout: Optional[float]) -> bool:
        """Park this rank's pump of *gkey* at a chunk boundary.  A
        sharded group's ranks park at the same boundary: the request
        goes through the pumps' agreement (``_worker_hook``)."""
        w = self._workers.get(gkey)
        if w is None:
            return True
        if not self._agreed(self._slots[gkey]):
            return w.fence(timeout)
        self._fence_wanted.add(gkey)
        try:
            ok = w.fenced.wait(timeout)
        finally:
            self._fence_wanted.discard(gkey)
        return ok or w.done.is_set()

    def _resume(self, gkey: GroupKey):
        """Release a fenced pump and wait until it has left the fence, so
        that the next fence cannot mistake the old one for its own."""
        w = self._workers.get(gkey)
        if w is None:
            return
        w.resume()
        while w.fenced.is_set() and not w.done.is_set():
            time.sleep(0.001)

    def _worker_hook(self, gkey: GroupKey, slot: GroupSlot):
        """The pump's ``fault_hook``: on a sharded group, at every
        "boundary" seam, one all-reduce (MAX, over the group's own
        process group, on the pump's thread) of whether this rank wants
        a fence; when any rank does, every rank's pump parks at the next
        boundary.  Then the ``FaultPlan``'s hook, if any."""
        plan_hook = self.fault_plan.worker_hook(gkey) \
            if self.fault_plan is not None else None
        if not self._agreed(slot):
            return plan_hook

        def hook(worker, phase: str):
            if phase == "boundary" and worker.runtime._all_max(
                    1.0 if gkey in self._fence_wanted else 0.0) > 0:
                worker._resume_evt.clear()
                worker._fence_req.set()
            if plan_hook is not None:
                plan_hook(worker, phase)
        return hook

    # ---------------------------------------------------- agreed readings
    def _steps_of(self, job_ids: Sequence[str]) -> Dict[str, int]:
        """Every job's ``steps_done``, the same on every rank: a live
        job's is its slot's first rank's (one gather for all of them)."""
        out: Dict[str, int] = {}
        live: Dict[GroupKey, List[str]] = {}
        for jid in job_ids:
            for book in (self._parked, self.finished, self.poisoned):
                if jid in book:
                    out[jid] = book[jid].steps_done
                    break
            else:
                gkey = self._home(jid)
                assert gkey is not None, f"unknown job {jid}"
                live.setdefault(gkey, []).append(jid)
        if live:
            mine = {}
            for gkey, ids in live.items():
                slot = self._slots[gkey]
                if slot.ranks[0] == self._rank:
                    rt = slot.runtime(gkey)
                    mine.update({j: rt.steps_done[j] for j in ids})
            for got in self._gather(mine):
                out.update(got)
        return out

    def _measured_of(self, gkeys: Sequence[GroupKey]
                     ) -> Dict[GroupKey, float]:
        """Each live group's measured step time, its first rank's."""
        mine = {g: self._slots[g].runtime(g).report.measured_step_time()
                for g in gkeys if self._slots[g].ranks[0] == self._rank}
        out: Dict[GroupKey, float] = {}
        for got in (self._gather(mine) if gkeys else []):
            out.update(got)
        return out

    def first_rank_value(self, job_ids: Sequence[str], value):
        """*value* as the first rank of the live group of *job_ids*
        computed it, on every rank (collective on a pool): how a
        measurement made on a slice becomes one every rank decides by."""
        slot = self._slots[self._home(job_ids[0])]
        return self._bcast(value, slot.ranks[0])

    # -------------------------------------------- double-buffered prepare
    def _snapshot_state(self, job_id: str) -> JobTrainState:
        """Consistent non-destructive snapshot of a job, fencing its
        group's pump (if live) so the export sees no in-flight chunk.
        The brief fence is the only synchronous touch on the source —
        the expensive assembly work downstream runs while it steps."""
        gkey = self._home(job_id)
        if gkey is not None and gkey in self._pumping:
            self._fence(gkey, self.join_timeout)
            try:
                return self.job_state(job_id)
            finally:
                self._resume(gkey)
        return self.job_state(job_id)

    def _warm_lengths(self) -> List[int]:
        return [min(self._chunk_size, max(1, self._run_target))
                if self._run_target else self._chunk_size]

    def _prepare(self, gkey: GroupKey, device_ids: Tuple[int, ...],
                 chips: int) -> _Prepared:
        """Assemble the double-buffered destination for *gkey*: snapshot
        members, fuse them on the destination submesh, warm the runtime.
        The sources keep stepping throughout; the stale snapshot is only
        shape substrate — ``refresh_member`` swaps in the authoritative
        states at handoff.

        Nothing compiles on the card: ``compile_s`` is ``GroupRuntime
        .warm``'s wall time — the step closures, a probe batch through
        the pinned staging path, the device constants, the kernels'
        libraries (built if missing) and tile tables, then a device
        synchronize."""
        t0 = time.perf_counter()
        states = [self._snapshot_state(jid) for jid in gkey]
        base = states[0].spec.base_model
        mesh = self._submesh(device_ids)
        ranks = self._ranks_of(device_ids)
        engine, rt = self._assemble(gkey, states, mesh, ranks,
                                    repark=False)
        compile_s = rt.warm(self._warm_lengths()) if rt is not None else 0.0
        return _Prepared(
            gkey=gkey, base_model=base, engine=engine, runtime=rt,
            device_ids=tuple(device_ids), chips=chips, mesh=mesh,
            snapshot_steps={s.spec.job_id: s.steps_done for s in states},
            assemble_s=time.perf_counter() - t0, compile_s=compile_s,
            ranks=ranks)

    def _take_prepared(self, gkey: GroupKey,
                       device_ids: Tuple[int, ...]) -> Optional[_Prepared]:
        for i, p in enumerate(self._prepared):
            if p.matches(gkey, device_ids):
                return self._prepared.pop(i)
        return None

    def prewarm(self, groups: Sequence[Sequence[str]],
                chips: Optional[Sequence[int]] = None) -> int:
        """Assemble + warm every group of a grouping decision that would
        need a (re)build, ahead of ``apply_grouping``.  Returns the
        number of groups prepared.  Safe to call while pumps run."""
        groups = [tuple(g) for g in groups]
        chips = list(chips) if chips is not None \
            else [len(g) for g in groups]
        plan = self._plan(groups, chips)
        n = 0
        for g in groups:
            dev, c = plan[g]
            live = next((k for k in self._slots
                         if frozenset(k) == frozenset(g)), None)
            if live is not None and self._slots[live].device_ids == dev:
                continue                      # kept verbatim: no build
            if any(p.matches(g, dev) for p in self._prepared):
                continue
            self._prepared.append(self._prepare(g, dev, c))
            n += 1
        return n

    def prewarm_async(self, groups: Sequence[Sequence[str]],
                      chips: Optional[Sequence[int]] = None
                      ) -> threading.Thread:
        """``prewarm`` on a background thread while every pump keeps
        training.  ``apply_grouping`` joins it before consuming.  On a
        pool of ranks it prepares on the calling thread (the returned
        thread has nothing left to do): a second control thread would
        interleave its collectives with the first's."""
        groups = [tuple(g) for g in groups]
        if self._ctl is not None:
            self.prewarm(groups, chips)
            t = threading.Thread(target=lambda: None, daemon=True,
                                 name="prewarm")
        else:
            t = threading.Thread(target=self.prewarm, args=(groups, chips),
                                 daemon=True, name="prewarm")
        self._prewarm_thread = t
        t.start()
        return t

    def prewarm_predicted(self, pressure: bool = False,
                          node_of: Optional[Callable[[str], int]] = None
                          ) -> threading.Thread:
        """Predict the next grouping (Algorithm 1, transition-gated) and
        warm it in the background."""
        groups, weights = self.predict_grouping(pressure=pressure,
                                                node_of=node_of)
        return self.prewarm_async(groups, weights)

    # --------------------------------------------------------- transitions
    def apply_grouping(self, groups: Sequence[Sequence[str]],
                       chips: Optional[Sequence[int]] = None,
                       overlap: Optional[bool] = None
                       ) -> Dict[str, list]:
        """Install a full grouping decision: repartition the pool into
        per-group submeshes honoring the scheduler's chip assignments
        and migrate whoever moved.  Groups keeping both their member set
        and their device slice keep their runtime.

        With pumps active (``begin``), the transition is OVERLAPPED by
        default: destinations are assembled + warmed (or consumed from
        ``prewarm``) while the sources keep stepping; only the fence →
        export → refresh → restart window stalls training.
        ``overlap=False`` forces the stop-the-world order (fence first,
        then build + warm inside the stall window).  Every transition
        appends a ``RegroupEvent`` and feeds the calibrator's
        regroup-cost term."""
        groups = [tuple(g) for g in groups]
        chips = list(chips) if chips is not None \
            else [len(g) for g in groups]
        assert len(chips) == len(groups)
        covered = {j for g in groups for j in g}
        assert len(covered) == sum(len(g) for g in groups), \
            "grouping assigns a job twice"
        if self._prewarm_thread is not None \
                and self._prewarm_thread.is_alive():
            self._prewarm_thread.join(self.join_timeout)
        plan = self._plan(groups, chips)

        keep, build = [], []
        planned_sets = {frozenset(g): g for g in groups}
        for gkey in list(self._slots):
            tgt = planned_sets.get(frozenset(gkey))
            if tgt is not None and \
                    self._slots[gkey].device_ids == plan[tgt][0]:
                keep.append(gkey)
                self._slots[gkey].chips = plan[tgt][1]
        kept_sets = {frozenset(g) for g in keep}
        dissolve = [g for g in list(self._slots) if g not in keep]
        for g in groups:
            if frozenset(g) not in kept_sets:
                build.append(g)
        if not build and not dissolve:
            return {"keep": keep, "build": build}

        running = self._any(any(w.alive for w in self._workers.values()))
        overlap = running if overlap is None else bool(overlap)
        ev = RegroupEvent(
            mode=("overlapped" if overlap else "stop_the_world")
            if running else "offline",
            groups_built=len(build), groups_dissolved=len(dissolve),
            jobs_moved=sum(len(g) for g in build))

        # ---- assembly (overlapped: sources keep stepping through this)
        prepared: Dict[GroupKey, _Prepared] = {}
        if running and overlap:
            t0 = time.perf_counter()
            for g in build:
                p = self._take_prepared(g, plan[g][0])
                if p is None:
                    p = self._prepare(g, *plan[g])
                prepared[g] = p
            ev.assemble_s = time.perf_counter() - t0

        # ---- fence + dissolve (the stall window opens)
        t_pause = time.perf_counter()
        affected = [g for g in dissolve if g in self._pumping]
        for g in affected:
            self._fence(g, self.join_timeout)
        for g in affected:
            w = self._workers.pop(g, None)
            if w is not None:
                w.stop()
                w.join(self.join_timeout)
            self._pumping.pop(g, None)
        for g in dissolve:
            self._dissolve(g)
            for jid in g:
                ev.fence_steps[jid] = self._parked[jid].steps_done
        ev.pause_s = time.perf_counter() - t_pause

        # ---- migrate/install (+ warm when not overlapped).  A prepared
        # destination is consumed in EVERY mode — it is an assembly
        # cache keyed on (members, device slice), valid regardless of
        # how the stall window is ordered.
        t_mig = time.perf_counter()
        for g in build:
            p = prepared.get(g) or self._take_prepared(g, plan[g][0])
            if p is not None:
                for jid in g:
                    st = self._claim(jid)
                    if p.runtime is not None:
                        p.runtime.refresh_member(st)
                self._count_regroup(g, p.base_model)
                self._slots[g] = GroupSlot(
                    base_model=p.base_model, engine=p.engine, mesh=p.mesh,
                    device_ids=p.device_ids, chips=p.chips, ranks=p.ranks)
            else:
                rt = self._build_slot(g, *plan[g])
                if running and rt is not None:   # stop-the-world: warm
                    ev.compile_s += rt.warm(self._warm_lengths())
        ev.migrate_s = time.perf_counter() - t_mig - ev.compile_s

        # ---- resume (restart pumps for the rebuilt groups).  Spawn on
        # _run_active, not `running`: during an active trace run every
        # pump may be momentarily done (all groups reaped, an arrival
        # just landed), yet new groups must still start pumping.
        t_res = time.perf_counter()
        if self._run_active:
            for g in build:
                self._spawn_worker(g)
        ev.resume_s = time.perf_counter() - t_res
        if build:
            self.repartitions += 1
        self.regroup_log.append(ev)
        if running and self.calibrator is not None and build:
            # calibrate the transition-cost term with the measured
            # per-group stall (rank 0's on a pool), keyed like the
            # step-time buckets: by the EXECUTABLE config's name
            per_group = self._bcast(ev.stall_s, 0)
            for g in build:
                base = self._slots[g].base_model if g in self._slots \
                    else self._specs[g[0]].base_model
                self.calibrator.observe_regroup(self._cfg(base).name,
                                                per_group)
        return {"keep": keep, "build": build}

    def predict_grouping(self, pressure: bool = False,
                         node_of: Optional[Callable[[str], int]] = None
                         ) -> Tuple[List[GroupKey], List[int]]:
        """Run Algorithm 1 per base model over the active jobs without
        applying the result (the planning half of ``reschedule`` — also
        what ``prewarm_predicted`` warms ahead of time).  On a pool its
        inputs are the agreed ones (clock, step counts, measured step
        times), so every rank plans the same grouping.

        When ``transition_aware``, the live groups are handed to the
        scheduler so it prices each proposed rebuild against the
        calibrated regroup cost and keeps the status quo when the
        payback horizon exceeds the members' residual time."""
        now = self._now()
        by_model: Dict[str, List[str]] = {}
        for jid in self.active_job_ids:
            if self._backoff_until.get(jid, 0.0) > now:
                continue        # restored job still in its retry backoff
            by_model.setdefault(self._specs[jid].base_model, []).append(jid)
        ids_all = [j for ids in by_model.values() for j in ids]
        steps = self._steps_of(ids_all)
        measured = self._measured_of(
            [g for g in self._slots if any(j in steps for j in g)])
        groups: List[GroupKey] = []
        weights: List[int] = []
        # residual capacity excludes quarantined devices: the scheduler
        # must not hand out chips the pool no longer has
        pool = len(self.available_device_ids()) if self.partition else None
        for base, ids in sorted(by_model.items()):
            sched = self.scheduler(base)
            jrs = []
            for jid in ids:
                spec = self._specs[jid]
                s = JobRuntimeState(spec=spec, steps_done=steps[jid])
                s.standalone_step_time = tp.standalone_step_time(
                    self._cfg(base), spec,
                    hw=sched.hw_for(max(spec.gpus, 1)),
                    kernel_fused=sched.sched.kernel_fused,
                    ragged_kernels=sched.sched.ragged_kernels)
                gkey = self._home(jid)
                if gkey is not None:
                    s.current_step_time = measured[gkey]
                jrs.append(s)
            current = None
            if self.transition_aware:
                jrs_by_id = {s.spec.job_id: s for s in jrs}
                current = [
                    Group([jrs_by_id[j] for j in gkey], slot.chips)
                    for gkey, slot in self._slots.items()
                    if slot.base_model == base
                    and all(j in jrs_by_id for j in gkey)]
            for g in sched.schedule(jrs, node_of=node_of,
                                    pressure=pressure,
                                    current_groups=current,
                                    pool_chips=pool):
                groups.append(g.job_ids)
                weights.append(g.chips)
        return groups, weights

    def reschedule(self, pressure: bool = False,
                   node_of: Optional[Callable[[str], int]] = None
                   ) -> List[GroupKey]:
        """Arrival/completion hook: re-run Algorithm 1 per base model
        over the active jobs (calibrated oracle when attached) and
        repartition the pool to the new grouping."""
        groups, weights = self.predict_grouping(pressure=pressure,
                                                node_of=node_of)
        self.apply_grouping(groups, chips=weights)
        return groups

    # ----------------------------------------------------------- execution
    def _spawn_worker(self, gkey: GroupKey):
        """Start a chunk pump for *gkey* (on the ranks that run it) with
        the remaining per-job budget of the active run (a group rebuilt
        mid-run resumes at the largest member deficit, so nobody
        under-trains).  In budget mode the pump self-terminates at the
        largest member's remaining ``steps_budget`` deficit instead."""
        slot = self._slots[gkey]
        steps = self._steps_of(gkey)
        if self._run_budget:
            remaining = max(
                max(0, self._specs[jid].steps_budget - steps[jid])
                for jid in gkey)
        else:
            for jid in gkey:
                self._run_base.setdefault(jid, steps[jid])
            remaining = max(
                max(0, self._run_target
                    - (steps[jid] - self._run_base[jid]))
                for jid in gkey)
        self._pumping[gkey] = None
        rt = slot.runtime(gkey)
        if rt is None:
            return
        if rt.checkpoint_every and rt.checkpoint_dir \
                and rt.report.steps == 0:
            # admission-time checkpoint: a fault landing before the
            # first periodic save must still restore with steps-lost
            # bounded by the checkpoint period, from step 0 on
            rt.save_checkpoints()
        w = GroupWorker(gkey, rt, remaining, self._run_chunk,
                        self._run_log,
                        fault_hook=self._worker_hook(gkey, slot))
        self._workers[gkey] = w
        w.start()      # remaining==0 exits at once; join stays legal

    def begin(self, steps: Optional[int] = None,
              chunk_size: Optional[int] = None,
              log: Optional[Callable[[str], None]] = None,
              until_budget: bool = False):
        """Start the event-driven run: one chunk pump per live group.
        The control thread is then free to plan/prewarm/apply regroups
        while every group trains; ``finish`` joins and reports.

        ``until_budget=True`` (no ``steps``) runs each pump to its
        members' remaining ``steps_budget`` — the trace-harness mode,
        where completions are reaped (``reap_completed``) and arrivals/
        failures reshape the pool while the run stays active."""
        assert not self._pumping, "a run is already active"
        assert steps is not None or until_budget, \
            "begin() needs a step target or until_budget=True"
        now = self._now() if self._parked else 0.0
        for jid in list(self._parked):        # stragglers train solo
            if self._backoff_until.get(jid, 0.0) > now:
                continue
            self.ensure_group((jid,))
        if self.fixed_mesh is not None and len(self._slots) > 1 \
                and self.fixed_mesh.mesh.numel() > 1:
            raise NotImplementedError(NO_SHARED_PUMPS)
        self._run_budget = bool(until_budget and steps is None)
        self._run_target = int(steps) if steps is not None else 0
        self._run_chunk = chunk_size
        self._run_log = log
        self._run_base = self._steps_of(self.active_job_ids)
        self._run_active = True
        for gkey in list(self._slots):
            self._spawn_worker(gkey)

    def finish(self, timeout: Optional[float] = None
               ) -> Dict[GroupKey, TrainReport]:
        """Join every pump (bounded — ``join_timeout`` default), surface
        worker failures (on every rank of a pool: a ``WorkerFailure`` on
        one rank is raised on all), feed the calibrator, retire finished
        jobs.  Returns the reports of this rank's groups."""
        err = None
        try:
            join_workers(self._workers,
                         self.join_timeout if timeout is None else timeout)
        except WorkerFailure as e:
            err = e
        finally:
            live = [g for g in self._pumping if g in self._slots]
            self._workers = {}
            self._pumping = {}
            self._run_target = 0
            self._run_base = {}
            self._run_active = False
            self._run_budget = False
        seen = self._gather(None if err is None else (
            str(err), {g: repr(e) for g, e in err.failures.items()},
            list(err.stuck)))
        if any(s is not None for s in seen):
            failures = {g: RuntimeError(r) for s in seen if s is not None
                        for g, r in s[1].items()}
            if err is not None:
                failures.update(err.failures)
            stuck = sorted({g for s in seen if s is not None for g in s[2]})
            raise WorkerFailure("  |  ".join(s[0] for s in seen
                                             if s is not None),
                                failures=failures, stuck=stuck) from err
        reports = {g: self._slots[g].runtime(g).report for g in live
                   if self._member(self._slots[g])}
        self._feed_calibrator(live)
        self.retire_finished()
        return reports

    def drain(self, timeout: Optional[float] = None
              ) -> Dict[GroupKey, TrainReport]:
        """End the active run at each pump's next chunk boundary WITHOUT
        waiting for the step targets.  Joins bounded, surfaces worker
        failures, feeds the calibrator, retires finished jobs."""
        t = self.join_timeout if timeout is None else timeout
        for g in list(self._pumping):
            self._fence(g, t)
        for w in self._workers.values():
            w.stop()
        return self.finish(timeout=t)

    # ----------------------------------- supervised recovery (DESIGN §12)
    def _release_quarantine(self):
        """Return a stuck pump's devices to duty once its zombie thread
        has exited on every rank (until then it may still touch the dead
        runtime's tensors).  Lost submeshes stay quarantined forever."""
        if not self._zombies:
            return
        alive = self._gather([w is not None and w.alive
                              for w, _ in self._zombies])
        still = []
        for i, (w, ids) in enumerate(self._zombies):
            if any(a[i] for a in alive):
                still.append((w, ids))
            else:
                self.quarantined.difference_update(ids)
        self._zombies = still

    def poll_failures(self) -> List[Tuple[GroupKey, Optional[GroupWorker],
                                          str]]:
        """Detect failed pumps without touching healthy ones: ``dead`` =
        done with a captured exception; ``stuck`` = alive, not fenced,
        no heartbeat for ``stuck_after`` seconds (``startup_grace_s``
        before the first collected chunk — a cold pump's first chunk
        builds its step and may build the kernels' libraries).  On a
        pool each rank reports its own pumps and a group fails when any
        of its ranks says so; the worker is None off the group."""
        local = {}
        now = time.monotonic()
        for gkey, w in list(self._workers.items()):
            how = None
            if w.done.is_set():
                if w.exception is not None:
                    how = "dead"
            elif self.stuck_after is not None and w.alive \
                    and not w.fenced.is_set():
                limit = self.stuck_after if w.steps_run > 0 \
                    else max(self.stuck_after, self.startup_grace_s)
                if now - w.last_beat > limit:
                    how = "stuck"
            if how is not None:
                exc = w.exception
                local[gkey] = (how, getattr(exc, "kind", None),
                               getattr(exc, "t_injected", None)
                               or w.t_failed or w.last_beat,
                               dict(w.runtime.steps_done))
        fired = dict(self.fault_plan.fired) if self.fault_plan else {}
        reports = self._gather((local, fired))
        if self.fault_plan is not None:
            # a fault that fired on a group's ranks has fired for the
            # whole pool: the plan must not fire it again where the
            # group's jobs land next
            with self.fault_plan._lock:
                for _, got in reports:
                    for idx, rec in got.items():
                        self.fault_plan.fired.setdefault(idx, rec)
        reports = [r for r, _ in reports]
        out = []
        for gkey in list(self._pumping):
            seen = [r[gkey] for r in reports if gkey in r]
            if not seen:
                continue
            first = next((s for s in seen if s[0] == "dead"), seen[0])
            self._fail_info[gkey] = first
            out.append((gkey, self._workers.get(gkey), first[0]))
        return out

    def _restore_state(self, jid: str, spec: LoRAJobSpec,
                       rec: FailureRecord) -> JobTrainState:
        """Best available state for a failed job: its latest periodic
        checkpoint, else (missing/corrupt file) the admission-time init
        — the same crc32 seed as ``submit``, so a degraded restart
        replays the job's original trajectory rather than forking it."""
        path = os.path.join(self.checkpoint_dir, f"{jid}.npz") \
            if self.checkpoint_dir else None
        if path is not None and os.path.exists(path):
            try:
                st = JobTrainState.from_checkpoint(
                    path, spec, self._cfg(spec.base_model),
                    seed=self.seed)
                rec.restored_from_checkpoint.append(jid)
                return st
            except CheckpointCorrupt:
                pass           # atomic writes make this rare; fall back
        st = self._fresh_state(spec)
        rec.restarted_fresh.append(jid)
        return st

    def _recover(self, gkey: GroupKey, worker: Optional[GroupWorker],
                 how: str) -> FailureRecord:
        """Contain one failure to its domain: detach the pump, apply the
        device policy (free / quarantine), restore every member from its
        checkpoint with per-job retry accounting, park the survivors
        behind an exponential backoff, poison chronic failers.  On a
        pool every rank applies the same recovery from the gathered
        report (``poll_failures``) and reads the same checkpoint files."""
        t_detect = self._now()
        _, kind, t_fault, steps_before = self._fail_info.pop(
            gkey, (how, None, None, {}))
        kind = kind or ("stuck" if how == "stuck" else "crash")
        t_fault = t_fault or t_detect
        self._workers.pop(gkey, None)
        self._pumping.pop(gkey, None)
        if worker is not None:
            worker.stop()
        slot = self._slots.pop(gkey, None)
        device_ids: Tuple[int, ...] = slot.device_ids if slot else ()
        quarantined_now: Tuple[int, ...] = ()
        if kind == "submesh_loss":
            self.quarantined.update(device_ids)       # hardware gone
            quarantined_now = device_ids
        elif how == "stuck" or kind == "stuck_worker":
            # the abandoned thread may still touch the dead runtime's
            # tensors; hold its devices until it exits
            self.quarantined.update(device_ids)
            quarantined_now = device_ids
            self._zombies.append((worker, device_ids))
        rec = FailureRecord(gkey=tuple(gkey), kind=kind,
                            detect_latency_s=max(0.0, t_detect - t_fault),
                            quarantined_devices=quarantined_now)
        for jid in gkey:
            spec = self._specs[jid]
            attempts = self._restarts.get(jid, 0) + 1
            self._restarts[jid] = attempts
            rec.attempts[jid] = attempts
            st = self._restore_state(jid, spec, rec)
            rec.steps_lost[jid] = max(
                0, steps_before.get(jid, st.steps_done) - st.steps_done)
            if attempts > self.max_restarts:
                # poison-job policy: out of the active set for good; the
                # rest of the cluster keeps going
                rec.poisoned.append(jid)
                self.poisoned[jid] = st
                self._backoff_until.pop(jid, None)
                continue
            self._parked[jid] = st
            backoff = min(self.backoff_max_s,
                          self.backoff_base_s * (2 ** (attempts - 1)))
            self._backoff_until[jid] = t_detect + backoff
        self.failure_log.append(rec)
        return rec

    def supervise(self, reschedule: bool = True) -> List[FailureRecord]:
        """One supervisor tick: release healed quarantines, recover
        every detected failure, re-admit restored jobs whose retry
        backoff expired, and (optionally) repartition the surviving pool
        via the overlapped-migration path.  Unaffected pumps are never
        touched — containment is the whole point."""
        self._release_quarantine()
        recs = []
        for gkey, w, how in self.poll_failures():
            t0 = time.monotonic()
            rec = self._recover(gkey, w, how)
            rec.restore_s = time.monotonic() - t0
            recs.append(rec)
        now = self._now()
        ready = [jid for jid, t in list(self._backoff_until.items())
                 if t <= now and jid in self._parked]
        if reschedule and (recs or ready):
            # a job leaves its backoff only on a tick that re-admits it:
            # popped on a tick without a reschedule, it would stay
            # parked, and no later tick would see it as ready
            for jid in ready:
                self._backoff_until.pop(jid, None)
            t0 = time.monotonic()
            self.reschedule()
            if recs:                       # detection → pumps respawned
                extra = (time.monotonic() - t0) / len(recs)
                for rec in recs:
                    rec.restore_s += extra
        return recs

    def reap_completed(self) -> List[str]:
        """Collect pumps that ran out their budget (budget-mode runs):
        retire members at their step budget, park the rest for the next
        reschedule.  Pumps still running or failed are left alone (the
        latter are ``supervise``'s to handle); on a pool a group is
        reaped once its pumps are done on every one of its ranks."""
        busy = [g for g, w in self._workers.items()
                if not w.done.is_set() or w.exception is not None
                or w.alive]
        busy = {g for got in self._gather(busy) for g in got}
        retired = []
        for gkey in list(self._pumping):
            if gkey in busy:
                continue
            self._workers.pop(gkey, None)
            self._pumping.pop(gkey)
            if gkey in self._slots:
                self._dissolve(gkey)       # pump done: boundary export
            for jid in gkey:
                if jid in self._parked and self._parked[jid].steps_done \
                        >= self._specs[jid].steps_budget:
                    self.finished[jid] = self._parked.pop(jid)
                    self._had_runtime.discard(jid)
                    retired.append(jid)
        return retired

    def run(self, steps: int, chunk_size: Optional[int] = None,
            log: Optional[Callable[[str], None]] = None
            ) -> Dict[GroupKey, TrainReport]:
        """Advance every live group by *steps* — concurrently.  Returns
        the reports of this rank's groups.

        threads (default under partitioning): ``begin`` + ``finish`` —
        one fence-able chunk pump per group; disjoint submeshes execute
        in parallel (on one device: their host work overlaps, the card
        runs their kernels in launch order) and regroups can overlap the
        run.  roundrobin: a single thread keeps one pending chunk per
        group via ``dispatch_chunk``/``collect_chunk``.  sequential:
        groups run one after another, a pool's other ranks waiting at a
        barrier.  All three give the same bits."""
        for jid in list(self._parked):        # stragglers train solo
            self.ensure_group((jid,))
        gkeys = list(self._slots)
        if not gkeys or steps <= 0:
            return {}
        if self.concurrency == "threads" and len(gkeys) > 1:
            self.begin(steps, chunk_size, log)
            return self.finish()
        rts = {g: self._slots[g].runtime(g) for g in gkeys
               if self._member(self._slots[g])}
        if self.concurrency == "roundrobin" and len(gkeys) > 1:
            reports = self._run_roundrobin(rts, steps, chunk_size, log)
        else:
            reports = {}
            for g in gkeys:
                if g in rts:
                    reports[g] = rts[g].run(steps, log=log,
                                            chunk_size=chunk_size)
                self._barrier()
        self._feed_calibrator(gkeys)
        self.retire_finished()
        return reports

    def _feed_calibrator(self, gkeys: Sequence[GroupKey]):
        if self.calibrator is None:
            return
        # close the loop: every run feeds measured step times back (each
        # group's first rank's on a pool), so the NEXT reschedule prices
        # with this machine's effective constants (min-of-window
        # discards warm-up outliers after a rebuild).  Bucket by the
        # device count the group ACTUALLY ran on.
        gkeys = [g for g in gkeys if g in self._slots]
        for gkey, measured in self._measured_of(gkeys).items():
            slot = self._slots[gkey]
            if measured > 0:
                self.calibrator.observe(
                    self._cfg(slot.base_model),
                    [self._specs[j] for j in gkey],
                    max(len(slot.device_ids), 1), measured,
                    backbone_dtype=self.sched_cfg.backbone_dtype)

    def _run_roundrobin(self, rts: Dict[GroupKey, GroupRuntime],
                        steps: int, chunk_size: Optional[int], log
                        ) -> Dict[GroupKey, TrainReport]:
        """One pending chunk per group; collect + redispatch in rotation
        so every submesh always has work queued."""
        chunk = {g: max(1, chunk_size or rt.chunk_size)
                 for g, rt in rts.items()}
        length = {g: min(chunk[g], steps) for g in rts}
        remaining = {g: steps for g in rts}
        pend = {}
        for g, rt in rts.items():
            pend[g] = rt.dispatch_chunk(
                length[g], count_aimd=length[g] > 1 or chunk[g] == 1)
        while pend:
            for g in list(pend):
                rt = rts[g]
                rt.collect_chunk(pend.pop(g), log=log)
                remaining[g] -= length[g]
                if remaining[g] > 0:
                    length[g] = chunk[g] if remaining[g] >= chunk[g] else 1
                    pend[g] = rt.dispatch_chunk(
                        length[g],
                        count_aimd=length[g] > 1 or chunk[g] == 1)
        return {g: rt.report for g, rt in rts.items()}

    # ---------------------------------------------------------- accounting
    def steps_done(self, job_id: str) -> int:
        """A job's lifetime steps, the same on every rank (collective on
        a pool while the job is live)."""
        return self._steps_of([job_id])[job_id]

    def job_state(self, job_id: str) -> JobTrainState:
        """Live snapshot (non-destructive) of any known job, the same on
        every rank (collective on a pool while the job is live: the
        group's first rank exports it)."""
        if job_id in self._parked:
            return self._parked[job_id]
        if job_id in self.finished:
            return self.finished[job_id]
        if job_id in self.poisoned:
            return self.poisoned[job_id]
        gkey = self._home(job_id)
        assert gkey is not None, f"unknown job {job_id}"
        slot = self._slots[gkey]
        mine = [slot.runtime(gkey).export(job_id)] \
            if slot.ranks[0] == self._rank else None
        return self._share(mine, slot.ranks[0])[0]

    def retire_finished(self) -> List[str]:
        """Move jobs past their step budget out of the active set."""
        active = self.active_job_ids
        steps = self._steps_of(active)
        done = [jid for jid in active
                if steps[jid] >= self._specs[jid].steps_budget]
        for jid in done:
            self.finished[jid] = self._claim(jid)
            self._had_runtime.discard(jid)
        return done

    @property
    def regroup_events(self) -> int:
        return sum(self._regroups.values())

    def regroup_stats(self) -> Dict[str, Dict[str, float]]:
        """Mean lifecycle breakdown per transition mode."""
        out: Dict[str, Dict[str, float]] = {}
        by_mode: Dict[str, List[RegroupEvent]] = {}
        for ev in self.regroup_log:
            by_mode.setdefault(ev.mode, []).append(ev)
        for mode, evs in by_mode.items():
            n = len(evs)
            out[mode] = {
                "events": n,
                "pause_s": sum(e.pause_s for e in evs) / n,
                "migrate_s": sum(e.migrate_s for e in evs) / n,
                "compile_s": sum(e.compile_s for e in evs) / n,
                "resume_s": sum(e.resume_s for e in evs) / n,
                "assemble_s": sum(e.assemble_s for e in evs) / n,
                "stall_s": sum(e.stall_s for e in evs) / n,
                "stall_group_s": sum(e.stall_group_s for e in evs) / n,
            }
        return out

    def save_calibration(self, path: Optional[str] = None):
        """Persist the attached calibrator's tables (warm-start for the
        next controller run); on a pool rank 0 writes."""
        path = path or self.calibration_path
        assert self.calibrator is not None and path, \
            "no calibrator/path to save"
        if self._rank == 0:
            self.calibrator.save(path)
        self._barrier()

    def model_view(self, base_model: str) -> ModelView:
        return ModelView(self, base_model)

    def group_devices(self) -> Dict[GroupKey, Tuple[int, ...]]:
        """Pool indices per live group (meshless: empty)."""
        return {g: s.device_ids for g, s in self._slots.items()}
