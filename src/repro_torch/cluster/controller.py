"""ClusterController — many fused groups at once on one GPU, with a
zero-stall control plane (port of ``repro.cluster.controller``, single
device; DESIGN.md §9, §11).

The paper's cluster layer (§3.4, §4.1) runs MANY heterogeneous fused
groups at once.  The controller owns them:

  * ``apply_grouping`` installs a grouping decision and runs one
    ``ElasticEngine`` per group, all over ONE frozen backbone per base
    model (``_backbone``), so the card holds one copy of it;
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
  * arrivals and completions trigger ``reschedule`` with
    transition-cost gating: live groups are passed to the scheduler,
    which refuses regroups whose measured stall cost exceeds the
    members' residual-time benefit;
  * ``supervise`` detects dead and stuck pumps and restores their jobs
    from the periodic checkpoints (quarantine, backoff, poison), as the
    reference does (DESIGN.md §12).

One device.  Every group runs meshless on ``device`` (the GPU unless the
caller asks for the CPU).  The pumps of the "threads" mode all launch on
the device's default stream: the card runs their kernels one after
another in launch order while their host work (batch building, staging,
launch overhead, metric reads, checkpoint writes) overlaps.  Every
tensor a pump, the control thread or a prepare thread touches is then
ordered on that one stream — the pinned staging copies, the exports at a
fence, the checkpoint reads, the kernels' cached tile tables — and a
group's launches are the ones a sequential run makes, so threads,
roundrobin and sequential runs give the same bits.  Partitioning the
pool into submeshes, fixed meshes, ``tp_mode`` other than "dp",
pipeline stages, the "rank_desc" nano order and the sharded gradient
sync are multi-GPU and refused (``NO_MESH``).

An ``OnlineCalibrator`` (core/throughput) can be attached: every
measured step AND every measured regroup stall feeds it, and the
``AdapterScheduler``s used by ``reschedule`` price merges and
transitions with the calibrated constants.  The tables persist via
``calibration_path`` (warm-start across controller runs).
"""
from __future__ import annotations

import os
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.checkpoint.checkpoint import CheckpointCorrupt
from repro_torch.cluster.control import (GroupWorker, PreparedGroup,
                                         RegroupEvent, join_workers)
from repro_torch.cluster.faults import FailureRecord, FaultPlan
from repro_torch.configs.base import ModelConfig
from repro_torch.core import throughput as tp
from repro_torch.core.jobs import JobRuntimeState, LoRAJobSpec
from repro_torch.core.lora import pad_rank
from repro_torch.core.scheduler import AdapterScheduler, Group, SchedulerConfig
from repro_torch.core.ssm import NO_MESH
from repro_torch.elastic.engine import ElasticEngine
from repro_torch.elastic.migrate import JobTrainState
from repro_torch.elastic.runtime import GroupRuntime, TrainReport
from repro_torch.models import model as M
from repro_torch.models import quant

GroupKey = Tuple[str, ...]


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
    """One live group: its engine and pool bookkeeping (meshless: it
    holds no devices of its own, ``device_ids`` stays empty)."""
    base_model: str
    engine: ElasticEngine
    device_ids: Tuple[int, ...]       # indices into the controller pool
    chips: int                        # scheduler's abstract assignment

    def runtime(self, gkey: GroupKey) -> GroupRuntime:
        return self.engine.ensure_group(gkey)


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


class ClusterController:
    """Runs many fused groups over one device."""

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
        if (devices is not None and len(devices) > 1) or partition \
                or fixed_mesh is not None or tp_mode != "dp" \
                or pipeline_stages > 1 or nano_order != "job" \
                or grad_sync != "gather" or data_axis != "data":
            raise NotImplementedError(NO_MESH)
        self.cfg_of = cfg_of
        self.devices = [torch.device(d) for d in devices] if devices \
            else [torch.device(device)]
        self.device = self.devices[0]
        # one device never partitions: every group runs meshless on it
        self.partition = False
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
        # sequential by default: the groups share the one device
        self.concurrency = concurrency or "sequential"
        assert self.concurrency in ("threads", "roundrobin", "sequential")
        self.transition_aware = transition_aware
        self.join_timeout = join_timeout
        self.block_t = block_t
        self.seed = seed
        self._engine_kwargs = dict(
            impl=impl, block_t=block_t, lr=lr, lr_fn=lr_fn, remat=remat,
            quantize=quantize,
            nano_batches=nano_batches, adaptive_nano=adaptive_nano,
            aimd_max_n=aimd_max_n, weight_decay=weight_decay,
            chunk_size=chunk_size, checkpoint_dir=checkpoint_dir,
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
        self._workers: Dict[GroupKey, GroupWorker] = {}
        self._run_target = 0              # per-job step target of begin()
        self._run_base: Dict[str, int] = {}   # steps_done at begin()
        self._run_chunk: Optional[int] = None
        self._run_log: Optional[Callable[[str], None]] = None
        self._run_active = False          # a begin() run is in progress
        self._run_budget = False          # pumps run to each job's budget
        self._prepared: List[PreparedGroup] = []
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
        # the zombie thread actually exits (it may still touch buffers)
        self._zombies: List[Tuple[GroupWorker, Tuple[int, ...]]] = []

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
        """ONE frozen backbone per base model, shared by every engine —
        drawn from the controller seed as a solo ``ElasticEngine`` draws
        it, so cross-engine migration is exact."""
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
        (restored checkpoint / migration from another controller)."""
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

    def _dissolve(self, gkey: GroupKey):
        """Tear a slot down: members leave as portable JobTrainStates."""
        slot = self._slots.pop(gkey)
        for jid in gkey:
            self._parked[jid] = slot.engine.remove_job(jid)
            self._had_runtime.add(jid)

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
    def available_device_ids(self) -> List[int]:
        """Pool indices fit for duty: everything not quarantined by the
        supervisor."""
        return [i for i in range(len(self.devices))
                if i not in self.quarantined]

    # ------------------------------------------------------------ grouping
    def current_grouping(self) -> List[GroupKey]:
        return list(self._slots) + [(jid,) for jid in self._parked]

    def _new_engine(self, base: str) -> ElasticEngine:
        return ElasticEngine(self._cfg(base), params=self._backbone(base),
                             **self._engine_kwargs)

    def _count_regroup(self, gkey: GroupKey, base: str):
        if any(jid in self._had_runtime for jid in gkey):
            self._regroups[base] = self._regroups.get(base, 0) + 1
            self._had_runtime.difference_update(gkey)

    def _build_slot(self, gkey: GroupKey, chips: int) -> GroupRuntime:
        states = [self._claim(jid) for jid in gkey]
        base = states[0].spec.base_model
        assert all(s.spec.base_model == base for s in states), \
            "groups fuse jobs of one base model"
        engine = self._new_engine(base)
        for st in states:
            engine.admit(st)
        try:
            rt = engine.ensure_group(gkey)
        except Exception:
            # infeasible group: recover the claimed states so no job's
            # training identity is lost in the throwaway engine
            for jid in gkey:
                if jid in engine.job_ids:
                    self._parked[jid] = engine.remove_job(jid)
            raise
        self._count_regroup(gkey, base)
        self._slots[gkey] = GroupSlot(base_model=base, engine=engine,
                                      device_ids=(), chips=chips)
        return rt

    def ensure_group(self, job_ids: Sequence[str],
                     chips: Optional[int] = None) -> GroupRuntime:
        """Guarantee a live runtime with exactly *job_ids*.  A matching
        live group keeps its runtime even if *chips* changed (the chips
        bookkeeping is refreshed)."""
        gkey = tuple(job_ids)
        for existing, slot in self._slots.items():
            if frozenset(existing) == frozenset(gkey):
                if chips is not None:
                    slot.chips = chips
                return slot.runtime(existing)
        want = chips if chips is not None else len(gkey)
        return self._build_slot(gkey, want)

    def _plan(self, groups: Sequence[GroupKey], chips: Sequence[int]
              ) -> Dict[GroupKey, Tuple[Tuple[int, ...], int]]:
        """The layout of a grouping: every group meshless on the one
        device (an empty device slice) with its scheduler chips."""
        return {g: ((), c) for g, c in zip(groups, chips)}

    # -------------------------------------------- double-buffered prepare
    def _snapshot_state(self, job_id: str) -> JobTrainState:
        """Consistent non-destructive snapshot of a job, fencing its
        group's pump (if live) so the export sees no in-flight chunk.
        The brief fence is the only synchronous touch on the source —
        the expensive assembly work downstream runs while it steps."""
        gkey = self._home(job_id)
        w = self._workers.get(gkey) if gkey is not None else None
        if w is not None and w.alive:
            w.fence(self.join_timeout)
            try:
                return self.job_state(job_id)
            finally:
                w.resume()
        return self.job_state(job_id)

    def _warm_lengths(self) -> List[int]:
        return [min(self._chunk_size, max(1, self._run_target))
                if self._run_target else self._chunk_size]

    def _prepare(self, gkey: GroupKey, device_ids: Tuple[int, ...],
                 chips: int) -> PreparedGroup:
        """Assemble the double-buffered destination for *gkey*: snapshot
        members, fuse them, warm the runtime.  The sources keep stepping
        throughout; the stale snapshot is only shape substrate —
        ``refresh_member`` swaps in the authoritative states at handoff.

        Nothing compiles on the card: ``compile_s`` is ``GroupRuntime
        .warm``'s wall time — the step closures, a probe batch through
        the pinned staging path, the device constants, the kernels'
        libraries (built if missing) and tile tables, then a device
        synchronize."""
        t0 = time.perf_counter()
        states = [self._snapshot_state(jid) for jid in gkey]
        base = states[0].spec.base_model
        engine = self._new_engine(base)
        for st in states:
            engine.admit(st)
        rt = engine.ensure_group(gkey)
        compile_s = rt.warm(self._warm_lengths())
        return PreparedGroup(
            gkey=gkey, base_model=base, engine=engine, runtime=rt,
            device_ids=tuple(device_ids), chips=chips, mesh=None,
            snapshot_steps={s.spec.job_id: s.steps_done for s in states},
            assemble_s=time.perf_counter() - t0, compile_s=compile_s)

    def _take_prepared(self, gkey: GroupKey,
                       device_ids: Tuple[int, ...]
                       ) -> Optional[PreparedGroup]:
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
        training.  ``apply_grouping`` joins it before consuming."""
        groups = [tuple(g) for g in groups]
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
        """Install a full grouping decision and migrate whoever moved.
        Groups keeping their member set keep their runtime (step
        closures and device tables included).

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

        running = any(w.alive for w in self._workers.values())
        overlap = running if overlap is None else bool(overlap)
        ev = RegroupEvent(
            mode=("overlapped" if overlap else "stop_the_world")
            if running else "offline",
            groups_built=len(build), groups_dissolved=len(dissolve),
            jobs_moved=sum(len(g) for g in build))

        # ---- assembly (overlapped: sources keep stepping through this)
        prepared: Dict[GroupKey, PreparedGroup] = {}
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
        affected = [(g, self._workers[g]) for g in dissolve
                    if g in self._workers]
        for g, w in affected:
            w.fence(self.join_timeout)
        for g, w in affected:
            w.stop()
            w.join(self.join_timeout)
            self._workers.pop(g, None)
        for g in dissolve:
            for jid in g:
                ev.fence_steps[jid] = self.steps_done(jid)
            self._dissolve(g)
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
                    p.runtime.refresh_member(self._claim(jid))
                self._count_regroup(g, p.base_model)
                self._slots[g] = GroupSlot(
                    base_model=p.base_model, engine=p.engine,
                    device_ids=p.device_ids, chips=p.chips)
            else:
                rt = self._build_slot(g, plan[g][1])
                if running:      # stop-the-world: warm in the window
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
            # per-group stall, keyed like the step-time buckets: by the
            # EXECUTABLE config's name
            per_group = ev.stall_s
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
        what ``prewarm_predicted`` warms ahead of time).

        When ``transition_aware``, the live groups are handed to the
        scheduler so it prices each proposed rebuild against the
        calibrated regroup cost and keeps the status quo when the
        payback horizon exceeds the members' residual time."""
        now = time.monotonic()
        by_model: Dict[str, List[str]] = {}
        for jid in self.active_job_ids:
            if self._backoff_until.get(jid, 0.0) > now:
                continue        # restored job still in its retry backoff
            by_model.setdefault(self._specs[jid].base_model, []).append(jid)
        groups: List[GroupKey] = []
        weights: List[int] = []
        for base, ids in sorted(by_model.items()):
            sched = self.scheduler(base)
            jrs = []
            for jid in ids:
                spec = self._specs[jid]
                s = JobRuntimeState(spec=spec,
                                    steps_done=self.steps_done(jid))
                s.standalone_step_time = tp.standalone_step_time(
                    self._cfg(base), spec,
                    hw=sched.hw_for(max(spec.gpus, 1)),
                    kernel_fused=sched.sched.kernel_fused,
                    ragged_kernels=sched.sched.ragged_kernels)
                gkey = self._home(jid)
                if gkey is not None:
                    s.current_step_time = self._slots[gkey].runtime(
                        gkey).report.measured_step_time()
                jrs.append(s)
            current = None
            if self.transition_aware:
                jrs_by_id = {s.spec.job_id: s for s in jrs}
                current = [
                    Group([jrs_by_id[j] for j in gkey], slot.chips)
                    for gkey, slot in self._slots.items()
                    if slot.base_model == base
                    and all(j in jrs_by_id for j in gkey)]
            # meshless: no pool to fit the chips to (pool_chips=None)
            for g in sched.schedule(jrs, node_of=node_of,
                                    pressure=pressure,
                                    current_groups=current):
                groups.append(g.job_ids)
                weights.append(g.chips)
        return groups, weights

    def reschedule(self, pressure: bool = False,
                   node_of: Optional[Callable[[str], int]] = None
                   ) -> List[GroupKey]:
        """Arrival/completion hook: re-run Algorithm 1 per base model
        over the active jobs (calibrated oracle when attached) and
        install the new grouping."""
        groups, weights = self.predict_grouping(pressure=pressure,
                                                node_of=node_of)
        self.apply_grouping(groups, chips=weights)
        return groups

    # ----------------------------------------------------------- execution
    def _spawn_worker(self, gkey: GroupKey):
        """Start a chunk pump for *gkey* with the remaining per-job
        budget of the active run (a group rebuilt mid-run resumes at
        the largest member deficit, so nobody under-trains).  In budget
        mode the pump self-terminates at the largest member's remaining
        ``steps_budget`` deficit instead."""
        slot = self._slots[gkey]
        rt = slot.runtime(gkey)
        if self._run_budget:
            remaining = max(
                max(0, self._specs[jid].steps_budget
                    - self.steps_done(jid))
                for jid in gkey)
        else:
            for jid in gkey:
                self._run_base.setdefault(jid, self.steps_done(jid))
            remaining = max(
                max(0, self._run_target
                    - (self.steps_done(jid) - self._run_base[jid]))
                for jid in gkey)
        if rt.checkpoint_every and rt.checkpoint_dir \
                and rt.report.steps == 0:
            # admission-time checkpoint: a fault landing before the
            # first periodic save must still restore with steps-lost
            # bounded by the checkpoint period, from step 0 on
            rt.save_checkpoints()
        hook = self.fault_plan.worker_hook(gkey) \
            if self.fault_plan is not None else None
        w = GroupWorker(gkey, rt, remaining, self._run_chunk,
                        self._run_log, fault_hook=hook)
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
        failures reshape the groups while the run stays active."""
        assert not self._workers, "a run is already active"
        assert steps is not None or until_budget, \
            "begin() needs a step target or until_budget=True"
        for jid in list(self._parked):        # stragglers train solo
            if self._backoff_until.get(jid, 0.0) > time.monotonic():
                continue
            self.ensure_group((jid,))
        self._run_budget = bool(until_budget and steps is None)
        self._run_target = int(steps) if steps is not None else 0
        self._run_chunk = chunk_size
        self._run_log = log
        self._run_base = {jid: self.steps_done(jid)
                          for jid in self.active_job_ids}
        self._run_active = True
        for gkey in list(self._slots):
            self._spawn_worker(gkey)

    def finish(self, timeout: Optional[float] = None
               ) -> Dict[GroupKey, TrainReport]:
        """Join every pump (bounded — ``join_timeout`` default), surface
        worker failures, feed the calibrator, retire finished jobs."""
        try:
            join_workers(self._workers,
                         self.join_timeout if timeout is None else timeout)
        finally:
            live = {g: w for g, w in self._workers.items()
                    if g in self._slots}
            self._workers = {}
            self._run_target = 0
            self._run_base = {}
            self._run_active = False
            self._run_budget = False
        reports = {g: self._slots[g].runtime(g).report for g in live}
        self._feed_calibrator(reports)
        self.retire_finished()
        return reports

    def drain(self, timeout: Optional[float] = None
              ) -> Dict[GroupKey, TrainReport]:
        """End the active run at each pump's next chunk boundary WITHOUT
        waiting for the step targets.  Joins bounded, surfaces worker
        failures, feeds the calibrator, retires finished jobs."""
        t = self.join_timeout if timeout is None else timeout
        for w in self._workers.values():
            if w.alive:
                w.fence(t)
        for w in self._workers.values():
            w.stop()
        return self.finish(timeout=t)

    # ----------------------------------- supervised recovery (DESIGN §12)
    def _release_quarantine(self):
        """Return a stuck pump's devices to duty once its zombie thread
        has actually exited (until then it may still touch the dead
        runtime's tensors)."""
        still = []
        for w, ids in self._zombies:
            if w.alive:
                still.append((w, ids))
            else:
                self.quarantined.difference_update(ids)
        self._zombies = still

    def poll_failures(self) -> List[Tuple[GroupKey, GroupWorker, str]]:
        """Detect failed pumps without touching healthy ones: ``dead`` =
        done with a captured exception; ``stuck`` = alive, not fenced,
        no heartbeat for ``stuck_after`` seconds (``startup_grace_s``
        before the first collected chunk — a cold pump's first chunk
        builds its step and may build the kernels' libraries)."""
        out = []
        now = time.monotonic()
        for gkey, w in list(self._workers.items()):
            if w.done.is_set():
                if w.exception is not None:
                    out.append((gkey, w, "dead"))
            elif self.stuck_after is not None and w.alive \
                    and not w.fenced.is_set():
                limit = self.stuck_after if w.steps_run > 0 \
                    else max(self.stuck_after, self.startup_grace_s)
                if now - w.last_beat > limit:
                    out.append((gkey, w, "stuck"))
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

    def _recover(self, gkey: GroupKey, worker: GroupWorker,
                 how: str) -> FailureRecord:
        """Contain one failure to its domain: detach the pump, apply the
        device policy (free / quarantine), restore every member from its
        checkpoint with per-job retry accounting, park the survivors
        behind an exponential backoff, poison chronic failers."""
        t_detect = time.monotonic()
        exc = worker.exception
        kind = getattr(exc, "kind", None) or \
            ("stuck" if how == "stuck" else "crash")
        t_fault = getattr(exc, "t_injected", None) or worker.t_failed \
            or worker.last_beat
        self._workers.pop(gkey, None)
        worker.stop()
        slot = self._slots.pop(gkey, None)
        steps_before: Dict[str, int] = {}
        device_ids: Tuple[int, ...] = ()
        if slot is not None:
            device_ids = slot.device_ids
            try:
                steps_before = dict(
                    slot.engine.ensure_group(gkey).steps_done)
            except Exception:
                steps_before = {}
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
        backoff expired, and (optionally) reschedule via the
        overlapped-migration path.  Unaffected pumps are never touched
        — containment is the whole point."""
        self._release_quarantine()
        recs = []
        for gkey, w, how in self.poll_failures():
            t0 = time.monotonic()
            rec = self._recover(gkey, w, how)
            rec.restore_s = time.monotonic() - t0
            recs.append(rec)
        now = time.monotonic()
        ready = [jid for jid, t in list(self._backoff_until.items())
                 if t <= now and jid in self._parked]
        for jid in ready:
            self._backoff_until.pop(jid, None)
        if reschedule and (recs or ready):
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
        latter are ``supervise``'s to handle)."""
        retired = []
        for gkey, w in list(self._workers.items()):
            if not w.done.is_set() or w.exception is not None or w.alive:
                continue
            self._workers.pop(gkey)
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
        """Advance every live group by *steps*.

        threads: ``begin`` + ``finish`` — one fence-able chunk pump per
        group, all launching on the device's default stream (the card
        runs their kernels in launch order; their host work overlaps),
        and regroups can overlap the run.  roundrobin: a single thread
        keeps one pending chunk per group via ``dispatch_chunk`` /
        ``collect_chunk`` (a group's launches queue behind another's
        while the host builds the next).  sequential (the default):
        groups run one after another.  All three give the same bits."""
        for jid in list(self._parked):        # stragglers train solo
            self.ensure_group((jid,))
        rts = {gkey: slot.runtime(gkey)
               for gkey, slot in self._slots.items()}
        if not rts or steps <= 0:
            return {}
        if self.concurrency == "threads" and len(rts) > 1:
            self.begin(steps, chunk_size, log)
            return self.finish()
        if self.concurrency == "roundrobin" and len(rts) > 1:
            reports = self._run_roundrobin(rts, steps, chunk_size, log)
        else:
            reports = {g: rt.run(steps, log=log, chunk_size=chunk_size)
                       for g, rt in rts.items()}
        self._feed_calibrator(reports)
        self.retire_finished()
        return reports

    def _feed_calibrator(self, reports: Dict[GroupKey, TrainReport]):
        if self.calibrator is None:
            return
        # close the loop: every run feeds measured step times back, so
        # the NEXT reschedule prices with this machine's effective
        # constants (min-of-window discards warm-up outliers after a
        # rebuild); every group runs on the one device
        for gkey in reports:
            slot = self._slots.get(gkey)
            if slot is None:
                continue
            rt = slot.runtime(gkey)
            measured = rt.report.measured_step_time()
            if measured > 0:
                self.calibrator.observe(
                    self._cfg(slot.base_model), rt.specs, 1, measured,
                    backbone_dtype=self.sched_cfg.backbone_dtype)

    def _run_roundrobin(self, rts: Dict[GroupKey, GroupRuntime],
                        steps: int, chunk_size: Optional[int], log
                        ) -> Dict[GroupKey, TrainReport]:
        """One pending chunk per group; collect + redispatch in rotation
        so the device always has work queued."""
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
        if job_id in self._parked:
            return self._parked[job_id].steps_done
        if job_id in self.finished:
            return self.finished[job_id].steps_done
        if job_id in self.poisoned:
            return self.poisoned[job_id].steps_done
        gkey = self._home(job_id)
        assert gkey is not None, f"unknown job {job_id}"
        return self._slots[gkey].runtime(gkey).steps_done[job_id]

    def job_state(self, job_id: str) -> JobTrainState:
        """Live snapshot (non-destructive) of any known job."""
        if job_id in self._parked:
            return self._parked[job_id]
        if job_id in self.finished:
            return self.finished[job_id]
        if job_id in self.poisoned:
            return self.poisoned[job_id]
        gkey = self._home(job_id)
        assert gkey is not None, f"unknown job {job_id}"
        return self._slots[gkey].runtime(gkey).export(job_id)

    def retire_finished(self) -> List[str]:
        """Move jobs past their step budget out of the active set."""
        done = [jid for jid in self.active_job_ids
                if self.steps_done(jid) >= self._specs[jid].steps_budget]
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
        next controller run)."""
        path = path or self.calibration_path
        assert self.calibrator is not None and path, \
            "no calibrator/path to save"
        self.calibrator.save(path)

    def model_view(self, base_model: str) -> ModelView:
        return ModelView(self, base_model)

    def group_devices(self) -> Dict[GroupKey, Tuple[int, ...]]:
        """Pool indices per live group (meshless: empty)."""
        return {g: s.device_ids for g, s in self._slots.items()}
