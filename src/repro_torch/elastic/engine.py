"""ElasticEngine — executes scheduler decisions on live training state
(port of ``repro.elastic.engine``, single device).

Jobs arrive and finish online; ``AdapterScheduler.schedule`` emits a
grouping, and the engine diffs it against the running groups, migrating
only the jobs whose membership changed:

    arrival -> schedule -> diff old/new grouping -> migrate state -> run

A group whose member set is unchanged keeps its ``GroupRuntime`` (step
closures and device tables included: no state moves).  Changed groups
are dissolved member by member into ``JobTrainState``s and fused anew,
which is lossless (migrate.py).  Per-job step accounting (train steps and
Adam steps) survives every migration.  Every runtime the engine builds
runs on its ``device`` (the GPU unless the caller asks for the CPU).
"""
from __future__ import annotations

import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core import throughput as tp
from repro_torch.core.jobs import JobRuntimeState, LoRAJobSpec
from repro_torch.core.lora import pad_rank
from repro_torch.core.scheduler import AdapterScheduler
from repro_torch.core.ssm import NO_MESH
from repro_torch.elastic.migrate import JobTrainState, diff_grouping
from repro_torch.elastic.runtime import GroupRuntime, TrainReport
from repro_torch.models import model as M

GroupKey = Tuple[str, ...]


class ElasticEngine:
    """Full elastic lifecycle over one shared frozen backbone."""

    def __init__(self, cfg: ModelConfig, *, params=None,
                 scheduler: Optional[AdapterScheduler] = None,
                 impl: str = "cuda", block_t: int = 128, lr: float = 1e-3,
                 lr_fn: Optional[Callable] = None, remat: bool = True,
                 quantize: Optional[str] = None,
                 nano_batches: int = 1, adaptive_nano: bool = False,
                 aimd_max_n: int = 16, weight_decay: float = 0.0,
                 chunk_size: int = 4, mesh=None,
                 checkpoint_dir=None, checkpoint_every: int = 0,
                 seed: int = 0, device="cuda"):
        if mesh is not None:
            raise NotImplementedError(NO_MESH)
        self.cfg = cfg
        self.device = device
        self.params = params if params is not None else \
            M.init_model(cfg, seed=seed, device=device)
        self.scheduler = scheduler or AdapterScheduler(cfg)
        self.block_t = block_t
        self.seed = seed
        self._rt_kwargs = dict(impl=impl, block_t=block_t, lr=lr,
                               lr_fn=lr_fn, remat=remat, quantize=quantize,
                               nano_batches=nano_batches,
                               adaptive_nano=adaptive_nano,
                               aimd_max_n=aimd_max_n,
                               weight_decay=weight_decay,
                               chunk_size=chunk_size, seed=seed,
                               checkpoint_dir=checkpoint_dir,
                               checkpoint_every=checkpoint_every,
                               device=device)
        self._parked: Dict[str, JobTrainState] = {}   # active, not grouped
        self._runtimes: Dict[GroupKey, GroupRuntime] = {}
        self.finished: Dict[str, JobTrainState] = {}
        self.regroup_events = 0        # groupings that MOVED running state

    # ----------------------------------------------------------- job set
    @property
    def job_ids(self) -> List[str]:
        ids = list(self._parked)
        for gkey in self._runtimes:
            ids.extend(gkey)
        return ids

    def _r_pad_solo(self, spec: LoRAJobSpec) -> int:
        # SSM padding rule for the stack this job would be born into
        return pad_rank(spec.rank, multiple=min(self.block_t, 16))

    def add_job(self, spec: LoRAJobSpec,
                init_seed: Optional[int] = None) -> JobTrainState:
        """Admit a new job (standard LoRA init, parked until grouped).
        Its init seed folds the engine's seed with the crc32 of its id, as
        the reference derives its key: crc32, not hash(), since Python's
        str hash is salted per process."""
        assert spec.job_id not in self.job_ids \
            and spec.job_id not in self.finished, f"duplicate {spec.job_id}"
        if init_seed is None:
            init_seed = (self.seed * 2 ** 31
                         + zlib.crc32(spec.job_id.encode()) % (2 ** 31))
        st = JobTrainState.fresh(spec, self.cfg, init_seed,
                                 r_pad=self._r_pad_solo(spec),
                                 seed=self.seed)
        self._parked[spec.job_id] = st
        return st

    def admit(self, state: JobTrainState):
        """Admit a job with existing state (e.g. a restored checkpoint)."""
        assert state.spec.job_id not in self.job_ids
        self._parked[state.spec.job_id] = state

    def remove_job(self, job_id: str) -> JobTrainState:
        """Decouple a job (its group, if any, is dissolved; peers park)."""
        return self._claim(job_id)

    # ----------------------------------------------------- state plumbing
    def _home(self, job_id: str) -> Optional[GroupKey]:
        for gkey in self._runtimes:
            if job_id in gkey:
                return gkey
        return None

    def _dissolve(self, gkey: GroupKey):
        rt = self._runtimes.pop(gkey)
        # a fence can land with the next chunk's batch prefetched: drop it
        # (rewinding the streams), so the exports carry no stream position
        # past data the group never trained on
        rt.discard_staged()
        for st in rt.export_all():
            self._parked[st.spec.job_id] = st

    def _claim(self, job_id: str) -> JobTrainState:
        if job_id in self._parked:
            return self._parked.pop(job_id)
        gkey = self._home(job_id)
        assert gkey is not None, f"unknown job {job_id}"
        self._dissolve(gkey)
        return self._parked.pop(job_id)

    # ------------------------------------------------------------ grouping
    def current_grouping(self) -> List[GroupKey]:
        return list(self._runtimes) + [(jid,) for jid in self._parked]

    def ensure_group(self, job_ids: Sequence[str]) -> GroupRuntime:
        """Guarantee a live runtime whose members are exactly *job_ids*,
        migrating members out of their current groups if needed."""
        gkey = tuple(job_ids)
        for existing in self._runtimes:
            if frozenset(existing) == frozenset(gkey):
                return self._runtimes[existing]
        had_running_state = any(self._home(j) is not None for j in gkey)
        states = [self._claim(j) for j in gkey]
        rt = self._build(states)
        self._runtimes[gkey] = rt
        if had_running_state:
            self.regroup_events += 1
        return rt

    def _build(self, states) -> GroupRuntime:
        try:
            return GroupRuntime.from_states(self.cfg, self.params, states,
                                            **self._rt_kwargs)
        except Exception:
            # infeasible group (e.g. mixed seq_len): re-park the claimed
            # states so no job's training state is lost
            for st in states:
                self._parked[st.spec.job_id] = st
            raise

    def set_grouping(self, groups: Sequence[Sequence[str]]
                     ) -> Dict[str, list]:
        """Apply a full grouping decision; returns the migration diff."""
        diff = diff_grouping(list(self._runtimes), groups)
        for gkey in diff["dissolve"]:
            self._dissolve(gkey)
        moved = bool(diff["dissolve"])
        for g in diff["build"]:
            gkey = tuple(g)
            had_running_state = any(self._home(j) is not None for j in gkey)
            states = [self._claim(j) for j in gkey]
            self._runtimes[gkey] = self._build(states)
            moved = moved or had_running_state
        if moved:
            self.regroup_events += 1
        return diff

    def reschedule(self, pressure: bool = False,
                   node_of: Optional[Callable[[str], int]] = None
                   ) -> List[GroupKey]:
        """Arrival/completion hook: re-run Algorithm 1 over the active
        jobs and migrate live state to the new grouping."""
        jrs = []
        for jid in self.job_ids:
            spec = self._spec_of(jid)
            s = JobRuntimeState(spec=spec, steps_done=self.steps_done(jid))
            s.standalone_step_time = tp.standalone_step_time(
                self.cfg, spec,
                hw=self.scheduler.hw_for(max(spec.gpus, 1)),
                kernel_fused=self.scheduler.sched.kernel_fused,
                ragged_kernels=self.scheduler.sched.ragged_kernels)
            gkey = self._home(jid)
            if gkey is not None:
                s.current_step_time = \
                    self._runtimes[gkey].report.measured_step_time()
            jrs.append(s)
        groups = self.scheduler.schedule(jrs, node_of=node_of,
                                         pressure=pressure)
        grouping = [g.job_ids for g in groups]
        self.set_grouping(grouping)
        return [tuple(g) for g in grouping]

    def _spec_of(self, job_id: str) -> LoRAJobSpec:
        if job_id in self._parked:
            return self._parked[job_id].spec
        gkey = self._home(job_id)
        return self._runtimes[gkey].specs[
            self._runtimes[gkey].index_of(job_id)]

    # ----------------------------------------------------------- execution
    def run_group(self, job_ids: Sequence[str], steps: int,
                  log=None) -> TrainReport:
        return self.ensure_group(job_ids).run(steps, log=log)

    def run(self, steps: int, log=None) -> Dict[GroupKey, TrainReport]:
        """Advance every live group by *steps*; retire finished jobs."""
        # park any stragglers into singleton groups so everyone trains
        for jid in list(self._parked):
            self.ensure_group((jid,))
        reports = {gkey: rt.run(steps, log=log)
                   for gkey, rt in list(self._runtimes.items())}
        self.retire_finished()
        return reports

    def steps_done(self, job_id: str) -> int:
        if job_id in self._parked:
            return self._parked[job_id].steps_done
        if job_id in self.finished:
            return self.finished[job_id].steps_done
        gkey = self._home(job_id)
        return self._runtimes[gkey].steps_done[job_id]

    def job_state(self, job_id: str) -> JobTrainState:
        """Live snapshot (non-destructive) of any known job."""
        if job_id in self._parked:
            return self._parked[job_id]
        if job_id in self.finished:
            return self.finished[job_id]
        gkey = self._home(job_id)
        return self._runtimes[gkey].export(job_id)

    def retire_finished(self) -> List[str]:
        """Move jobs past their step budget out of the active set."""
        done = [jid for jid in self.job_ids
                if self.steps_done(jid) >= self._spec_of(jid).steps_budget]
        for jid in done:
            self.finished[jid] = self._claim(jid)
        return done
