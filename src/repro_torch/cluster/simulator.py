"""Trace-driven discrete-event cluster simulator (paper §4.1): a copy of
``repro.cluster.simulator`` for the port, held to it by the tests.
``ClusterConfig.hw`` defaults to ``V5E`` as in the reference; an H100
replay passes ``hw=tp.H100`` (or a calibrator whose ``hw`` is that
spec).  The ``execution=`` and ``calibrator=`` hooks stay as they are:
the port has no ``ExecutionBackend`` yet (it comes with cluster control,
ROADMAP queue A), so a simulation here prices every group analytically,
through the calibrator when one is given.

Stands in for the Sailor simulator: replays a job trace against a cluster
of ``total_chips``, invoking a pluggable grouping policy at each
scheduling horizon (arrival / completion / periodic).  Step times come
from the calibrated analytic cost model (core/throughput) — the same
two-level methodology the paper uses (micro-benchmark profiles feeding a
trace-driven emulator).

Emits the paper's three metrics: cluster training throughput
(samples/sec), per-job completion time, and average accelerator
utilization — consumed by the reference's benchmarks/fig5..fig9, and
here by ``launch/train.py``'s ``simulate``.
"""
from __future__ import annotations

import dataclasses
import heapq
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.jobs import JobRuntimeState, LoRAJobSpec
from repro_torch.core.scheduler import (AdapterScheduler, Group,
                                       SchedulerConfig)
from repro_torch.core import throughput as tp


@dataclass
class ClusterConfig:
    total_chips: int = 128
    chips_per_node: int = 8
    horizon: float = 300.0               # scheduling horizon (s)
    concurrency_cap: int = 128           # runnable-job cap (paper A.1)
    hw: tp.HardwareSpec = tp.V5E
    kernel_fused: bool = True
    ragged_kernels: bool = True          # per-adapter-rank pricing (§10)
    reduced_models: bool = False         # price full cfgs (analytic, cached)


@dataclass
class JobLog:
    spec: LoRAJobSpec
    arrival: float
    start: Optional[float] = None
    finish: Optional[float] = None
    steps_done: int = 0
    grouped_steps: int = 0               # steps executed while co-located

    @property
    def jct(self) -> Optional[float]:
        return None if self.finish is None else self.finish - self.arrival

    @property
    def grouping_ratio(self) -> float:
        return self.grouped_steps / max(self.steps_done, 1)


@dataclass
class SimResult:
    logs: Dict[str, JobLog]
    makespan: float
    samples_done: float
    busy_chip_seconds: float
    useful_chip_seconds: float
    total_chips: int
    throughput_series: List[Tuple[float, float]] = field(default_factory=list)
    # execution-backed mode: measured-vs-predicted step times + number of
    # live state migrations executed (cluster/execution.StepRecord)
    step_records: List = field(default_factory=list)
    regroup_events: int = 0

    @property
    def avg_throughput(self) -> float:
        return self.samples_done / max(self.makespan, 1e-9)

    @property
    def avg_jct(self) -> float:
        jcts = [l.jct for l in self.logs.values() if l.jct is not None]
        return float(np.mean(jcts)) if jcts else float("inf")

    def jct_cdf(self) -> np.ndarray:
        return np.sort([l.jct for l in self.logs.values()
                        if l.jct is not None])

    @property
    def utilization(self) -> float:
        """Average *useful* accelerator utilization (compute-busy fraction
        of provisioned chip-time while the cluster had work)."""
        return self.useful_chip_seconds / max(self.busy_chip_seconds, 1e-9)

    @property
    def completion_rate(self) -> float:
        done = sum(1 for l in self.logs.values() if l.finish is not None)
        return done / max(len(self.logs), 1)


GroupPolicy = Callable[[List[JobRuntimeState], ClusterConfig, bool],
                       List[Group]]


def tlora_policy(cfg_of: Callable[[str], ModelConfig],
                 kernel_fused: bool = True,
                 calibrator=None,
                 transition_aware: bool = False) -> GroupPolicy:
    """The paper's Adapter Scheduler (Algorithm 1) as a policy.  With a
    *calibrator* the grouping decisions price against the online-fitted
    effective constants instead of the static HardwareSpec.

    With ``transition_aware`` the policy is stateful: it remembers its
    last grouping per base model and hands the still-intact groups back
    to the scheduler as the status quo, so a regroup whose calibrated
    stall cost exceeds the members' residual-time benefit is not
    proposed (DESIGN.md §11) — until the benefit horizon grows."""
    last: Dict[str, List[Tuple[str, ...]]] = {}

    def policy(jobs: List[JobRuntimeState], cc: ClusterConfig,
               pressure: bool = False) -> List[Group]:
        groups: List[Group] = []
        # groups can only fuse jobs sharing a base model
        by_model: Dict[str, List[JobRuntimeState]] = {}
        for j in jobs:
            by_model.setdefault(j.spec.base_model, []).append(j)
        for model, js in by_model.items():
            sched = AdapterScheduler(
                cfg_of(model),
                SchedulerConfig(hw=cc.hw, kernel_fused=kernel_fused,
                                ragged_kernels=cc.ragged_kernels),
                calibrator=calibrator)
            node_of = _node_assigner(js, cc)
            current = None
            if transition_aware and model in last:
                by_id = {j.spec.job_id: j for j in js}
                # only groups whose members ALL survive are a viable
                # status quo — a departed member forces a rebuild anyway
                current = [Group([by_id[j] for j in g],
                                 sum(max(by_id[j].spec.gpus, 1)
                                     for j in g))
                           for g in last[model]
                           if all(j in by_id for j in g)]
            out = sched.schedule(js, node_of=node_of, pressure=pressure,
                                 current_groups=current)
            if transition_aware:
                last[model] = [tuple(g.job_ids) for g in out]
            groups.extend(out)
        return groups
    return policy


def _node_assigner(jobs: Sequence[JobRuntimeState],
                   cc: ClusterConfig) -> Callable[[str], int]:
    """First-fit chip placement -> node id per job (grouping tiers)."""
    placement: Dict[str, int] = {}
    cursor = 0
    for j in jobs:
        placement[j.spec.job_id] = cursor // cc.chips_per_node
        cursor += j.spec.gpus
    return lambda job_id: placement.get(job_id, 0)


class ClusterSimulator:
    """Discrete-event simulator; optionally execution-backed.

    With ``execution`` set (cluster/execution.ExecutionBackend), small
    configs run REAL fused train steps at each horizon: the backend
    mirrors grouping decisions onto a live ElasticEngine (adapter +
    optimizer state migrating losslessly across regroups) and the
    measured step time replaces the analytic one, validating the
    scheduler's throughput oracle against execution.
    """

    def __init__(self, cluster: ClusterConfig, policy: GroupPolicy,
                 cfg_of: Optional[Callable[[str], ModelConfig]] = None,
                 execution=None, calibrator=None):
        self.cc = cluster
        self.policy = policy
        self.execution = execution
        # close the loop: with an execution backend, measured step times
        # re-fit the oracle's effective constants online, and every
        # analytic price (non-executed groups included) uses the fit
        self.calibrator = calibrator if calibrator is not None \
            else getattr(execution, "calibrator", None)
        self._cfg_cache: Dict[str, ModelConfig] = {}
        self._cfg_of = cfg_of or self._default_cfg_of

    def _default_cfg_of(self, model: str) -> ModelConfig:
        if model not in self._cfg_cache:
            cfg = get_config(model)
            self._cfg_cache[model] = cfg.reduced() if self.cc.reduced_models \
                else cfg
        return self._cfg_cache[model]

    # ----------------------------------------------------------- pricing
    def _group_step_time(self, g: Group, calibrated: bool = True) -> float:
        cfg = self._cfg_of(g.jobs[0].spec.base_model)
        hw = self.cc.hw
        # calibrated pricing only when the fit's frame of reference
        # matches this simulator's: the calibrator regresses against
        # fused-kernel pricing on ITS base constants, so a cluster
        # configured with different constants (pass hw=cc.hw to
        # ExecutionBackend to align) or the unfused-kernel ablation
        # must not silently reprice through a mismatched fit
        if calibrated and self.calibrator is not None \
                and self.calibrator.hw == self.cc.hw \
                and self.cc.kernel_fused:
            hw = self.calibrator.hw_for(cfg.name, g.chips, len(g.jobs))
        return tp.group_step_cost(
            cfg, g.specs, g.chips, hw=hw,
            spans_nodes=g.spans_nodes,
            kernel_fused=self.cc.kernel_fused,
            ragged_kernels=self.cc.ragged_kernels).total

    def _group_compute_time(self, g: Group) -> float:
        cfg = self._cfg_of(g.jobs[0].spec.base_model)
        return tp.group_step_cost(
            cfg, g.specs, g.chips, hw=self.cc.hw,
            spans_nodes=g.spans_nodes,
            kernel_fused=self.cc.kernel_fused,
            ragged_kernels=self.cc.ragged_kernels).t_compute_ideal

    # ---------------------------------------------------------------- run
    def run(self, trace: Sequence[LoRAJobSpec],
            max_time: Optional[float] = None) -> SimResult:
        logs = {j.job_id: JobLog(j, j.arrival_time) for j in trace}
        states = {j.job_id: JobRuntimeState(spec=j) for j in trace}
        for s in states.values():
            s.standalone_step_time = tp.standalone_step_time(
                self._cfg_of(s.spec.base_model), s.spec, hw=self.cc.hw,
                kernel_fused=self.cc.kernel_fused,
                ragged_kernels=self.cc.ragged_kernels)

        # the backend accumulates across runs; report only this run's slice
        rec0 = len(self.execution.records) if self.execution else 0
        ev0 = self.execution.regroup_events if self.execution else 0

        pending = sorted(trace, key=lambda j: j.arrival_time)
        active: List[JobRuntimeState] = []
        t = 0.0
        samples = 0.0
        busy = 0.0          # chip-seconds allocated to running groups
        useful = 0.0        # chip-seconds of saturated-efficiency compute
        series: List[Tuple[float, float]] = []

        while pending or active:
            while (pending and pending[0].arrival_time <= t and
                   len(active) < self.cc.concurrency_cap):
                active.append(states[pending.pop(0).job_id])
            if not active:
                if pending:
                    t = pending[0].arrival_time
                    continue
                break

            # group all active jobs; allocate cluster chips group-by-group
            # (urgency first); groups that do not fit queue this horizon.
            pressure = bool(pending and pending[0].arrival_time <= t) or \
                len(active) > self.cc.concurrency_cap // 2
            groups = self.policy(active, self.cc, pressure)
            groups.sort(key=lambda g: -g.urgency())
            free = self.cc.total_chips
            running: List[Group] = []
            for g in groups:
                if g.chips <= free:
                    running.append(g)
                    free -= g.chips
            running_ids = {j.spec.job_id for g in running for j in g.jobs}
            for jid in running_ids:
                if logs[jid].start is None:
                    logs[jid].start = t

            # advance to the next FUTURE arrival or a full horizon; jobs
            # already arrived but blocked by the concurrency cap queue.
            next_arrival = next((j.arrival_time for j in pending
                                 if j.arrival_time > t), float("inf"))
            horizon_end = min(t + self.cc.horizon, max(next_arrival, t + 1.0))
            if max_time is not None:
                horizon_end = min(horizon_end, max_time)
            dt = horizon_end - t

            for g in running:
                step_t = self._group_step_time(g)
                if self.execution is not None:
                    # the backend records the UNCALIBRATED analytic
                    # prediction (its calibrated counterpart is computed
                    # backend-side) so StepRecords measure how much the
                    # online fit improves on the static constants
                    measured = self.execution.observe(
                        self._cfg_of(g.jobs[0].spec.base_model), g,
                        self._group_step_time(g, calibrated=False), t)
                    if measured:
                        step_t = measured
                comp_t = self._group_compute_time(g)
                steps = int(dt / step_t)
                grouped = len(g.jobs) > 1
                for s in g.jobs:
                    remaining = s.spec.steps_budget - s.steps_done
                    done = min(steps, remaining)
                    s.steps_done += done
                    s.current_step_time = step_t
                    lg = logs[s.spec.job_id]
                    lg.steps_done += done
                    if grouped:
                        lg.grouped_steps += done
                    samples += done * s.spec.batch_size
                    if s.done and lg.finish is None:
                        lg.finish = t + done * step_t
                busy += g.chips * dt
                useful += g.chips * min(dt, steps * comp_t)

            active = [j for j in active if not j.done]
            series.append((t, samples / max(t + dt, 1e-9)))
            t = horizon_end
            if max_time is not None and t >= max_time:
                break

        return SimResult(logs=logs, makespan=t, samples_done=samples,
                         busy_chip_seconds=busy, useful_chip_seconds=useful,
                         total_chips=self.cc.total_chips,
                         throughput_series=series,
                         step_records=list(self.execution.records[rec0:])
                         if self.execution is not None else [],
                         regroup_events=self.execution.regroup_events - ev0
                         if self.execution is not None else 0)
