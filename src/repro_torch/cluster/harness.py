"""Long-horizon trace harness: the live controller under fire (a copy of
``repro.cluster.harness`` for the port, held to it by the tests).

``ClusterSimulator`` replays traces against the analytic oracle; this
module replays them against the REAL ``ClusterController`` — arrivals
submit jobs into a budget-mode run (``begin(until_budget=True)``),
completions are reaped at pump exit, failures are detected and recovered
by the supervisor (``supervise``), and every metric is MEASURED wall
clock, not predicted: per-job JCT, cluster throughput, utilization
samples, and per-fault recovery latencies.  With a ``FaultPlan``
attached to the controller, the same loop doubles as the survival
benchmark behind ``benchmarks/bench_trace.py`` (DESIGN.md §12).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from repro_torch.core.jobs import LoRAJobSpec
from repro_torch.cluster.faults import FailureRecord
from repro_torch.cluster.metrics import jct_stats, recovery_stats


@dataclass
class JobLog:
    """Measured lifecycle of one trace job."""
    job_id: str
    arrival_s: float                  # harness wall (run-relative)
    batch_size: int
    steps_budget: int
    start_s: Optional[float] = None   # first observed in a live group
    finish_s: Optional[float] = None  # retired at its budget
    poisoned: bool = False

    @property
    def jct_s(self) -> Optional[float]:
        return None if self.finish_s is None \
            else self.finish_s - self.arrival_s


@dataclass
class TraceRunResult:
    wall_s: float
    pool_devices: int
    logs: Dict[str, JobLog]
    failures: List[FailureRecord]
    util_samples: List[float] = field(default_factory=list)
    total_steps: int = 0
    total_samples: int = 0
    timed_out: bool = False

    @property
    def completed(self) -> List[str]:
        return [j for j, l in self.logs.items() if l.finish_s is not None]

    @property
    def poisoned(self) -> List[str]:
        return [j for j, l in self.logs.items() if l.poisoned]

    @property
    def lost(self) -> List[str]:
        """Jobs that neither completed nor survived as poisoned-parked —
        a recovery contract violation if ever non-empty."""
        return [j for j, l in self.logs.items()
                if l.finish_s is None and not l.poisoned]

    @property
    def utilization(self) -> float:
        s = self.util_samples
        return sum(s) / len(s) if s else 0.0

    @property
    def throughput_samples_per_sec(self) -> float:
        return self.total_samples / max(self.wall_s, 1e-9)

    def summary(self) -> dict:
        jcts = [l.jct_s for l in self.logs.values()
                if l.jct_s is not None]
        return {"jobs": len(self.logs),
                "completed": len(self.completed),
                "poisoned": len(self.poisoned),
                "lost_jobs": len(self.lost),
                "wall_s": self.wall_s,
                "throughput_samples_per_sec":
                    self.throughput_samples_per_sec,
                "total_steps": self.total_steps,
                "utilization": self.utilization,
                "timed_out": self.timed_out,
                **jct_stats(jcts),
                "recovery": recovery_stats(self.failures),
                "failures": [f.summary() for f in self.failures]}


class TraceRunner:
    """Drive a live controller with a trace's arrival process.

    Trace arrival times (seconds, possibly spanning months) are mapped
    linearly onto ``arrival_window_s`` of wall clock, preserving order
    and relative spacing — the generator's burst structure survives, at
    a timescale a bench can afford.  The control loop polls at
    ``poll_s``: admit arrivals, supervise failures (detection +
    checkpoint restore + repartition), reap budget-complete pumps,
    sample utilization.  ``max_wall_s`` bounds the whole run."""

    def __init__(self, controller, jobs: Sequence[LoRAJobSpec], *,
                 arrival_window_s: float = 10.0, poll_s: float = 0.05,
                 max_wall_s: float = 900.0,
                 reschedule_cooldown_s: float = 0.5):
        self.ctl = controller
        self.jobs = sorted(jobs, key=lambda j: j.arrival_time)
        self.poll_s = poll_s
        self.max_wall_s = max_wall_s
        self.reschedule_cooldown_s = reschedule_cooldown_s
        span = max((j.arrival_time for j in self.jobs), default=0.0)
        scale = arrival_window_s / span if span > 0 else 0.0
        self._arrivals = [(j.arrival_time * scale, j) for j in self.jobs]

    # ------------------------------------------------------------- loop
    def run(self) -> TraceRunResult:
        ctl = self.ctl
        logs: Dict[str, JobLog] = {}
        util: List[float] = []
        t0 = time.monotonic()
        last_resched = -1e9
        pending = list(self._arrivals)
        ctl.begin(until_budget=True)
        timed_out = False
        try:
            while True:
                now = time.monotonic() - t0
                events = False
                # ---- arrivals
                while pending and pending[0][0] <= now:
                    _, spec = pending.pop(0)
                    ctl.submit(spec)
                    logs[spec.job_id] = JobLog(
                        job_id=spec.job_id, arrival_s=now,
                        batch_size=spec.batch_size,
                        steps_budget=spec.steps_budget)
                    events = True
                # ---- failures: detect, restore, repartition
                recs = ctl.supervise(reschedule=True)
                events = events or bool(recs)
                for jid in ctl.poisoned:
                    if jid in logs and not logs[jid].poisoned:
                        logs[jid].poisoned = True
                        events = True
                # ---- completions
                retired = ctl.reap_completed()
                for jid in retired:
                    logs[jid].finish_s = time.monotonic() - t0
                events = events or bool(retired)
                for jid, log in logs.items():
                    if log.start_s is None and ctl._home(jid) is not None:
                        log.start_s = now
                # ---- keep eligible parked jobs scheduled.  Events
                # trigger immediately; otherwise a cooldown guards
                # against planning every tick (identical groupings are
                # cheap no-ops, but prepare fences are not free).
                eligible_parked = [
                    jid for jid in ctl._parked
                    if ctl._backoff_until.get(jid, 0.0) <= time.monotonic()]
                if eligible_parked and (
                        events or now - last_resched
                        >= self.reschedule_cooldown_s):
                    ctl.reschedule()
                    last_resched = time.monotonic() - t0
                # ---- utilization sample: busy device fraction of the
                # healthy pool (meshless mode: the one shared device is
                # busy whenever any pump is alive)
                if ctl.partition:
                    avail = ctl.available_device_ids()
                    busy = {i for g, s in ctl._slots.items()
                            for i in s.device_ids
                            if g in ctl._workers and ctl._workers[g].alive}
                    util.append(len(busy) / max(len(avail), 1))
                else:
                    util.append(1.0 if any(
                        w.alive for w in ctl._workers.values()) else 0.0)
                # ---- termination
                if not pending and not ctl.active_job_ids \
                        and not ctl._workers:
                    break
                if time.monotonic() - t0 > self.max_wall_s:
                    timed_out = True
                    break
                time.sleep(self.poll_s)
        finally:
            try:
                ctl.drain()
            except Exception:
                pass                     # failures already in the log
        wall = time.monotonic() - t0
        total_steps = sum(ctl.steps_done(j) for j in logs)
        total_samples = sum(ctl.steps_done(j) * logs[j].batch_size
                            for j in logs)
        return TraceRunResult(
            wall_s=wall, pool_devices=len(ctl.devices), logs=logs,
            failures=list(ctl.failure_log), util_samples=util,
            total_steps=total_steps, total_samples=total_samples,
            timed_out=timed_out)
