"""Deterministic fault injection + failure records (DESIGN.md §12): a
copy of ``repro.cluster.faults`` for the port, held to it by the tests.

The fault-tolerance contract is only worth what its tests can prove, so
every failure mode the supervisor handles must be reproducible on
demand.  ``FaultPlan`` is a seedable script of ``FaultSpec``s injected
into ``GroupWorker``'s chunk pump via its ``fault_hook`` seam:

  * ``worker_death``   — the pump raises at a chunk boundary or, with
    ``phase="inflight"``, between dispatch and collect (the in-flight
    chunk's steps are lost — the hard case for steps-lost accounting).
  * ``submesh_loss``   — same raise, but the supervisor treats the
    group's devices as gone: they are quarantined permanently and the
    pool shrinks.
  * ``stuck_worker``   — the pump wedges (sleeps past ``stuck_after`` /
    ``join_timeout``) without raising, exercising heartbeat detection;
    it honours ``stop()`` so the zombie thread exits promptly once the
    supervisor has moved on, releasing its quarantined devices.
  * ``corrupt_checkpoint`` — the victim job's checkpoint file is
    truncated in place *before* the pump dies, so the restore path must
    take the typed ``CheckpointCorrupt`` fallback (restart from the
    admission-time init) instead of crashing.

Faults fire at most once, under a lock, at a deterministic trigger
(victim job + worker step count), so a trace run with a given plan and
seed replays the same failure schedule every time.
"""
from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

KINDS = ("worker_death", "submesh_loss", "stuck_worker",
         "corrupt_checkpoint")


class InjectedFault(RuntimeError):
    """Raised inside a chunk pump by an armed ``FaultSpec``.  Carries
    the fault kind so the supervisor can apply the matching device
    policy (free vs quarantine) and the injection timestamp so
    detection latency is measured, not guessed."""

    def __init__(self, kind: str, gkey: Tuple[str, ...], at_step: int,
                 t_injected: float):
        super().__init__(
            f"injected {kind} in group {gkey} at step {at_step}")
        self.kind = kind
        self.gkey = gkey
        self.at_step = at_step
        self.t_injected = t_injected


@dataclass(frozen=True)
class FaultSpec:
    """One scripted failure: fire in the group containing ``job_id``
    once that group's pump has completed ``at_step`` steps.

    ``phase`` picks the seam: ``"boundary"`` (before dispatch — no work
    in flight, steps lost limited to the checkpoint period) or
    ``"inflight"`` (after dispatch, before collect — the dispatched
    chunk is additionally lost).  ``stuck_s`` bounds how long a
    ``stuck_worker`` wedges before exiting on its own."""
    kind: str
    job_id: str
    at_step: int = 0
    phase: str = "boundary"
    stuck_s: float = 60.0

    def __post_init__(self):
        assert self.kind in KINDS, self.kind
        assert self.phase in ("boundary", "inflight"), self.phase


@dataclass
class FaultRecord:
    """What actually fired: bound at injection time."""
    spec: FaultSpec
    gkey: Tuple[str, ...]
    step: int
    t_injected: float


class FaultPlan:
    """A deterministic, seedable schedule of faults.

    The plan is shared by every pump (hooks run in worker threads), so
    matching is done under a lock and each fault fires exactly once.
    ``checkpoint_dir`` is bound by the controller so
    ``corrupt_checkpoint`` faults can truncate the victim's file."""

    def __init__(self, faults: Sequence[FaultSpec], seed: int = 0):
        self.faults: List[FaultSpec] = list(faults)
        self.seed = seed
        self.fired: Dict[int, FaultRecord] = {}
        self.checkpoint_dir: Optional[str] = None
        self._lock = threading.Lock()

    @classmethod
    def sample(cls, job_ids: Sequence[str], kinds: Sequence[str],
               max_step: int = 8, seed: int = 0,
               phase: str = "boundary", stuck_s: float = 60.0
               ) -> "FaultPlan":
        """Draw one fault per kind with rng-chosen victims/steps — the
        same (job_ids, kinds, seed) always yields the same plan."""
        rng = np.random.default_rng(seed)
        jobs = list(job_ids)
        specs = [FaultSpec(kind=k,
                           job_id=jobs[int(rng.integers(len(jobs)))],
                           at_step=int(rng.integers(1, max_step + 1)),
                           phase=phase, stuck_s=stuck_s)
                 for k in kinds]
        return cls(specs, seed=seed)

    @property
    def pending(self) -> List[FaultSpec]:
        return [f for i, f in enumerate(self.faults)
                if i not in self.fired]

    # ------------------------------------------------------------ hooks
    def _match(self, gkey: Tuple[str, ...], steps_of, phase: str
               ) -> Optional[int]:
        for i, f in enumerate(self.faults):
            if i in self.fired:
                continue
            if f.phase == phase and f.job_id in gkey \
                    and steps_of(f.job_id) >= f.at_step:
                return i
        return None

    def worker_hook(self, gkey: Tuple[str, ...]):
        """The ``GroupWorker(fault_hook=...)`` callable for one group.

        ``at_step`` triggers on the victim JOB's cumulative step count
        (``GroupRuntime.steps_done``), not the pump's local counter —
        regroups replace pumps mid-run, and a per-pump trigger could
        reset forever without firing."""
        def hook(worker, phase: str):
            def steps_of(jid):
                return worker.runtime.steps_done.get(jid,
                                                     worker.steps_run)
            with self._lock:
                idx = self._match(gkey, steps_of, phase)
                if idx is None:
                    return
                f = self.faults[idx]
                t_inj = time.monotonic()
                step = steps_of(f.job_id)
                self.fired[idx] = FaultRecord(
                    spec=f, gkey=tuple(gkey), step=step,
                    t_injected=t_inj)
            if f.kind == "corrupt_checkpoint":
                self._truncate_checkpoint(f.job_id)
            elif f.kind == "stuck_worker":
                # wedge without raising until the supervisor detects us
                # via heartbeat; honour stop() so the zombie thread
                # exits soon after recovery moves on
                t0 = time.monotonic()
                while time.monotonic() - t0 < f.stuck_s \
                        and not worker._stop:
                    time.sleep(0.05)
            raise InjectedFault(f.kind, tuple(gkey), step, t_inj)
        return hook

    def _truncate_checkpoint(self, job_id: str) -> None:
        if not self.checkpoint_dir:
            return
        path = os.path.join(self.checkpoint_dir, f"{job_id}.npz")
        if os.path.exists(path):
            size = os.path.getsize(path)
            with open(path, "r+b") as fh:
                fh.truncate(max(size // 3, 8))


@dataclass
class FailureRecord:
    """One supervised recovery, as measured by the controller."""
    gkey: Tuple[str, ...]
    kind: str                                # fault kind or "crash"/"stuck"
    detect_latency_s: float                  # injection/death -> poll
    restore_s: float = 0.0                   # detection -> pumps respawned
    steps_lost: Dict[str, int] = field(default_factory=dict)
    restored_from_checkpoint: List[str] = field(default_factory=list)
    restarted_fresh: List[str] = field(default_factory=list)
    poisoned: List[str] = field(default_factory=list)
    quarantined_devices: Tuple[int, ...] = ()
    attempts: Dict[str, int] = field(default_factory=dict)

    @property
    def recovered(self) -> bool:
        """Every affected job survived (checkpoint or fresh restart)."""
        return not self.poisoned

    def summary(self) -> dict:
        return {"gkey": list(self.gkey), "kind": self.kind,
                "detect_latency_s": self.detect_latency_s,
                "restore_s": self.restore_s,
                "steps_lost": dict(self.steps_lost),
                "restored_from_checkpoint":
                    list(self.restored_from_checkpoint),
                "restarted_fresh": list(self.restarted_fresh),
                "poisoned": list(self.poisoned),
                "quarantined_devices": list(self.quarantined_devices),
                "attempts": dict(self.attempts),
                "recovered": self.recovered}
