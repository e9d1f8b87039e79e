"""Event-driven control-plane primitives (DESIGN.md §11): a copy of
``repro.cluster.control`` for the port, held to it by the tests.

The runtime's ``dispatch_chunk``/``collect_chunk`` split lets a
controller keep disjoint submeshes busy; this module reduces the
per-group thread to a *chunk pump* the control thread can fence, and
adds the bookkeeping for zero-stall transitions:

  * ``GroupWorker`` — one group's dispatch/collect loop, mirroring
    ``GroupRuntime.run``'s chunk cadence exactly (threads-vs-sequential
    bit-exactness) but pausable at chunk boundaries: ``fence`` parks the
    pump where no chunk is in flight, ``resume``/``stop`` release it.
    Exceptions are captured, never swallowed, and every wait is bounded.
  * ``RegroupEvent`` — the per-transition lifecycle record (pause_s /
    migrate_s / compile_s / resume_s) behind the regroup-stall metric.
  * ``PreparedGroup`` — a double-buffered destination: engine + runtime
    assembled (and AOT-warmed) from snapshots while the sources keep
    stepping, consumed at handoff by refreshing members with their
    authoritative fenced exports.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

GroupKey = Tuple[str, ...]


@dataclass
class RegroupEvent:
    """Lifecycle of one grouping transition.

    ``stall_s`` is the pause-to-resume wall time — the window in which
    the affected groups were not training.  ``assemble_s`` is the
    double-buffered work (snapshot + fuse + warm compile) that ran
    *outside* that window in overlapped mode; a stop-the-world
    transition instead pays build + compile inside the window
    (``migrate_s`` + ``compile_s``)."""
    mode: str                     # "overlapped" | "stop_the_world" | "offline"
    groups_built: int = 0
    groups_dissolved: int = 0
    jobs_moved: int = 0
    pause_s: float = 0.0          # fence + dissolve (state export)
    migrate_s: float = 0.0        # build/refresh inside the stall window
    compile_s: float = 0.0        # AOT warm inside the stall window
    resume_s: float = 0.0         # install + worker restart
    assemble_s: float = 0.0       # overlapped background work (off-path)
    # per-job steps_done at the handoff fence (replay-exact audit trail)
    fence_steps: Dict[str, int] = field(default_factory=dict)

    @property
    def stall_s(self) -> float:
        return self.pause_s + self.migrate_s + self.compile_s \
            + self.resume_s

    @property
    def stall_group_s(self) -> float:
        """Group-seconds not training: the headline regroup-stall metric
        (stall window x groups affected)."""
        return self.stall_s * max(self.groups_dissolved, self.groups_built)

    def summary(self) -> Dict[str, float]:
        return {"mode": self.mode, "pause_s": self.pause_s,
                "migrate_s": self.migrate_s, "compile_s": self.compile_s,
                "resume_s": self.resume_s, "assemble_s": self.assemble_s,
                "stall_s": self.stall_s,
                "stall_group_s": self.stall_group_s,
                "groups_built": self.groups_built,
                "groups_dissolved": self.groups_dissolved,
                "jobs_moved": self.jobs_moved}


@dataclass
class PreparedGroup:
    """A destination group assembled ahead of its handoff."""
    gkey: GroupKey
    base_model: str
    engine: object                # ElasticEngine holding the runtime
    runtime: object               # GroupRuntime (unstepped)
    device_ids: Tuple[int, ...]
    chips: int
    mesh: object
    snapshot_steps: Dict[str, int]   # members' steps_done at snapshot
    assemble_s: float = 0.0
    compile_s: float = 0.0

    def matches(self, gkey: GroupKey, device_ids: Tuple[int, ...]) -> bool:
        """The compile-cache key: member set + device slice (the layout
        is a function of the member specs, so it is implied)."""
        return frozenset(self.gkey) == frozenset(gkey) \
            and self.device_ids == tuple(device_ids)


class WorkerFailure(RuntimeError):
    """One or more group workers died (original exceptions chained via
    ``failures``) and/or sat past the shared join deadline (``stuck``).

    ``failures`` maps every failed group's key to its captured
    exception; ``stuck`` names every group still pumping when the
    deadline expired — the full failure picture in ONE raise, so a
    supervisor can quarantine/recover each domain instead of learning
    about concurrent failures one crash at a time."""

    def __init__(self, msg: str,
                 failures: Optional[Dict[GroupKey, BaseException]] = None,
                 stuck: Optional[List[GroupKey]] = None):
        super().__init__(msg)
        self.failures: Dict[GroupKey, BaseException] = dict(failures or {})
        self.stuck: List[GroupKey] = list(stuck or [])


class GroupWorker:
    """Chunk pump for one group: the thread half of the event-driven
    core.  The loop replicates ``GroupRuntime.run``'s cadence — same
    chunk lengths, same prefetch, same AIMD gating — so a threaded
    controller run stays bit-exact with the sequential mode.  Between
    chunks it honours fence/stop requests from the control thread."""

    def __init__(self, gkey: GroupKey, runtime, steps: int,
                 chunk_size: Optional[int] = None,
                 log: Optional[Callable[[str], None]] = None,
                 fault_hook: Optional[Callable[["GroupWorker", str],
                                               None]] = None):
        self.gkey = gkey
        self.runtime = runtime
        self.remaining = int(steps)
        self.chunk = max(1, chunk_size or runtime.chunk_size)
        self.log = log
        self.fault_hook = fault_hook  # fault injection seam (faults.py)
        self.steps_run = 0            # steps completed by THIS worker
        self.exception: Optional[BaseException] = None
        self.t_failed: Optional[float] = None   # monotonic, at capture
        self.last_beat = time.monotonic()       # heartbeat: last collect
        self._fence_req = threading.Event()
        self._resume_evt = threading.Event()
        self._stop = False
        self.fenced = threading.Event()   # set while parked at a boundary
        self.done = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"group-{'+'.join(gkey)[:40]}")

    def start(self):
        self.last_beat = time.monotonic()
        self._thread.start()

    # ------------------------------------------------------------- pump
    def _loop(self):
        rt = self.runtime
        try:
            L = min(self.chunk, self.remaining)
            while self.remaining > 0:
                if self._fence_req.is_set():
                    self.fenced.set()
                    self._resume_evt.wait()
                    self.fenced.clear()
                    self.last_beat = time.monotonic()  # fence ≠ stuck
                    continue
                if self._stop:
                    break
                if self.fault_hook is not None:
                    self.fault_hook(self, "boundary")
                nxt = self.chunk if self.remaining - L >= self.chunk \
                    else min(1, self.remaining - L)
                pending = rt.dispatch_chunk(
                    L, prefetch=nxt,
                    count_aimd=L > 1 or self.chunk == 1)
                if self.fault_hook is not None:
                    # mid-chunk seam: the chunk is in flight, its collect
                    # has not run — a kill here loses the in-flight steps
                    self.fault_hook(self, "inflight")
                rt.collect_chunk(pending, log=self.log)
                self.remaining -= L
                self.steps_run += L
                self.last_beat = time.monotonic()
                L = nxt if nxt > 0 else L
        except BaseException as e:          # surfaced by finish()
            self.exception = e
            self.t_failed = time.monotonic()
        finally:
            self.done.set()
            self.fenced.set()     # a fence waiter must never hang on us

    # ---------------------------------------------------------- control
    def fence(self, timeout: Optional[float] = None) -> bool:
        """Park the pump at the next chunk boundary (no chunk in flight,
        collect done).  Returns True when parked — or when the worker
        already finished/died, which is an equally quiescent state."""
        self._resume_evt.clear()
        self._fence_req.set()
        ok = self.fenced.wait(timeout)
        return ok or self.done.is_set()

    def resume(self):
        self._fence_req.clear()
        self._resume_evt.set()

    def stop(self):
        """Ask the pump to exit at the next boundary (releases a fence)."""
        self._stop = True
        self._fence_req.clear()
        self._resume_evt.set()

    def join(self, timeout: Optional[float] = None) -> bool:
        self._thread.join(timeout)
        return not self._thread.is_alive()

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()


def join_workers(workers: Dict[GroupKey, "GroupWorker"],
                 timeout: Optional[float] = None) -> None:
    """Bounded join over a worker set; surfaces failures instead of
    hanging (the controller-shutdown contract).

    Waits for every pump with one shared deadline.  A worker exception
    stops the remaining pumps at their next boundary, but joining keeps
    COLLECTING until every pump is done or the deadline expires — so
    concurrent failures are never masked by the first raise.  The single
    ``WorkerFailure`` raised at the end carries the complete picture:
    ``failures`` (every dead group's exception, first one chained as
    ``__cause__``) and ``stuck`` (every group still alive past the
    deadline)."""
    deadline = None if timeout is None else time.monotonic() + timeout
    pending = dict(workers)
    failures: Dict[GroupKey, BaseException] = {}
    while pending:
        for gkey, w in list(pending.items()):
            left = None if deadline is None \
                else max(0.0, deadline - time.monotonic())
            if w.done.wait(min(left, 0.1) if left is not None else 0.1):
                pending.pop(gkey)
                if w.exception is not None:
                    failures[gkey] = w.exception
                    # contain the blast: park the healthy pumps at their
                    # next boundary, then keep collecting their results
                    for other in workers.values():
                        other.stop()
        if deadline is not None and time.monotonic() >= deadline \
                and pending:
            for other in workers.values():
                other.stop()
            break
    stuck = sorted(pending)
    if not failures and not stuck:
        return
    parts = []
    if failures:
        parts.append("group worker(s) failed: " + "; ".join(
            f"{g}: {e!r}" for g, e in sorted(failures.items())))
    if stuck:
        parts.append(f"worker join timed out after {timeout}s; "
                     f"stuck groups: {stuck}")
    err = WorkerFailure("  |  ".join(parts), failures=failures,
                        stuck=stuck)
    if failures:
        raise err from next(iter(failures.values()))
    raise err
