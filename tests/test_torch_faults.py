"""Fault tolerance of the port's controller (``cluster/{faults,harness,
controller}``) on the CPU: tests/test_fault_tolerance.py's single-device
scenarios (recovery from the periodic checkpoints after a mid-chunk
worker death, the poison policy, heartbeat detection of a stuck pump,
the trace runner) on reduced tinyllama-1.1b in f32 with block_t 8 and
``device="cpu"``, the failure records' kinds, members, attempts and
steps lost compared exactly with the reference controller's ("xla"
impl) on the same jobs and fault plans; then a corrupt checkpoint,
whose job restarts from exactly its admission-time init.
"""
import copy
import dataclasses
import os
import time

import pytest
import torch

import jax

from repro.cluster.controller import ClusterController as RefController
from repro.cluster.faults import FaultPlan as RefPlan
from repro.cluster.faults import FaultSpec as RefFault
from repro.cluster.harness import TraceRunner as RefRunner
from repro.configs import get_config as ref_get_config
from repro.core.jobs import LoRAJobSpec as RefSpec

from repro_torch.checkpoint.checkpoint import stream_state
from repro_torch.cluster.controller import ClusterController
from repro_torch.cluster.faults import FaultPlan, FaultSpec
from repro_torch.cluster.harness import TraceRunner
from repro_torch.cluster.metrics import recovery_stats
from repro_torch.configs import get_config
from repro_torch.core.jobs import LoRAJobSpec

from torch_train_common import one_torch_thread  # noqa: F401

CFG = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                          dtype="float32")
REF_CFG = dataclasses.replace(ref_get_config("tinyllama-1.1b").reduced(),
                              dtype="float32")
CHUNK, CKPT_EVERY = 2, 1            # checkpoint period: 2 steps
PERIOD = CHUNK * CKPT_EVERY
PORT = (ClusterController, LoRAJobSpec, FaultPlan, FaultSpec, TraceRunner)
REF = (RefController, RefSpec, RefPlan, RefFault, RefRunner)


def _spec(cls, jid="a", rank=4, batch=2, budget=6):
    return cls(jid, rank=rank, batch_size=batch, seq_len=32,
               base_model=CFG.name, steps_budget=budget)


def _controller(side, tmp_path, plan=None, stuck_after=None, **kw):
    cls = side[0]
    if cls is RefController:
        cfg = REF_CFG
        kw = dict(devices=jax.devices()[:1], impl="xla", **kw)
    else:
        cfg = CFG
        kw = dict(device="cpu", impl="cuda", **kw)
    ctl = cls(lambda m: cfg, block_t=8, lr=1e-2, chunk_size=CHUNK, seed=0,
              checkpoint_dir=str(tmp_path), checkpoint_every=CKPT_EVERY,
              fault_plan=plan, stuck_after=stuck_after, backoff_base_s=0.01,
              **kw)
    ctl.register_cfg(cfg.name, cfg)
    return ctl


def _until(cond, tick, limit=300.0):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < limit
        tick()
        time.sleep(0.02)


def _records(ctl):
    return [(r.kind, r.gkey, r.restored_from_checkpoint, r.restarted_fresh,
             r.poisoned, r.attempts, r.steps_lost) for r in ctl.failure_log]


def _recovery(side, tmp_path):
    """tests/test_fault_tolerance.py:249: a mid-chunk worker death."""
    _, spec, plan_cls, fault, _ = side
    plan = plan_cls([fault("worker_death", job_id="b", at_step=2,
                           phase="inflight")])
    ctl = _controller(side, tmp_path, plan)
    ctl.submit(_spec(spec, "a", budget=8))
    ctl.submit(_spec(spec, "b", rank=8, budget=8))
    groups = ctl.reschedule()
    ctl.begin(until_budget=True)
    assert os.path.exists(tmp_path / "a.npz")
    assert os.path.exists(tmp_path / "b.npz")
    recs = []
    _until(lambda: recs, lambda: recs.extend(ctl.supervise(reschedule=True)))
    rec = recs[0]
    assert rec.kind == "worker_death" and rec.recovered
    assert "b" in rec.gkey
    assert sorted(rec.restored_from_checkpoint) == sorted(rec.gkey)
    assert all(n <= PERIOD for n in rec.steps_lost.values()), rec.steps_lost
    assert rec.detect_latency_s >= 0 and rec.restore_s > 0

    def tick():
        ctl.supervise(reschedule=True)
        ctl.reap_completed()
    _until(lambda: len(ctl.finished) >= 2, tick)
    ctl.drain()
    stats = recovery_stats(ctl.failure_log)
    assert stats["faults"] == stats["recovered"] == 1
    assert stats["max_steps_lost"] <= PERIOD
    return (groups, _records(ctl), ctl.steps_done("a"), ctl.steps_done("b"),
            dict(ctl.poisoned))


def test_recovery_restores_from_checkpoint_and_completes(tmp_path):
    got = _recovery(PORT, tmp_path / "port")
    assert got == _recovery(REF, tmp_path / "ref")
    assert got[2:] == (8, 8, {})


def _poison(side, tmp_path):
    """tests/test_fault_tolerance.py:290: a chronic failer is retried
    max_restarts times, then poisoned while the rest completes."""
    _, spec, plan_cls, fault, _ = side
    plan = plan_cls([fault("worker_death", job_id="sick", at_step=1)
                     for _ in range(8)])
    ctl = _controller(side, tmp_path, plan, max_restarts=2)
    ctl.submit(_spec(spec, "healthy", budget=6))
    ctl.submit(_spec(spec, "sick", rank=8, budget=50))
    ctl.reschedule()
    ctl.begin(until_budget=True)

    def tick():
        ctl.supervise(reschedule=True)
        ctl.reap_completed()
    _until(lambda: "sick" in ctl.poisoned and "healthy" in ctl.finished,
           tick)
    ctl.drain()
    assert ctl.steps_done("healthy") == 6
    assert "sick" not in ctl.active_job_ids
    sick = [r for r in ctl.failure_log if "sick" in r.gkey]
    assert max(r.attempts["sick"] for r in sick) == 3
    assert any(r.poisoned == ["sick"] for r in sick)
    assert ctl._restarts["sick"] == 3
    assert ctl.job_state("sick") is not None
    return ([(r.kind, r.gkey, r.poisoned, r.attempts) for r in sick],
            ctl.steps_done("healthy"), sorted(ctl.poisoned))


def test_poison_policy_parks_chronic_failer_cluster_survives(tmp_path):
    got = _poison(PORT, tmp_path / "port")
    assert got == _poison(REF, tmp_path / "ref")


def test_stuck_worker_detected_by_heartbeat(tmp_path):
    """tests/test_fault_tolerance.py:319: a wedged pump never raises; the
    heartbeat catches it, it is recovered like a death, and its zombie
    thread exits once it honours stop()."""
    plan = FaultPlan([FaultSpec("stuck_worker", job_id="w", at_step=2,
                                stuck_s=120.0)])
    ctl = _controller(PORT, tmp_path, plan, stuck_after=1.5,
                      startup_grace_s=120.0)
    ctl.submit(_spec(LoRAJobSpec, "w", budget=6))
    ctl.reschedule()
    ctl.begin(until_budget=True)
    recs = []
    _until(lambda: recs, lambda: recs.extend(ctl.supervise(reschedule=True)))
    rec = recs[0]
    assert rec.kind in ("stuck_worker", "stuck"), rec
    assert rec.restored_from_checkpoint == ["w"]
    assert all(n <= PERIOD for n in rec.steps_lost.values()), rec.steps_lost

    def tick():
        ctl.supervise(reschedule=True)
        ctl.reap_completed()
    _until(lambda: "w" in ctl.finished, tick)
    ctl.drain()
    assert ctl.steps_done("w") == 6 and not ctl.poisoned
    _until(lambda: not ctl._zombies,
           lambda: ctl.supervise(reschedule=False), limit=60.0)
    assert not ctl.quarantined


def _trace(side, tmp_path):
    """tests/test_fault_tolerance.py:354: three arrivals, run to budget."""
    _, spec, _, _, runner = side
    jobs = [dataclasses.replace(_spec(spec, f"t{i}", budget=4),
                                arrival_time=i) for i in range(3)]
    res = runner(_controller(side, tmp_path), jobs, arrival_window_s=1.0,
                 max_wall_s=300.0).run()
    assert not res.lost and not res.poisoned and not res.timed_out
    s = res.summary()
    assert s["lost_jobs"] == 0 and s["completed"] == 3
    assert s["p50_jct_s"] > 0 and s["utilization"] > 0
    return sorted(res.completed), res.total_steps, res.total_samples


def test_trace_runner_meshless_smoke(tmp_path):
    got = _trace(PORT, tmp_path / "port")
    assert got == _trace(REF, tmp_path / "ref")
    assert got == (["t0", "t1", "t2"], 12, 24)


def test_corrupt_checkpoint_restarts_from_the_admission_time_init(tmp_path):
    """The victim's checkpoint is truncated before its pump dies: its
    restore takes the ``CheckpointCorrupt`` fallback and restarts from
    exactly the state ``submit`` drew (adapter, moments, Adam step, data
    stream), while its group peers restore from their checkpoints; both
    then reach their budgets."""
    plan = FaultPlan([FaultSpec("corrupt_checkpoint", job_id="v",
                                at_step=2)])
    ctl = _controller(PORT, tmp_path, plan)
    admitted = copy.deepcopy(ctl.submit(_spec(LoRAJobSpec, "v", budget=6)))
    ctl.submit(_spec(LoRAJobSpec, "p", rank=8, budget=6))
    ctl.apply_grouping([("v", "p")])
    ctl.begin(until_budget=True)
    recs = []
    _until(lambda: recs,
           lambda: recs.extend(ctl.supervise(reschedule=False)))
    rec = recs[0]
    assert rec.kind == "corrupt_checkpoint" and rec.recovered
    assert rec.restarted_fresh == ["v"]
    assert rec.restored_from_checkpoint == ["p"]
    assert rec.steps_lost["p"] <= PERIOD
    assert rec.steps_lost["v"] == 2          # back to step 0
    st = ctl._parked["v"]
    assert (st.opt_step, st.steps_done) == (0, 0)
    for part in ("adapter", "mu", "nu"):
        want, have = getattr(admitted, part), getattr(st, part)
        assert sorted(want) == sorted(have)
        assert all(torch.equal(want[k], have[k]) for k in want), part
    assert stream_state(st.stream) == stream_state(admitted.stream)

    def tick():
        ctl.supervise(reschedule=True)
        ctl.reap_completed()
    _until(lambda: len(ctl.finished) == 2, tick)
    ctl.drain()
    assert ctl.steps_done("v") == 6 and ctl.steps_done("p") == 6
