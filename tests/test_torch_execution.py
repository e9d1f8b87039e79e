"""The port's execution backend (``cluster/execution``) inside its cluster
simulator, on the CPU: tests/test_elastic.py:74's execution-backed
simulation on reduced tinyllama-1.1b in f32 with block_t 8 and
``device="cpu"``, against the reference's backend ("ref" impl) on the
same trace.

The simulator advances its clock by the measured step times, which
differ between two machines' runs, so the comparison pins the simulated
step to the analytic price on both sides (``observe`` runs its real
steps and records them, then hands the simulator no measurement; the
backends' calibrators fit a spec with twice V5E's peak, which a V5E
simulator does not price with): the executed groupings, their horizons, chips and
predictions, and the live migrations are then compared exactly.  The
reference test's own assertions run on the port unpinned, fed recorded
step times (``RECORDED_STEP_S``) instead of this host's wall clock.
"""
import dataclasses

import pytest
import torch

from repro.cluster.execution import ExecutionBackend as RefBackend
from repro.cluster.simulator import ClusterConfig as RefClusterConfig
from repro.cluster.simulator import ClusterSimulator as RefSimulator
from repro.cluster.simulator import tlora_policy as ref_tlora_policy
from repro.configs import get_config as ref_get_config
from repro.core import throughput as ref_tp
from repro.core.jobs import LoRAJobSpec as RefSpec

from repro_torch.cluster.execution import ExecutionBackend
from repro_torch.cluster.simulator import (ClusterConfig, ClusterSimulator,
                                           tlora_policy)
from repro_torch.configs import get_config
from repro_torch.core import throughput as tp
from repro_torch.core.jobs import LoRAJobSpec

from torch_train_common import one_torch_thread  # noqa: F401

BT = 8
MODEL = "tinyllama-1.1b"
PORT = (ExecutionBackend, ClusterConfig, ClusterSimulator, tlora_policy,
        LoRAJobSpec, tp, get_config, dict(device="cpu", impl="cuda"))
REF = (RefBackend, RefClusterConfig, RefSimulator, ref_tlora_policy,
       RefSpec, ref_tp, ref_get_config, dict(impl="ref"))


def _trace(spec):
    def J(i, arr, budget, rank=4):
        return spec(f"j{i}", rank=rank, batch_size=1, seq_len=32,
                    base_model=MODEL, steps_budget=budget,
                    arrival_time=arr, max_slowdown=2.0)
    return [J(0, 0.0, 20_000), J(1, 0.0, 20_000, rank=8),
            J(2, 40.0, 4_000, rank=2)]


def _simulate(side, pinned: bool):
    backend_cls, cc_cls, sim_cls, policy, spec, tpm, get, kw = side
    cfg = dataclasses.replace(get(MODEL).reduced(), dtype="float32")
    cc = cc_cls(total_chips=8, horizon=30.0, concurrency_cap=4,
                reduced_models=True)
    hw = dataclasses.replace(tpm.V5E, peak_flops=2 * tpm.V5E.peak_flops) \
        if pinned else tpm.V5E
    backend = backend_cls(steps_per_measure=2, block_t=BT, hw=hw, **kw)
    if pinned:
        run_steps = backend.observe
        backend.observe = lambda *a: run_steps(*a) and None
    sim = sim_cls(cc, None, cfg_of=lambda m: cfg, execution=backend)
    sim.policy = policy(sim._cfg_of)
    res = sim.run(_trace(spec), max_time=700.0)
    return backend, res


def _executed(backend, res):
    return ([(r.t, r.base_model, r.job_ids, r.chips, r.predicted)
             for r in res.step_records], res.regroup_events,
            backend.regroup_events, backend.summary()["observations"],
            sorted((j, backend.engine(MODEL).steps_done(j))
                   for j in ("j0", "j1", "j2")))


def test_executed_groupings_match_reference():
    got = _executed(*_simulate(PORT, pinned=True))
    assert got == _executed(*_simulate(REF, pinned=True))
    assert got[1] >= 2 and any(len(g) > 1 for _, _, g, _, _ in got[0])


# Fused step times of this test's groups on an unloaded 8-core host
# (seconds, by the number of batch-1 jobs in the group; K = 1 read
# 0.022-0.051 and K = 3 0.031-0.056 over two runs).  The unpinned
# simulator advances its clock by the measured step, so the regroups it
# makes follow the host's speed: beside three busy loops on its core a
# step read 0.236 s and the run made one regroup instead of three.  The
# test feeds these recorded times as the measurement; the steps still
# run.
RECORDED_STEP_S = {1: 0.025, 2: 0.035, 3: 0.045}


def test_execution_backed_simulator(monkeypatch):
    """tests/test_elastic.py:74 on the port: >= 2 regroup events, measured
    and predicted step times for every executed horizon, a fused group
    executed, and the live state's step counts behind it."""
    from repro_torch.elastic.runtime import TrainReport
    monkeypatch.setattr(
        TrainReport, "measured_step_time",
        lambda self, window=8: RECORDED_STEP_S[self.samples_per_step])
    backend, res = _simulate(PORT, pinned=False)
    assert res.step_records, "no execution observations recorded"
    assert res.regroup_events >= 2, res.regroup_events
    for r in res.step_records:
        assert r.predicted > 0 and r.measured > 0
    assert any(len(r.job_ids) > 1 for r in res.step_records)
    summ = backend.summary()
    assert summ["observations"] == len(res.step_records)
    assert summ["mean_measured_s"] > 0
    eng = backend.engine(MODEL)
    assert eng is not None and eng.regroup_events >= 2
    total_real = sum(eng.steps_done(j) for j in ("j0", "j1", "j2")
                     if j in eng.job_ids or j in eng.finished)
    assert total_real >= 2 * len(res.step_records)
    assert backend.controller.devices == [torch.device("cpu")]


def test_executable_models_and_backend_defaults():
    """tests/test_controller.py:221 on the port: registry-driven
    discovery, and the backend's calibrator on the spec it is given."""
    from repro_torch.cluster.execution import (EXECUTABLE_MODELS,
                                               executable_models)
    got = executable_models()
    assert "smollm-360m" in got and "tinyllama-1.1b" in got
    assert "qwen1.5-110b" not in got and "command-r-35b" not in got
    assert EXECUTABLE_MODELS == got
    assert len(executable_models(max_params=1e12)) > len(got)
    be = ExecutionBackend(block_t=BT, device="cpu")
    assert be.models == got and be.calibrator.hw == tp.V5E
    assert ExecutionBackend(hw=tp.H100, device="cpu").calibrator.hw \
        == tp.H100
    with pytest.raises(AssertionError):
        ExecutionBackend(steps_per_measure=1, device="cpu")
