"""The port's pricing and scheduling copies (``core/throughput``,
``core/scheduler``, ``core/jobs.JobRuntimeState``, ``launch/mesh``'s
device arithmetic, ``models/model.adapter_param_count``,
``core/ssm.pipeline_legal_stages``) held to the reference.

First the copies' sources against their originals (the one substitution
``repro.`` -> ``repro_torch.``; ``H100`` is the port's one addition), then
their results under ``V5E`` against the reference's, exactly, on the
cases of tests/test_scheduler.py, tests/test_calibration.py,
tests/test_throughput_properties.py and tests/test_mesh_properties.py:
each case is one function run once over each package's modules.
Hypothesis draws the property tests' inputs (few examples, derandomized,
no deadline).
"""
import dataclasses
import inspect
import json
import math
import random
import types

import pytest
from hypothesis import given, settings, strategies as st

from repro.configs import get_config as ref_get_config
from repro.configs.registry import ARCH_IDS
from repro.core import jobs as ref_jobs
from repro.core import scheduler as ref_scheduler
from repro.core import ssm as ref_ssm
from repro.core import throughput as ref_tp
from repro.launch import mesh as ref_mesh
from repro.models import model as ref_model

from repro_torch.configs import get_config
from repro_torch.core import jobs as port_jobs
from repro_torch.core import scheduler as port_scheduler
from repro_torch.core import ssm as port_ssm
from repro_torch.core import throughput as port_tp
from repro_torch.launch import mesh as port_mesh
from repro_torch.models import model as port_model

REF = types.SimpleNamespace(tp=ref_tp, sched=ref_scheduler, jobs=ref_jobs,
                            mesh=ref_mesh, cfg=ref_get_config)
PORT = types.SimpleNamespace(tp=port_tp, sched=port_scheduler,
                             jobs=port_jobs, mesh=port_mesh, cfg=get_config)
FEW = settings(max_examples=8, deadline=None, derandomize=True)


def both(case, *args):
    """*case* run over the reference's modules and over the port's: the
    results must be equal."""
    want, got = case(REF, *args), case(PORT, *args)
    assert got == want
    return got


# ------------------------------------------------------------- copies
def _src(obj, port: bool) -> str:
    s = inspect.getsource(obj)
    return s if port else s.replace("repro.", "repro_torch.")


@pytest.mark.parametrize("ref_mod,port_mod", [
    (ref_tp, port_tp), (ref_scheduler, port_scheduler)],
    ids=["throughput", "scheduler"])
def test_copies_equal_their_originals(ref_mod, port_mod):
    names = [n for n, v in vars(ref_mod).items()
             if (inspect.isfunction(v) or inspect.isclass(v)
                 or hasattr(v, "__wrapped__"))
             and getattr(v, "__module__", None) == ref_mod.__name__]
    assert names
    for n in names:
        assert _src(getattr(port_mod, n), True) == \
            _src(getattr(ref_mod, n), False), n
    consts = {"V5E", "_BACKBONE_BYTES"} & set(vars(ref_mod))
    for n in consts:       # the two packages' HardwareSpec classes differ
        want, got = getattr(ref_mod, n), getattr(port_mod, n)
        if dataclasses.is_dataclass(want):
            want, got = dataclasses.astuple(want), dataclasses.astuple(got)
        assert got == want, n


def test_small_copies_equal_their_originals():
    assert _src(port_jobs.JobRuntimeState, True) == \
        _src(ref_jobs.JobRuntimeState, False)
    for n in ("device_shares", "legal_stage_counts", "_check_stages"):
        assert _src(getattr(port_mesh, n), True) == \
            _src(getattr(ref_mesh, n), False), n
    assert _src(port_ssm.pipeline_legal_stages, True) == \
        _src(ref_ssm.pipeline_legal_stages, False)


def test_h100_spec():
    """The peaks PERF.md's bounds use, V5E's fitted constants (the chip
    fits them), and the rest of V5E unchanged."""
    h = port_tp.H100
    assert (h.peak_flops, h.hbm_bw, h.hbm_capacity) == (989e12, 3.35e12,
                                                        80e9)
    assert (h.ici_bw, h.dcn_bw, h.chips_per_node) == (450e9, 50e9, 8)
    v = port_tp.V5E
    for f in ("mfu_cap", "launch_overhead", "step_overhead", "sat_tokens",
              "kernels_per_layer", "sync_latency", "regroup_overhead",
              "backbone_bytes_per_param"):
        assert getattr(h, f) == getattr(v, f), f
    assert dataclasses.astuple(v) == dataclasses.astuple(ref_tp.V5E)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_and_stages_equal_the_reference(arch):
    """Every config, the families the port does not run included: the
    pricing needs only their shapes."""
    rc, pc = ref_get_config(arch), get_config(arch)
    assert port_tp.param_counts(pc) == ref_tp.param_counts(rc)
    for ranks in ([1], [4, 16, 64]):
        assert port_model.adapter_param_count(pc, ranks) == \
            ref_model.adapter_param_count(rc, ranks)
    assert port_ssm.pipeline_legal_stages(pc) == \
        ref_ssm.pipeline_legal_stages(rc)
    hw8 = port_tp.with_backbone_dtype(port_tp.V5E, "int8")
    assert port_tp.min_chips(pc) == ref_tp.min_chips(rc)
    assert port_tp.min_chips(pc, hw=hw8) == ref_tp.min_chips(
        rc, hw=ref_tp.with_backbone_dtype(ref_tp.V5E, "int8"))


# ----------------------------------------------- tests/test_scheduler.py
SCHED_CFG = "recurrentgemma-9b"


def _state(P, jid, rank=4, batch=1, gpus=2, seq=512, max_slowdown=1.5,
           budget=1000, steps_done=0):
    cfg = P.cfg(SCHED_CFG)
    s = P.jobs.JobRuntimeState(spec=P.jobs.LoRAJobSpec(
        jid, rank=rank, batch_size=batch, seq_len=seq, gpus=gpus,
        max_slowdown=max_slowdown, base_model=cfg.name,
        steps_budget=budget), steps_done=steps_done)
    s.standalone_step_time = P.tp.standalone_step_time(cfg, s.spec)
    return s


def _groups(gs):
    return [(g.job_ids, g.chips, g.spans_nodes, g.stages) for g in gs]


def _schedule(P, kind):
    cfg = P.cfg(SCHED_CFG)
    sched = P.sched.AdapterScheduler(cfg)
    if kind == "complementary":
        jobs = [_state(P, f"s{i}") for i in range(6)]
        return _groups(sched.schedule(jobs, pressure=True))
    if kind == "slowdown":
        jobs = [_state(P, f"j{i}", batch=2, max_slowdown=1.05)
                for i in range(5)]
        gs = sched.schedule(jobs, pressure=True)
        return _groups(gs), [sorted(P.tp.slowdowns(
            cfg, g.specs, g.chips, spans_nodes=g.spans_nodes).items())
            for g in gs]
    if kind == "mixed_seq":
        return _groups(sched.schedule(
            [_state(P, "a", seq=512), _state(P, "b", seq=1024)],
            pressure=True))
    if kind == "urgent":
        urgent = _state(P, "urgent")
        urgent.standalone_step_time, urgent.current_step_time = 0.1, 1.0
        calm = [_state(P, f"c{i}") for i in range(3)]
        return _groups(sched.schedule([*calm, urgent]))
    if kind == "residual":
        small = _state(P, "s", gpus=4)
        return (P.sched.Group([small], 4).residual(cfg, P.tp.V5E),
                P.sched.Group([small, _state(P, "s2", batch=8, gpus=4)],
                              8).residual(cfg, P.tp.V5E))
    if kind == "shrink":
        jobs = [_state(P, f"j{i}", gpus=4, max_slowdown=2.0)
                for i in range(4)]
        return _groups([sched.shrink(P.sched.Group(jobs, 16))])
    if kind == "many":
        jobs = [_state(P, f"j{i}", batch=1 + i % 8, gpus=2 * (1 + i % 4))
                for i in range(64)]
        return _groups(sched.schedule(jobs, pressure=True))
    if kind == "model_sanity":
        j = P.jobs.LoRAJobSpec("x", rank=8, batch_size=4, seq_len=512,
                               gpus=4)
        return [dataclasses.astuple(P.tp.group_step_cost(cfg, [j], c, **kw))
                for c, kw in ((4, {}), (8, {}), (8, {"spans_nodes": True}),
                              (4, {"kernel_fused": False}))]
    if kind in ("gated", "proposed", "calibrated_stall", "identical"):
        done = 199_995 if kind in ("gated", "identical") else 0
        jobs = [_state(P, f"s{i}", steps_done=done, budget=200_000)
                for i in range(6)]
        if kind == "calibrated_stall":
            cal = P.tp.OnlineCalibrator()
            sched = P.sched.AdapterScheduler(cfg, calibrator=cal)
            before = sched.transition_cost()
            cal.observe_regroup(cfg.name, 1e9)
            out = [before, sched.transition_cost()]
        else:
            out = []
        proposal = sched.schedule(jobs, pressure=True)
        if kind == "identical":
            return _groups(sched.filter_transitions(proposal, proposal))
        current = [P.sched.Group([j], 2) for j in jobs]
        gated = sched.schedule(jobs, pressure=True, current_groups=current)
        return out + [_groups(proposal), _groups(gated)]
    raise ValueError(kind)


@pytest.mark.parametrize("kind", [
    "complementary", "slowdown", "mixed_seq", "urgent", "residual",
    "shrink", "many", "model_sanity", "gated", "proposed",
    "calibrated_stall", "identical"])
def test_scheduler_cases_equal_the_reference(kind):
    out = both(_schedule, kind)
    if kind == "complementary":      # the reference test's own claim
        assert any(len(g[0]) > 1 for g in out)


# --------------------------------------------- tests/test_calibration.py
CAL_CFG, CHIPS = "tinyllama-1.1b", 4


def _group(P, batch, n=2, rank=8):
    return [P.jobs.LoRAJobSpec(f"j{batch}-{i}", rank=rank, batch_size=batch,
                               seq_len=512) for i in range(n)]


def _synth(P, cal, jobs, alpha, beta):
    return alpha * cal.machine_time(P.cfg(CAL_CFG), jobs, CHIPS) + beta


def _predictions(P, cal):
    cfg = P.cfg(CAL_CFG)
    return [cal.predict(cfg, _group(P, b), CHIPS) for b in (1, 2, 3, 4, 8)]


def _calibrate(P, kind):
    cfg = P.cfg(CAL_CFG)
    if kind == "recovers":
        cal = P.tp.OnlineCalibrator()
        for b in (2, 8, 1, 4):
            cal.observe(cfg, _group(P, b), CHIPS,
                        _synth(P, cal, _group(P, b), 1.7, 0.013))
        return cal.fit(cfg.name, CHIPS, 2), _predictions(P, cal)
    if kind == "uncalibrated":
        cal = P.tp.OnlineCalibrator()
        first = cal.hw_for(cfg.name, CHIPS, 2) is P.tp.V5E
        cal.observe(cfg, _group(P, 2), CHIPS, 0.5)
        return first, cal.hw_for(cfg.name, CHIPS, 2) is P.tp.V5E, \
            cal.calibrated
    if kind == "degenerate":
        cal = P.tp.OnlineCalibrator()
        for _ in range(4):
            cal.observe(cfg, _group(P, 2), CHIPS,
                        _synth(P, cal, _group(P, 2), 2.1, 0.02))
        return cal.fit(cfg.name, CHIPS, 2), _predictions(P, cal)
    if kind == "buckets":
        cal = P.tp.OnlineCalibrator()
        for b in (1, 4):
            cal.observe(cfg, _group(P, b), CHIPS,
                        _synth(P, cal, _group(P, b), 1.5, 0.01))
        return (cal.hw_for("smollm-360m", CHIPS, 2) is P.tp.V5E,
                dataclasses.astuple(cal.hw_for(cfg.name, 8, 2)))
    if kind == "ewma":
        cal = P.tp.OnlineCalibrator(decay=0.6)
        for a, n in ((1.0, 3), (2.0, 8)):
            for _ in range(n):
                for b in (1, 8):
                    cal.observe(cfg, _group(P, b), CHIPS,
                                _synth(P, cal, _group(P, b), a, 0.0))
        return cal.fit(cfg.name, CHIPS, 2)
    if kind == "scheduler":
        cal = P.tp.OnlineCalibrator()
        sched = P.sched.AdapterScheduler(cfg, calibrator=cal)
        for b in (1, 8):
            cal.observe(cfg, _group(P, b), CHIPS,
                        _synth(P, cal, _group(P, b), 3.0, 0.0))
        g = P.sched.Group([P.jobs.JobRuntimeState(spec=s)
                           for s in _group(P, 4)], CHIPS)
        return (dataclasses.astuple(sched.hw_for(CHIPS, 2)),
                sched.throughput(g),
                P.sched.AdapterScheduler(cfg).throughput(g))
    if kind == "regroup":
        cal = P.tp.OnlineCalibrator(decay=0.5)
        out = [cal.regroup_cost(cfg.name)]
        for stall in (10.0, 20.0):
            cal.observe_regroup(cfg.name, stall)
            out.append(cal.regroup_cost(cfg.name))
        return out + [cal.regroup_cost("other-model")]
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["recovers", "uncalibrated", "degenerate",
                                  "buckets", "ewma", "scheduler", "regroup"])
def test_calibration_cases_equal_the_reference(kind):
    both(_calibrate, kind)


@FEW
@given(alpha=st.floats(0.3, 5.0), beta=st.floats(0.0, 0.1),
       head=st.sampled_from([(1, 2), (2, 8), (4, 1), (8, 3)]),
       tail=st.permutations([1, 2, 3, 4, 8, 2]))
def test_calibration_stream_equals_the_reference(alpha, beta, head, tail):
    """tests/test_calibration.py's acceptance property: the predictions
    after every observation of a synthetic stream."""
    def case(P):
        cal, out = P.tp.OnlineCalibrator(), []
        for b in list(head) + list(tail):
            cal.observe(P.cfg(CAL_CFG), _group(P, b), CHIPS,
                        _synth(P, cal, _group(P, b), alpha, beta))
            out.append(_predictions(P, cal))
        return out
    both(case)


@FEW
@given(ranks=st.lists(st.integers(1, 64), min_size=1, max_size=8))
def test_ragged_rank_pricing_equals_the_reference(ranks):
    def case(P):
        jobs = [P.jobs.LoRAJobSpec(f"r{i}-{r}", rank=r, batch_size=2,
                                   seq_len=512) for i, r in enumerate(ranks)]
        return [P.tp.group_step_cost(P.cfg(CAL_CFG), jobs, CHIPS,
                                     ragged_kernels=rg).total
                for rg in (True, False)]
    both(case)


def test_save_load_crosses_the_packages(tmp_path):
    """A table saved by either package loads in the other with the same
    predictions and regroup cost."""
    def fill(P):
        cal = P.tp.OnlineCalibrator(decay=0.9, min_obs=2)
        for b in (2, 8, 1, 4):
            cal.observe(P.cfg(CAL_CFG), _group(P, b), CHIPS,
                        _synth(P, cal, _group(P, b), 1.7, 0.013))
        cal.observe_regroup(CAL_CFG, 12.5)
        cal.observe_regroup(CAL_CFG, 14.5)
        return cal
    for src, dst in ((REF, PORT), (PORT, REF)):
        path = str(tmp_path / "cal.json")
        cal = fill(src)
        cal.save(path)
        back = dst.tp.OnlineCalibrator.load(path)
        assert _predictions(dst, back) == _predictions(src, cal)
        assert back.regroup_cost(CAL_CFG) == cal.regroup_cost(CAL_CFG)
        assert json.load(open(path))["hw"] == dataclasses.asdict(
            dst.tp.V5E)


# ------------------------------------ tests/test_throughput_properties.py
def _job(P, rank, batch, seq=512, gpus=2, jid="j"):
    return P.jobs.LoRAJobSpec(jid, rank=rank, batch_size=batch, seq_len=seq,
                              gpus=gpus)


@FEW
@given(rank=st.sampled_from([2, 4, 8, 16]),
       batch=st.sampled_from([1, 2, 4, 8]),
       chips=st.sampled_from([2, 4, 8, 16, 32]),
       k=st.integers(1, 6), spans=st.booleans(), fused=st.booleans())
def test_step_cost_equals_the_reference(rank, batch, chips, k, spans,
                                        fused):
    def case(P):
        jobs = [_job(P, rank, batch, jid=f"j{i}") for i in range(k)]
        cfg = P.cfg(SCHED_CFG)
        return (dataclasses.astuple(P.tp.group_step_cost(
                    cfg, jobs, chips, spans_nodes=spans,
                    kernel_fused=fused)),
                P.tp.group_throughput(cfg, jobs, chips),
                sorted(P.tp.slowdowns(cfg, jobs, chips).items()),
                P.tp.residual_capacity(cfg, _job(P, rank, batch)))
    both(case)


@FEW
@given(k=st.integers(1, 7), rank=st.sampled_from([2, 4, 8, 16]),
       batch=st.sampled_from([1, 2, 4]), chips=st.sampled_from([2, 4, 8]),
       remat=st.booleans(), dtype=st.sampled_from(["bf16", "int8"]))
def test_memory_model_equals_the_reference(k, rank, batch, chips, remat,
                                           dtype):
    def case(P):
        hw = P.tp.with_backbone_dtype(P.tp.V5E, dtype)
        jobs = [_job(P, rank, batch, jid=f"j{i}") for i in range(k)]
        cfg = P.cfg(SCHED_CFG)
        return (P.tp.group_memory_bytes(cfg, jobs, chips, hw=hw,
                                        remat=remat),
                P.tp.memory_feasible(cfg, jobs, chips, hw=hw, remat=remat),
                P.tp.max_feasible_k(cfg, _job(P, rank, batch, seq=64),
                                    chips, hw=hw))
    both(case)


# ----------------------------------------- tests/test_mesh_properties.py
def test_device_shares_edge_cases_equal_the_reference():
    for w, n in (([], 8), ([4, 4, 4], 2), ([1, 1], 8), ([0.0, 8], 8),
                 ([8, 2], 8)):
        assert port_mesh.device_shares(w, n) == ref_mesh.device_shares(w, n)
    for n in (1, 6, 7, 8, 12):
        assert port_mesh.legal_stage_counts(n) == \
            ref_mesh.legal_stage_counts(n)
        for s in (1, 2, 3, 4):
            try:
                want = ref_mesh._check_stages(s, n, "slice")
            except ValueError as e:
                with pytest.raises(ValueError, match=str(e)[:20]):
                    port_mesh._check_stages(s, n, "slice")
            else:
                assert port_mesh._check_stages(s, n, "slice") == want


def test_device_shares_sweep_equals_the_reference():
    rng = random.Random(0)
    for _ in range(500):
        k = rng.randint(0, 12)
        weights = [rng.choice([rng.randint(0, 16), rng.uniform(0.0, 16.0)])
                   for _ in range(k)]
        n = rng.randint(0, 64)
        assert port_mesh.device_shares(weights, n) == \
            ref_mesh.device_shares(weights, n)


@settings(max_examples=50, deadline=None, derandomize=True)
@given(weights=st.lists(st.one_of(st.integers(0, 64),
                                  st.floats(0.0, 64.0, allow_nan=False)),
                        min_size=0, max_size=16),
       n=st.integers(0, 128))
def test_device_shares_property_equals_the_reference(weights, n):
    got = port_mesh.device_shares(weights, n)
    assert got == ref_mesh.device_shares(weights, n)
    if weights and n >= len(weights):
        caps = [max(1, math.ceil(max(float(w), 1e-9))) for w in weights]
        assert sum(got) == min(n, sum(caps))
