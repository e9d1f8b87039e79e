"""The port's cluster simulation copies (``cluster/{trace,simulator,
baselines,metrics}``) held to the reference on the CPU.

First the copies' sources against their originals (the one substitution
``repro.`` -> ``repro_torch.``), then their results against the
reference's, exactly: the same traces, and every system's summary and
comparison on tests/test_cluster.py's trace under ``V5E`` (the default
spec of both packages).  Then tests/test_cluster.py's nine properties run
on the port's modules, and ``load_csv`` on a small CSV written here.
Host arithmetic only: no tolerance anywhere.
"""
import dataclasses
import inspect

import numpy as np
import pytest

from repro.cluster import baselines as ref_baselines
from repro.cluster import metrics as ref_metrics
from repro.cluster import simulator as ref_simulator
from repro.cluster import trace as ref_trace

from repro_torch.cluster import baselines, metrics, simulator, trace
from repro_torch.cluster.baselines import SYSTEMS, make_simulator
from repro_torch.cluster.metrics import (compare, format_table,
                                         size_terciles, summarize)
from repro_torch.cluster.simulator import ClusterConfig
from repro_torch.cluster.trace import (MONTH, TraceConfig, generate,
                                       month_slice, scale_arrivals)

MODULES = [(ref_trace, trace), (ref_simulator, simulator),
           (ref_baselines, baselines), (ref_metrics, metrics)]
TEST_TRACE = dict(months=1, jobs_per_month=120, steps_mean=2000, seed=1)


def _src(obj, port: bool) -> str:
    s = inspect.getsource(obj)
    return s if port else s.replace("repro.", "repro_torch.")


def _specs(jobs):
    return [dataclasses.astuple(j) for j in jobs]


# ------------------------------------------------------------- copies
@pytest.mark.parametrize("ref_mod,port_mod", MODULES,
                         ids=[m.__name__.split(".")[-1] for m, _ in MODULES])
def test_copies_equal_their_originals(ref_mod, port_mod):
    names = [n for n, v in vars(ref_mod).items()
             if (inspect.isfunction(v) or inspect.isclass(v))
             and getattr(v, "__module__", None) == ref_mod.__name__]
    assert names
    for n in names:
        assert _src(getattr(port_mod, n), True) == \
            _src(getattr(ref_mod, n), False), n
    for n in ("RANKS", "BATCHES", "GPUS", "MONTH", "SYSTEMS"):
        if n in vars(ref_mod):
            assert getattr(port_mod, n) == getattr(ref_mod, n), n


def test_cluster_package_exports_the_four_copies():
    import repro_torch.cluster as pkg
    assert sorted(pkg.__all__) == ["baselines", "metrics", "simulator",
                                   "trace"]


@pytest.mark.parametrize("kw", [
    TEST_TRACE, dict(months=3, jobs_per_month=100, seed=2),
    dict(months=1, jobs_per_month=40, seed=0,
         base_models=("tinyllama-1.1b",))],
    ids=["test_cluster", "three_months", "tinyllama"])
def test_generate_equals_reference(kw):
    got = generate(TraceConfig(**kw))
    assert _specs(got) == _specs(ref_trace.generate(
        ref_trace.TraceConfig(**kw)))
    assert _specs(scale_arrivals(got, 30.0)) == _specs(
        ref_trace.scale_arrivals(ref_trace.generate(
            ref_trace.TraceConfig(**kw)), 30.0))


def _replay(tr_mod, bl_mod, sim_mod):
    tr = tr_mod.scale_arrivals(tr_mod.generate(tr_mod.TraceConfig(
        **TEST_TRACE)), 30.0)
    out = {}
    for s in bl_mod.SYSTEMS:
        sim = bl_mod.make_simulator(s, sim_mod.ClusterConfig(total_chips=64))
        out[s] = sim.run(tr, max_time=2.0 * max(j.arrival_time for j in tr))
    return tr, out


@pytest.fixture(scope="module")
def replays():
    """tests/test_cluster.py's replay through both packages."""
    return (_replay(trace, baselines, simulator),
            _replay(ref_trace, ref_baselines, ref_simulator))


def test_every_system_equals_the_reference_exactly(replays):
    (_, got), (_, want) = replays
    assert list(got) == list(want) == list(SYSTEMS)
    for s in SYSTEMS:
        assert summarize(got[s]) == ref_metrics.summarize(want[s]), s
        assert size_terciles(got[s]) == ref_metrics.size_terciles(want[s])
        assert got[s].throughput_series == want[s].throughput_series
    assert compare(got) == ref_metrics.compare(want)


def test_load_csv_equals_reference(tmp_path):
    path = tmp_path / "trace.csv"
    path.write_text("submit_time,duration,gpu_num\n"
                    "120.0,7200,2\n0,3600,1\n60.5,50,16\n30,86400,4\n"
                    "90,1800,0\n")
    got = trace.load_csv(str(path), seed=3)
    assert _specs(got) == _specs(ref_trace.load_csv(str(path), seed=3))
    assert [j.arrival_time for j in got] == [0.0, 30.0, 60.5, 90.0, 120.0]
    assert [j.gpus for j in got] == [1, 4, 8, 1, 2]     # clipped to [1, 8]
    assert [j.steps_budget for j in got] == [1800, 43200, 50, 900, 3600]
    assert len(trace.load_csv(str(path), max_jobs=2)) == 2
    with pytest.raises(trace.TraceValidationError, match="demands 8"):
        trace.load_csv(str(path), pool_chips=4)


def test_validate_trace_without_the_execution_backend():
    """``executable=True`` asks for cluster/execution, which the port does
    not have yet (cluster control); an explicit model list works."""
    jobs = generate(TraceConfig(months=1, jobs_per_month=10, seed=0))
    with pytest.raises(ImportError):
        trace.validate_trace(jobs, executable=True)
    with pytest.raises(trace.TraceValidationError, match="not runnable"):
        trace.validate_trace(jobs, models=("tinyllama-1.1b",))
    assert trace.validate_trace(jobs, models=TraceConfig().base_models) \
        == jobs


def test_format_table_equals_reference(replays):
    (_, got), _ = replays
    rows = [dict(system=s, **summarize(r)) for s, r in got.items()]
    cols = ["system", "avg_jct_sec", "utilization", "completion_rate"]
    assert format_table(rows, cols, title="T") == \
        ref_metrics.format_table(rows, cols, title="T")


# ------------------------------ tests/test_cluster.py on the port's modules
@pytest.fixture(scope="module")
def small_trace():
    return generate(TraceConfig(**TEST_TRACE))


@pytest.fixture(scope="module")
def sim_results(replays):
    return replays[0][1]


def test_trace_shape(small_trace):
    assert len(small_trace) > 60
    assert all(j.rank in (2, 4, 8, 16) for j in small_trace)
    assert all(j.batch_size in (1, 2, 4, 8) for j in small_trace)
    ts = [j.arrival_time for j in small_trace]
    assert ts == sorted(ts)
    assert all(0 <= t < MONTH for t in ts)


def test_trace_monthly_burstiness():
    tr = generate(TraceConfig(months=3, jobs_per_month=100, seed=2))
    counts = [len(month_slice(tr, m)) for m in range(3)]
    assert counts[1] > 1.4 * counts[0]          # ~2x month 2
    assert counts[2] > 2.5 * counts[0]          # ~4x month 3


def test_scale_arrivals(small_trace):
    fast = scale_arrivals(small_trace, 2.0)
    assert fast[-1].arrival_time == pytest.approx(
        small_trace[-1].arrival_time / 2.0)


def test_all_systems_make_progress(sim_results):
    for name, res in sim_results.items():
        assert res.samples_done > 0, name


def test_tlora_beats_mlora(sim_results):
    """Headline claims direction: throughput, JCT, utilization."""
    d = compare(sim_results)
    assert d["tlora"]["throughput_x"] >= 1.0
    assert d["tlora"]["jct_speedup_x"] >= 1.2
    assert d["tlora"]["utilization_delta"] > 0


def test_ablations_are_worse_than_full(sim_results):
    s = {k: summarize(v) for k, v in sim_results.items()}
    full = s["tlora"]["avg_jct_sec"]
    assert s["tlora_no_scheduler"]["avg_jct_sec"] >= 0.95 * full
    assert s["tlora_no_kernel"]["avg_jct_sec"] >= full


def test_grouping_happens_across_terciles(sim_results):
    t = size_terciles(sim_results["tlora"])
    m = size_terciles(sim_results["mlora"])
    for size in ("small", "medium", "large"):
        assert t[size][0] > 0.2, (size, t)
    assert m["small"][0] > 0.4


def test_simulator_conserves_jobs(small_trace, sim_results):
    for res in sim_results.values():
        assert len(res.logs) == len(small_trace)
        done = [l for l in res.logs.values() if l.finish is not None]
        for l in done:
            assert l.steps_done >= l.spec.steps_budget
            assert l.finish >= l.arrival


def test_format_table():
    rows = [{"a": 1.0, "b": "x"}, {"a": 2.5, "b": "y"}]
    out = format_table(rows, ["a", "b"], title="T")
    assert "##" in out and "2.5" in out


# ------------------------------------------------------ the H100 spec
def test_h100_replay_runs_and_differs_from_v5e(small_trace):
    """The same trace priced with the port's ``H100`` spec (how the chip
    smoke replays it): every job completes, and the prices are not
    V5E's.  No reference counterpart: ``H100`` is the port's."""
    from repro_torch.core import throughput as tp
    tr = scale_arrivals(small_trace, 30.0)
    res = {}
    for hw in (tp.V5E, tp.H100):
        sim = make_simulator("tlora", ClusterConfig(total_chips=64, hw=hw))
        res[hw] = summarize(sim.run(tr))
    assert res[tp.H100]["completion_rate"] == 1.0
    assert res[tp.H100]["avg_jct_sec"] != res[tp.V5E]["avg_jct_sec"]


def test_calibrated_pricing_goes_through_hw_for(small_trace):
    """A calibrator whose ``hw`` is the cluster's prices through
    ``hw_for`` (the frame check of ``_group_step_time``); one whose
    ``hw`` differs is ignored, exactly."""
    from repro_torch.core import throughput as tp
    tr = scale_arrivals(small_trace, 30.0)[:40]
    calls = []

    class Counting(tp.OnlineCalibrator):
        def hw_for(self, *a, **k):
            calls.append(a)
            return super().hw_for(*a, **k)

    cc = ClusterConfig(total_chips=64, hw=tp.H100)
    plain = make_simulator("tlora", cc).run(tr)
    sim = make_simulator("tlora", cc)
    sim.calibrator = Counting(tp.H100)
    priced = sim.run(tr)
    assert calls and summarize(priced) == summarize(plain)   # no fit yet
    calls.clear()
    sim = make_simulator("tlora", cc)
    sim.calibrator = Counting(tp.V5E)
    sim.run(tr)
    assert not calls
