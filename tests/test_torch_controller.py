"""The port's cluster control (``cluster/{control,controller}``) on the
CPU, against the reference controller.

First the copies' sources against their originals (the substitution
``repro.`` -> ``repro_torch.``): ``control``, ``faults`` and ``harness``
whole, and the functions and classes the controller and the execution
backend keep unchanged.  Then tests/test_controller.py's single-device
scenarios on both controllers over reduced tinyllama-1.1b in f32 with
block_t 8 (the reference's "ref" impl, the port's "cuda" impl through
its plain versions, ``device="cpu"``): groupings, step counts, Adam
steps, retirements and regroup events compared exactly.  Then the
port's own contracts: a controller-run job equal to the same job in a
solo ``ElasticEngine`` bit for bit, threads / roundrobin / sequential
runs of the same groups bit-equal, a dying pump surfacing, a stuck join
bounded, the overlapped regroup under live pumps, the calibration round
trip, and the multi-GPU options: accepted and passed through where the
pool of ranks runs them, refused where it does not (ROADMAP A2, A4).
"""
import dataclasses
import inspect
import os
import time

import numpy as np
import pytest
import torch

from repro.cluster import control as ref_control
from repro.cluster import controller as ref_controller
from repro.cluster import execution as ref_execution
from repro.cluster import faults as ref_faults
from repro.cluster import harness as ref_harness
from repro.configs import get_config as ref_get_config
from repro.core.jobs import LoRAJobSpec as RefSpec

from repro_torch.cluster import (control, controller, execution, faults,
                                 harness)
from repro_torch.cluster.control import WorkerFailure
from repro_torch.cluster.controller import ClusterController
from repro_torch.configs import get_config
from repro_torch.core.jobs import LoRAJobSpec
from repro_torch.elastic import ElasticEngine
from repro_torch.optim.adamw import tree_leaves

from torch_train_common import one_torch_thread  # noqa: F401

BT = 8
KW = dict(block_t=BT, lr=1e-2, remat=False, chunk_size=2, seed=3)


@pytest.fixture(scope="module")
def cfg():
    return dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                               dtype="float32")


@pytest.fixture(scope="module")
def ref_cfg():
    return dataclasses.replace(ref_get_config("tinyllama-1.1b").reduced(),
                               dtype="float32")


def _spec(jid, rank=4, bs=1, budget=10_000, cls=LoRAJobSpec):
    return cls(jid, rank=rank, batch_size=bs, seq_len=32,
               base_model="tinyllama-1.1b", steps_budget=budget,
               max_slowdown=2.0)


def _port(cfg, **kw):
    return ClusterController(lambda m: cfg, impl="cuda", device="cpu",
                             **{**KW, **kw})


def _ref(ref_cfg, **kw):
    return ref_controller.ClusterController(lambda m: ref_cfg, impl="ref",
                                            **{**KW, **kw})


def _src(obj, port: bool) -> str:
    s = inspect.getsource(obj)
    return s if port else s.replace("repro.", "repro_torch.")


# ------------------------------------------------------------- copies
COPIES = [(ref_control, control, None), (ref_faults, faults, None),
          (ref_harness, harness, None),
          (ref_controller, controller, ("effective_grad_sync", "ModelView")),
          (ref_execution, execution, ("executable_models", "StepRecord"))]


@pytest.mark.parametrize("ref_mod,port_mod,names", COPIES,
                         ids=[m.__name__.split(".")[-1] for m, _, _ in COPIES])
def test_copies_equal_their_originals(ref_mod, port_mod, names):
    if names is None:
        names = [n for n, v in vars(ref_mod).items()
                 if (inspect.isfunction(v) or inspect.isclass(v))
                 and getattr(v, "__module__", None) == ref_mod.__name__]
    assert names
    for n in names:
        assert _src(getattr(port_mod, n), True) == \
            _src(getattr(ref_mod, n), False), n
    if "KINDS" in vars(ref_mod):
        assert port_mod.KINDS == ref_mod.KINDS
    if "EXECUTABLE_MODELS" in vars(ref_mod):
        assert port_mod.EXECUTABLE_MODELS == ref_mod.EXECUTABLE_MODELS


# ------------------------------------------- lifecycle vs the reference
def _lifecycle(ctl, cls):
    """tests/test_controller.py:67, recording what both must agree on."""
    out = []
    ctl.submit(_spec("a", rank=4, bs=2, cls=cls))
    ctl.submit(_spec("b", rank=8, cls=cls))
    ctl.ensure_group(("a", "b"))
    ctl.run(3)
    out.append(("run3", ctl.steps_done("a"), ctl.steps_done("b")))
    ctl.submit(_spec("c", rank=2, cls=cls))
    rt_before = ctl._slots[("a", "b")].runtime(("a", "b"))
    d = ctl.apply_grouping([("a", "b"), ("c",)], chips=[2, 1])
    out.append(("kept", ctl._slots[("a", "b")].runtime(("a", "b"))
                is rt_before, d, ctl.regroup_events))
    d = ctl.apply_grouping([("a", "b", "c")], chips=[3])
    out.append(("merged", d, ctl.regroup_events, ctl.current_grouping()))
    ctl.run(2)
    out.append(("run2", ctl.steps_done("a"), ctl.steps_done("c"),
                ctl.job_state("a").opt_step))
    st_a = ctl.remove_job("a")
    ctl.apply_grouping([("b", "c")], chips=[2])
    ctl.run(1)
    out.append(("removed", st_a.steps_done, ctl.steps_done("b"),
                ctl.steps_done("c"), ctl.current_grouping(),
                ctl.regroup_events, ctl.repartitions,
                [(e.mode, e.groups_built, e.groups_dissolved, e.jobs_moved)
                 for e in ctl.regroup_log]))
    return out


def test_lifecycle_and_migration_match_reference(cfg, ref_cfg):
    got = _lifecycle(_port(cfg), LoRAJobSpec)
    assert got == _lifecycle(_ref(ref_cfg), RefSpec)
    # the reference test's own assertions
    assert got[0][1:] == (3, 3)
    assert got[1][1] is True and got[1][3] == 0
    assert got[2][2] == 1
    assert got[3][1:] == (5, 2, 5)
    assert got[4][1:4] == (5, 6, 3)


def _retire(ctl, cls):
    ctl.submit(_spec("a", budget=4, cls=cls))
    ctl.submit(_spec("b", budget=8, cls=cls))
    grouping = ctl.reschedule(pressure=True)
    ctl.run(4)
    view = ctl.model_view("tinyllama-1.1b")
    return (grouping, sorted(ctl.finished), ctl.finished["a"].steps_done,
            ctl.active_job_ids, view.job_ids, sorted(view.finished),
            ctl.steps_done("b"), ctl.regroup_events)


def test_reschedule_and_retire_match_reference(cfg, ref_cfg):
    got = _retire(_port(cfg), LoRAJobSpec)
    assert got == _retire(_ref(ref_cfg), RefSpec)
    grouping, finished, a_steps, active, view_ids, view_fin, _, _ = got
    assert sorted(j for g in grouping for j in g) == ["a", "b"]
    assert finished == ["a"] and a_steps == 4
    assert active == ["b"] and view_ids == ["b"] and view_fin == ["a"]


# -------------------------------------------------- the port's contracts
def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def test_controller_matches_solo_engine_bit_for_bit(cfg):
    """The controller's backbone and init-seed derivation mirror
    ElasticEngine's: the same seed gives the same trajectory."""
    eng = ElasticEngine(cfg, block_t=BT, lr=1e-2, remat=False, seed=3,
                        chunk_size=2, device="cpu")
    eng.add_job(_spec("a", rank=4, bs=2))
    rt_e = eng.ensure_group(("a",))
    rt_e.run(3)
    ctl = _port(cfg)
    ctl.submit(_spec("a", rank=4, bs=2))
    rt_c = ctl.ensure_group(("a",))
    rt_c.run(3)
    a, b = eng.job_state("a"), ctl.job_state("a")
    for part in ("adapter", "mu", "nu"):
        for k in getattr(a, part):
            assert torch.equal(getattr(a, part)[k], getattr(b, part)[k]), \
                (part, k)
    assert a.opt_step == b.opt_step == 3
    assert np.array_equal(np.stack(rt_e.report.per_job_losses),
                          np.stack(rt_c.report.per_job_losses))


def test_concurrency_modes_bit_equal(cfg):
    """threads, roundrobin and sequential runs of the same two groups give
    equal adapters, Adam moments and per-job losses (the control plane's
    threads-vs-sequential contract), and the same step counts."""
    runs = {}
    for mode in ("sequential", "roundrobin", "threads"):
        ctl = _port(cfg, concurrency=mode)
        for jid, r in (("a", 4), ("b", 8), ("c", 2), ("d", 16)):
            ctl.submit(_spec(jid, rank=r))
        ctl.apply_grouping([("a", "b"), ("c", "d")])
        ctl.run(5)
        runs[mode] = {g: ctl._slots[g].runtime(g) for g in ctl._slots}
        assert all(ctl.steps_done(j) == 5 for j in "abcd")
    seq = runs["sequential"]
    for mode in ("roundrobin", "threads"):
        for g, rt in runs[mode].items():
            ref = seq[g]
            assert _same(rt.adapters, ref.adapters), (mode, g)
            assert _same(rt.opt_state.mu, ref.opt_state.mu), (mode, g)
            assert _same(rt.opt_state.nu, ref.opt_state.nu), (mode, g)
            assert torch.equal(rt.opt_state.step, ref.opt_state.step)
            assert np.array_equal(np.stack(rt.report.per_job_losses),
                                  np.stack(ref.report.per_job_losses))


def test_worker_failure_surfaces_instead_of_hanging(cfg):
    """tests/test_controller.py:233: a pump dying mid-run surfaces its
    exception from finish() within the join bound; its sibling is
    stopped, not abandoned."""
    ctl = _port(cfg)
    ctl.submit(_spec("a", rank=4, bs=2))
    ctl.submit(_spec("b", rank=8))
    ctl.apply_grouping([("a",), ("b",)])
    rt_b = ctl._slots[("b",)].runtime(("b",))
    calls = {"n": 0}
    orig = rt_b.dispatch_chunk

    def boom(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] > 1:
            raise RuntimeError("chunk pump died")
        return orig(*args, **kwargs)

    rt_b.dispatch_chunk = boom
    t0 = time.monotonic()
    ctl.begin(500)
    with pytest.raises(WorkerFailure, match="chunk pump died") as err:
        ctl.finish(timeout=120)
    assert time.monotonic() - t0 < 120
    assert list(err.value.failures) == [("b",)] and not err.value.stuck
    assert not any(w.alive for w in ctl._workers.values())


def test_stuck_worker_join_is_bounded(cfg):
    """tests/test_controller.py:264: a wedged pump trips the shared
    deadline and is named in the raise."""
    ctl = _port(cfg)
    ctl.submit(_spec("a", rank=4, bs=2))
    ctl.apply_grouping([("a",)])
    rt = ctl._slots[("a",)].runtime(("a",))
    rt.dispatch_chunk = lambda *a, **k: time.sleep(3600)
    t0 = time.monotonic()
    ctl.begin(10)
    with pytest.raises(WorkerFailure, match="timed out") as err:
        ctl.finish(timeout=2)
    assert time.monotonic() - t0 < 30
    assert err.value.stuck == [("a",)]


def test_overlapped_regroup_under_live_pumps(cfg):
    """tests/test_controller.py:283: two solo pumps keep stepping while
    the merged destination is assembled and warmed; the handoff fences
    them at a chunk boundary with no warm inside the stall window, and
    the migrated jobs still reach the run target."""
    ctl = _port(cfg)
    ctl.submit(_spec("a", rank=4, bs=2))
    ctl.submit(_spec("b", rank=8))
    ctl.apply_grouping([("a",), ("b",)])
    for g in (("a",), ("b",)):
        rt = ctl._slots[g].runtime(g)
        orig = rt.dispatch_chunk

        def slow(*args, _orig=orig, **kwargs):
            time.sleep(0.02)
            return _orig(*args, **kwargs)
        rt.dispatch_chunk = slow

    target = 80
    ctl.begin(target)
    assert ctl.prewarm([("a", "b")]) == 1
    before = {j: ctl.steps_done(j) for j in ("a", "b")}
    ctl.apply_grouping([("a", "b")])
    ev = ctl.regroup_log[-1]
    assert ev.mode == "overlapped"
    assert ev.compile_s == 0.0 and ev.assemble_s > 0.0
    assert ev.groups_dissolved == 2 and ev.groups_built == 1
    assert set(ev.fence_steps) == {"a", "b"}
    assert all(0 < s < target for s in ev.fence_steps.values())
    assert all(ev.fence_steps[j] >= before[j] for j in before)
    ctl.finish()
    assert ctl.steps_done("a") >= target and ctl.steps_done("b") >= target
    stats = ctl.regroup_stats()
    assert stats["overlapped"]["events"] == 1
    assert stats["overlapped"]["stall_s"] > 0.0
    assert ctl.regroup_events == 1


def test_calibration_warm_start_roundtrip(cfg, tmp_path):
    """tests/test_controller.py:329 on the port."""
    from repro_torch.core import throughput as tp
    path = str(tmp_path / "cal.json")
    cal = tp.OnlineCalibrator()
    cal.observe_regroup(cfg.name, 7.5)
    ctl = _port(cfg, calibrator=cal, calibration_path=path)
    ctl.save_calibration()
    assert os.path.exists(path)
    ctl2 = _port(cfg, calibration_path=path)
    assert ctl2.calibrator is not None
    assert ctl2.calibrator.regroup_cost(cfg.name) == pytest.approx(7.5)
    assert ctl2.scheduler("tinyllama-1.1b").transition_cost() == \
        pytest.approx(7.5)
    cal3 = tp.OnlineCalibrator()
    assert _port(cfg, calibrator=cal3,
                 calibration_path=path).calibrator is cal3


@pytest.mark.parametrize("kw", [
    dict(partition=True), dict(fixed_mesh="world"),
    dict(devices=["cpu", "cpu"]), dict(tp_mode="auto"),
    dict(pipeline_stages=2), dict(nano_order="rank_desc"),
    dict(grad_sync="psum"), dict(data_axis="dp")],
    ids=["partition", "fixed_mesh", "two_devices", "tp_mode", "pipeline",
         "nano_order", "grad_sync", "data_axis"])
def test_multi_gpu_options_refused(cfg, kw, tmp_path):
    """The options the single-device controller refused as multi-GPU
    now run over a pool of ranks and are accepted and passed through to
    the engines: partition, a fixed mesh, ``tp_mode="auto"`` (the
    data-parallel step on the pool's 1-D slices, as in the reference),
    ``pipeline_stages``, ``nano_order``, ``grad_sync`` and ``data_axis``
    in a one-rank gloo world, where the group is built on a one-rank
    mesh and trains two steps; two devices on a world of two spawned
    gloo ranks, where the pool partitions into one rank a group.  A
    tp_mode the reference does not have is refused.  With
    ``tp_mode="pipeline"`` a depth of 2 does not divide the one-rank
    slice: refused at partition time, as in the reference."""
    if "tp_mode" in kw:
        with pytest.raises(ValueError, match="unknown tp_mode"):
            _port(cfg, tp_mode="fsdp")
    if "devices" in kw:
        import torch_sharded_common as C
        import torch_sharded_worker as W
        got = C.collect(C.spawn(["ctl_pool_of_two"], tmp_path,
                                W.ctl_inputs(), world=2))
        for r in range(2):
            res = C.result(got, "ctl_pool_of_two", r)
            assert res["devices"] == kw["devices"]
            assert res["partition"] and res["concurrency"] == "threads"
            assert res["groups"] == [(["g0j0"], [0]), (["g0j1"], [1])]
            assert res["steps"] == 2
        return
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_mesh
    mesh = init_mesh(0, 1, f"file://{tmp_path}/store", "gloo")
    try:
        if kw.get("fixed_mesh") == "world":
            kw = dict(fixed_mesh=mesh)
        elif "partition" not in kw:
            kw = dict(kw, partition=True)   # the sharded options need a mesh
        ctl = _port(cfg, **kw)
        for k, v in kw.items():
            if k in ctl._engine_kwargs:
                assert ctl._engine_kwargs[k] == v
        ctl.submit(_spec("a", rank=4, bs=2))
        ctl.submit(_spec("b", rank=8, bs=2))
        rt = ctl.ensure_group(("a", "b"))
        if "fixed_mesh" in kw:
            assert rt.mesh is mesh and not ctl.partition
        else:
            assert rt.mesh.mesh_dim_names == (kw.get("data_axis", "data"),)
        assert rt.data_shards == 1
        assert ctl.group_devices()[("a", "b")] == \
            (() if "fixed_mesh" in kw else (0,))
        assert rt.nano_order == kw.get("nano_order", "job")
        assert rt.grad_sync == kw.get("grad_sync", "gather")
        assert rt.tp_mode == kw.get("tp_mode", "dp")
        ctl.run(2)
        assert ctl.steps_done("a") == ctl.steps_done("b") == 2
        assert np.isfinite(np.asarray(rt.report.per_job_losses)).all()
        if "pipeline_stages" in kw:
            pipe = _port(cfg, tp_mode="pipeline", **kw)
            pipe.submit(_spec("a", rank=4, bs=2))
            with pytest.raises(ValueError,
                               match="does not divide the group slice"):
                pipe.ensure_group(("a",))
    finally:
        dist.destroy_process_group()


def test_execution_backend_refuses_a_mesh(cfg, tmp_path):
    """``ExecutionBackend(mesh=)`` pins every group to that mesh and
    ``(devices=)`` partitions the pool (the reference's modes), here in a
    one-rank gloo world: each measures a positive step; "ref" falls back
    to "psum" on a mesh."""
    import torch.distributed as dist
    from repro_torch.core.jobs import JobRuntimeState
    from repro_torch.core.scheduler import Group
    from repro_torch.launch.mesh import init_mesh
    mesh = init_mesh(0, 1, f"file://{tmp_path}/store", "gloo")
    try:
        for kw in (dict(mesh=mesh), dict(devices=["cpu"])):
            be = execution.ExecutionBackend(impl="cuda", block_t=BT, seed=0,
                                            device="cpu", **kw)
            assert be.controller.fixed_mesh is kw.get("mesh")
            assert be.controller.partition == ("devices" in kw)
            group = Group(jobs=[JobRuntimeState(spec=_spec("x1", bs=2))],
                          chips=1)
            t = be.observe(cfg, group, predicted=1e-3, now=0.0)
            assert t is not None and t > 0 and be.records[0].measured == t
            rt = be.controller.ensure_group(("x1",))
            assert rt.mesh is not None and rt.data_shards == 1
        be2 = execution.ExecutionBackend(block_t=BT, mesh=mesh, impl="ref",
                                         device="cpu")
        assert be2._engine_kwargs["grad_sync"] == "psum"
    finally:
        dist.destroy_process_group()


def test_controller_runs_on_the_given_device(cfg):
    ctl = _port(cfg)
    assert ctl.devices == [torch.device("cpu")] and not ctl.partition
    assert ctl.concurrency == "sequential"
    ctl.submit(_spec("a"))
    rt = ctl.ensure_group(("a",))
    assert rt.device == torch.device("cpu")
    assert all(t.device.type == "cpu" for t in tree_leaves(rt.adapters))
