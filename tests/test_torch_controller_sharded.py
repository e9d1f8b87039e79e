"""The port's multi-device controller on the CPU: four gloo ranks (one
spawn for the file, tests/torch_sharded_worker.py) run
``ClusterController`` over the pool of ranks — the reference's
controller scenarios (tests/sharded_worker.py: concurrent groups on
disjoint slices, repartition with cross-slice migration, the overlapped
migration, ``ExecutionBackend`` on a mesh) and the port's own (a fixed
mesh over the world, a short ``TraceRunner`` trace) — on reduced
tinyllama-1.1b in f32 with block_t 8, impl "cuda" (its kernels' plain
versions), every job starting from the reference's initial adapters and
backbone.  Meanwhile the test process runs the same groups through the
port's meshless controller and the reference's single-device
controller ("xla").

Bars are tests/torch_sharded_common.py's: per-job losses at 1e-4, state
at the Adam bound, Adam steps and steps done exactly; threads and
sequential bit for bit.  Every scenario also holds every rank's
decisions (group devices, regroup modes and fences, failures) equal.
"""
import copy

import numpy as np
import pytest
import torch

import jax

from repro.cluster.controller import ClusterController as RefController
from repro.core.jobs import LoRAJobSpec as RefSpec
from repro.elastic.migrate import JobTrainState as RefState
from repro.models import model as RM

from repro_torch.cluster.controller import ClusterController
from repro_torch.data.pipeline import JobStream
from repro_torch.elastic.migrate import JobTrainState
from repro_torch.models.convert import params_from_numpy

import torch_sharded_common as C
import torch_sharded_worker as W
from torch_train_common import one_torch_thread  # noqa: F401


def _inputs():
    """The reference's backbone and fresh job states (r_pad 8, the
    controllers' padding at block_t 8), as the reference's and the
    port's."""
    cfg = C.ref_cfg()
    key = jax.random.PRNGKey(5)
    params = RM.init_model(jax.random.fold_in(key, 0), cfg)
    port_cfg = W.cfg_f32()
    states, ref_states = {}, {}
    specs = W.ctl_specs()
    for i, (jid, rank) in enumerate(W.CTL_JOBS):
        rspec = RefSpec(jid, rank=rank, batch_size=2, seq_len=W.SEQ,
                        base_model=cfg.name)
        st = RefState.fresh(rspec, cfg, jax.random.fold_in(key, i + 1),
                            r_pad=8)
        ref_states[jid] = st
        ad = {k: torch.from_numpy(np.array(v, np.float32))
              for k, v in st.adapter.items()}
        states[jid] = JobTrainState(
            spec=specs[jid], adapter=ad,
            mu={k: torch.zeros_like(v) for k, v in ad.items()},
            nu={k: torch.zeros_like(v) for k, v in ad.items()},
            stream=JobStream(specs[jid], port_cfg.vocab_size, 0))
    port = {"params": params_from_numpy(jax.tree.map(np.asarray, params),
                                        "cpu"), "states": states}
    return port, params, ref_states


def _meshless(inputs):
    """The port's single-device controller on the two groups: each
    group's summary after 4 and after 6 steps."""
    ctl = ClusterController(lambda m: W.cfg_f32(), impl="cuda",
                            block_t=W.BT, lr=W.LR, remat=False,
                            chunk_size=2, seed=3, device="cpu")
    W.admit(ctl, {"ctl": inputs}, [j for j, _ in W.CTL_JOBS])
    ctl.apply_grouping(W.CTL_GROUPS, chips=[2, 2])
    out = {}
    for n, steps in ((4, 4), (6, 2)):
        ctl.run(steps)
        out[n] = {g: W.summary(ctl._slots[g].runtime(g))
                  for g in W.CTL_GROUPS}
    return out


def _reference(params, ref_states):
    """The reference's single-device controller on the same groups."""
    cfg = C.ref_cfg()
    ctl = RefController(lambda m: cfg, devices=jax.devices()[:1],
                        impl="xla", block_t=W.BT, lr=W.LR, remat=False,
                        chunk_size=2, seed=3)
    ctl._backbones[cfg.name] = params
    for jid, _ in W.CTL_JOBS:
        st = copy.deepcopy(ref_states[jid])
        ctl.submit(st.spec, state=st)
    ctl.apply_grouping(W.CTL_GROUPS, chips=[2, 2])
    out = {}
    for n, steps in ((4, 4), (6, 2)):
        ctl.run(steps)
        out[n] = {g: C.ref_summary(ctl._slots[g].runtime(g))
                  for g in W.CTL_GROUPS}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    inputs, params, ref_states = _inputs()
    handle = C.spawn(W.CONTROLLER,
                     tmp_path_factory.mktemp("controller_sharded"),
                     {"ctl": inputs})
    meshless = _meshless(inputs)
    ref = _reference(params, ref_states)
    return {"ranks": C.collect(handle), "meshless": meshless, "ref": ref}


def _all(runs, name):
    return [C.result(runs["ranks"], name, r) for r in range(C.WORLD)]


def _same(a, b):
    """Two runs' trajectories and states, bit for bit."""
    np.testing.assert_array_equal(a["losses"], b["losses"])
    for part in ("adapters", "mu", "nu"):
        assert a[part].keys() == b[part].keys()
        for k in a[part]:
            np.testing.assert_array_equal(a[part][k], b[part][k], err_msg=k)
    assert a["step"] == b["step"] and a["steps_done"] == b["steps_done"]


@pytest.mark.parametrize("name", W.CONTROLLER)
def test_every_rank_reports_the_same_decisions(runs, name):
    """Group devices, regroup modes, fence steps, failures, quarantine
    and finished jobs: equal on all four ranks."""
    got = _all(runs, name)

    def decisions(res):
        if "decisions" in res:
            return [res["decisions"]]
        return [v["decisions"] for v in res.values()
                if isinstance(v, dict) and "decisions" in v]
    for g in got[1:]:
        assert decisions(g) == decisions(got[0])


def test_threads_equal_sequential_on_every_rank(runs):
    """tests/sharded_worker.py:391: concurrency changes nothing but the
    wall clock, on each rank of both slices."""
    for r, res in enumerate(_all(runs, "ctl_concurrent_parity")):
        assert res["threads"]["gkey"] == res["sequential"]["gkey"] \
            == W.CTL_GROUPS[r // 2]
        _same(res["threads"]["run"], res["sequential"]["run"])
        assert res["threads"]["decisions"]["devices"] == [
            (list(W.CTL_GROUPS[0]), [0, 1]), (list(W.CTL_GROUPS[1]), [2, 3])]


def test_partitioned_groups_match_meshless_and_reference(runs):
    """Each group on its two-rank slice against the same group in the
    port's meshless controller and in the reference's single-device
    controller, after 6 steps."""
    got = _all(runs, "ctl_concurrent_parity")
    for r in (0, 2):
        g = tuple(got[r]["threads"]["gkey"])
        run = got[r]["threads"]["run"]
        C.compare(runs["meshless"][6][g], run)
        C.compare(runs["ref"][6][g], run)
        # both slices' ranks hold the same replicated trajectory
        _same(run, got[r + 1]["threads"]["run"])


def test_repartition_migration_matches_solo_throughout(runs):
    """tests/sharded_worker.py:420: solo on one rank -> fused on four ->
    solo, against solo throughout; Adam and step counts exact; the
    incremental regroup on a full pool takes the freed ranks."""
    for res in _all(runs, "ctl_repartition_migration"):
        C.losses_close(res["got"], res["ref"])
        assert res["b_steps"] == (2, 2)
        assert res["regroup_events"] >= 2
        assert res["steps_done"] == 6
        st, ref = res["state"], res["ref_state"]
        assert st["opt_step"] == ref["opt_step"] == 6
        C.state_close(st["adapter"], ref["adapter"])
        C.state_close(st["mu"], ref["mu"])
        assert res["incremental"] == (4, (0,))


def test_overlapped_migration_matches_stop_the_world(runs):
    """tests/sharded_worker.py:478: the merge lands overlapped with no
    warm in the stall, at fences every rank agrees on, and equals a
    stop-the-world run cut at the same fences."""
    got = _all(runs, "ctl_overlapped_migration")
    for res in got:
        ev = res["event"]
        assert ev["mode"] == "overlapped" and ev["compile_s"] == 0.0
        assert ev["assemble_s"] > 0.0 and ev["stall_s"] > 0.0
        assert ev["dissolved"] == 2 and ev["built"] == 1
        assert res["devices"] == (0, 1, 2, 3)
        assert all(s >= 4 for s in res["fence_steps"].values())
        assert res["fence_steps"] == got[0]["fence_steps"]
        for j, st in res["states"].items():
            ref = res["ref_states"][j]
            assert st["opt_step"] == ref["opt_step"]
            assert st["steps_done"] == ref["steps_done"]
            for part in ("adapter", "mu", "nu"):
                C.state_close(st[part], ref[part])


def test_fixed_mesh_runs_every_group_over_the_world(runs):
    """``fixed_mesh``: both groups 4-way on the world's mesh, sequential
    == roundrobin bit for bit, each against the meshless and the
    reference's controllers after 4 steps."""
    for res in _all(runs, "ctl_fixed_mesh"):
        assert res["sequential"]["shards"] == [4, 4]
        for g in W.CTL_GROUPS:
            k = "+".join(g)
            _same(res["sequential"][k], res["roundrobin"][k])
            C.compare(runs["meshless"][4][g], res["sequential"][k])
            C.compare(runs["ref"][4][g], res["sequential"][k])


def test_execution_backend_on_a_mesh_and_a_pool(runs):
    """tests/sharded_worker.py:693: ``mesh=`` (a fixed mesh) and
    ``devices=`` (a partitioned pool) each measure a positive step, the
    same on every rank; "ref" falls back to "psum"."""
    got = _all(runs, "ctl_execution_backend")
    for res in got:
        for name in ("mesh", "devices"):
            assert res[name]["t"] is not None and res[name]["t"] > 0
            assert res[name]["records"] == [res[name]["t"]]
            assert res[name]["t"] == got[0][name]["t"]
            assert res[name]["grad_sync"] == "gather"
        assert not res["mesh"]["partition"] and res["devices"]["partition"]
        assert res["mesh"]["devices"] == ()
        assert res["devices"]["devices"] == (0, 1)
        assert res["ref_grad_sync"] == "psum"


def test_trace_over_the_partitioned_pool(runs):
    """A TraceRunner trace of four jobs over the pool: every job
    completes its budget, none lost."""
    for res in _all(runs, "ctl_trace"):
        assert res["completed"] == ["t0", "t1", "t2", "t3"]
        assert res["lost"] == [] and not res["timed_out"]
        assert all(s == 4 for s in res["steps"].values()), res["steps"]

