"""The port's pipeline mode on the CPU: four gloo ranks (one spawn for
the file, tests/torch_sharded_worker.py, scenarios ``pipe_*``) run
stage-partitioned fused groups — the reference's pipeline scenarios
(tests/sharded_worker.py:225-300: parity against single-submesh
execution, the migration trajectory; tests/test_lossless.py's pipeline
case) and the port's own (the masked route, an unscanned tail,
residency, occupancy and legality, ``ElasticEngine`` and
``ClusterController`` on slices) — on reduced tinyllama-1.1b (2 cycles,
one a stage) in f32 with block_t 8, impl "cuda" (its kernels' plain
versions).  P = 2 x D = 2 runs over the world, P = 2 x D = 1 on the two
2-rank slices.  Meanwhile the test process makes the port's meshless
runs and the reference's single-device "xla" runs of the same jobs,
seeds and initial weights.

Bars are tests/torch_sharded_common.py's (the reference's): per-job
losses at 1e-4 relative and absolute, adapters and moments within 2.5e-2
and within 1e-5 for more than 85% of the coordinates, Adam steps and
steps done exactly.  Bit for bit where the port adds the same products
in the same order: a pipeline run and the data-parallel run over the
same data shards (D = 2 on a 2-rank slice, D = 1 on one rank) with the
same N, nano order and grad sync — each micro is that run's nano slice,
its stage-local gradients are summed in micro order as the nano slices'
are, and the handoffs copy bytes.
"""
import dataclasses
import inspect
import re

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec

from repro.configs import get_config as ref_get_config
from repro.core import ssm as ref_ssm
from repro.core.jobs import LoRAJobSpec as RefSpec
from repro.elastic.migrate import JobTrainState as RefState
from repro.models import model as RM

from repro_torch.cluster.controller import ClusterController
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import ssm
from repro_torch.core.ssm import SharedSuperModel
from repro_torch.data.pipeline import JobStream
from repro_torch.elastic.engine import ElasticEngine
from repro_torch.elastic.migrate import JobTrainState
from repro_torch.elastic.runtime import GroupRuntime
from repro_torch.launch.mesh import _stage_group_keys, make_local_mesh
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim.schedule import constant

import torch_sharded_common as C
import torch_sharded_worker as W
from torch_train_common import one_torch_thread  # noqa: F401


def _pmig_inputs():
    """tests/test_lossless.py's pipeline case: the reference's backbone
    and two fresh job states (rank 4 and rank 64, batch 8), as the
    port's."""
    cfg = C.ref_cfg()
    key = jax.random.PRNGKey(5)
    params = RM.init_model(jax.random.fold_in(key, 0), cfg)
    port_cfg = W.cfg_f32()
    states = []
    for i, (jid, rank, r_pad) in enumerate((("small", 4, 8),
                                            ("wide", 64, 64))):
        rspec = RefSpec(jid, rank=rank, batch_size=8, seq_len=W.SEQ)
        st = RefState.fresh(rspec, cfg, jax.random.fold_in(key, i + 1),
                            r_pad=r_pad)
        pspec = W.LoRAJobSpec(jid, rank=rank, batch_size=8, seq_len=W.SEQ)
        ad = {k: torch.from_numpy(np.array(v, np.float32))
              for k, v in st.adapter.items()}
        states.append(JobTrainState(
            spec=pspec, adapter=ad,
            mu={k: torch.zeros_like(v) for k, v in ad.items()},
            nu={k: torch.zeros_like(v) for k, v in ad.items()},
            stream=JobStream(pspec, port_cfg.vocab_size, 0)))
    return {"params": params_from_numpy(jax.tree.map(np.asarray, params),
                                        "cpu"), "states": states}


def _tail_weights():
    ssm_ = SharedSuperModel(W.tail_cfg(), W.specs("ab"), impl="cuda",
                            block_t=W.BT)
    params, adapters = ssm_.init(seed=5, device="cpu")
    return {"params": params, "adapters": adapters}


def _meshless_controller(inputs):
    ctl = ClusterController(lambda m: W.cfg_f32(), impl="cuda",
                            block_t=W.BT, lr=W.LR, remat=False,
                            chunk_size=2, seed=3, device="cpu")
    W.admit(ctl, inputs, [j for j, _ in W.CTL_JOBS])
    ctl.apply_grouping(W.CTL_GROUPS, chips=[2, 2])
    ctl.run(4)
    return {"losses": {"+".join(g): [[float(l[j]) for l in
                                      ctl._slots[g].runtime(g).report
                                      .per_job_losses]
                                     for j in range(2)]
                       for g in W.CTL_GROUPS},
            "states": {j: W.state_of(ctl.job_state(j))
                       for j, _ in W.CTL_JOBS}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results, with the port's meshless runs and the
    reference's single-device runs made while the ranks work."""
    inputs = {k: C.port_weights(k) for k in ("pl", "ab")}
    inputs["tail"] = _tail_weights()
    inputs["pmig"] = _pmig_inputs()
    inputs.update(W.ctl_inputs())
    handle = C.spawn(W.PIPELINE, tmp_path_factory.mktemp("pipeline"),
                     inputs)
    meshless = {
        "pl": W.run(inputs, "pl", 2, impl="cuda"),
        "ab": W.run(inputs, "ab", 2, impl="cuda"),
        "pl_int8": W.run(inputs, "pl", 2, impl="cuda", quantize="int8"),
        "ctl": _meshless_controller(inputs),
    }
    w = inputs["tail"]
    rt = GroupRuntime.from_specs(W.tail_cfg(), W.specs("ab"),
                                 params=w["params"], adapters=w["adapters"],
                                 **dict(W.KW, impl="cuda", chunk_size=1))
    rt.run(2)
    meshless["tail"] = W.summary(rt)
    eng = ElasticEngine(W.cfg_f32(), params=inputs["ab"]["params"],
                        impl="cuda", block_t=W.BT, lr=W.LR, remat=False,
                        chunk_size=2, device="cpu")
    for s in W.specs("ab"):
        eng.add_job(s, init_seed=11)
    rt = eng.ensure_group(("a", "b"))
    rt.run(2)
    meshless["engine"] = W.summary(rt)
    ref = {k: C.ref_runs(k, at=(2,))[2] for k in ("pl", "ab")}
    return {"ranks": C.collect(handle), "meshless": meshless, "ref": ref}


def _all(runs, name):
    return [C.result(runs["ranks"], name, r) for r in range(C.WORLD)]


def _same(a, b):
    """Two runs' trajectories, trainable state and accounting, bit for
    bit."""
    np.testing.assert_array_equal(a["losses"], b["losses"])
    for part in ("adapters", "mu", "nu"):
        assert a[part].keys() == b[part].keys()
        for k in a[part]:
            np.testing.assert_array_equal(a[part][k], b[part][k], err_msg=k)
    assert a["step"] == b["step"] and a["steps_done"] == b["steps_done"]


# ------------------------------------------------------------- parity
@pytest.mark.parametrize("name", list(W.PIPE_RUNS))
def test_pipeline_equals_data_parallel_bit_for_bit(runs, name):
    """P = 2 x D = 2 against D = 2 over the same data shards, the same
    N, nano order and grad sync: equal on every rank, every stage."""
    for res in _all(runs, "pipe_parity"):
        _same(res["dp"][name], res[name])
        assert (res[name]["stages"], res[name]["shards"]) == (2, 2)


@pytest.mark.parametrize("name", list(W.PIPE_RUNS))
def test_pipeline_matches_meshless_and_reference(runs, name):
    """tests/sharded_worker.py:225 (pipeline_parity_vs_single_submesh) at
    the reference's bars: the port's meshless run (N = 1) and the
    reference's single-device "xla" run of the same jobs."""
    got = C.result(runs["ranks"], "pipe_parity")[name]
    C.compare(runs["meshless"]["pl"], got)
    C.compare(runs["ref"]["pl"], got)


def test_one_shard_a_stage(runs):
    """P = 2 x D = 1 on each 2-rank slice: equal to the data-parallel
    step on one rank (same N = 2, "rank_desc"), and at the bars of the
    meshless and the reference's runs."""
    for res in _all(runs, "pipe_parity"):
        assert (res["d1"]["stages"], res["d1"]["shards"]) == (2, 1)
        _same(res["dp1"], res["d1"])
        C.compare(runs["meshless"]["pl"], res["d1"])
        C.compare(runs["ref"]["pl"], res["d1"])


def test_uniform_set_takes_the_masked_route(runs):
    """A uniform layout (ranks 4 and 8 in 8-wide segments, the masked
    kernels B6-B8) in a P = 2 x D = 2 group at N = 2: equal to its D = 2
    run, at the bars of the meshless and reference runs."""
    for res in _all(runs, "pipe_uniform"):
        assert res["uniform"]
        _same(res["dp"], res)
    got = C.result(runs["ranks"], "pipe_uniform")
    C.compare(runs["meshless"]["ab"], got)
    C.compare(runs["ref"]["ab"], got)


def test_unscanned_tail_updates_alike_on_every_stage(runs):
    """recurrentgemma-9b cut to 7 layers (a scanned 2-cycle stack and an
    unscanned tail that only the last stage runs): after each step the
    tail's adapter and first moment are equal on all four ranks, and
    the run holds the meshless run's bars."""
    got = _all(runs, "pipe_unscanned_tail")
    assert sorted(g["stage"] for g in got) == [0, 0, 1, 1]
    for step in range(2):
        for g in got[1:]:
            for part in ("adapters", "mu"):
                want = got[0]["tails"][step][part]
                assert g["tails"][step][part].keys() == want.keys()
                for k in want:
                    np.testing.assert_array_equal(
                        g["tails"][step][part][k], want[k])
        assert any(np.abs(v).max() > 0
                   for v in got[0]["tails"][step]["mu"].values())
    C.compare(runs["meshless"]["tail"], got[0]["run"])


# ---------------------------------------------------------- residency
@pytest.mark.parametrize("quantize", ["None", "int8"])
def test_each_stage_keeps_only_its_cycles(runs, quantize):
    """Every scanned leaf a rank holds (backbone — an int8 QuantTensor's
    codes and scales —, adapters, both moments) has 1 of the 2 cycles,
    and it is its own stage's cycle of the whole tree."""
    for res in _all(runs, "pipe_residency"):
        r = res[quantize]
        assert r["quant"] == (quantize == "int8")
        assert len(r["leaves"]) > 0
        for k, (shape, ok) in r["leaves"].items():
            assert shape[0] == 1 and ok, (k, shape, r["stage"])
        assert {k.split("/")[0] for k in r["leaves"]} == \
            {"params", "adapters", "mu", "nu"}
    if quantize == "int8":
        C.compare(runs["meshless"]["pl_int8"],
                  C.result(runs["ranks"], "pipe_residency")["int8_run"])


# ---------------------------------------------- occupancy and legality
@pytest.mark.parametrize("name", list(W.PIPE_RUNS))
def test_occupancy_counters(runs, name):
    """pipe_useful_slots = N·P and pipe_slots = (N + P - 1)·P each step,
    counted from the schedule the step ran (P = 2)."""
    for res in _all(runs, "pipe_parity"):
        got = res[name]
        n = got["n"]
        assert n == W.PIPE_RUNS[name]["nano_batches"]
        assert list(got["useful"]) == [n * 2] * 2
        assert list(got["slots"]) == [(n + 1) * 2] * 2


def test_legality(runs):
    """A requested N of 1 under P = 2 snaps to 2; a depth that does not
    divide the slice (3 of 4 ranks) or the 2-cycle stack (4), and a depth
    of 1, raise the reference's ValueErrors on every rank."""
    for res in _all(runs, "pipe_legality"):
        assert res["snapped"] == 2
        e = res["errors"]
        assert "stages=3 does not divide the group submesh of 4" in \
            e["slice"] and "[1, 2, 4]" in e["slice"]
        assert "stages=4 does not divide the scanned stack's 2" in \
            e["stack"] and "[1, 2]" in e["stack"]
        assert "pipeline_stages >= 2" in e["depth1"]


def test_refusals_without_a_world():
    """No mesh: refused as the reference refuses it; without a mesh
    ``make_train_step`` ignores the pipeline arguments.  A MoE model's
    pipeline step is no longer refused (ROADMAP A3): it reaches the
    depth check, and a depth that does not divide its stack raises the
    reference's error.  tp_mode "auto" is accepted by the engine (A4);
    a pipeline mesh with a model axis is no longer refused (A8d: each
    model index a replica, tests/test_torch_whole_mixers.py runs it)."""
    cfg, jobs = W.cfg_f32(), W.specs("ab")
    with pytest.raises(ValueError, match="needs a mesh"):
        GroupRuntime.from_specs(cfg, jobs, impl="cuda", block_t=8,
                                device="cpu", tp_mode="pipeline",
                                pipeline_stages=2)
    step = SharedSuperModel(cfg, jobs, impl="cuda", block_t=8) \
        .make_train_step(lr_fn=constant(1e-2), tp_mode="pipeline",
                         pipeline_stages=2)
    assert callable(step)
    moe = dataclasses.replace(get_config("qwen3-moe-30b-a3b").reduced(),
                              dtype="float32")
    with pytest.raises(ValueError, match="legal pipeline depths"):
        SharedSuperModel(moe, jobs, impl="torch", block_t=8) \
            .make_train_step(lr_fn=constant(1e-2), mesh=object(),
                             tp_mode="pipeline", pipeline_stages=4)
    eng = ElasticEngine(cfg, params={}, device="cpu", tp_mode="auto")
    assert eng._rt_kwargs["tp_mode"] == "auto"
    src = inspect.getsource(make_local_mesh)
    assert "ROADMAP A8d" not in src and "raise" not in src
    assert "stage_mesh(list(range(n)), p, model=m)" in src
    keys = _stage_group_keys(list(range(8)), 2, model=2)
    assert keys[-4:] == [((0, 1), "model"), ((2, 3), "model"),
                         ((4, 5), "model"), ((6, 7), "model")]
    assert keys[0] == ((0, 2), "") and ((0, 4), "stage") in keys


# ----------------------------------------------------- the reference's
@pytest.mark.parametrize("name", sorted(ARCH_IDS))
def test_stage_split_matches_the_reference(name):
    """``scanned_segment_index``, ``pipeline_legal_stages`` and which
    leaves ``stage_slices`` cuts (those ``pipeline_stage_specs`` shards
    over "stage"), on every registry config's structure."""
    cfg = get_config(name)
    rcfg = ref_get_config(name)
    plan = [s.scanned for s in M.segment_plan(cfg)]
    assert ssm.pipeline_legal_stages(cfg) == \
        ref_ssm.pipeline_legal_stages(rcfg)
    if plan.count(True) != 1:
        with pytest.raises(ValueError, match="exactly one scanned"):
            ssm.scanned_segment_index(cfg)
        return
    si = ssm.scanned_segment_index(cfg)
    assert si == ref_ssm.scanned_segment_index(rcfg)
    tree = {"embed": 0, "segments": [{"x": np.zeros(1)} for _ in plan]}
    specs = ref_ssm.pipeline_stage_specs(rcfg, tree)
    cut = [spec["x"] == PartitionSpec("stage") for spec in specs["segments"]]
    assert cut == [i == si for i in range(len(plan))]


def test_stage_slices_cut_the_scanned_cycles():
    """``stage_slices`` / ``stage_flat`` on the 7-layer recurrentgemma:
    the scanned segment's stage-s cycle, copied (no view of the stack);
    the tail shared."""
    cfg = W.tail_cfg()
    w = _tail_weights()
    for s in range(2):
        part = ssm.stage_slices(cfg, w["adapters"], 2, s)
        a = part["segments"][0]["0"]["rg_in"]["A"]
        full = w["adapters"]["segments"][0]["0"]["rg_in"]["A"]
        assert torch.equal(a, full[s:s + 1])
        assert a.untyped_storage().data_ptr() != \
            full.untyped_storage().data_ptr()
        assert part["segments"][1] is w["adapters"]["segments"][1]
        flat = ssm.stage_flat(cfg, {"segments/0/0/rg_in/A": full,
                                    "segments/1/0/rg_in/A": full}, 2, s)
        assert torch.equal(flat["segments/0/0/rg_in/A"], full[s:s + 1])
        assert flat["segments/1/0/rg_in/A"] is full
    with pytest.raises(ValueError, match="legal pipeline depths"):
        ssm.stage_slices(cfg, w["adapters"], 3, 0)


@pytest.mark.parametrize("ranks,stages", [((0, 1, 2, 3), 2),
                                          ((2, 3), 2), ((0, 1, 2, 3), 4)])
def test_stage_group_order(ranks, stages):
    """The stage groups of a slice, in the order every rank makes them:
    each stage's data group, the columns (stage order), the neighbouring
    pairs, the slice; stage s is the s-th run of D ranks."""
    keys = _stage_group_keys(ranks, stages)
    D = len(ranks) // stages
    grid = [ranks[s * D:(s + 1) * D] for s in range(stages)]
    assert [k for k, _ in keys[:stages]] == [tuple(g) for g in grid]
    cols = keys[stages:stages + D]
    assert [k for k, t in cols] == [tuple(g[d] for g in grid)
                                    for d in range(D)]
    assert all(t == "stage" for _, t in cols)
    assert keys[-1] == (tuple(ranks), "")
    assert len(keys) == stages + D + (stages - 1) * D + 1


# ------------------------------------------- migration, engine, controller
def test_migration_through_a_pipeline_group(runs):
    """tests/test_lossless.py's pipeline case: solo 2 -> fused with a
    rank-64 peer into a P = 2 x D = 2 group 2 -> extracted and solo 2,
    against the port's solo run throughout (within one framework, as
    the reference holds its own): the stitched losses and the final
    adapter and moments at the bars, the rank-4 job's slices 4 wide,
    Adam steps exact.  It is not held against the reference's solo run:
    from the first update one coordinate of v/B, whose gradient is
    float noise (~1e-7) of opposite sign in the two frameworks, moves
    1.7 lr apart under Adam, and over 6 steps at lr 1e-2 the two solo
    runs' losses part by 0.028 and their k/A by 0.042 (ROADMAP C12)."""
    got = C.result(runs["ranks"], "pipe_migration")
    assert got["step0"] == [2, 2] and got["n"] == 2
    assert got["widths"] == [4]
    assert got["merged_opt_step"] == 4
    assert got["opt_step"] == (6, 6) and got["steps_done"] == (6, 6)
    C.losses_close(got["ref"], got["got"])
    for part in ("adapter", "mu", "nu"):
        C.state_close(got[f"ref_{part}"], got[part])


def test_engine_in_pipeline_mode(runs):
    """``ElasticEngine(tp_mode="pipeline", pipeline_stages=2)`` over the
    world: the same on every rank, at the bars of the meshless engine;
    the removed job leaves whole, with its steps."""
    got = _all(runs, "pipe_engine")
    for g in got[1:]:
        _same(got[0], g)
        for k, v in got[0]["removed"][2].items():
            np.testing.assert_array_equal(g["removed"][2][k], v)
    C.compare(runs["meshless"]["engine"], got[0])
    assert got[0]["removed"][:2] == (2, 2)


def test_controller_in_pipeline_mode(runs):
    """``ClusterController(partition=True, tp_mode="pipeline",
    pipeline_stages=2)``: two groups on disjoint 2-rank slices, each a
    P = 2 x D = 1 pipeline; every rank's decisions and the losses agree,
    held to the meshless controller's at the bars; a depth of 3 is
    refused at partition time on every rank."""
    got = _all(runs, "pipe_controller")
    want = runs["meshless"]["ctl"]
    for r, g in enumerate(got):
        assert g["gkey"] == W.CTL_GROUPS[r // 2] and g["n"] == 2
        assert g["stage"] == r % 2
        assert g["decisions"] == got[0]["decisions"]
        assert g["losses"] == got[0]["losses"]
        assert "stages=3 does not divide the group slice of 2" in \
            g["depth3"]
    assert got[0]["decisions"]["devices"] == [
        (list(W.CTL_GROUPS[0]), [0, 1]), (list(W.CTL_GROUPS[1]), [2, 3])]
    for i, gk in enumerate(W.CTL_GROUPS):
        key = "+".join(gk)
        for j in range(2):
            C.losses_close(want["losses"][key][j],
                           got[0]["losses"][key][j])
    for jid, _ in W.CTL_JOBS:
        a, b = want["states"][jid], got[0]["states"][jid]
        for part in ("adapter", "mu", "nu"):
            C.state_close(a[part], b[part])
        assert (a["opt_step"], a["steps_done"]) == \
            (b["opt_step"], b["steps_done"])
