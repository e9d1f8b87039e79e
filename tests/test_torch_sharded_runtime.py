"""The port's sharded runtime layer on the CPU: four gloo ranks (one
spawn for the file, tests/torch_sharded_worker.py) run the reference's
runtime scenarios (tests/sharded_worker.py: nano re-granulation, mixed
ranks in both sync modes, the rank-descending nano order, migration
across meshes) and the port's own (checkpoints and publishes on rank 0,
AIMD agreed across ranks, ``ElasticEngine(mesh=...)``,
``make_train_step(mesh=...)``) on reduced tinyllama-1.1b in f32 with
block_t 8; then the shard layout held equal to the reference's, and the
refusals.

Tolerances are those of tests/torch_sharded_common.py: each sharded run
against the port's meshless run and against the reference's
single-device "xla" run (per-job losses at 1e-4, state at the Adam
bound), Adam steps and steps done exactly; within the port, what the
contract makes replicated (every rank's losses, the restored
checkpoints) is asserted equal.
"""
import dataclasses
import math
import types

import numpy as np
import pytest
import torch

import jax

from repro.configs import get_config as ref_get_config
from repro.core.jobs import LoRAJobSpec as RefSpec
from repro.core.ssm import _nano_index as ref_nano_index
from repro.data.pipeline import FusedBatcher as RefBatcher
from repro.data.pipeline import inverse_permutation as ref_inverse
from repro.data.pipeline import shard_permutation as ref_shard_perm
from repro.elastic.migrate import JobTrainState as RefState
from repro.elastic.runtime import GroupRuntime as RefRuntime
from repro.models import model as RM

from repro_torch.configs import get_config
from repro_torch.core.jobs import LoRAJobSpec
from repro_torch.core.ssm import SharedSuperModel, _nano_index
from repro_torch.data.pipeline import (FusedBatcher, JobStream,
                                       inverse_permutation,
                                       shard_permutation)
from repro_torch.elastic.engine import ElasticEngine
from repro_torch.elastic.migrate import JobTrainState
from repro_torch.elastic.runtime import GroupRuntime
from repro_torch.kernels import ops
from repro_torch.launch.mesh import init_mesh
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim.schedule import constant

import torch_sharded_common as C
import torch_sharded_worker as W
from torch_train_common import StandInMesh
from torch_train_common import one_torch_thread  # noqa: F401


def _mig_inputs():
    """The reference's migration scenario inits (sharded_worker.py:303):
    params and two fresh job states, as the port's."""
    cfg = C.ref_cfg()
    key = jax.random.PRNGKey(3)
    params = RM.init_model(jax.random.fold_in(key, 0), cfg)
    port_cfg = W.cfg_f32()
    states, ref_states = [], []
    for i, spec in enumerate(W.specs("mig", RefSpec)):
        st = RefState.fresh(spec, cfg, jax.random.fold_in(key, i + 1),
                            r_pad=8)
        ref_states.append(st)
        pspec = W.specs("mig")[i]
        ad = {k: torch.from_numpy(np.array(v, np.float32))
              for k, v in st.adapter.items()}
        states.append(JobTrainState(
            spec=pspec, adapter=ad,
            mu={k: torch.zeros_like(v) for k, v in ad.items()},
            nu={k: torch.zeros_like(v) for k, v in ad.items()},
            stream=JobStream(pspec, port_cfg.vocab_size, 0)))
    return ({"params": params_from_numpy(jax.tree.map(np.asarray, params),
                                         "cpu"), "states": states},
            params, ref_states)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results, with the port's meshless runs and the
    reference's single-device runs made while the ranks work."""
    inputs = {k: C.port_weights(k) for k in ("ab", "rag")}
    inputs["mig"], ref_params, ref_states = _mig_inputs()
    handle = C.spawn(W.RUNTIME,
                     tmp_path_factory.mktemp("sharded_runtime"), inputs)
    meshless = {
        "ab": W.run(inputs, "ab", 2, impl="torch"),
        "rag_cuda": W.run(inputs, "rag", 2, impl="cuda"),
        "rag_torch": W.run(inputs, "rag", 2, impl="torch"),
    }
    eng = ElasticEngine(W.cfg_f32(), params=inputs["ab"]["params"],
                        impl="torch", block_t=W.BT, lr=W.LR, remat=False,
                        chunk_size=2, device="cpu")
    for s in W.specs("ab"):
        eng.add_job(s, init_seed=11)
    rt = eng.ensure_group(("a", "b"))
    rt.run(2)
    meshless["engine"] = W.summary(rt)
    ref = {k: C.ref_runs(k, at=(2,)) for k in ("ab", "rag")}
    rt = RefRuntime.from_states(C.ref_cfg(), ref_params, [ref_states[0]],
                                lr=W.LR, impl="xla", block_t=W.BT,
                                remat=False, chunk_size=2)
    rt.run(6)
    ref["mig"] = {"losses": [l[0] for l in rt.report.per_job_losses],
                  "state": rt.export("mig-a")}
    return {"ranks": C.collect(handle), "meshless": meshless, "ref": ref,
            "inputs": inputs}


def _same_on_ranks(runs, name, key, ranks=(0, 1, 2, 3)):
    got = [C.result(runs["ranks"], name, r) for r in ranks]
    for g in got[1:]:
        np.testing.assert_array_equal(np.asarray(g[key]),
                                      np.asarray(got[0][key]))
    return got[0]


def test_nano_regranulation_sharded(runs):
    got = C.result(runs["ranks"], "nano_regranulation_sharded")
    C.compare(got["n1"], got["n2"])                  # N = 1 == N = 2
    C.compare(got["n1"], got["n2_cuda"])
    for n in ("n1", "n2", "n2_cuda"):
        C.compare(runs["meshless"]["ab"], got[n])
        C.compare(runs["ref"]["ab"][2], got[n])
    # AIMD's legal set: divisors of the gcd of per-shard rows that keep
    # every job's per-slice tokens whole tiles
    g = math.gcd(*got["rows_loc"])
    assert got["legal"] and all(g % n == 0 for n in got["legal"])
    assert all(r * W.SEQ % (n * W.BT) == 0
               for n in got["legal"] for r in got["rows_loc"])


def test_ragged_mixed_rank_parity(runs):
    got = C.result(runs["ranks"], "ragged_mixed_rank_parity")
    assert got["r_pads"] == [8, 64]
    assert 72 in got["widths"]                       # 8 + 64, not 2 x 64
    ref = runs["ref"]["rag"][2]
    for impl in ("cuda", "torch"):
        C.compare(runs["meshless"][f"rag_{impl}"], got[impl])
        C.compare(ref, got[impl])
    C.losses_close(ref["losses"], got["psum"]["losses"])
    C.state_close(ref["adapters"], got["psum"]["adapters"])
    C.compare(runs["meshless"]["rag_cuda"], got["psum"])
    other = C.result(runs["ranks"], "ragged_mixed_rank_parity", 3)
    np.testing.assert_array_equal(other["cuda"]["losses"],
                                  got["cuda"]["losses"])


def test_ragged_nano_rank_desc_order(runs):
    got = C.result(runs["ranks"], "ragged_nano_rank_desc_order")
    C.compare(got["job"], got["rank_desc"])
    C.compare(got["job"], got["cuda_rank_desc"])
    for k in ("job", "rank_desc", "cuda_rank_desc"):
        C.compare(runs["ref"]["rag"][2], got[k])
        C.compare(runs["meshless"]["rag_torch"], got[k])


def test_migration_across_meshes(runs):
    got = C.result(runs["ranks"], "migration_across_meshes")
    assert got["step0"] == [2, 0]         # a joins at Adam step 2, b at 0
    assert (got["opt_step"], got["steps_done"]) == (6, 6)
    C.losses_close(got["ref"], got["got"])           # port, meshless
    C.state_close(got["ref_adapter"], got["adapter"])
    C.state_close(got["ref_mu"], got["mu"])
    ref = runs["ref"]["mig"]                          # the reference
    C.losses_close(ref["losses"], got["got"])
    st = ref["state"]
    assert st.opt_step == 6
    C.state_close(W.flat(jax.tree.map(np.asarray, st.adapter)),
                  got["adapter"])


def test_checkpoints_and_publish_on_rank0(runs):
    got = [C.result(runs["ranks"], "checkpoints_and_publish_on_rank0", r)
           for r in range(C.WORLD)]
    for g in got:
        if g["shard"] == 0:
            assert sorted(g["published"]) == ["a", "b"]
        else:
            assert g["published"] == {}
        for jid, flat in g["restored"].items():
            for k, v in flat.items():
                np.testing.assert_array_equal(v, got[0]["restored"][jid][k])


def test_aimd_agrees_across_ranks(runs):
    got = [C.result(runs["ranks"], "aimd_agrees_across_ranks", r)
           for r in range(C.WORLD)]
    for pair in ((0, 1), (2, 3)):
        a, b = (got[r] for r in pair)
        assert a["nano"] == b["nano"] and len(a["nano"]) == 12
        assert a["step_times"] == b["step_times"]
        np.testing.assert_array_equal(a["losses"], b["losses"])


def test_engine_on_a_mesh(runs):
    got = _same_on_ranks(runs, "engine_on_a_mesh", "losses")
    C.compare(runs["meshless"]["engine"], got)
    assert got["removed_steps"] == (2, 2)


def test_make_train_step_on_a_mesh(runs):
    got = _same_on_ranks(runs, "make_train_step_on_a_mesh", "per_job")
    w, jobs, cfg = runs["inputs"]["ab"], W.specs("ab"), W.cfg_f32()
    ssm = SharedSuperModel(cfg, jobs, impl="cuda", block_t=W.BT,
                           data_shards=2)
    from repro_torch.optim import adamw
    batch = {k: torch.from_numpy(v) for k, v in got["batch"].items()}
    step = ssm.make_train_step(lr_fn=constant(W.LR), remat=False)
    ad, _, m = step(w["params"], w["adapters"],
                    adamw.init(w["adapters"], per_job=len(jobs)), batch)
    np.testing.assert_allclose(got["per_job"], m["per_job_loss"].numpy(),
                               rtol=1e-6, atol=1e-6)
    C.state_close(W.flat(ad), got["adapters"])


# ------------------------------------------------------ shard layout
@pytest.mark.parametrize("rows,shards", [([4, 8], 2), ([4, 4, 8], 4),
                                         ([2], 2), ([6, 3], 3)])
def test_shard_permutation_matches_the_reference(rows, shards):
    perm = shard_permutation(rows, shards)
    np.testing.assert_array_equal(perm, ref_shard_perm(rows, shards))
    np.testing.assert_array_equal(inverse_permutation(perm),
                                  ref_inverse(ref_shard_perm(rows, shards)))
    assert np.array_equal(perm[inverse_permutation(perm)],
                          np.arange(sum(rows)))


@pytest.mark.parametrize("order", [None, (1, 0, 2)])
def test_nano_index_matches_the_reference(order):
    rows = [4, 8, 2]
    np.testing.assert_array_equal(_nano_index(rows, 2, order=order),
                                  ref_nano_index(rows, 2, order=order))


def test_batcher_shards_match_the_reference():
    """FusedBatcher(shards=4) gives the reference's batches, and padding
    consumes no stream data (tests/test_sharded_runtime.py:109)."""
    jobs = [LoRAJobSpec("a", rank=4, batch_size=3, seq_len=32),
            LoRAJobSpec("b", rank=8, batch_size=2, seq_len=32)]
    rjobs = [RefSpec("a", rank=4, batch_size=3, seq_len=32),
             RefSpec("b", rank=8, batch_size=2, seq_len=32)]
    solo = FusedBatcher(jobs, 128, block_t=8, seed=0)
    shard = FusedBatcher(jobs, 128, block_t=8, seed=0, shards=4)
    ref = RefBatcher(rjobs, 128, block_t=8, seed=0, shards=4)
    assert shard.rows_per_job() == ref.rows_per_job() == [4, 4]
    for _ in range(2):
        b1, b2, b3 = solo.next_batch(), shard.next_batch(), ref.next_batch()
        for k in b3:
            np.testing.assert_array_equal(b2[k], b3[k])
        r1 = np.concatenate([[0], np.cumsum(solo.rows_per_job())])
        r2 = np.concatenate([[0], np.cumsum(shard.rows_per_job())])
        for j, job in enumerate(jobs):
            real = job.batch_size
            for key in ("tokens", "labels", "loss_mask"):
                np.testing.assert_array_equal(
                    b1[key][r1[j]:r1[j] + real], b2[key][r2[j]:r2[j] + real])
            assert not b2["loss_mask"][r2[j] + real:r2[j + 1]].any()


# --------------------------------------------------------- refusals
def _cfg_and_specs():
    return W.cfg_f32(), W.specs("ab")


@pytest.mark.parametrize("kw,match", [
    pytest.param(dict(tp_mode="auto"), "model", id="kw0-A7c"),
    pytest.param(dict(tp_mode="pipeline"), "pipeline_stages >= 2",
                 id="kw1-A7b")])
def test_tp_modes_other_than_dp_refuse(kw, match):
    """"auto" (ROADMAP A4, old A7c) is ported: the engine passes it
    through, and over a model axis of 2 the int8 backbone (A8b) and MLA
    (A8c) build; a pipeline mesh with a model axis is the reference's
    (stage, data, model) mesh, each model index a replica (A8d,
    ``make_local_mesh(model=, stages=)``).  "pipeline" (old A7b) is
    ported and refuses what the reference refuses: no mesh, a depth of
    1, a depth that does not divide the scanned stack (a MoE model's
    too: it is no longer refused, A3); the engine passes it through."""
    cfg, jobs = _cfg_and_specs()
    if kw["tp_mode"] == "pipeline":
        with pytest.raises(ValueError, match="needs a mesh"):
            GroupRuntime.from_specs(cfg, jobs, impl="torch", block_t=8,
                                    device="cpu", pipeline_stages=2, **kw)
        eng = ElasticEngine(cfg, params={}, mesh=object(), device="cpu",
                            pipeline_stages=2, **kw)
        assert (eng._rt_kwargs["tp_mode"],
                eng._rt_kwargs["pipeline_stages"]) == ("pipeline", 2)
        ssm_ = SharedSuperModel(cfg, jobs, impl="torch", block_t=8)
        with pytest.raises(ValueError, match=match):
            ssm_.make_train_step(lr_fn=constant(1e-2), mesh=object(), **kw)
        with pytest.raises(ValueError, match="legal pipeline depths"):
            ssm_.make_train_step(lr_fn=constant(1e-2), mesh=object(),
                                 pipeline_stages=4, **kw)
        moe = dataclasses.replace(
            get_config("qwen3-moe-30b-a3b").reduced(), dtype="float32")
        with pytest.raises(ValueError, match="legal pipeline depths"):
            SharedSuperModel(moe, jobs, impl="torch", block_t=8) \
                .make_train_step(lr_fn=constant(1e-2), mesh=object(),
                                 pipeline_stages=4, **kw)
        return
    from repro_torch.launch.mesh import fake_world, make_local_mesh
    rt = GroupRuntime.from_specs(cfg, jobs, impl="torch", block_t=8,
                                 device="cpu", mesh=StandInMesh(),
                                 quantize="int8", **kw)
    assert rt.model_axis == (2, 0) and rt.quantize == "int8"
    eng = ElasticEngine(cfg, params={}, mesh=object(), device="cpu", **kw)
    assert eng._rt_kwargs["tp_mode"] == "auto"
    mla = dataclasses.replace(
        get_config("deepseek-v2-lite-16b").reduced(), dtype="float32")
    assert callable(SharedSuperModel(mla, jobs, impl="torch", block_t=8)
                    .make_train_step(lr_fn=constant(1e-2),
                                     mesh=StandInMesh(), **kw))
    with fake_world(4, 0):
        mesh = make_local_mesh(model=2, stages=2)
        assert mesh.mesh_dim_names[-1] == match and mesh.shape == {
            "stage": 2, "data": 1, "model": 2}
        assert (mesh.stage, mesh.shard, mesh.model_index) == (0, 0, 0)
        assert mesh.ranks == ((0,), (2,))


@pytest.mark.parametrize("impl", ["ref", "loop"])
def test_gather_mode_refuses_ref_and_loop(impl):
    cfg, jobs = _cfg_and_specs()
    fake = types.SimpleNamespace(mesh_dim_names=("data",))
    with pytest.raises(ValueError, match="no shard-local VJP"):
        GroupRuntime.from_specs(cfg, jobs, impl=impl, block_t=8,
                                device="cpu", mesh=fake)
    with pytest.raises(ValueError, match="no shard-local VJP"):
        SharedSuperModel(cfg, jobs, impl=impl, block_t=8) \
            .make_train_step(lr_fn=constant(1e-2), mesh=fake)
    shard = ops.Shard(None, torch.arange(8), 8)
    x = torch.zeros(8, 4)
    A, B = torch.zeros(2, 4, 8), torch.zeros(2, 8, 4)
    ids = torch.zeros(8, dtype=torch.int32)
    ranks, sc = torch.tensor([4, 8]), torch.ones(2)
    with pytest.raises(ValueError, match="no shard-local VJP"):
        ops.fused_lora(x, A, B, ids, ranks, sc, impl=impl, shard=shard)
    from repro_torch.core.lora import RankLayout
    lay = RankLayout((4, 8), multiple=8)
    with pytest.raises(ValueError, match="no shard-local VJP"):
        ops.fused_lora_ragged(x, torch.zeros(4, 16), torch.zeros(16, 4),
                              ids, sc, lay, impl=impl, shard=shard)


def test_moe_over_a_mesh_refuses():
    """A MoE model's sharded step is no longer refused (ROADMAP A3, old
    A7d; tests/test_torch_moe_mesh.py trains it): over a ("data",
    "model") mesh it builds the tensor-parallel step (expert parallel:
    the model axis divides its E), a MoE model with MLA too (A8c), and
    one over a model axis that would split its MLA heads, which then run
    whole (A4)."""
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b").reduced(),
                              dtype="float32")
    assert cfg.num_experts % 2 == 0
    ssm = SharedSuperModel(cfg, W.specs("ab"), impl="torch", block_t=8)
    assert callable(ssm.make_train_step(lr_fn=constant(1e-2),
                                        mesh=StandInMesh(), tp_mode="auto"))
    mla = dataclasses.replace(
        get_config("deepseek-v2-lite-16b").reduced(), dtype="float32")
    mla_ssm = SharedSuperModel(mla, W.specs("ab"), impl="torch", block_t=8)
    assert callable(mla_ssm.make_train_step(
        lr_fn=constant(1e-2), mesh=StandInMesh(), tp_mode="auto"))
    three = StandInMesh()
    three.size = lambda dim: (1, 3)[dim]
    # 4 MLA heads over 3: MLA runs whole on every rank (A4); no other
    # dimension is refused (d_ff, the experts and the vocab the axis
    # does not divide stay whole too)
    from repro_torch.models.model import whole_mixers
    assert whole_mixers(mla, 3) == ("mla",)
    assert callable(mla_ssm.make_train_step(lr_fn=constant(1e-2),
                                            mesh=three, tp_mode="auto"))
    assert ref_get_config("qwen3-moe-30b-a3b").num_experts


def test_init_mesh_names_its_backend(tmp_path):
    """The backend is explicit: an unknown one is refused, and "nccl"
    without a GPU for every rank is refused, never replaced by gloo."""
    with pytest.raises(ValueError, match="backend"):
        init_mesh(0, 1, f"file://{tmp_path}/s", "mpi")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="gloo"):
            init_mesh(0, 1, f"file://{tmp_path}/s", "nccl")
