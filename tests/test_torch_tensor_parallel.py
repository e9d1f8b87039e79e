"""Tensor parallelism (``tp_mode="auto"``, ROADMAP A4) and the
expert-parallel MoE (A3) on the CPU: four gloo ranks (one spawn for the
file, tests/torch_sharded_worker.py, scenarios ``tp_*``) train over
("data", "model") meshes — data 1 x model 2 on each pair of the world,
data 2 x model 2 over the whole world — reduced f32 tinyllama-1.1b with
a mixed-rank group ("rag": the ragged kernels, gather and psum) and a
uniform one ("ab": the masked kernels), and reduced f32 qwen3-moe-30b-a3b
(E = 4 over model 2: expert parallel, capacity and ragged, and with one
shared expert beside the ragged dispatch), impl "cuda"
(its kernels' plain versions), block_t 8; also ``make_train_step(mesh=,
tp_mode="auto")`` called directly, ``ElasticEngine(tp_mode="auto")`` and
``ClusterController(tp_mode="auto")`` on the pool's slices.

Every run is held against the reference's single-device step over the
same data shards (``tests/torch_sharded_common.ref_shard_function``:
for data 1 and for the dense model it is the meshless step; for the MoE
at data 2 the reference's function over the two shards, as in
tests/test_torch_moe_mesh.py) at PR 25's bars: per-job losses at 1e-4,
adapters and moments within 2.5e-2 and within 1e-5 for more than 85% of
the coordinates, Adam steps and steps done exactly.  Every rank's
adapters and moments are bit-equal (the model ranks compute the same
adapter gradients, and the data axis reduces them as in "dp"), and each
rank holds only its slices of the backbone under the runtime specs.
The last test records ROADMAP C13: the capacity the reference's
expert-parallel dispatch takes inside its runtime's data-manual
``shard_map``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.models import model as RM  # noqa: F401  (the import cycle)
from repro.models import moe as RMoE

from repro_torch.cluster.controller import ClusterController
from repro_torch.elastic.engine import ElasticEngine
from repro_torch.models import moe
from repro_torch.models.layers import ModelAxis
from repro_torch.sharding import rules

import torch_sharded_common as C
import torch_sharded_worker as W
from torch_train_common import one_torch_thread  # noqa: F401


def _ref_cfg(key):
    return W.tp_cfg(key, ref_get_config)


def _meshless_engine(inputs):
    eng = ElasticEngine(W.cfg_f32(), params=inputs["tl:ab"]["params"],
                        impl="cuda", block_t=W.BT, lr=W.LR, remat=False,
                        chunk_size=2, device="cpu")
    for s in W.specs("ab"):
        eng.add_job(s, init_seed=11)
    rt = eng.ensure_group(("a", "b"))
    rt.run(2)
    return W.summary(rt)


def _meshless_controller(inputs):
    ctl = ClusterController(lambda m: W.cfg_f32(), impl="cuda",
                            block_t=W.BT, lr=W.LR, remat=False,
                            chunk_size=2, seed=3, device="cpu")
    W.admit(ctl, inputs, [j for j, _ in W.CTL_JOBS])
    ctl.apply_grouping(W.CTL_GROUPS, chips=[2, 2])
    ctl.run(4)
    return {"losses": {g: [[float(l[j]) for l in
                            ctl._slots[g].runtime(g).report.per_job_losses]
                           for j in range(2)] for g in W.CTL_GROUPS},
            "states": {j: W.state_of(ctl.job_state(j))
                       for j, _ in W.CTL_JOBS}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results, with the reference's runs and the port's
    meshless engine and controller made while the ranks work."""
    keys = {(c, j) for c, j, _ in W.TP_RUNS.values()}
    weights = {(c, j): C.ref_weights(_ref_cfg(c), j) for c, j in keys}
    inputs = {f"{c}:{j}": w["port"] for (c, j), w in weights.items()}
    inputs.update(W.ctl_inputs())
    handle = C.spawn(W.TENSOR_PARALLEL, tmp_path_factory.mktemp("tp"),
                     inputs)
    ref = {(c, j, d): C.ref_shard_function(_ref_cfg(c), j,
                                           weights[(c, j)]["np"], shards=d)
           for c, j in sorted(keys) for d in (1, 2)}
    meshless = {"engine": _meshless_engine(inputs),
                "ctl": _meshless_controller(inputs)}
    return {"ranks": C.collect(handle), "ref": ref, "meshless": meshless}


def _all(runs, name):
    return [C.result(runs["ranks"], name, r) for r in range(4)]


@pytest.mark.parametrize("mesh", ["d1", "d2"])
@pytest.mark.parametrize("name", sorted(W.TP_RUNS))
def test_tensor_parallel_matches_the_reference(runs, name, mesh):
    """Each run on every rank against the reference's step over the same
    data shards; every rank's trainable state bit-equal."""
    c, j, _ = W.TP_RUNS[name]
    d = 1 if mesh == "d1" else 2
    want = runs["ref"][(c, j, d)]
    got = [res[mesh][name] for res in _all(runs, "tp_parity")]
    for r, g in enumerate(got):
        C.compare(want, g)
        assert g["model_axis"] == (2, r % 2) and g["shards"] == d
    for part in ("adapters", "mu", "nu"):
        for g in got[1:]:
            assert all(np.array_equal(g[part][k], got[0][part][k])
                       for k in got[0][part]), (name, mesh, part)


@pytest.mark.parametrize("name", ["rag", "qc"])
def test_each_rank_holds_only_its_slices(runs, name):
    """Every backbone leaf a rank holds has the shape of its share under
    the runtime specs (Megatron columns and rows, the vocab, E/2 experts
    a rank), and the rank's backbone is under 60% of the whole."""
    c, _, _ = W.TP_RUNS[name]
    for res in _all(runs, "tp_parity"):
        g = res["d2"][name]
        for k, shape in g["shapes"].items():
            spec = g["specs"][k]
            assert "data" not in spec, (k, spec)
            whole = tuple(shape[i] * (2 if i < len(spec) and spec[i] ==
                                      "model" else 1)
                          for i in range(len(shape)))
            assert rules.local_shape(whole, spec, {"model": 2}) == shape
        split = [k for k, s in g["specs"].items() if "model" in s]
        assert any(k.endswith("wq") for k in split)
        assert "embed" in split
        if c != "tl":
            assert any(k.endswith("ffn/w_in") for k in split)
        assert g["bytes"] < 0.6 * g["whole_bytes"], (g["bytes"],
                                                     g["whole_bytes"])


def test_make_train_step_and_engine(runs):
    """``make_train_step(mesh=, tp_mode="auto")`` on the world (data 2 x
    model 2): the step-1 losses and adapters against the reference's
    first step; ``ElasticEngine(tp_mode="auto")``'s group against the
    port's meshless engine, and a removed job's step accounting."""
    want = C.ref_shard_function(_ref_cfg("tl"), "ab",
                                C.ref_weights(_ref_cfg("tl"), "ab")["np"],
                                shards=2, steps=1)
    for res in _all(runs, "tp_step_and_engine"):
        C.losses_close(want["losses"][0], res["step"]["per_job"])
        C.state_close(want["adapters"], res["step"]["adapters"])
        C.compare(runs["meshless"]["engine"], res["engine"])
        assert res["removed_steps"] == (2, 2)


def test_controller_runs_auto_on_its_slices(runs):
    """``ClusterController(tp_mode="auto")``: each group on its 1-D
    2-rank slice (the data-parallel step, no model axis), against the
    port's meshless controller; every rank's decisions equal."""
    got = _all(runs, "tp_controller")
    want = runs["meshless"]["ctl"]
    for res in got:
        C.losses_close(np.asarray(want["losses"][tuple(res["gkey"])]),
                       np.asarray(res["losses"]))
        for jid, st in res["states"].items():
            for part in ("adapter", "mu", "nu"):
                C.state_close(want["states"][jid][part], st[part])
            assert st["opt_step"] == want["states"][jid]["opt_step"]
        assert res["decisions"] == got[0]["decisions"]


def test_reference_capacity_under_a_manual_data_axis_c13(monkeypatch):
    """ROADMAP C13.  Inside the reference runtime's data-manual
    ``shard_map`` (``tp_mode="auto"``) a data shard's rows are already
    local, but ``_expert_parallel_moe`` divides their T by the data size
    once more (``moe.py:150-155``), so its capacity is a data shard's
    C / D.  The dry run (global T) takes C from the tokens a data shard
    holds; the port takes it so from the shard's own T.  Shown on a
    ("data" 2, "model" 2) geometry with the reference's ``shard_map``
    replaced by a stand-in that reads the C its ``local`` closes over."""
    rc = _ref_cfg("qc")
    pc = W.moe_cfg("qc")
    E, k, d = rc.num_experts, rc.num_experts_per_tok, rc.d_model
    T_loc = 96                                  # tokens a data shard holds
    seen = {}

    def shard_map(local, **kw):
        free = dict(zip(local.__code__.co_freevars,
                        (c.cell_contents for c in local.__closure__)))
        seen["C"] = free["C"]
        return lambda *a: None

    class Mesh:
        axis_names = ("data", "model")
        shape = {"data": 2, "model": 2}

    monkeypatch.setattr(jax, "shard_map", shard_map)
    ref_C = {}
    for T in (T_loc, 2 * T_loc):                # runtime, dry run
        RMoE._expert_parallel_moe(
            rc, {"w_in": None, "w_out": None}, jnp.zeros((T, d)),
            jnp.zeros((T * k,), jnp.int32), jnp.zeros((T, k)), E, k, T, d,
            jnp.float32, Mesh())
        ref_C[T] = seen["C"]
    cap = lambda T: int(max(1, (T * k / E) * rc.moe_capacity_factor))
    assert ref_C[T_loc] == cap(T_loc // 2) != cap(T_loc)
    assert ref_C[2 * T_loc] == cap(T_loc)
    # the port: C from the shard's own T
    got = {}
    real = moe._dispatch_local

    def spy(*a):
        got["C"] = a[-1]
        return real(*a)
    monkeypatch.setattr(moe, "_dispatch_local", spy)
    pp = C.ref_weights(rc, "ab")["port"]["params"]["segments"][0]["0"]["ffn"]
    w = {kk: v[0] for kk, v in pp.items()}
    w = dict(w, w_in=w["w_in"][:E // 2], w_out=w["w_out"][:E // 2])
    x = torch.randn(T_loc, d)
    _, top_w, top_i = moe.route(pc, w, x)
    moe._expert_parallel_moe(pc, w, x, top_i.reshape(-1), top_w, E, k,
                             T_loc, d, x.dtype, ModelAxis(None, 2, 0))
    assert got["C"] == cap(T_loc) == ref_C[2 * T_loc]
