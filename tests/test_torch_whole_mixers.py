"""Mixers that a model axis would split through a head run whole on every
rank (ROADMAP A4), and a pipeline mesh with a model axis (ROADMAP A8d),
on the CPU: four gloo ranks (one spawn for the file,
tests/torch_sharded_worker.py, scenarios ``wm_parity`` and
``ppm_parity``).

Whole mixers: reduced f32 configs replaced so that a model axis of 2
splits their mixer's heads or channels -- tinyllama-1.1b with 3 query
heads over 1 kv head ("wl"), deepseek-v2-lite-16b with 3 MLA heads
("wm", its MoE expert parallel beside it) and recurrentgemma-9b with 255
RG-LRU channels ("wr", its local attention split beside it) -- train
through ``GroupRuntime(tp_mode="auto")``, job set "rag" (the ragged
kernels' plain versions), 2 steps, at data 1 x model 2 on each pair of
the world and ("wl") data 2 x model 2 over the world.  Each run is held
against the reference's single-device step over the same data shards
(``torch_sharded_common.ref_shard_function``) at the tensor-parallel
tests' bars: per-job losses at 1e-4, adapters and moments within 2.5e-2
and within 1e-5 for over 85% of the coordinates, Adam steps exactly.
Every rank's adapters and moments are bit-equal, the whole mixer's
leaves and caches are whole on every rank, the rest of the layer is
cut.  The serve steps of "wl" and of reduced hubert-xlarge (its cached
prefill, A9) over the pair match the meshless ones at 1e-4.

Pipeline x model axis: ``make_local_mesh(model=2, stages=2)`` over the
world is the reference's (stage, data, model) mesh, each model index a
replica of the (stage, data) pipeline (its ``shard_map`` names only
"stage" and "data").  The replicas' losses, adapters and moments are bit-equal to one
another and to the model-1 pipeline on a 2-rank slice (the same
program), and at the bars above against the meshless run; only model
index 0 writes checkpoints.  The reference's sharded steps do not run
on the CPU's JAX (ROADMAP C4).
"""
import os

import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.models import model as RM  # noqa: F401  (the import cycle)

from repro_torch.models import model as M
from repro_torch.models.layers import ModelAxis
from repro_torch.sharding import rules

import torch_sharded_common as C
import torch_sharded_worker as W
from torch_train_common import one_torch_thread  # noqa: F401

WHOLE = {"wl": ("attn",), "wm": ("mla",), "wr": ("rglru",)}
CASES = [(k, "d1") for k in W.WM_ARCHS] + [(k, "d2") for k in W.WM_D2]


def _ref_cfg(key):
    if key == "hb":
        import dataclasses
        return dataclasses.replace(ref_get_config("hubert-xlarge")
                                   .reduced(), dtype="float32")
    return W.wm_cfg(key, ref_get_config)


def _ref_weights(key):
    """The reference's (params, adapters) of job set "rag" on *key*'s
    config, drawn from PRNGKey(SEED) by its jitted ``init``, as numpy."""
    import jax
    from repro.core.jobs import LoRAJobSpec as RefSpec
    from repro.core.ssm import SharedSuperModel as RefSSM
    ssm = RefSSM(_ref_cfg(key), W.specs("rag", RefSpec), impl="xla",
                 block_t=W.BT)
    return jax.tree.map(np.asarray, jax.jit(ssm.init)(
        jax.random.PRNGKey(W.SEED)))


def _ref_steps(key, weights):
    """The reference's single-device step of each of *key*'s cases, one
    after another (its data-2 case reuses its data-1 compile)."""
    return {(k, d): C.ref_shard_function(_ref_cfg(k), "rag", weights,
                                         shards=1 if d == "d1" else 2)
            for k, d in CASES if k == key}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results, with the reference's weights and its
    single-device steps (two spawned processes: they import JAX and draw
    two keys' weights while this one draws the others', then compile the
    steps while the ranks work) and the port's meshless pipeline run."""
    from concurrent.futures import ProcessPoolExecutor
    import torch.multiprocessing as mp
    from repro_torch.models.convert import (adapters_from_numpy,
                                            params_from_numpy)
    with ProcessPoolExecutor(2, mp_context=mp.get_context("spawn")) as pool:
        there = {k: pool.submit(_ref_weights, k) for k in ("wr", "hb")}
        weights = {k: _ref_weights(k) for k in ("wl", "wm")}
        weights.update({k: f.result() for k, f in there.items()})
        ref = [pool.submit(_ref_steps, k, weights[k]) for k in W.WM_ARCHS]
        inputs = {f"wm:{k}": {"params": params_from_numpy(w[0], "cpu"),
                              "adapters": adapters_from_numpy(w[1], "cpu")}
                  for k, w in weights.items()}
        inputs["pl"] = C.port_weights("pl")
        out = tmp_path_factory.mktemp("wm")
        handle = C.spawn(W.WHOLE_MIXERS, out, inputs)
        meshless = W.run(inputs, "pl", 2, impl="cuda")
        ref = {c: r for f in ref for c, r in f.result().items()}
    return {"ranks": C.collect(handle), "ref": ref, "meshless": meshless,
            "dir": out}


def _all(runs, name):
    return [C.result(runs["ranks"], name, r) for r in range(C.WORLD)]


def _same(a, b):
    np.testing.assert_array_equal(a["losses"], b["losses"])
    for part in ("adapters", "mu", "nu"):
        assert a[part].keys() == b[part].keys()
        for k in a[part]:
            np.testing.assert_array_equal(a[part][k], b[part][k], err_msg=k)
    assert a["step"] == b["step"] and a["steps_done"] == b["steps_done"]


@pytest.mark.parametrize("key,mesh", CASES)
def test_whole_mixer_matches_the_reference(runs, key, mesh):
    """Each run on every rank against the reference's step over the same
    data shards; every rank's trainable state bit-equal."""
    got = [res[mesh][key] for res in _all(runs, "wm_parity")]
    for r, g in enumerate(got):
        C.compare(runs["ref"][(key, mesh)], g)
        assert g["model_axis"] == (2, r % 2)
        assert g["shards"] == (1 if mesh == "d1" else 2)
    for part in ("adapters", "mu", "nu"):
        for g in got[1:]:
            assert all(np.array_equal(g[part][k], got[0][part][k])
                       for k in got[0][part]), (key, mesh, part)


@pytest.mark.parametrize("key", sorted(W.WM_ARCHS))
def test_whole_mixer_is_whole_on_every_rank(runs, key):
    """The axis of 2 would split the config's mixer (``whole_mixers``
    names it), so its block is whole on every rank, while the layer's
    MLP or experts and the vocabulary are cut."""
    cfg = W.wm_cfg(key)
    assert M.whole_mixers(cfg, 2) == WHOLE[key]
    assert M.whole_mixers(cfg, 1) == ()
    block = {"wl": "attn", "wm": "attn", "wr": "rg"}[key]
    full = {k: tuple(v.shape) for k, v in W.flat_t(
        M.init_model(cfg, device="meta")).items()}
    for res in _all(runs, "wm_parity"):
        shapes = res["d1"][key]["shapes"]
        assert shapes.keys() == full.keys()
        mixer = [k for k in full if f"/{block}/" in k]
        assert mixer and all(shapes[k] == full[k] for k in mixer)
        cut = [k for k in full if shapes[k] != full[k]]
        assert cut and all(f"/{block}/" not in k for k in cut)
        assert any(k.endswith(("ffn/gate", "embed", "ffn/w_in"))
                   for k in cut)


@pytest.mark.parametrize("key", sorted(W.WM_ARCHS))
def test_caches_of_a_whole_mixer_are_whole(key):
    """A whole mixer's caches on a rank are the meshless caches' shapes,
    and the runtime cache specs split them over the batch axes only;
    a split mixer's (recurrentgemma's local attention) stay split."""
    cfg = W.wm_cfg(key)
    whole = M.init_caches(cfg, 4, 64, device="meta")
    for i in range(2):
        mine = M.init_caches(cfg, 4, 64, device="meta",
                             tp=ModelAxis(None, 2, i))
        for seg, a, b in zip(M.segment_plan(cfg), whole, mine):
            for j, spec in enumerate(seg.specs):
                same = [tuple(x.shape) == tuple(y.shape)
                        for x, y in zip(a[str(j)], b[str(j)])]
                assert all(same) == M.mixer_runs_whole(cfg, spec.mixer, 2) \
                    or spec.mixer == "mla", (key, spec)
    specs = rules.runtime_cache_specs({"data": 2, "model": 2}, whole, cfg)
    for seg, seg_s in zip(M.segment_plan(cfg), specs):
        for j, spec in enumerate(seg.specs):
            flat = [e for leaf in seg_s[str(j)] for e in leaf]
            if M.mixer_runs_whole(cfg, spec.mixer, 2):
                assert "model" not in flat and "data" in flat


@pytest.mark.parametrize("key", ["wl", "hb"])
def test_serving_with_a_whole_mixer(runs, key):
    """The prefill (and "wl"'s two decode steps) over the pair against
    the meshless serve at 1e-4; a whole attention's caches are the
    meshless caches' shapes on every rank."""
    for res in _all(runs, "wm_parity"):
        got = res["serve"][key]
        np.testing.assert_allclose(got["mesh"]["logits"],
                                   got["meshless"]["logits"],
                                   rtol=1e-4, atol=1e-4)
        if key == "wl":
            assert got["mesh"]["caches"] == got["meshless"]["caches"]


def test_pipeline_model_replicas_are_bit_equal(runs):
    """The (stage 2, data 1, model 2) mesh: rank s·2 + i is stage s,
    model index i; the two replicas of each stage hold and compute the
    same bits, and only model index 0 of stage 0 writes."""
    got = _all(runs, "ppm_parity")
    for r, g in enumerate(got):
        assert g["shape"] == {"stage": 2, "data": 1, "model": 2}
        assert g["grid"] == [[[0, 1]], [[2, 3]]]
        assert g["replica"] == [[r % 2], [2 + r % 2]]
        assert (g["stage"], g["shards"], g["model_axis"]) == \
            (r // 2, 1, (2, r % 2))
        assert g["writer"] == (r == 0)
        assert (g["useful"].tolist(), g["slots"].tolist()) == ([4, 4],
                                                               [6, 6])
    for s in range(2):
        _same(got[2 * s], got[2 * s + 1])
        assert got[2 * s]["resident"] == got[2 * s + 1]["resident"]
    assert all(os.path.exists(os.path.join(runs["dir"], f"{s.job_id}.npz"))
               for s in W.specs("pl"))


def test_pipeline_model_axis_matches_model_one_and_meshless(runs):
    """Each replica equals the model-1 pipeline (P = 2 x D = 1 on a
    2-rank slice, the same N = 2 "rank_desc") bit for bit, and the
    meshless run at the pipeline tests' bars."""
    for g in _all(runs, "ppm_parity"):
        _same(g["model1"], g)
        C.compare(runs["meshless"], g)
