"""Training with kv heads shared across model ranks (ROADMAP A4) on the
CPU: four gloo ranks (one spawn for the file, tests/torch_sharded_worker
.py, scenarios ``kvr_*``) train reduced f32 tinyllama-1.1b (H 4, KV 2)
at data 1 x model 4, so each kv head is held whole by 2 model ranks
(``sharding/rules.shard_params(cfg=)``, ``ModelAxis.kv_columns``),
through ``GroupRuntime(tp_mode="auto")`` with a mixed-rank group ("rag":
the ragged kernels' plain versions) and a uniform one ("ab": the masked
kernels'), and through ``make_train_step(mesh=, tp_mode="auto")`` called
directly.

Each run is held against the reference's single-device step at the
sharded tests' bars (``tests/torch_sharded_common``): per-job losses at
1e-4, adapters and Adam moments within 2.5e-2 and within 1e-5 for more
than 85% of the coordinates, Adam steps exactly; every rank's adapters
and moments are bit-equal. A planted cut that takes each kv head's
cotangent from one replica instead of the replicas' sum (each replica's
covers only its own query heads) must miss the k/v bars.
Where a model axis does not divide the query heads, or neither divides
nor is a multiple of the kv heads, the attention runs whole on every
rank (``models/model.whole_mixers`` names it; ROADMAP A4).
"""
import dataclasses

import numpy as np
import pytest

from repro.configs import get_config as ref_get_config

from repro_torch.configs import get_config

import torch_sharded_common as C
import torch_sharded_worker as W
from torch_train_common import one_torch_thread  # noqa: F401


def _ref_cfg():
    return dataclasses.replace(ref_get_config("tinyllama-1.1b").reduced(),
                               dtype="float32")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results, with the reference's steps made while the
    ranks work."""
    weights = {j: C.ref_weights(_ref_cfg(), j) for j in W.KVR_JOBS}
    inputs = {f"tl:{j}": w["port"] for j, w in weights.items()}
    handle = C.spawn(W.KV_REPLICAS, tmp_path_factory.mktemp("kvr"), inputs)
    ref = {j: C.ref_shard_function(_ref_cfg(), j, w["np"])
           for j, w in weights.items()}
    ref["step1"] = C.ref_shard_function(_ref_cfg(), "rag",
                                        weights["rag"]["np"], steps=1)
    return {"ranks": C.collect(handle), "ref": ref}


def _all(runs, name):
    return [C.result(runs["ranks"], name, r) for r in range(4)]


@pytest.mark.parametrize("jobs", W.KVR_JOBS)
def test_shared_kv_heads_train_as_the_reference(runs, jobs):
    """Two steps at data 1 x model 4 against the reference; each rank
    holds its one kv head's columns of wk and wv; every rank's state is
    bit-equal."""
    got = [res[jobs] for res in _all(runs, "kvr_runtime")]
    hd = W.cfg_f32().head_dim
    for r, g in enumerate(got):
        C.compare(runs["ref"][jobs], g)
        assert g["model_axis"] == (4, r) and g["shards"] == 1
        for k, shape in g["shapes"].items():
            if k.endswith(("attn/wk", "attn/wv")):
                assert shape[-1] == hd, (k, shape)
    for part in ("adapters", "mu", "nu"):
        for g in got[1:]:
            assert all(np.array_equal(g[part][k], got[0][part][k])
                       for k in got[0][part]), (jobs, part)


def test_make_train_step_with_shared_kv_heads(runs):
    """``make_train_step(mesh=, tp_mode="auto")`` on the world: step 1's
    losses and adapters against the reference's first step."""
    want = runs["ref"]["step1"]
    for r, res in enumerate(_all(runs, "kvr_step")):
        assert res["model_axis"] == (4, r)
        assert res["wk_shape"][-1] == W.cfg_f32().head_dim
        C.losses_close(want["losses"][0], res["per_job"])
        C.state_close(want["adapters"], res["adapters"])


def test_one_replica_instead_of_the_sum_misses_the_bars(runs):
    """Each kv head's cotangent from its first replica alone: the k and
    v adapters' first moments leave the bars the sum holds."""
    want = runs["ref"]["rag"]
    for res in _all(runs, "kvr_planted"):
        missed = []
        for k in want["mu"]:
            if not k.split("/")[-2] in ("k", "v"):
                continue
            try:
                C.state_close({k: want["mu"][k]}, {k: res["mu"][k]})
            except AssertionError:
                missed.append(k)
        assert missed, "the planted replica cut held the k/v bars"


@pytest.mark.parametrize("heads, kv, m, ok", [
    (4, 2, 2, True), (4, 2, 4, True), (32, 4, 16, True), (64, 8, 16, True),
    (4, 2, 3, False), (4, 2, 8, False), (12, 4, 6, False), (15, 5, 16, False)])
def test_refusals_name_the_roadmap_line(heads, kv, m, ok):
    """The attention is split over a model axis that divides its query
    heads and divides or is a multiple of its kv heads; otherwise it runs
    whole on every rank (ROADMAP A4, no longer refused):
    ``whole_mixers`` names it, and a rank's caches of it are
    whole."""
    from repro_torch.models import model as M
    from repro_torch.models.layers import ModelAxis
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              num_heads=heads, num_kv_heads=kv)
    assert M.whole_mixers(cfg, m) == (() if ok else ("attn",))
    kv_loc = M.init_caches(cfg, 2, 8, device="meta",
                           tp=ModelAxis(None, m, m - 1))[0]["0"].k.shape[-2]
    assert (kv_loc == kv) == (not ok)
