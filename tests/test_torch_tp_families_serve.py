"""Serving over a model axis for the decoder families (ROADMAP A8c) on the
CPU: four gloo ranks (one spawn for the file, tests/torch_sharded_
worker.py, scenario ``tpf_serve``) run the serve steps
(``make_prefill_step(mesh=)``, ``make_serve_step(mesh=)``) of reduced
f32 deepseek-v2-lite-16b (MLA: the absorbed decode on a rank's heads,
the latent cache whole), mamba2-2.7b (SSD: a rank's heads' state, its
channels' conv tail), recurrentgemma-9b (RG-LRU's channels; local
attention's ring caches on the rank's kv heads) and internvl2-26b
(text: its reduced vocab split over the axis), at data 1 x model 2 on
each pair of the world and, for mamba2 and recurrentgemma, at data 1 x
model 4.  A job set of ranks 4 and 16 (the ragged kernels' plain
versions), 16 rows a job: prefill 8 tokens, then 8 greedy decode steps,
impl "cuda", block_t 8.

Each run, and the port's meshless serve, is held against the
reference's single-device ``make_prefill_step`` / ``make_serve_step``
fed the same weights as numpy (B drawn nonzero; made while the ranks
work): every step's logits within 1e-4 (O(1) f32 logits summed in other
orders) and the greedy ids exactly.  recurrentgemma's prefill runs its
local attention through a ring, which the reference attends
non-causally (ROADMAP C6); its reduced cycle puts that layer last, so
only positions the prefill never returns differ, and the reference's
served logits stand.  Each run is also held against the port's
meshless serve at the same bar; each rank's caches have the local
shapes of
``sharding/rules.runtime_cache_specs``; fused vs solo (each job served
alone, its adapter re-packed, every product and every sum over the
model axis 16 rows at a time) ids and logits bit for bit under each
mesh (ROADMAP C1).
"""
import numpy as np
import pytest

from repro_torch.configs.base import InputShape
from repro_torch.core.ssm import SharedSuperModel
from repro_torch.models import model as M
from repro_torch.models.convert import adapters_from_numpy, params_from_numpy
from repro_torch.models.layers import ModelAxis
from repro_torch.sharding import rules

import torch_sharded_common as C
import torch_sharded_worker as W
from test_torch_tp_families import _ref_cfg
from test_torch_tp_serve import _weights, ref_serve
from torch_train_common import one_torch_thread  # noqa: F401

LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results, with the reference's served logits made while
    the ranks work."""
    inputs, weights = {}, {}
    for key in W.TPF_DECODERS:
        weights[key] = _weights(_ref_cfg(key))
        _, p, a = weights[key]
        inputs[f"tpfs:{key}"] = {"params": params_from_numpy(p, "cpu"),
                                 "adapters": adapters_from_numpy(a, "cpu")}
    toks = np.random.default_rng(4).integers(
        1, 500, (W.TPS_ROWS * len(W.TPS_RANKS), W.TPS_PROMPT)
    ).astype(np.int32)
    inputs["tpfs:toks"] = toks
    handle = C.spawn(W.TP_FAMILIES_SERVE, tmp_path_factory.mktemp("tpfs"),
                     inputs)
    ref = {k: ref_serve(*w, toks)[0] for k, w in weights.items()}
    return {"ranks": C.collect(handle), "ref": ref}


def _all(runs):
    return [C.result(runs["ranks"], "tpf_serve", r) for r in range(4)]


CASES = [(k, "m2") for k in W.TPF_DECODERS] + [(k, "m4") for k in W.TPF_M4]


def _cache_shapes(key, m, index) -> dict:
    """{leaf path: shape} of model rank *index*'s caches under the
    runtime cache specs (m 1: the whole caches)."""
    cfg = W.tpf_cfg(key)
    ssm = SharedSuperModel(cfg, W.tps_specs(), block_t=W.BT)
    shape = W.tps_shape(InputShape)
    whole = M.init_caches(cfg, sum(ssm.rows_per_job()), shape.seq_len,
                          device="meta")
    sizes = {"data": 1, "model": m}
    specs = rules.runtime_cache_specs(sizes, whole, cfg)
    out = {}
    for i, (seg_w, seg_s) in enumerate(zip(whole, specs)):
        for j, k in enumerate(seg_w):
            for n, (t, s) in enumerate(zip(seg_w[k], seg_s[k])):
                out[f"{i}/{j}/{n}"] = rules.local_shape(tuple(t.shape), s,
                                                        sizes)
    assert out == {k: tuple(v.shape) for k, v in W.flat_t(
        [list(c.values()) for c in M.init_caches(
            cfg, sum(ssm.rows_per_job()), shape.seq_len, device="meta",
            tp=ModelAxis(None, m, index) if m > 1 else None)]).items()}
    return out


@pytest.mark.parametrize("key,mesh", [(k, "meshless")
                                      for k in W.TPF_DECODERS] + CASES)
def test_family_serving_matches_the_reference(runs, key, mesh):
    """Prefill and 8 greedy decode steps, meshless and on every rank of
    each mesh, against the reference's single-device serve on the rank's
    rows: logits within 1e-4, ids exactly."""
    want = runs["ref"][key]
    for res in _all(runs):
        got = res[key][mesh]
        np.testing.assert_allclose(got["logits"], want[got["rows"]],
                                   rtol=0, atol=LOGIT_ATOL)
        np.testing.assert_array_equal(got["ids"],
                                      want[got["rows"]].argmax(-1))


@pytest.mark.parametrize("key,mesh", CASES)
def test_family_serving_over_a_model_axis(runs, key, mesh):
    """Prefill and 8 greedy decode steps on every rank against the
    port's meshless serve: logits within 1e-4, ids exactly, each rank's
    caches of its runtime specs' shapes (smaller than whole where the
    mixer keeps a rank's heads or channels)."""
    m = 2 if mesh == "m2" else 4
    for r, res in enumerate(_all(runs)):
        ml, got = res[key]["meshless"], res[key][mesh]
        np.testing.assert_allclose(got["logits"], ml["logits"], rtol=0,
                                   atol=LOGIT_ATOL)
        np.testing.assert_array_equal(got["ids"], ml["ids"])
        assert got["caches"] == _cache_shapes(key, m, r % m)
        assert ml["caches"] == _cache_shapes(key, 1, 0)
        if key in ("mb", "rg"):
            assert got["caches"] != ml["caches"]


@pytest.mark.parametrize("key,mesh", CASES)
def test_family_fused_matches_solo_over_a_model_axis(runs, key, mesh):
    """C1's contract under the mesh: each job's greedy ids and logits
    served inside the fused batch equal those served alone, exactly."""
    for res in _all(runs):
        for part in ("logits", "ids"):
            fused, solo = res[key][f"{mesh}_fused_solo"][part]
            np.testing.assert_array_equal(fused, solo, err_msg=part)
