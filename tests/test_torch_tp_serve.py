"""Serving under tensor parallelism (ROADMAP A8a) on the CPU: four gloo
ranks (one spawn for the file, tests/torch_sharded_worker.py, scenarios
``tps_*``) run the serve steps (``make_prefill_step(mesh=)``,
``make_serve_step(mesh=)``) of reduced f32 tinyllama-1.1b (H 4, KV 2,
block_t 8) over three ("data", "model") meshes: data 1 x model 2 on each
pair of the world (the kv heads split), data 1 x model 4 over the world
(each kv head shared by 2 ranks) and data 2 x model 2 (the batch's rows
split in order over "data" as well). A job set of ranks 4 and 16 (the
ragged kernels' plain versions), 16 rows a job: prefill 8 tokens, then 8
greedy decode steps.

Each run is held against the reference's single-device
``make_prefill_step`` / ``make_serve_step`` fed the same weights as
numpy (B drawn nonzero): every step's logits within 1e-4 (O(1) f32
logits, other summation orders), the greedy ids exactly, and every
rank's caches equal to its block of rows and kv heads (or its shared
head) of the port's meshless caches within 1e-5, and of the reference's
within 1e-4 (the port's meshless caches themselves sit up to 1.7e-5 from
the reference's, on values up to 13.4: the float noise of the layers
below, as in the logits). A ring case (every attention cache a ring) is
held against the port's own meshless ring serve (the reference prefills
through a ring non-causally, ROADMAP C6); fused vs solo ids exactly
under model 2 and model 4, ids and logits bit for bit (each job served
alone, its adapter re-packed, every product and every sum over the model
axis 16 rows at a time); reduced qwen3-moe-30b-a3b (E 4, expert
parallel over model 2) against the reference.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.configs.base import InputShape as RefShape
from repro.core.jobs import LoRAJobSpec as RefSpec
from repro.core.ssm import SharedSuperModel as RefSSM

from repro_torch.models.convert import adapters_from_numpy, params_from_numpy

import torch_sharded_common as C
import torch_sharded_worker as W
from torch_train_common import one_torch_thread  # noqa: F401

LOGIT_ATOL = 1e-4
CACHE_ATOL = 1e-5              # against the port's meshless caches
REF_CACHE_ATOL = 1e-4          # against the reference's


def _ref_cfg(key):
    if key == "tl":
        return dataclasses.replace(ref_get_config("tinyllama-1.1b")
                                   .reduced(), dtype="float32")
    return W.moe_cfg("qr", ref_get_config)


def _weights(rcfg, seed=3):
    """The reference's (params, adapters) of the serve job set, every B
    drawn nonzero from a seeded numpy stream, as numpy trees."""
    ssm = RefSSM(rcfg, W.tps_specs(RefSpec), impl="ref", block_t=W.BT)
    params, adapters = jax.tree.map(np.asarray,
                                    ssm.init(jax.random.PRNGKey(seed)))
    act = np.asarray(ssm.layout.active_cols)[:, None]
    rng = np.random.default_rng(seed)

    def fill_b(tree):
        for k, v in tree.items():
            if k == "B":
                tree[k] = (rng.standard_normal(v.shape) * 0.05 * act
                           ).astype(np.float32)
            elif isinstance(v, dict):
                fill_b(v)
    for seg in adapters["segments"]:
        fill_b(seg)
    return ssm, params, adapters


def _ref_greedy(ssm, params, adapters, toks):
    """The reference's prefill and TPS_DECODE greedy steps: logits (B,
    1 + TPS_DECODE, V), ids, and its KV caches after the last step."""
    lg, caches = ref_serve(ssm, params, adapters, toks)
    kv = caches[0]["0"]
    return {"logits": lg, "ids": lg.argmax(-1), "k": np.asarray(kv.k),
            "v": np.asarray(kv.v)}


def ref_serve(ssm, params, adapters, toks):
    """The reference's single-device prefill of *toks* and TPS_DECODE
    greedy steps: (logits (B, 1 + TPS_DECODE, V), its caches after the
    last step)."""
    jp = jax.tree.map(jnp.asarray, params)
    ja = jax.tree.map(jnp.asarray, adapters)
    ids = jnp.asarray(np.repeat(np.arange(len(W.TPS_RANKS), dtype=np.int32),
                                W.TPS_ROWS))
    lp, caches = jax.jit(ssm.make_prefill_step(W.tps_shape(RefShape)))(
        jp, ja, {"tokens": jnp.asarray(toks[:, :W.TPS_PROMPT]),
                 "adapter_ids": ids})
    step = jax.jit(ssm.make_serve_step())       # one compile: pos traced
    logits = [np.asarray(lp[:, 0])]
    for pos in range(W.TPS_PROMPT, W.TPS_PROMPT + W.TPS_DECODE):
        tok = jnp.asarray(logits[-1].argmax(-1).astype(np.int32))
        lg, caches = step(jp, ja, caches, {"tokens": tok[:, None],
                                           "adapter_ids": ids},
                          jnp.int32(pos))
        logits.append(np.asarray(lg[:, 0]))
    return np.stack(logits, axis=1), caches


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results, with the reference's runs made while the
    ranks work."""
    toks = np.random.default_rng(4).integers(
        1, 512, (W.TPS_ROWS * len(W.TPS_RANKS), W.TPS_PROMPT)
    ).astype(np.int32)
    weights = {k: _weights(_ref_cfg(k)) for k in ("tl", "qr")}
    inputs = {f"tps:{k}": {"params": params_from_numpy(p, "cpu"),
                           "adapters": adapters_from_numpy(a, "cpu")}
              for k, (_, p, a) in weights.items()}
    inputs["tps:toks"] = toks
    handle = C.spawn(W.TP_SERVE, tmp_path_factory.mktemp("tps"), inputs)
    ref = {k: _ref_greedy(s, p, a, toks) for k, (s, p, a) in weights.items()}
    return {"ranks": C.collect(handle), "ref": ref}


def _all(runs, name):
    return [C.result(runs["ranks"], name, r) for r in range(4)]


def _held(want, got, meshless=None):
    """One rank's serve run against the reference's on the rank's rows:
    logits, ids and its kv heads of the caches (and of the port's
    meshless caches, where given)."""
    rows = got["rows"]
    np.testing.assert_allclose(got["logits"], want["logits"][rows],
                               rtol=0, atol=LOGIT_ATOL)
    np.testing.assert_array_equal(got["ids"], want["ids"][rows])
    h, n = got["kv_head"], got["kv_local"]
    seq = want["k"].shape[2]
    for part in ("k", "v"):
        mine = got[part]
        # the port's caches round up to whole decode chunks: the keys
        # past the reference's width were never written
        assert not mine[:, :, seq:].any()
        np.testing.assert_allclose(
            mine[:, :, :seq], want[part][:, rows, :, h:h + n], rtol=0,
            atol=REF_CACHE_ATOL)
        if meshless is not None:
            np.testing.assert_allclose(
                mine, meshless[part][:, rows, :, h:h + n], rtol=0,
                atol=CACHE_ATOL)


@pytest.mark.parametrize("mesh", ["m2", "m4", "d2m2"])
def test_serving_over_a_model_axis_matches_the_reference(runs, mesh):
    """Prefill and 8 greedy decode steps on every rank against the
    reference; each rank holds its kv heads (KV/m split, or one head
    shared by m / KV ranks) and, at data 2, its half of the batch's
    rows (split in order, as the reference's batch shardings)."""
    want = runs["ref"]["tl"]
    res = _all(runs, "tps_meshes_run")
    got = [x[mesh] for x in res]
    m = {"m2": 2, "m4": 4, "d2m2": 2}[mesh]
    for r, g in enumerate(got):
        _held(want, g, res[r]["meshless"])
        assert g["model_axis"] == (m, r % m)
        assert g["kv_local"] == 1
        assert g["kv_head"] == (r % m) * 2 // m
        assert len(g["rows"]) == (W.TPS_ROWS if mesh == "d2m2"
                                  else 2 * W.TPS_ROWS)
    if mesh == "m4":          # the two replicas of a head hold equal caches
        for r in (0, 2):
            assert np.array_equal(got[r]["k"], got[r + 1]["k"])
    if mesh == "d2m2":        # the data ranks split the batch in order
        assert sorted(np.concatenate([got[0]["rows"], got[2]["rows"]])
                      .tolist()) == list(range(2 * W.TPS_ROWS))


def test_ring_caches_over_a_model_axis(runs):
    """Every attention cache a ring: model 2 and model 4 against this
    rank's meshless ring serve, logits within 1e-4 and ids exactly."""
    for res in _all(runs, "tps_ring"):
        ml = res["meshless"]
        for mesh in ("m2", "m4"):
            g = res[mesh]
            np.testing.assert_allclose(g["logits"], ml["logits"], rtol=0,
                                       atol=LOGIT_ATOL)
            np.testing.assert_array_equal(g["ids"], ml["ids"])
            assert g["k"].shape[2] == W.TPS_PROMPT + W.TPS_DECODE
            h, n = g["kv_head"], g["kv_local"]
            np.testing.assert_allclose(g["k"], ml["k"][..., h:h + n, :],
                                       rtol=0, atol=CACHE_ATOL)


def _fused_is_solo(runs, mesh):
    for res in _all(runs, "tps_fused_solo"):
        for part in ("logits", "ids"):
            fused, solo = res[mesh][part]
            np.testing.assert_array_equal(fused, solo)


def test_fused_matches_solo_under_a_model_axis(runs):
    """C1's contract under data 1 x model 2: each job's greedy ids and
    logits served inside the fused batch equal those served alone,
    exactly."""
    _fused_is_solo(runs, "m2")


def test_fused_matches_solo_with_shared_kv_heads(runs):
    """C1's contract under data 1 x model 4 (each kv head on 2 ranks):
    fused equals solo bit for bit only because the sums over the model
    axis run in row blocks too (``ModelAxis.sum``): with four addends an
    all-reduce's order follows the buffer's size, and the logits of one
    whole-batch all-reduce sit up to 3.2e-6 from the solo batch's."""
    _fused_is_solo(runs, "m4")


def test_moe_serving_over_a_model_axis(runs):
    """Reduced qwen3-moe-30b-a3b, its 4 experts 2 a rank, against the
    reference's serve steps."""
    for res in _all(runs, "tps_moe"):
        _held(runs["ref"]["qr"], res)
