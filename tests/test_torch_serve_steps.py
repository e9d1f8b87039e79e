"""The port's serve steps (``SharedSuperModel.make_prefill_step`` /
``make_serve_step``, ``decode_buf``, ``init_decode_caches``) and
``train/serve.py`` held against the JAX reference on the CPU, on reduced
tinyllama-1.1b in float32.

Weights come from the reference's ``SharedSuperModel.init`` (B drawn from
a seeded numpy RNG, so that every adapter changes the output), exported
with ``np.asarray`` and carried across with ``models/convert.py``.  The
steps' group mixes ranks {8, 16, 4}, which pad to 8/16/8 at block_t 8:
with 8 rows a job, a prompt of 7 tokens and a decode token are whole
token tiles of every segment, so the "cuda" impl takes the ragged
kernels' plain versions, with their static tile map.  Tolerances:
  * prefill-then-decode against the teacher-forced forward: 2e-3, the
    reference's own (tests/test_integration.py); the two sides run the
    same products over other key counts;
  * the port against the reference's serve steps: 1e-4 absolute on O(1)
    f32 logits, as tests/test_torch_serve.py (same math, other summation
    orders);
  * token ids: exact (greedy argmax over f32 logits).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.configs.base import InputShape as RefShape
from repro.core.jobs import LoRAJobSpec as RefSpec
from repro.core.ssm import SharedSuperModel as RefSSM
from repro.train import serve as ref_serve

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core.jobs import LoRAJobSpec
from repro_torch.core.ssm import SharedSuperModel
from repro_torch.kernels import ops
from repro_torch.models import model as M
from repro_torch.models.attention import DECODE_CHUNK
from repro_torch.models.convert import adapters_from_numpy, params_from_numpy
from repro_torch.train import serve

BT = 8
RANKS = (8, 16, 4)              # pads 8/16/8: a mixed layout
ROWS = 8                        # rows a job: 8 decode tokens, one tile
PROMPT = 7
SHAPE = dict(name="p", seq_len=16, global_batch=ROWS * len(RANKS),
             kind="decode")


def _cfgs():
    ref = dataclasses.replace(ref_get_config("tinyllama-1.1b").reduced(),
                              dtype="float32")
    port = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                               dtype="float32")
    return ref, port


def _jobs(cls, ranks, batch_size):
    return [cls(f"job-{i}", rank=r, batch_size=batch_size, seq_len=BT)
            for i, r in enumerate(ranks)]


def _weights(ref_cfg, ranks, batch_size, seed=3):
    """Reference SSM params + packed adapters (numpy trees), B nonzero."""
    ssm = RefSSM(ref_cfg, _jobs(RefSpec, ranks, batch_size), impl="ref",
                 block_t=BT)
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


@pytest.fixture(scope="module")
def setup():
    ref_cfg, cfg = _cfgs()
    ref_ssm, params, adapters = _weights(ref_cfg, RANKS, ROWS)
    rng = np.random.default_rng(4)
    toks = rng.integers(1, cfg.vocab_size, (ROWS * len(RANKS), PROMPT + 1)
                        ).astype(np.int32)
    ids = np.repeat(np.arange(len(RANKS), dtype=np.int32), ROWS)
    return ref_cfg, cfg, ref_ssm, params, adapters, toks, ids


def _port_steps(cfg, impl, params, adapters, toks, ids):
    """Prefill PROMPT tokens, decode the next: (prefill logits, decode
    logits, teacher-forced logits), each (B, V) at its position."""
    ssm = SharedSuperModel(cfg, _jobs(LoRAJobSpec, RANKS, ROWS), impl=impl,
                           block_t=BT)
    p, a = params_from_numpy(params, "cpu"), adapters_from_numpy(adapters,
                                                                 "cpu")
    t, i = torch.from_numpy(toks), torch.from_numpy(ids)
    prefill = ssm.make_prefill_step(InputShape(**SHAPE))
    lp, caches = prefill(p, a, {"tokens": t[:, :PROMPT], "adapter_ids": i})
    step = ssm.make_serve_step()
    ld, caches2 = step(p, a, caches, {"tokens": t[:, PROMPT:],
                                      "adapter_ids": i}, PROMPT)
    assert caches2 is caches             # written in place, same list
    with torch.no_grad():
        tf = M.forward(cfg, p, a, ssm.lora_ctx(i), {"tokens": t})[0]
    return lp[:, 0], ld[:, 0], tf, ssm


@pytest.mark.parametrize("impl", ["cuda", "ref", "torch"])
def test_prefill_then_decode_equals_teacher_forcing(setup, impl,
                                                    monkeypatch):
    """For "cuda", every LoRA delta of the three passes goes through the
    ragged family (B1's plain version here), none through the masked
    fallback of a batch without a static tile map."""
    _, cfg, _, params, adapters, toks, ids = setup
    calls = {"ragged": 0, "masked": 0}
    for name, cls in (("ragged", ops._RaggedLoRA),
                      ("masked", ops._MaskedLoRA)):
        def counting(*a, _name=name, _apply=cls.apply):
            calls[_name] += 1
            return _apply(*a)
        monkeypatch.setattr(cls, "apply", counting)
    lp, ld, tf, ssm = _port_steps(cfg, impl, params, adapters, toks, ids)
    assert lp.shape == (len(ids), cfg.vocab_size)
    np.testing.assert_allclose(lp.numpy(), tf[:, PROMPT - 1].numpy(),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(ld.numpy(), tf[:, PROMPT].numpy(),
                               rtol=2e-3, atol=2e-3)
    if impl == "cuda":
        assert not ssm.layout.is_uniform
        # 4 projections x 2 layers x (prefill, decode, teacher forcing)
        assert calls == {"ragged": 24, "masked": 0}


def test_serve_steps_equal_the_reference(setup):
    """The port's "cuda" (the ragged kernels' plain versions) against the
    reference's steps ("ref") on the same weights and tokens."""
    ref_cfg, cfg, ref_ssm, params, adapters, toks, ids = setup
    lp, ld, _, _ = _port_steps(cfg, "cuda", params, adapters, toks, ids)
    jp = jax.tree.map(jnp.asarray, params)
    ja = jax.tree.map(jnp.asarray, adapters)
    jt, ji = jnp.asarray(toks), jnp.asarray(ids)
    want_p, caches = ref_ssm.make_prefill_step(RefShape(**SHAPE))(
        jp, ja, {"tokens": jt[:, :PROMPT], "adapter_ids": ji})
    want_d, _ = ref_ssm.make_serve_step()(
        jp, ja, caches, {"tokens": jt[:, PROMPT:], "adapter_ids": ji},
        PROMPT)
    np.testing.assert_allclose(lp.numpy(), np.asarray(want_p[:, 0]),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(ld.numpy(), np.asarray(want_d[:, 0]),
                               rtol=0, atol=1e-4)


def test_prefill_without_cache(setup):
    _, cfg, ref_ssm, params, adapters, toks, ids = setup
    ssm = SharedSuperModel(cfg, _jobs(LoRAJobSpec, RANKS, ROWS), impl="cuda",
                           block_t=BT)
    p, a = params_from_numpy(params, "cpu"), adapters_from_numpy(adapters,
                                                                 "cpu")
    batch = {"tokens": torch.from_numpy(toks),
             "adapter_ids": torch.from_numpy(ids)}
    lp, caches = ssm.make_prefill_step(InputShape(**SHAPE),
                                       with_cache=False)(p, a, batch)
    assert caches is None and lp.shape == (len(ids), 1, cfg.vocab_size)
    want, _ = ref_ssm.make_prefill_step(RefShape(**SHAPE), with_cache=False)(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, adapters),
        {"tokens": jnp.asarray(toks), "adapter_ids": jnp.asarray(ids)})
    np.testing.assert_allclose(lp.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("variant", [False, True])
def test_decode_buf_and_cache_width(variant):
    ref_cfg, cfg = _cfgs()
    kw = dict(SHAPE, seq_len=100, sliding_window_variant=variant)
    ssm = SharedSuperModel(cfg, _jobs(LoRAJobSpec, RANKS, ROWS), block_t=BT)
    want = RefSSM(ref_cfg, _jobs(RefSpec, RANKS, ROWS),
                  block_t=BT).decode_buf(RefShape(**kw))
    assert ssm.decode_buf(InputShape(**kw)) == want
    if variant:      # rings: exactly min(seq_len, window) slots
        caches = ssm.init_decode_caches(InputShape(**kw), batch=2,
                                        device="cpu")
        assert caches[0]["0"].k.shape[:3] == (cfg.num_layers, 2, want)
        return
    caches = ssm.init_decode_caches(InputShape(**kw), batch=2, device="cpu")
    width = caches[0]["0"].k.shape[2]
    assert width == DECODE_CHUNK and width > want
    assert caches[0]["0"].k.shape[:2] == (cfg.num_layers, 2)
    assert ssm.init_decode_caches(InputShape(**kw), device="cpu"
                                  )[0]["0"].k.shape[1] == kw["global_batch"]


def test_ring_caches_are_refused():
    """Ring caches are served now (tests/test_torch_serve_recurrent.py);
    what a ring still refuses is a per-row position, as the reference's
    ring decode asserts: a ring slot is shared by the batch's rows."""
    _, cfg = _cfgs()
    ssm = SharedSuperModel(cfg, _jobs(LoRAJobSpec, RANKS, ROWS), block_t=BT)
    ring = InputShape(**dict(SHAPE, sliding_window_variant=True))
    caches = ssm.init_decode_caches(ring, device="cpu")
    assert caches[0]["0"].k.shape[2] == min(ring.seq_len,
                                            cfg.sliding_window)
    p, a = ssm.init(seed=0, device="cpu")
    B = SHAPE["global_batch"]
    batch = {"tokens": torch.ones((B, 1), dtype=torch.int32),
             "adapter_ids": torch.arange(B, dtype=torch.int32) // ROWS}
    with pytest.raises(ValueError, match="per-row"):
        ssm.make_serve_step(ring=True)(p, a, caches, batch,
                                       torch.zeros(B, dtype=torch.int32))


# ------------------------------------------------------- train/serve.py
def test_pad_requests_equals_reference():
    rng = np.random.default_rng(0)
    lens = (5, 11, 1, 16, 9)
    for pad_to in (1, 8, 16):
        prompts = [rng.integers(1, 100, n).astype(np.int32) for n in lens]
        got = serve.pad_requests([serve.Request(p, i % 2)
                                  for i, p in enumerate(prompts)], pad_to)
        want = ref_serve.pad_requests([ref_serve.Request(p, i % 2)
                                       for i, p in enumerate(prompts)],
                                      pad_to)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype


@pytest.fixture(scope="module")
def served():
    """Ranks {16, 8, 4, 2} pad to 16/8/8/8 at block_t 8 (a mixed layout);
    prompts of 3-14 tokens, budgets of 2-5 new tokens; the reference's
    ``serve_batch`` with impl="ref" run once."""
    ref_cfg, cfg = _cfgs()
    ranks = (16, 8, 4, 2)
    _, params, adapters = _weights(ref_cfg, ranks, 1, seed=5)
    rng = np.random.default_rng(6)
    reqs = [(rng.integers(1, cfg.vocab_size, int(rng.integers(3, 15))
                          ).astype(np.int32), i % 4, int(rng.integers(2, 6)))
            for i in range(7)]
    want = ref_serve.serve_batch(
        ref_cfg, _jobs(RefSpec, ranks, 1),
        [ref_serve.Request(*r) for r in reqs], impl="ref", block_t=BT,
        params=jax.tree.map(jnp.asarray, params),
        adapters=jax.tree.map(jnp.asarray, adapters))
    return cfg, ranks, params, adapters, reqs, want


@pytest.mark.parametrize("impl", ["ref", "cuda"])
def test_serve_batch_equals_reference(served, impl):
    cfg, ranks, params, adapters, reqs, want = served
    got = serve.serve_batch(
        cfg, _jobs(LoRAJobSpec, ranks, 1), [serve.Request(*r) for r in reqs],
        impl=impl, block_t=BT, params=params_from_numpy(params, "cpu"),
        adapters=adapters_from_numpy(adapters, "cpu"), device="cpu")
    assert [len(g) for g in got] == [r[2] for r in reqs]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
