"""The serve steps of the recurrent families and of the ring caches held
against the JAX reference on the CPU, float32: reduced mamba2-2.7b and
recurrentgemma-9b through ``make_prefill_step`` (a cache) and
``make_serve_step``, against the teacher-forced forward and the
reference's serve steps; ROADMAP C6, the reference's non-causal prefill
through a ring, at 6 layers and at 3; tinyllama-1.1b's sliding-window
variant (``ring=True``) decoding past its window against the reference;
and the serving engine's refusal of the recurrent configs.

Weights come from the reference's ``SharedSuperModel.init`` (B drawn
from a seeded numpy RNG) through ``models/convert.py``.  The group mixes
ranks {8, 16, 4} (pads 8/16/8 at block_t 8), 8 rows a job, so a prompt
of 16 tokens and a decode token are whole token tiles of every segment
and "cuda" takes the ragged kernels' plain versions.  Tolerances:
  * logits: 2e-4 absolute on O(1) logits (the chunked and the recurrent
    forms of the scans, and the two frameworks, sum the same terms in
    other orders);
  * C6: the reference's cache path differs from its cacheless forward
    by more than 0.1 at 6 layers (asserted, so that a repair upstream
    shows here).
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
from repro.models import model as RM

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core.jobs import LoRAJobSpec
from repro_torch.core.ssm import SharedSuperModel
from repro_torch.launch import train as launcher
from repro_torch.models import model as M
from repro_torch.models.convert import adapters_from_numpy, params_from_numpy
from repro_torch.serve import AdapterPool, ServeEngine

from torch_train_common import one_torch_thread  # noqa: F401

BT, RANKS, ROWS = 8, (8, 16, 4), 8
PROMPT, DECODE = 16, 4
ATOL = 2e-4


def _cfgs(arch, layers=None):
    ref, port = ref_get_config(arch).reduced(), get_config(arch).reduced()
    kw = dict(dtype="float32")
    if layers:
        kw["num_layers"] = layers
    return dataclasses.replace(ref, **kw), dataclasses.replace(port, **kw)


def _jobs(cls):
    return [cls(f"job-{i}", rank=r, batch_size=ROWS, seq_len=BT)
            for i, r in enumerate(RANKS)]


def _weights(ref_cfg, seed=3):
    ssm = RefSSM(ref_cfg, _jobs(RefSpec), impl="ref", block_t=BT)
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


def _inputs(vocab, S, seed=4):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, vocab, (ROWS * len(RANKS), S)).astype(np.int32)
    return toks, np.repeat(np.arange(len(RANKS), dtype=np.int32), ROWS)


def _shape(cls, seq_len):
    return cls("p", seq_len, ROWS * len(RANKS), "decode")


def _port_steps(cfg, impl, params, adapters, toks, ids, prompt, n_decode):
    """(prefill last logits, [decode logits], teacher-forced logits)."""
    ssm = SharedSuperModel(cfg, _jobs(LoRAJobSpec), impl=impl, block_t=BT)
    p, a = params_from_numpy(params, "cpu"), adapters_from_numpy(adapters,
                                                                 "cpu")
    t, i = torch.from_numpy(toks), torch.from_numpy(ids)
    prefill = ssm.make_prefill_step(_shape(InputShape, 32))
    lp, caches = prefill(p, a, {"tokens": t[:, :prompt], "adapter_ids": i})
    step = ssm.make_serve_step()
    lds = []
    for pos in range(prompt, prompt + n_decode):
        ld, c2 = step(p, a, caches, {"tokens": t[:, pos:pos + 1],
                                     "adapter_ids": i}, pos)
        assert c2 is caches
        lds.append(ld[:, 0].numpy())
    with torch.no_grad():
        tf = M.forward(cfg, p, a, ssm.lora_ctx(i),
                       {"tokens": t[:, :prompt + n_decode]}).numpy()
    return lp[:, 0].numpy(), lds, tf


def _ref_steps(ref_cfg, ref_ssm, params, adapters, toks, ids, prompt,
               n_decode, with_cache=True):
    jp, ja = (jax.tree.map(jnp.asarray, t) for t in (params, adapters))
    prefill = jax.jit(ref_ssm.make_prefill_step(_shape(RefShape, 32),
                                                with_cache=with_cache))
    lp, caches = prefill(jp, ja, {"tokens": jnp.asarray(toks[:, :prompt]),
                                  "adapter_ids": jnp.asarray(ids)})
    step = jax.jit(ref_ssm.make_serve_step())
    lds = []
    for pos in range(prompt, prompt + n_decode if with_cache else prompt):
        ld, caches = step(jp, ja, caches,
                          {"tokens": jnp.asarray(toks[:, pos:pos + 1]),
                           "adapter_ids": jnp.asarray(ids)}, pos)
        lds.append(np.asarray(ld[:, 0]))
    return np.asarray(lp[:, 0]), lds


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("impl", ["cuda", "ref"])
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "recurrentgemma-9b"])
def test_serve_steps_match_teacher_forcing_and_reference(arch, impl):
    """Prefill 16 tokens into the caches (SSD and RG-LRU state, the
    local layer's 32-slot ring), decode 4: each against the teacher-
    forced forward at its position and the reference's serve steps.  At
    3 layers recurrentgemma's local-attention layer is the last one, so
    the reference's non-causal ring prefill (C6) reaches no output that
    is read: the two agree."""
    rc, cfg = _cfgs(arch)
    ref_ssm, params, adapters = _weights(rc)
    toks, ids = _inputs(cfg.vocab_size, PROMPT + DECODE)
    lp, lds, tf = _port_steps(cfg, impl, params, adapters, toks, ids,
                              PROMPT, DECODE)
    _close(lp, tf[:, PROMPT - 1])
    for j, ld in enumerate(lds):
        _close(ld, tf[:, PROMPT + j])
    want_p, want_d = _ref_steps(rc, ref_ssm, params, adapters, toks, ids,
                                PROMPT, DECODE)
    _close(lp, want_p)
    for got, want in zip(lds, want_d):
        _close(got, want)


# ------------------------------------------------------------------ C6
def test_ring_prefill_is_causal_at_six_layers_c6():
    """recurrentgemma reduced to two whole cycles (6 layers: the first
    local-attention layer is not the last layer), a 24-token prompt: the
    port's prefill through the rings gives the reference's cacheless
    forward; the reference's own cache path differs from it by more than
    0.1; the port's decode continues its teacher-forced forward."""
    rc, cfg = _cfgs("recurrentgemma-9b", layers=6)
    ref_ssm, params, adapters = _weights(rc)
    S = 24
    toks, ids = _inputs(cfg.vocab_size, S + 2)
    ring, _ = _ref_steps(rc, ref_ssm, params, adapters, toks, ids, S, 0)
    cacheless, _ = _ref_steps(rc, ref_ssm, params, adapters, toks, ids, S,
                              0, with_cache=False)
    assert np.abs(ring - cacheless).max() > 0.1
    lp, lds, tf = _port_steps(cfg, "cuda", params, adapters, toks, ids, S,
                              2)
    _close(lp, cacheless)
    for j, ld in enumerate(lds):
        _close(ld, tf[:, S + j])


# ---------------------------------------------------- sliding variant
def test_sliding_window_variant_decodes_like_reference():
    """tinyllama-1.1b reduced (window 64) with every attention cache a
    ring: the SSM's steps (prefill 7 tokens, decode 1) against teacher
    forcing inside the window; ``init_decode_caches`` of a
    sliding-window-variant shape gives rings of min(seq_len, 64) slots;
    then 80 single-token decode steps from position 0, past the window,
    against the reference's ``decode_step(ring=True)``, jitted."""
    rc, cfg = _cfgs("tinyllama-1.1b")
    ref_ssm, params, adapters = _weights(rc)
    toks, ids = _inputs(cfg.vocab_size, 80)
    ssm = SharedSuperModel(cfg, _jobs(LoRAJobSpec), impl="cuda", block_t=BT)
    p, a = params_from_numpy(params, "cpu"), adapters_from_numpy(adapters,
                                                                 "cpu")
    t, i = torch.from_numpy(toks), torch.from_numpy(ids)
    shape = InputShape("w", 100, len(ids), "decode",
                       sliding_window_variant=True)
    assert ssm.decode_buf(shape) == ref_ssm.decode_buf(
        RefShape("w", 100, len(ids), "decode", sliding_window_variant=True))
    assert ssm.init_decode_caches(shape, device="cpu")[0]["0"].k.shape[2] \
        == 64
    lp, caches = ssm.make_prefill_step(shape, ring=True)(
        p, a, {"tokens": t[:, :7], "adapter_ids": i})
    assert caches[0]["0"].k.shape[2] == 64
    ld, _ = ssm.make_serve_step(ring=True)(
        p, a, caches, {"tokens": t[:, 7:8], "adapter_ids": i}, 7)
    with torch.no_grad():
        tf = M.forward(cfg, p, a, ssm.lora_ctx(i), {"tokens": t[:, :8]})
    _close(lp[:, 0], tf[:, 6])
    _close(ld[:, 0], tf[:, 7])

    jp = jax.tree.map(jnp.asarray, params)
    step = jax.jit(lambda tk, pos, c: RM.decode_step(rc, jp, None, None, tk,
                                                     pos, c, ring=True))
    rcaches = RM.init_caches(rc, len(ids), 128, ring=True)
    caches = M.init_caches(cfg, len(ids), 128, True, device="cpu")
    want, got = [], []
    with torch.no_grad():
        for pos in range(80):
            lg, rcaches = step(jnp.asarray(toks[:, pos:pos + 1]),
                               jnp.int32(pos), rcaches)
            want.append(np.asarray(lg[:, 0]))
            got.append(M.decode_step(cfg, p, None, None, t[:, pos:pos + 1],
                                     pos, caches, ring=True)[0][:, 0])
    _close(torch.stack(got).numpy(), np.stack(want))


# --------------------------------------------------------------- engine
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "recurrentgemma-9b"])
def test_engine_and_launcher_refuse_recurrent_configs(arch):
    """Right-padded prefill would fold pad tokens into recurrent state:
    the engine refuses these configs up front (the reference's
    test_serve.py), with the port's own weights, and so does the
    launcher's ``serve``."""
    cfg = get_config(arch).reduced()
    ssm = SharedSuperModel(cfg, _jobs(LoRAJobSpec), impl="ref", block_t=BT)
    params, _ = ssm.init(seed=0, device="cpu")
    pool = AdapterPool(cfg, multiple=ssm.layout.multiple, device="cpu")
    with pytest.raises(ValueError, match="recurrent|ring"):
        ServeEngine(cfg, params, pool, impl="ref", block_t=BT)
    with pytest.raises(ValueError, match="recurrent|ring"):
        launcher.main(["serve", "--arch", arch, "--reduced", "--device",
                       "cpu", "--impl", "ref", "--block-t", "8"])
