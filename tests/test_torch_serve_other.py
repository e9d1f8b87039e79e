"""The serve steps of the other decoder families, and the serving
engine on the MoE decoders, held against the JAX reference on the CPU:
reduced deepseek-v2-lite-16b (MLA: latent caches, the absorbed decode,
the MLA ring), reduced qwen3-moe-30b-a3b (GQA caches, MoE FFNs) and
reduced internvl2-26b (GQA, token prompts: the front ends are not
served), float32; the encoder hubert-xlarge is refused.

Weights come from the reference's ``SharedSuperModel.init`` (B drawn
from a seeded numpy RNG) through ``models/convert.py``.  The steps'
group mixes ranks {8, 16, 4} (pads 8/16/8 at block_t 8) with 8 rows a
job, so a 7-token prompt and each decode token are whole token tiles
and the "cuda" impl takes the ragged kernels' plain versions.
Tolerances (those of tests/test_torch_serve_steps.py):
  * the port against the reference's serve steps: 1e-4 absolute on O(1)
    f32 logits (same math, other summation orders);
  * against the port's own teacher-forced forward: 2e-3 (the
    reference's tests/test_integration.py bound);
  * engine token ids: exact (greedy argmax over f32 logits).
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
from repro.models import model as RM  # noqa: F401  (import order)
from repro.serve import AdapterPool as RefPool
from repro.serve import ServeEngine as RefEngine
from repro.serve import ServeRequest as RefRequest

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core.jobs import LoRAJobSpec
from repro_torch.core.ssm import SharedSuperModel
from repro_torch.models import model as M
from repro_torch.models.convert import adapters_from_numpy, params_from_numpy
from repro_torch.serve import AdapterPool, ServeEngine, ServeRequest

from torch_train_common import fill_b, one_torch_thread  # noqa: F401

DECODERS = ("deepseek-v2-lite-16b", "qwen3-moe-30b-a3b", "internvl2-26b")
BT = 16


def _cfgs(arch):
    return (dataclasses.replace(ref_get_config(arch).reduced(),
                                dtype="float32"),
            dataclasses.replace(get_config(arch).reduced(), dtype="float32"))


S_RANKS, S_ROWS, PROMPT, N_DEC = (8, 16, 4), 8, 7, 2


def _serve_setup(arch):
    rc, pc = _cfgs(arch)
    jobs = [RefSpec(f"job-{i}", rank=r, batch_size=S_ROWS, seq_len=BT)
            for i, r in enumerate(S_RANKS)]
    rs = RefSSM(rc, jobs, impl="ref", block_t=8)
    params, adapters = jax.tree.map(np.asarray,
                                    jax.jit(rs.init)(jax.random.PRNGKey(3)))
    fill_b(adapters, np.asarray(rs.layout.active_cols)[:, None],
            np.random.default_rng(3))
    rng = np.random.default_rng(4)
    toks = rng.integers(1, pc.vocab_size, (S_ROWS * len(S_RANKS),
                                           PROMPT + N_DEC)).astype(np.int32)
    ids = np.repeat(np.arange(len(S_RANKS), dtype=np.int32), S_ROWS)
    return rc, pc, rs, params, adapters, toks, ids


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("arch", DECODERS)
def test_serve_steps_match_reference_and_teacher_forcing(arch, ring):
    """Prefill 7 tokens, decode 2, through full caches and (``ring``)
    every attention cache a ring of min(16, 64) = 16 slots: the port
    against the reference's serve steps (MLA's ring: the reference's
    ring prefill is the expand path; GQA rings in the reference attend a
    prompt with the one-token rule, ROADMAP C6, so they are held against
    teacher forcing only), and against the port's teacher-forced
    forward (the ring holds every key here)."""
    rc, pc, rs, params, adapters, toks, ids = _serve_setup(arch)
    shape = dict(name="p", seq_len=16, global_batch=len(ids), kind="decode")
    jobs = [LoRAJobSpec(f"job-{i}", rank=r, batch_size=S_ROWS, seq_len=BT)
            for i, r in enumerate(S_RANKS)]
    ssm = SharedSuperModel(pc, jobs, impl="cuda", block_t=8)
    p, a = params_from_numpy(params, "cpu"), adapters_from_numpy(adapters,
                                                                 "cpu")
    t, i = torch.from_numpy(toks), torch.from_numpy(ids)
    lp, caches = ssm.make_prefill_step(InputShape(**shape), ring=ring)(
        p, a, {"tokens": t[:, :PROMPT], "adapter_ids": i})
    step = ssm.make_serve_step(ring=ring)
    got = [lp[:, 0].numpy()]
    for n in range(N_DEC):
        ld, caches = step(p, a, caches, {"tokens": t[:, PROMPT + n:
                                                     PROMPT + n + 1],
                                         "adapter_ids": i}, PROMPT + n)
        got.append(ld[:, 0].numpy())
    with torch.no_grad():
        tf = M.forward(pc, p, a, ssm.lora_ctx(i), {"tokens": t})[0].numpy()
    for n, g in enumerate(got):
        np.testing.assert_allclose(g, tf[:, PROMPT - 1 + n], rtol=2e-3,
                                   atol=2e-3)
    if ring and not pc.use_mla:
        return
    pj, aj = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray,
                                                             adapters)
    tj, ij = jnp.asarray(toks), jnp.asarray(ids)
    wp, cj = jax.jit(rs.make_prefill_step(RefShape(**shape), ring=ring))(
        pj, aj, {"tokens": tj[:, :PROMPT], "adapter_ids": ij})
    want = [np.asarray(wp[:, 0])]
    rstep = jax.jit(rs.make_serve_step(ring=ring))
    for n in range(N_DEC):
        wd, cj = rstep(pj, aj, cj, {"tokens": tj[:, PROMPT + n:
                                                 PROMPT + n + 1],
                                    "adapter_ids": ij},
                   jnp.int32(PROMPT + n))
        want.append(np.asarray(wd[:, 0]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)


def test_serve_steps_refuse_the_encoder():
    """An encoder's prefill step builds and writes its caches (ROADMAP
    A9; tests/test_torch_encoder_prefill.py holds it against the
    reference); its decode step is refused."""
    _, pc = _cfgs("hubert-xlarge")
    ssm = SharedSuperModel(pc, [LoRAJobSpec("job-0", rank=8, batch_size=1,
                                            seq_len=BT)], impl="ref",
                           block_t=BT)
    assert callable(ssm.make_prefill_step(InputShape("p", 16, 4, "decode")))
    with pytest.raises(ValueError, match="encoder"):
        ssm.make_serve_step()


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "qwen3-moe-30b-a3b"])
def test_engine_serves_the_moe_decoders_as_the_reference(arch):
    """``ServeEngine`` on reduced MoE decoders (MLA's absorbed decode for
    deepseek), "ref" impl: the generated ids equal the reference
    engine's on the same weights and requests."""
    rc, pc, rs, params, adapters, _, _ = _serve_setup(arch)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, pc.vocab_size, int(n)).astype(np.int32)
               for n in (5, 9, 3, 7)]
    specs = [RefSpec(f"job-{k}", rank=r, batch_size=S_ROWS, seq_len=BT)
             for k, r in enumerate(S_RANKS)]
    names = [sp.job_id for sp in specs]
    rpool = RefPool(rc, capacity=len(specs), multiple=8)
    rpool.publish_group(specs, jax.tree.map(jnp.asarray, adapters),
                        rs.layout)
    pool = AdapterPool(pc, capacity=len(specs), multiple=8, device="cpu")
    pool.publish_group(specs, adapters_from_numpy(adapters, "cpu"),
                       rs.layout)
    reqs = [(pr, names[j % len(names)], 4) for j, pr in enumerate(prompts)]
    got = ServeEngine(pc, params_from_numpy(params, "cpu"), pool,
                      impl="ref", block_t=8).serve(
        [ServeRequest(pr, n, max_new_tokens=m) for pr, n, m in reqs])
    want = RefEngine(rc, jax.tree.map(jnp.asarray, params), rpool,
                     impl="ref", block_t=8).serve(
        [RefRequest(pr, n, max_new_tokens=m) for pr, n, m in reqs])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))


@pytest.mark.parametrize("arch", ["hubert-xlarge", "internvl2-26b"])
def test_engine_refuses_the_front_ends(arch):
    _, pc = _cfgs(arch)
    p, _ = SharedSuperModel(pc, [LoRAJobSpec("job-0", rank=8, batch_size=1,
                                             seq_len=BT)],
                            block_t=BT).init(seed=0, device="cpu")
    with pytest.raises(ValueError):
        ServeEngine(pc, p, AdapterPool(pc, device="cpu"), impl="ref")
