"""The other model families held against the JAX reference on the CPU:
reduced deepseek-v2-lite-16b (MLA with q/k 48 and v 32, a dense head
layer then a MoE layer of 4 experts top-2 plus a shared expert),
reduced qwen3-moe-30b-a3b (GQA, MoE layers of 4 experts top-2),
reduced hubert-xlarge (a non-causal encoder on audio frames) and reduced
internvl2-26b (GQA, 16 VLM patches before the text), float32.

Parameter trees and counts, the bf16 trees carried across, one train
step's per-job losses and adapter gradients through every impl,
``train_group`` over three steps, and the launcher's ``train --arch``
(the serve steps and the engine: tests/test_torch_serve_other.py).  On the CPU every attention here is the plain chunk
scan and plain backward (reduced MLA's q/k 48 with v 32 and the others'
head dim 32); at full width the card takes the flash kernel at
(192, 128), 128 and 80.

Weights come from the reference's ``SharedSuperModel.init`` (B drawn
from a seeded numpy RNG, so that every adapter gradient is nonzero)
through ``models/convert.py``; batches from the reference's
``FusedBatcher``, with the audio frames and VLM patches of
``data.pipeline.frontend_inputs`` (tests/test_archs.py's draws).  The
group mixes ranks {4, 20, 8} (pads 16/32/16 at block_t 16: the ragged
kernels' plain versions for "cuda") over 4 x 64 tokens.  Every port impl
is held against the reference's "ref" impl.  Tolerances, those of
tests/test_torch_archs_recurrent.py:
  * per-job losses: 1e-5 relative; the MoE aux 1e-6 absolute;
  * adapter gradients: 1e-4 of the leaf's largest |value|;
  * ``train_group``: losses 1e-4 relative over three Adam steps at lr
    1e-2, adapters within tests/test_lossless.py's bound.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.core.jobs import LoRAJobSpec as RefSpec
from repro.core.ssm import SharedSuperModel as RefSSM
from repro.core.ssm import _per_job_token_counts as ref_counts
from repro.data.pipeline import FusedBatcher as RefBatcher
from repro.models import model as RM
from repro.optim import adamw as ref_adamw
from repro.optim.schedule import constant as ref_constant
from repro.train.train_loop import train_group as ref_train_group

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.jobs import LoRAJobSpec
from repro_torch.core.ssm import SharedSuperModel, _per_job_token_counts
from repro_torch.data.pipeline import frontend_inputs
from repro_torch.launch import train as launcher
from repro_torch.models import model as M
from repro_torch.models.convert import (adapters_from_numpy,
                                        params_from_numpy, to_numpy)
from repro_torch.optim import adamw
from repro_torch.optim.schedule import constant
from repro_torch.train.train_loop import train_group

from torch_train_common import (_adam_close, _flat, fill_b,  # noqa: F401
                                one_torch_thread)

ARCHS = ("deepseek-v2-lite-16b", "qwen3-moe-30b-a3b", "hubert-xlarge",
         "internvl2-26b")
DECODERS = ("deepseek-v2-lite-16b", "qwen3-moe-30b-a3b", "internvl2-26b")
RANKS, BATCH, SEQ, BT, LR = (4, 20, 8), (2, 1, 1), 64, 16, 1e-2
_SETUPS = {}


def _specs(cls):
    return [cls(f"job-{i}", rank=r, batch_size=b, seq_len=SEQ)
            for i, (r, b) in enumerate(zip(RANKS, BATCH))]


def _cfgs(arch):
    return (dataclasses.replace(ref_get_config(arch).reduced(),
                                dtype="float32"),
            dataclasses.replace(get_config(arch).reduced(), dtype="float32"))


def _setup(arch):
    """(ref cfg, port cfg, ref SSM, params, adapters, numpy batch), the
    weights as numpy trees with B nonzero; built once per arch."""
    if arch not in _SETUPS:
        rc, pc = _cfgs(arch)
        rs = RefSSM(rc, _specs(RefSpec), impl="ref", block_t=BT)
        params, adapters = jax.tree.map(
            np.asarray, jax.jit(rs.init)(jax.random.PRNGKey(0)))
        fill_b(adapters, np.asarray(rs.layout.active_cols)[:, None],
                np.random.default_rng(0))
        batch = RefBatcher(_specs(RefSpec), rc.vocab_size, block_t=BT,
                           seed=0).next_batch()
        batch = frontend_inputs(pc, batch, np.random.default_rng(1))
        _SETUPS[arch] = (rc, pc, rs, params, adapters, batch)
    return _SETUPS[arch]


_REF_GRADS = {}


def _ref_loss_and_grads(arch):
    """The reference's per-job losses, aux and adapter gradients of the
    train step's loss (remat, full-batch denominators), "ref" impl."""
    if arch not in _REF_GRADS:
        rc, _, rs, params, adapters, batch = _setup(arch)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        denom = ref_counts(jb, len(RANKS), causal=rc.causal)

        def loss(ad, p):
            return RM.loss_fn(rc, p, ad, rs.lora_ctx(jb["adapter_ids"]), jb,
                              remat=True, per_job_denom=denom)

        (_, aux), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            jax.tree.map(jnp.asarray, adapters),
            jax.tree.map(jnp.asarray, params))
        _REF_GRADS[arch] = (np.asarray(aux["per_job"]), float(aux["aux"]),
                            _flat(g))
    return _REF_GRADS[arch]


def _leaves(tree):
    """Leaves in ``_flat`` order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


# --------------------------------------------------------------- trees
@pytest.mark.parametrize("arch", ARCHS)
def test_trees_and_param_counts_match_reference(arch):
    """The port's own init draws trees of the reference's structure and
    shapes (the head segment of deepseek's dense layer, MoE routers and
    slabs, MLA's latent weights, the front ends' projection); parameter
    and adapter counts equal the reference's at the reduced widths, and
    the adapter counts the layer pattern's sum at the full ones."""
    rc, pc, _, params, adapters, _ = _setup(arch)
    p, a = SharedSuperModel(pc, _specs(LoRAJobSpec), block_t=BT).init(
        seed=0, device="cpu")
    for mine, ref in ((to_numpy(p), params), (to_numpy(a), adapters)):
        fm, fr = _flat(mine), _flat(ref)
        assert fm.keys() == fr.keys()
        assert all(fm[k].shape == fr[k].shape for k in fr), arch
    assert sum(v.size for v in _flat(params).values()) == \
        sum(t.numel() for t in _leaves(p))
    assert M.adapter_param_count(pc, RANKS) == \
        RM.adapter_param_count(rc, RANKS)
    # full width, (d_in + d_out) per target a layer
    per_rank = {"deepseek-v2-lite-16b": 27 * ((2048 + 3072) + (2048 + 576)
                                              + (2048 + 2048)),
                "qwen3-moe-30b-a3b": 48 * (2 * (2048 + 4096)
                                           + 2 * (2048 + 512)),
                "hubert-xlarge": 48 * 4 * (1280 + 1280),
                "internvl2-26b": 48 * (2 * (6144 + 6144)
                                       + 2 * (6144 + 1024))}[arch]
    assert M.adapter_param_count(get_config(arch), RANKS) == \
        per_rank * sum(RANKS)


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_carries_the_new_leaves(arch):
    """``convert.params_from_numpy`` carries the reference's bf16 tree
    across with each leaf's dtype, bit for bit: f32 routers and norms,
    bf16 expert slabs, MLA weights and front-end projection."""
    rc = ref_get_config(arch).reduced()             # bf16, as shipped
    params = jax.tree.map(np.asarray, RM.init_model(jax.random.PRNGKey(1),
                                                    rc))
    tp = params_from_numpy(params, "cpu")
    f32 = {"router", "kv_norm", "ln1", "ln2", "ln_f"}
    fr, fm = _flat(params), _flat(to_numpy(tp))
    assert fr.keys() == fm.keys()
    for path in fr:
        np.testing.assert_array_equal(fm[path], fr[path], err_msg=str(path))
    seen = set()
    for path, t in zip(fr, _leaves(tp)):
        want = torch.float32 if path[-1] in f32 else torch.bfloat16
        assert t.dtype == want, path
        seen.add(path[-1])
    if rc.num_experts:
        assert {"router", "w_in", "w_out"} <= seen
    if rc.use_mla:
        assert {"w_kv_a", "kv_norm", "w_kv_b"} <= seen
    if rc.frontend_dim:
        assert "frontend" in seen


def test_quantize_walks_the_new_trees_as_the_reference():
    """``quant.quantize_params`` on reduced deepseek-v2-lite-16b and
    qwen3-moe-30b-a3b (bf16, as shipped): the MoE routers and expert
    slabs stay dense, MLA's wq, w_kv_a, w_kv_b and wo, the attention
    projections, the dense and shared-expert FFNs are quantized, with
    the reference's codes and scales, bit for bit."""
    from repro.models import quant as ref_quant
    from repro_torch.models import quant
    for arch in ("deepseek-v2-lite-16b", "qwen3-moe-30b-a3b"):
        rc = ref_get_config(arch).reduced()
        params = RM.init_model(jax.random.PRNGKey(2), rc)
        want = jax.tree.map(np.asarray, ref_quant.quantize_params(params))
        got = to_numpy(quant.quantize_params(params_from_numpy(
            jax.tree.map(np.asarray, params), "cpu")))

        def walk(w, g, path=()):
            if isinstance(w, dict):
                assert w.keys() == g.keys(), path
                for k in w:
                    yield from walk(w[k], g[k], path + (k,))
            elif isinstance(w, list):
                for i, (a, b) in enumerate(zip(w, g)):
                    yield from walk(a, b, path + (str(i),))
            else:
                yield path, w, g

        quantized = set()
        for path, w, g in walk(want, got):
            is_q = hasattr(w, "q")
            assert is_q == hasattr(g, "q"), path
            if is_q:
                quantized.add(path[-1])
                np.testing.assert_array_equal(g.q, np.asarray(w.q))
                np.testing.assert_array_equal(g.scale, np.asarray(w.scale))
            else:
                assert path[-1] not in ("wq", "wo", "gate", "up", "down"), \
                    path
        assert not quantized & {"router", "w_in", "w_out", "embed", "head"}
        want_q = ({"wq", "w_kv_a", "w_kv_b", "wo", "gate", "up", "down"}
                  if rc.use_mla else {"wq", "wk", "wv", "wo"})
        assert want_q <= quantized, (arch, quantized)


# ---------------------------------------------------------- train step
@pytest.mark.parametrize("impl", ["ref", "cuda", "torch", "loop"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_losses_and_grads_match_reference(arch, impl):
    _, pc, _, params, adapters, batch = _setup(arch)
    want_loss, want_aux, want_g = _ref_loss_and_grads(arch)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    ssm = SharedSuperModel(pc, _specs(LoRAJobSpec), impl=impl, block_t=BT)
    assert not ssm.layout.is_uniform
    tp = params_from_numpy(params, "cpu")
    ad = adapters_from_numpy(adapters, "cpu")
    leaves = [t.requires_grad_() for t in _leaves(ad)]
    total, aux = M.loss_fn(pc, tp, ad, ssm.lora_ctx(tb["adapter_ids"]), tb,
                           remat=True, per_job_denom=_per_job_token_counts(
                               tb, len(RANKS), causal=pc.causal))
    total.backward()
    np.testing.assert_allclose(aux["per_job"].detach().numpy(), want_loss,
                               rtol=1e-5)
    np.testing.assert_allclose(aux["aux"].item(), want_aux, rtol=0,
                               atol=1e-6)
    assert (aux["aux"].item() > 0) == bool(pc.num_experts)
    for path, t in zip(want_g, leaves):
        w = want_g[path]
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=str(path))
    step = ssm.make_train_step(lr_fn=constant(LR))
    _, _, m = step(tp, adapters_from_numpy(adapters, "cpu"),
                   adamw.init(ad, per_job=len(RANKS)), tb)
    np.testing.assert_allclose(m["per_job_loss"].numpy(), want_loss,
                               rtol=1e-5)
    np.testing.assert_allclose(m["aux"].item(), want_aux, rtol=0, atol=1e-6)


def test_vlm_lora_rows_cover_patches_and_text():
    """A VLM sequence is its 16 patches and 64 text tokens: the LoRA
    kernels see 80 rows a sequence, and the per-job token counts of the
    static tile map are whole tiles of them."""
    _, pc, _, _, _, batch = _setup("internvl2-26b")
    seen = []
    ssm = SharedSuperModel(pc, _specs(LoRAJobSpec), impl="cuda", block_t=BT)
    ctx = ssm.lora_ctx(torch.from_numpy(batch["adapter_ids"]))
    apply = ctx.apply

    def spy(x, ab):
        seen.append(tuple(x.shape[:2]))
        return apply(x, ab)

    ctx.apply = spy
    ssm.lora_ctx = lambda ids: ctx
    tp, ta = ssm.init(seed=0, device="cpu")
    M.loss_fn(pc, tp, ta, ctx, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    P = pc.num_patches
    assert set(seen) == {(sum(BATCH), P + SEQ)}
    assert all(r * (P + SEQ) % BT == 0 for r in ssm.rows_per_job())


# ----------------------------------------------------------- train_group
def _ref_chunk(rc, rs, params, adapters, batches):
    """The reference's chunked train step over *batches* (a leading
    chunk axis): the three steps its ``train_group`` would take, for the
    front-end configs whose batches its batcher does not make."""
    step = rs.make_train_step(lr_fn=ref_constant(LR), steps=3)
    ad = jax.tree.map(jnp.asarray, adapters)
    ad, opt, m = jax.jit(step)(jax.tree.map(jnp.asarray, params), ad,
                               ref_adamw.init(ad, per_job=len(RANKS)),
                               {k: jnp.asarray(v) for k, v in
                                batches.items()})
    return np.asarray(m["per_job_loss"]), ad, np.asarray(opt.step)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_group_matches_reference(arch):
    """Three steps in one chunk from the same weights and data streams
    (for audio and VLM with the frames or patches the port's runtime
    draws from the seed): per-step per-job losses, adapters and Adam
    steps."""
    rc, pc, rs, params, adapters, _ = _setup(arch)
    if pc.frontend_dim:
        batches = RefBatcher(_specs(RefSpec), rc.vocab_size, block_t=BT,
                             seed=0).next_batches(3)
        batches = frontend_inputs(pc, batches, np.random.default_rng(0))
        want_losses, want_ad, want_step = _ref_chunk(rc, rs, params,
                                                     adapters, batches)
    else:
        want = ref_train_group(
            rc, _specs(RefSpec), steps=3, lr=LR, seed=0, impl="ref",
            block_t=BT, adaptive_nano=False, nano_batches=1, remat=True,
            chunk_size=3, params=jax.tree.map(jnp.asarray, params),
            adapters=jax.tree.map(jnp.asarray, adapters))
        want_losses = np.stack(want["report"].per_job_losses)
        want_ad, want_step = want["adapters"], want["opt_state"].step
    got = train_group(pc, _specs(LoRAJobSpec), steps=3, lr=LR, seed=0,
                      impl="cuda", block_t=BT, chunk_size=3,
                      adaptive_nano=False,
                      params=params_from_numpy(params, "cpu"),
                      adapters=adapters_from_numpy(adapters, "cpu"),
                      device="cpu")
    gr = got["report"]
    assert gr.steps == 3
    np.testing.assert_allclose(np.stack(gr.per_job_losses), want_losses,
                               rtol=1e-4)
    _adam_close(_flat(to_numpy(got["adapters"])), _flat(want_ad))
    np.testing.assert_array_equal(got["opt_state"].step.numpy(),
                                  np.asarray(want_step))


# ------------------------------------------------------------ launcher
@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_the_other_archs(arch, capsys):
    assert arch in ARCH_IDS
    out = launcher.main(["train", "--arch", arch, "--reduced", "--device",
                         "cpu", "--jobs", "2", "--steps", "2",
                         "--chunk-size", "2", "--seq-len", "64",
                         "--batch-size", "1", "--block-t", "16",
                         "--no-aimd"])
    losses = np.stack(out["report"].per_job_losses)
    assert losses.shape == (2, 2) and np.isfinite(losses).all()
    assert "final loss" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_registry_config_trains_and_serves(arch):
    """Every config of the registry, reduced, in the port alone: one
    train step with finite per-job losses and, for a decoder, a prefill
    and a decode step with finite logits (the encoder has no decode)."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    specs = [LoRAJobSpec("job-0", rank=4, batch_size=2, seq_len=SEQ)]
    ssm = SharedSuperModel(cfg, specs, impl="ref", block_t=BT)
    p, a = ssm.init(seed=0, device="cpu")
    from repro_torch.data.pipeline import FusedBatcher
    nb = frontend_inputs(cfg, FusedBatcher(specs, cfg.vocab_size,
                                           block_t=BT).next_batch(),
                         np.random.default_rng(0))
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    _, _, m = ssm.make_train_step(lr_fn=constant(LR))(
        p, a, adamw.init(a, per_job=1), tb)
    assert np.isfinite(m["per_job_loss"].numpy()).all()
    if not cfg.supports_decode():
        return
    from repro_torch.configs.base import InputShape
    ids = tb["adapter_ids"]
    tok = tb["tokens"][:, :8]
    lp, caches = ssm.make_prefill_step(InputShape("p", 16, 2, "decode"))(
        p, a, {"tokens": tok, "adapter_ids": ids})
    ld, _ = ssm.make_serve_step()(p, a, caches, {"tokens": tok[:, :1],
                                                 "adapter_ids": ids}, 8)
    assert torch.isfinite(lp).all() and torch.isfinite(ld).all()
