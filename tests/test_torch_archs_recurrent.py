"""The recurrent families' training path held against the JAX reference
on the CPU: reduced mamba2-2.7b (two SSD layers, mixer-only blocks) and
reduced recurrentgemma-9b (rglru, rglru, local_attn with window 64),
float32.  Parameter trees and counts, one train step's per-job losses
and adapter gradients through every impl, ``train_group`` over three
steps, N = 1 against N = 2 nano-batches, and the launcher's ``train
--arch``.

Weights come from the reference's ``SharedSuperModel.init`` (B drawn
from a seeded numpy RNG, so that every adapter gradient is nonzero)
through ``models/convert.py``; batches from the reference's
``FusedBatcher``.  The group mixes ranks {4, 20, 8} (pads 16/32/16 at
block_t 16: the ragged kernels' plain versions for "cuda") over 4 x 128
tokens, longer than the window, so the window masks keys.  Every port
impl is held against the reference's "ref" impl (the same function).
Tolerances:
  * per-job losses: 1e-5 relative;
  * adapter gradients: 1e-4 of the leaf's largest |value| (the same
    products summed in other orders, through the scans' backward);
  * ``train_group``: losses 1e-4 relative over three Adam steps at lr
    1e-2 and adapters within tests/test_lossless.py's bound (Adam turns
    a rounding difference in a near-zero gradient into up to 2 lr at
    that coordinate, which the next step's loss sees);
  * nano N = 1 against N = 2: per-job losses bit for bit (each row's
    forward does not depend on the rows beside it), adapters within the
    same Adam bound (the gradient is summed over two slices, in another
    order).

ROADMAP C7 reaches this group: after two steps at lr 1e-2 the LoRA
delta on ``ssd_in`` pushes dt past the 32-token chunk's overflow and the
reference's third step is NaN (asserted in ``test_train_group_matches_
reference``), so mamba2's three steps are held against the reference
with its ``_segsum_decay`` masked before ``exp`` (monkeypatched there).
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
from repro.models import ssd as RS
from repro.train.train_loop import train_group as ref_train_group

from repro_torch.configs import get_config
from repro_torch.core.jobs import LoRAJobSpec
from repro_torch.core.ssm import SharedSuperModel, _per_job_token_counts
from repro_torch.launch import train as launcher
from repro_torch.models import model as M
from repro_torch.models.convert import (adapters_from_numpy,
                                        params_from_numpy, to_numpy)
from repro_torch.optim import adamw
from repro_torch.optim.schedule import constant
from repro_torch.train.train_loop import train_group

from torch_train_common import _adam_close, _flat, one_torch_thread  # noqa: F401

ARCHS = ("mamba2-2.7b", "recurrentgemma-9b")
RANKS, BATCH, SEQ, BT, LR = (4, 20, 8), (2, 1, 1), 128, 16, 1e-2
_SETUPS = {}


def _specs(cls):
    return [cls(f"job-{i}", rank=r, batch_size=b, seq_len=SEQ)
            for i, (r, b) in enumerate(zip(RANKS, BATCH))]


def _setup(arch):
    """(ref cfg, port cfg, ref SSM, params, adapters, numpy batch), the
    weights as numpy trees with B nonzero; built once per arch."""
    if arch not in _SETUPS:
        rc = dataclasses.replace(ref_get_config(arch).reduced(),
                                 dtype="float32")
        pc = dataclasses.replace(get_config(arch).reduced(),
                                 dtype="float32")
        rs = RefSSM(rc, _specs(RefSpec), impl="ref", block_t=BT)
        params, adapters = jax.tree.map(np.asarray,
                                        rs.init(jax.random.PRNGKey(0)))
        act = np.asarray(rs.layout.active_cols)[:, None]
        rng = np.random.default_rng(0)

        def fill_b(tree):
            for k, v in tree.items():
                if k == "B":
                    tree[k] = (rng.standard_normal(v.shape) * 0.05 * act
                               ).astype(np.float32)
                elif isinstance(v, dict):
                    fill_b(v)
        for seg in adapters["segments"]:
            fill_b(seg)
        batch = RefBatcher(_specs(RefSpec), rc.vocab_size, block_t=BT,
                           seed=0).next_batch()
        _SETUPS[arch] = (rc, pc, rs, params, adapters, batch)
    return _SETUPS[arch]


_REF_GRADS = {}


def _ref_loss_and_grads(arch):
    """The reference's per-job losses and adapter gradients of the train
    step's loss (remat, full-batch denominators), "ref" impl."""
    if arch not in _REF_GRADS:
        rc, _, rs, params, adapters, batch = _setup(arch)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        denom = ref_counts(jb, len(RANKS), causal=True)

        def loss(ad, p):
            return RM.loss_fn(rc, p, ad, rs.lora_ctx(jb["adapter_ids"]), jb,
                              remat=True, per_job_denom=denom)

        (_, aux), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            jax.tree.map(jnp.asarray, adapters),
            jax.tree.map(jnp.asarray, params))
        _REF_GRADS[arch] = (np.asarray(aux["per_job"]), _flat(g))
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
    """The port's own init draws trees of the reference's structure,
    shapes (mixer-only SSD blocks have no ln2 and no ffn); parameter
    counts equal; adapter counts equal the reference's at the reduced
    widths and the layer pattern's sum at the full ones."""
    rc, pc, rs, params, adapters, _ = _setup(arch)
    ssm = SharedSuperModel(pc, _specs(LoRAJobSpec), block_t=BT)
    p, a = ssm.init(seed=0, device="cpu")
    for mine, ref in ((to_numpy(p), params), (to_numpy(a), adapters)):
        fm, fr = _flat(mine), _flat(ref)
        assert fm.keys() == fr.keys()
        assert all(fm[k].shape == fr[k].shape for k in fr)
    assert sum(v.size for v in _flat(params).values()) == \
        sum(t.numel() for t in _leaves(p))
    if arch == "mamba2-2.7b":
        assert set(p["segments"][0]["0"]) == {"ln1", "ssd"}
    assert M.adapter_param_count(pc, RANKS) == \
        RM.adapter_param_count(rc, RANKS)
    # full width, (d_in + d_out) per target a layer: mamba2's 64 layers
    # of ssd_in 2560 -> 12368 and ssd_out 5120 -> 2560; recurrentgemma's
    # 26 rglru layers (rg_in, rg_gate, rg_out, 4096 wide) and 12 local
    # attention layers (q, o 4096 -> 4096; k, v 4096 -> 256)
    per_rank = {"mamba2-2.7b": 64 * (2560 + 12368 + 5120 + 2560),
                "recurrentgemma-9b": 26 * 3 * 8192
                + 12 * (2 * 8192 + 2 * 4352)}[arch]
    assert M.adapter_param_count(get_config(arch), RANKS) == \
        per_rank * sum(RANKS)


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_and_migration_trees_carry_the_new_leaves(arch):
    """``convert.params_from_numpy`` carries the reference's bf16 tree
    across with each leaf's dtype: the f32 ``lam``, ``A_log``, ``D``,
    ``dt_bias`` and gate biases, the bf16 stacked ``conv_w`` and
    projections, bit for bit; ``migrate.zeros_like_fused`` builds the
    adapter tree's shapes for these mixers."""
    from repro_torch.elastic.migrate import zeros_like_fused
    rc = ref_get_config(arch).reduced()             # bf16, as shipped
    params = jax.tree.map(np.asarray, RM.init_model(jax.random.PRNGKey(1),
                                                    rc))
    tp = params_from_numpy(params, "cpu")
    blk = tp["segments"][0]["0"]["ssd" if arch == "mamba2-2.7b" else "rg"]
    f32 = {"A_log", "D", "dt_bias", "gate_norm"} if arch == "mamba2-2.7b" \
        else {"lam", "b_a", "b_i"}
    for k, t in blk.items():
        assert t.dtype == (torch.float32 if k in f32 else torch.bfloat16), k
    assert blk["conv_w"].shape[0] == M.segment_plan(get_config(arch)
                                                    .reduced())[0].repeats
    fr, fm = _flat(params), _flat(to_numpy(tp))
    assert fr.keys() == fm.keys()
    for k in fr:
        np.testing.assert_array_equal(fm[k], fr[k], err_msg=str(k))
    _, pc, _, _, adapters, _ = _setup(arch)
    layout = SharedSuperModel(pc, _specs(LoRAJobSpec), block_t=BT).layout
    zeros = to_numpy(zeros_like_fused(pc, layout))
    fz, fa = _flat(zeros), _flat(adapters)
    assert fz.keys() == fa.keys()
    assert all(fz[k].shape == fa[k].shape and not fz[k].any() for k in fa)


# ---------------------------------------------------------- train step
@pytest.mark.parametrize("impl", ["ref", "cuda", "torch", "loop"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_losses_and_grads_match_reference(arch, impl):
    _, pc, _, params, adapters, batch = _setup(arch)
    want_loss, want_g = _ref_loss_and_grads(arch)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    ssm = SharedSuperModel(pc, _specs(LoRAJobSpec), impl=impl, block_t=BT)
    assert not ssm.layout.is_uniform
    tp = params_from_numpy(params, "cpu")
    ad = adapters_from_numpy(adapters, "cpu")
    leaves = [t.requires_grad_() for t in _leaves(ad)]
    total, aux = M.loss_fn(pc, tp, ad, ssm.lora_ctx(tb["adapter_ids"]), tb,
                           remat=True, per_job_denom=_per_job_token_counts(
                               tb, len(RANKS), causal=True))
    total.backward()
    np.testing.assert_allclose(aux["per_job"].detach().numpy(), want_loss,
                               rtol=1e-5)
    for path, t in zip(want_g, leaves):
        w = want_g[path]
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=str(path))
    # the train step's metrics are the same forward
    step = ssm.make_train_step(lr_fn=constant(LR))
    _, _, m = step(tp, adapters_from_numpy(adapters, "cpu"),
                   adamw.init(ad, per_job=len(RANKS)), tb)
    np.testing.assert_allclose(m["per_job_loss"].numpy(), want_loss,
                               rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_group_matches_reference(arch, monkeypatch):
    """Three steps in one chunk from the same weights and data streams:
    per-step per-job losses, adapters and Adam steps."""
    rc, pc, _, params, adapters, _ = _setup(arch)

    def ref_run():
        return ref_train_group(
            rc, _specs(RefSpec), steps=3, lr=LR, seed=0, impl="ref",
            block_t=BT, adaptive_nano=False, nano_batches=1, remat=True,
            chunk_size=3, params=jax.tree.map(jnp.asarray, params),
            adapters=jax.tree.map(jnp.asarray, adapters))

    if arch == "mamba2-2.7b":          # ROADMAP C7, at reduced width
        assert np.isnan(ref_run()["report"].per_job_losses[2]).all()

        def masked_first(dA_cs):
            L = dA_cs.shape[-1]
            diff = dA_cs[..., :, None] - dA_cs[..., None, :]
            mask = jnp.tril(jnp.ones((L, L), bool))
            return jnp.where(mask, jnp.exp(jnp.where(mask, diff, 0.0)), 0.0)

        monkeypatch.setattr(RS, "_segsum_decay", masked_first)
    want = ref_run()
    got = train_group(pc, _specs(LoRAJobSpec), steps=3, lr=LR, seed=0,
                      impl="cuda", block_t=BT, chunk_size=3,
                      adaptive_nano=False,
                      params=params_from_numpy(params, "cpu"),
                      adapters=adapters_from_numpy(adapters, "cpu"),
                      device="cpu")
    wr, gr = want["report"], got["report"]
    assert gr.steps == wr.steps == 3
    np.testing.assert_allclose(np.stack(gr.per_job_losses),
                               np.stack(wr.per_job_losses), rtol=1e-4)
    _adam_close(_flat(to_numpy(got["adapters"])), _flat(want["adapters"]))
    np.testing.assert_array_equal(got["opt_state"].step.numpy(),
                                  np.asarray(want["opt_state"].step))


@pytest.mark.parametrize("arch", ARCHS)
def test_nano_n1_against_n2(arch):
    _, pc, _, params, adapters, batch = _setup(arch)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tp = params_from_numpy(params, "cpu")
    runs = {}
    for n in (1, 2):
        ssm = SharedSuperModel(pc, _specs(LoRAJobSpec), impl="cuda",
                               block_t=BT)
        step = ssm.make_train_step(lr_fn=constant(LR), nano_batches=n)
        ad = adapters_from_numpy(adapters, "cpu")
        new, _, m = step(tp, ad, adamw.init(ad, per_job=len(RANKS)), tb)
        runs[n] = (m["per_job_loss"].numpy(), new)
    np.testing.assert_array_equal(runs[1][0], runs[2][0])
    _adam_close(_flat(to_numpy(runs[2][1])), _flat(to_numpy(runs[1][1])))


# ------------------------------------------------------------ launcher
@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_the_recurrent_archs(arch, capsys):
    out = launcher.main(["train", "--arch", arch, "--reduced", "--device",
                         "cpu", "--jobs", "2", "--steps", "2",
                         "--chunk-size", "2", "--seq-len", "64",
                         "--batch-size", "1", "--block-t", "16",
                         "--no-aimd"])
    losses = np.stack(out["report"].per_job_losses)
    assert losses.shape == (2, 2) and np.isfinite(losses).all()
    assert "final loss" in capsys.readouterr().out
