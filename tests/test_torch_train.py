"""The port's training path held against the JAX reference on the CPU, on
reduced tinyllama-1.1b: cross entropy, the per-job loss and its adapter
gradients, AdamW with per-job steps, the fused batcher, and
``train_group`` end to end; then the port's own lossless contract (fused
== isolated, adapter isolation) and the configurations it refuses.

Weights come from the reference's ``init_model`` / ``init_adapters``
(B drawn from a seeded numpy RNG, so that every adapter gradient is
nonzero), exported with ``np.asarray`` and carried across with
``models/convert.py``.  The group mixes ranks {4, 20, 8}, which pad to
16/32/16 at the rank multiple 16 (block_t 16): a non-uniform layout, so
both sides take the ragged kernels (the port's plain versions on the
CPU, the reference's Pallas kernels in interpret mode).  Tolerances:
  * f32 losses: 1e-5 relative; f32 gradients: 1e-4 relative and 1e-4 of
    the leaf's largest |value| absolute — the frameworks sum the same
    products in other orders through two layers and their backward;
  * bf16 losses 2e-2 relative; bf16 gradients 5e-2 of the leaf's largest
    |value| absolute — both round every op to bf16, and one-ulp flips
    (2^-8 relative) of hidden states carry through the layers;
  * adapters after Adam steps: the bound of tests/test_lossless.py —
    within 2.5 lr everywhere, and within 1e-5 for over 97% of the
    coordinates (Adam divides by sqrt(v), so a float-order difference in
    a near-zero gradient can flip an update by up to 2 lr);
  * within the port: fused == isolated at test_lossless.py's 2e-4
    relative (the two sides run other products), adapter isolation at
    its 1e-6.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.jobs import LoRAJobSpec as RefSpec
from repro.core.ssm import SharedSuperModel as RefSSM
from repro.core.ssm import _per_job_token_counts as ref_counts
from repro.data.pipeline import FusedBatcher as RefBatcher
from repro.kernels import ops as ref_ops
from repro.models import layers as RL
from repro.models import model as RM
from repro.optim import adamw as ref_adamw
from repro.train.train_loop import train_group as ref_train_group

from repro_torch.core.jobs import LoRAJobSpec
from repro_torch.core.ssm import SharedSuperModel, _per_job_token_counts
from repro_torch.data.pipeline import FusedBatcher
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.convert import (adapters_from_numpy,
                                        opt_state_from_numpy,
                                        params_from_numpy, to_numpy)
from repro_torch.optim import adamw
from repro_torch.optim.schedule import constant
from repro_torch.train.train_loop import train_group

from torch_train_common import (BT, LR, RANKS, RANKS_U, _adam_close,
                                _cfgs, _flat, _specs, _weights)


def _batch(vocab, seed=0):
    b = RefBatcher(_specs(RefSpec), vocab, block_t=BT, seed=seed).next_batch()
    return b, {k: torch.from_numpy(v) for k, v in b.items()}


def _assert_grads(got: dict, want: dict, rtol: float, frac: float):
    assert got.keys() == want.keys()
    for p in want:
        w = want[p]
        np.testing.assert_allclose(got[p], w, rtol=rtol,
                                   atol=frac * max(np.abs(w).max(), 1e-30),
                                   err_msg=str(p))


# -------------------------------------------------------------- layers
def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) > 0.3).astype(np.float32)
    want = RL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                            jnp.asarray(mask))
    got = L.cross_entropy(torch.from_numpy(logits).bfloat16().float(),
                          torch.from_numpy(labels), torch.from_numpy(mask))
    want_bf = RL.cross_entropy(jnp.asarray(logits).astype(jnp.bfloat16)
                               .astype(jnp.float32), jnp.asarray(labels),
                               jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_bf), rtol=1e-5,
                               atol=1e-5)
    got = L.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    want = RL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------------ the loss
@pytest.mark.parametrize("dtype,loss_rtol,g_rtol,g_frac",
                         [("float32", 1e-5, 1e-4, 1e-4),
                          ("bfloat16", 2e-2, 0.0, 5e-2)])
def test_loss_fn_per_job_and_grads_match_reference(dtype, loss_rtol, g_rtol,
                                                   g_frac):
    ref_cfg, cfg = _cfgs(dtype)
    ref_ssm, params, adapters = _weights(ref_cfg)
    nb, tb = _batch(cfg.vocab_size)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    denom = ref_counts(jb, len(RANKS), causal=True)

    def ref_loss(ad):
        lora = ref_ssm.lora_ctx(jb["adapter_ids"])
        return RM.loss_fn(ref_cfg, jax.tree.map(jnp.asarray, params), ad,
                          lora, jb, remat=True, per_job_denom=denom)

    (_, want_aux), want_g = jax.value_and_grad(ref_loss, has_aux=True)(
        jax.tree.map(jnp.asarray, adapters))

    ssm = SharedSuperModel(cfg, _specs(LoRAJobSpec), impl="cuda",
                           block_t=BT)
    assert not ssm.layout.is_uniform
    tparams = params_from_numpy(params, "cpu")
    got_denom = _per_job_token_counts(tb, len(RANKS), causal=True)
    np.testing.assert_array_equal(got_denom.numpy(), np.asarray(denom))
    grads = {}
    for remat in (True, False):
        ad = adapters_from_numpy(adapters, "cpu")
        leaves = [t.requires_grad_() for t in _torch_leaves(ad)]
        total, aux = M.loss_fn(cfg, tparams, ad, ssm.lora_ctx(
            tb["adapter_ids"]), tb, remat=remat, per_job_denom=got_denom)
        total.backward()
        grads[remat] = {p: t.grad.numpy().copy() for p, t in
                        zip(_flat(adapters).keys(), leaves)}
        np.testing.assert_allclose(aux["per_job"].detach().numpy(),
                                   np.asarray(want_aux["per_job"]),
                                   rtol=loss_rtol)
    _assert_grads(grads[True], _flat(want_g), g_rtol, g_frac)
    # remat recomputes the same values: the gradients are bit-equal
    for p in grads[True]:
        np.testing.assert_array_equal(grads[True][p], grads[False][p])


def _torch_leaves(tree):
    """Leaves in ``_flat`` order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _torch_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _torch_leaves(v)]
    return [tree]


# ----------------------------------------------------------- optimizer
@pytest.mark.parametrize("per_job", [True, False])
def test_adamw_update_matches_reference(per_job):
    """Per-job (K,) steps gathered per packed column (A leaves on the last
    axis, B leaves on the second to last), or one scalar step."""
    rng = np.random.default_rng(3)
    lay = RefSSM(_cfgs("float32")[0], _specs(RefSpec), block_t=BT).layout
    R = lay.total
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    params = {"segments": [{"0": {"q": {"A": f(2, 8, R), "B": f(2, R, 6)}}}]}
    grads = {"segments": [{"0": {"q": {"A": f(2, 8, R), "B": f(2, R, 6)}}}]}
    mu = jax.tree.map(lambda a: a * 0.1, grads)
    nu = jax.tree.map(lambda a: np.abs(a) * 0.01, grads)
    step = (np.asarray([0, 3, 7], np.int32) if per_job
            else np.asarray(2, np.int32))
    state = ref_adamw.AdamWState(step, mu, nu)
    kw = dict(lr=1e-2, weight_decay=0.01,
              col_jobs=lay.col_jobs if per_job else None)
    want_p, want_s = ref_adamw.update(
        jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, state),
        jax.tree.map(jnp.asarray, params), **kw)
    got_p, got_s = adamw.update(
        params_from_numpy(grads, "cpu"), opt_state_from_numpy(state, "cpu"),
        params_from_numpy(params, "cpu"), **kw)
    for got, want in ((got_p, want_p), (got_s.mu, want_s.mu),
                      (got_s.nu, want_s.nu)):
        g, w = _flat(to_numpy(got)), _flat(want)
        for p in w:
            np.testing.assert_allclose(g[p], w[p], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got_s.step.numpy(), np.asarray(want_s.step))


# -------------------------------------------------------------- batches
def test_fused_batcher_batches_equal_reference():
    ref = RefBatcher(_specs(RefSpec), 1000, block_t=BT, seed=3)
    port = FusedBatcher(_specs(LoRAJobSpec), 1000, block_t=BT, seed=3)
    assert port.rows_per_job() == ref.rows_per_job()
    np.testing.assert_array_equal(port.adapter_ids, ref.adapter_ids)
    for _ in range(2):
        a, b = ref.next_batch(), port.next_batch()
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    a, b = ref.next_batches(2), port.next_batches(2)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


# ------------------------------------------------------------ end to end
def test_train_group_matches_reference():
    """3 steps in chunks of 2 (one chunk of 2, then one of 1), the same
    weights and data streams: per-step per-job losses, adapters and the
    per-job Adam steps agree."""
    ref_cfg, cfg = _cfgs("float32")
    _, params, adapters = _weights(ref_cfg)
    want = ref_train_group(
        ref_cfg, _specs(RefSpec), steps=3, lr=LR, seed=0, impl="pallas",
        block_t=BT, adaptive_nano=False, nano_batches=1, remat=True,
        chunk_size=2, params=jax.tree.map(jnp.asarray, params),
        adapters=jax.tree.map(jnp.asarray, adapters))
    got = train_group(cfg, _specs(LoRAJobSpec), steps=3, lr=LR, seed=0,
                      impl="cuda", block_t=BT, chunk_size=2,
                      adaptive_nano=False,
                      params=params_from_numpy(params, "cpu"),
                      adapters=adapters_from_numpy(adapters, "cpu"),
                      device="cpu")
    wr, gr = want["report"], got["report"]
    assert gr.steps == wr.steps == 3
    np.testing.assert_allclose(np.stack(gr.per_job_losses),
                               np.stack(wr.per_job_losses), rtol=1e-5)
    _adam_close(_flat(to_numpy(got["adapters"])), _flat(want["adapters"]))
    np.testing.assert_array_equal(got["opt_state"].step.numpy(),
                                  np.asarray(want["opt_state"].step))


# ------------------------------------------- the port's lossless contract
def _slice_tree(adapters, layout, k):
    """Job k's packed segment of a fused adapter tree (a solo tree)."""
    off, rp = layout.slice_of(k)
    return adamw.tree_map(
        lambda p, t: (t[..., :, off:off + rp] if p[-1] == "A"
                      else t[..., off:off + rp, :]), adapters)


def _job_batch(batch, k):
    rows = batch["adapter_ids"] == k
    out = {key: v[rows] for key, v in batch.items()}
    out["adapter_ids"] = torch.zeros(int(rows.sum()), dtype=torch.int32)
    return out


def _port_grads(cfg, specs, impl, params, adapters, batch):
    ssm = SharedSuperModel(cfg, specs, impl=impl, block_t=BT)
    leaves = [t.requires_grad_() for t in _torch_leaves(adapters)]
    total, _ = M.loss_fn(cfg, params, adapters,
                         ssm.lora_ctx(batch["adapter_ids"]), batch,
                         remat=False)
    total.backward()
    return [t.grad for t in leaves]


def _run_steps(cfg, specs, impl, params, adapters, batches):
    ssm = SharedSuperModel(cfg, specs, impl=impl, block_t=BT)
    step = ssm.make_train_step(lr_fn=constant(LR), remat=False)
    opt = adamw.init(adapters)
    losses = []
    for b in batches:
        adapters, opt, m = step(params, adapters, opt, b)
        losses.append(m["per_job_loss"].numpy())
    return adapters, losses


@pytest.fixture(scope="module")
def port_setup():
    ref_cfg, cfg = _cfgs("float32")
    _, params, adapters = _weights(ref_cfg, seed=7)
    batcher = FusedBatcher(_specs(LoRAJobSpec), cfg.vocab_size, block_t=BT)
    batches = [{k: torch.from_numpy(v) for k, v in
                batcher.next_batch().items()} for _ in range(3)]
    return (cfg, params_from_numpy(params, "cpu"), adapters, batches,
            SharedSuperModel(cfg, _specs(LoRAJobSpec), block_t=BT).layout)


def test_fused_equals_isolated_grads(port_setup):
    """Job k's adapter gradient in the fused group (ragged kernels) equals
    its gradient trained alone.  Alone, one job's layout is uniform, which
    the ragged kernels do not take; it runs the "loop" impl, autograd
    through one GEMM pair per adapter."""
    cfg, params, adapters, batches, layout = port_setup
    specs = _specs(LoRAJobSpec)
    fused = _port_grads(cfg, specs, "cuda", params,
                        adapters_from_numpy(adapters, "cpu"), batches[0])
    fused_tree = adamw.tree_map(
        lambda _, t, it=iter(fused): next(it),
        adapters_from_numpy(adapters, "cpu"))
    for k, spec in enumerate(specs):
        solo_ad = _slice_tree(adapters_from_numpy(adapters, "cpu"), layout, k)
        solo_ad = adamw.tree_map(lambda _, t: t.detach().clone(), solo_ad)
        solo = _port_grads(cfg, [spec], "loop", params, solo_ad,
                           _job_batch(batches[0], k))
        want = _torch_leaves(_slice_tree(fused_tree, layout, k))
        for w, g in zip(want, solo):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-4,
                                       atol=1e-6)


def test_fused_equals_isolated_trajectory(port_setup):
    """3 Adam steps fused vs alone: per-step losses and adapters agree."""
    cfg, params, adapters, batches, layout = port_setup
    specs = _specs(LoRAJobSpec)
    fused_ad, fused_losses = _run_steps(
        cfg, specs, "cuda", params, adapters_from_numpy(adapters, "cpu"),
        batches)
    for k, spec in enumerate(specs):
        solo_ad = _slice_tree(adapters_from_numpy(adapters, "cpu"), layout, k)
        got_ad, got_losses = _run_steps(
            cfg, [spec], "loop", params,
            adamw.tree_map(lambda _, t: t.clone(), solo_ad),
            [_job_batch(b, k) for b in batches])
        for fl, gl in zip(fused_losses, got_losses):
            np.testing.assert_allclose(fl[k], gl[0], rtol=1e-5, atol=1e-6)
        _adam_close(_flat(to_numpy(got_ad)),
                    _flat(to_numpy(_slice_tree(fused_ad, layout, k))))


def test_adapter_isolation(port_setup):
    """Job 0's update does not depend on job 1's data."""
    cfg, params, adapters, batches, layout = port_setup
    specs = _specs(LoRAJobSpec)
    ad_ref, _ = _run_steps(cfg, specs, "cuda", params,
                           adapters_from_numpy(adapters, "cpu"),
                           batches[:1])
    b2 = dict(batches[0])
    rows = b2["adapter_ids"] == 1
    toks = b2["tokens"].clone()
    toks[rows] = (toks[rows] + 17) % cfg.vocab_size
    b2["tokens"], b2["labels"] = toks, toks
    ad_alt, _ = _run_steps(cfg, specs, "cuda", params,
                           adapters_from_numpy(adapters, "cpu"), [b2])
    want = _flat(to_numpy(_slice_tree(ad_ref, layout, 0)))
    got = _flat(to_numpy(_slice_tree(ad_alt, layout, 0)))
    for p in want:
        np.testing.assert_allclose(got[p], want[p], rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------- uniform layouts
@pytest.mark.parametrize("ranks,nano", [(RANKS_U, 1), (RANKS, 2)],
                         ids=["uniform", "mixed_nano2"])
def test_train_group_matches_reference_masked_route(ranks, nano):
    """``train_group`` 3 steps, the port's "cuda" against the reference's
    "pallas": a uniform group (the masked family at N = 1) and a mixed
    group at nano_batches=2 (contiguous slices without a static tile map,
    densified to the widest segment, the masked family on both sides).
    Per-step per-job losses at 1e-5 relative, adapters at the Adam bound,
    the same per-job Adam steps."""
    ref_cfg, cfg = _cfgs("float32")
    _, params, adapters = _weights(ref_cfg, ranks=ranks)
    want = ref_train_group(
        ref_cfg, _specs(RefSpec, ranks), steps=3, lr=LR, seed=0,
        impl="pallas", block_t=BT, adaptive_nano=False, nano_batches=nano,
        remat=True, chunk_size=2, params=jax.tree.map(jnp.asarray, params),
        adapters=jax.tree.map(jnp.asarray, adapters))
    got = train_group(cfg, _specs(LoRAJobSpec, ranks), steps=3, lr=LR,
                      seed=0, impl="cuda", block_t=BT, chunk_size=2,
                      adaptive_nano=False, nano_batches=nano,
                      params=params_from_numpy(params, "cpu"),
                      adapters=adapters_from_numpy(adapters, "cpu"),
                      device="cpu")
    assert got["ssm"].layout.is_uniform == (ranks == RANKS_U)
    wr, gr = want["report"], got["report"]
    assert gr.nano_history == wr.nano_history == [nano] * 3
    np.testing.assert_allclose(np.stack(gr.per_job_losses),
                               np.stack(wr.per_job_losses), rtol=1e-5)
    _adam_close(_flat(to_numpy(got["adapters"])), _flat(want["adapters"]))
    np.testing.assert_array_equal(got["opt_state"].step.numpy(),
                                  np.asarray(want["opt_state"].step))



@pytest.fixture(scope="module")
def uniform_setup():
    ref_cfg, cfg = _cfgs("float32")
    _, params, adapters = _weights(ref_cfg, seed=7, ranks=RANKS_U)
    specs = _specs(LoRAJobSpec, RANKS_U)
    batcher = FusedBatcher(specs, cfg.vocab_size, block_t=BT)
    batches = [{k: torch.from_numpy(v) for k, v in
                batcher.next_batch().items()} for _ in range(3)]
    return (cfg, params_from_numpy(params, "cpu"), adapters, batches,
            SharedSuperModel(cfg, specs, block_t=BT).layout)


def test_uniform_group_fused_equals_isolated_grads(uniform_setup):
    """A uniform group on the masked kernels: job k's fused gradient
    equals its gradient alone (the masked kernels too), at
    test_lossless.py's 2e-4 relative."""
    cfg, params, adapters, batches, layout = uniform_setup
    assert layout.is_uniform
    specs = _specs(LoRAJobSpec, RANKS_U)
    fused = _port_grads(cfg, specs, "cuda", params,
                        adapters_from_numpy(adapters, "cpu"), batches[0])
    fused_tree = adamw.tree_map(
        lambda _, t, it=iter(fused): next(it),
        adapters_from_numpy(adapters, "cpu"))
    for k, spec in enumerate(specs):
        solo_ad = adamw.tree_map(
            lambda _, t: t.detach().clone(),
            _slice_tree(adapters_from_numpy(adapters, "cpu"), layout, k))
        solo = _port_grads(cfg, [spec], "cuda", params, solo_ad,
                           _job_batch(batches[0], k))
        want = _torch_leaves(_slice_tree(fused_tree, layout, k))
        for w, g in zip(want, solo):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-4,
                                       atol=1e-6)


def test_uniform_group_fused_equals_isolated_trajectory(uniform_setup):
    """3 Adam steps fused vs alone, both on the masked kernels."""
    cfg, params, adapters, batches, layout = uniform_setup
    specs = _specs(LoRAJobSpec, RANKS_U)
    fused_ad, fused_losses = _run_steps(
        cfg, specs, "cuda", params, adapters_from_numpy(adapters, "cpu"),
        batches)
    for k, spec in enumerate(specs):
        solo_ad = _slice_tree(adapters_from_numpy(adapters, "cpu"), layout, k)
        got_ad, got_losses = _run_steps(
            cfg, [spec], "cuda", params,
            adamw.tree_map(lambda _, t: t.clone(), solo_ad),
            [_job_batch(b, k) for b in batches])
        for fl, gl in zip(fused_losses, got_losses):
            np.testing.assert_allclose(fl[k], gl[0], rtol=1e-5, atol=1e-6)
        _adam_close(_flat(to_numpy(got_ad)),
                    _flat(to_numpy(_slice_tree(fused_ad, layout, k))))


def test_uniform_group_adapter_isolation(uniform_setup):
    """Job 0's update in a uniform group does not depend on job 1's data."""
    cfg, params, adapters, batches, layout = uniform_setup
    specs = _specs(LoRAJobSpec, RANKS_U)
    ad_ref, _ = _run_steps(cfg, specs, "cuda", params,
                           adapters_from_numpy(adapters, "cpu"),
                           batches[:1])
    b2 = dict(batches[0])
    rows = b2["adapter_ids"] == 1
    toks = b2["tokens"].clone()
    toks[rows] = (toks[rows] + 17) % cfg.vocab_size
    b2["tokens"], b2["labels"] = toks, toks
    ad_alt, _ = _run_steps(cfg, specs, "cuda", params,
                           adapters_from_numpy(adapters, "cpu"), [b2])
    want = _flat(to_numpy(_slice_tree(ad_ref, layout, 0)))
    got = _flat(to_numpy(_slice_tree(ad_alt, layout, 0)))
    for p in want:
        np.testing.assert_allclose(got[p], want[p], rtol=1e-6, atol=1e-7)


# --------------------------------------------------------- refusals
def test_make_train_step_refuses_what_is_not_ported():
    """On every device: meshes and pipeline stages (ROADMAP queue A,
    multi-GPU).  Uniform layouts and nano batches build."""
    cfg = _cfgs("float32")[1]
    lr = constant(LR)
    ragged = SharedSuperModel(cfg, _specs(LoRAJobSpec), impl="cuda",
                              block_t=BT)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        ragged.make_train_step(lr_fn=lr, mesh=object())
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        ragged.make_train_step(lr_fn=lr, pipeline_stages=2)
    uniform = SharedSuperModel(cfg, _specs(LoRAJobSpec, ranks=(4, 8, 16)),
                               impl="cuda", block_t=BT)
    assert uniform.layout.is_uniform
    uniform.make_train_step(lr_fn=lr, nano_batches=2)
    ragged.make_train_step(lr_fn=lr, nano_batches=2)
