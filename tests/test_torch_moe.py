"""The port's MoE FFN (``models/moe.py``) held against the JAX reference
(``repro.models.moe``) on the CPU.

Reduced deepseek-v2-lite-16b (4 experts, top-2, 1 shared expert, d_model
256, moe_d_ff 128) and reduced qwen3-moe-30b-a3b (4 experts, top-2, no
shared expert), float32, 2 x 24 tokens drawn with numpy; weights from
the reference's ``moe_init`` through ``models/convert.py``.  Both
dispatches ("ragged", the default, and "capacity", which drops overflow
at capacity factor 1.25).

The routing is asserted equal for every token first: a top-k that flips
between the frameworks is an O(1) difference in that token's output, so
it must show as such and not be averaged away.  Tolerances:
  * out and aux: 1e-5 absolute on O(1) values (the same f32 products,
    summed in other orders);
  * gradients of sum(out · g) + 3 · aux w.r.t. x and the router: 1e-4 of
    the tensor's largest |value| (the same, through the backward);
  * ``_ExpertMM`` at bf16 against per-segment f32 products of the same
    bf16 operands: 2e-2 (its output and dx are rounded to bf16).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.models import model as RM  # noqa: F401  (resolves the import
from repro.models import moe as RMoE  # cycle of the reference's models)

from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.models.convert import params_from_numpy

from torch_train_common import one_torch_thread  # noqa: F401

ARCHS = ("deepseek-v2-lite-16b", "qwen3-moe-30b-a3b")
B, S = 2, 24


def _setup(arch, impl="ragged", seed=0):
    rc, pc = (dataclasses.replace(c.reduced(), dtype="float32",
                                  moe_impl=impl)
              for c in (ref_get_config(arch), get_config(arch)))
    params = jax.tree.map(np.asarray, RMoE.moe_init(jax.random.PRNGKey(seed),
                                                    rc))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, rc.d_model)).astype(np.float32)
    g = rng.standard_normal((B, S, rc.d_model)).astype(np.float32)
    return rc, pc, params, x, g


def _ref_route(rc, params, x):
    probs = jax.nn.softmax(jnp.asarray(x).reshape(-1, rc.d_model)
                           @ jnp.asarray(params["router"]), axis=-1)
    return np.asarray(jax.lax.top_k(probs, rc.num_experts_per_tok)[1])


@pytest.mark.parametrize("impl", ["ragged", "capacity"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_reference(arch, impl):
    rc, pc, params, x, g = _setup(arch, impl)
    tp = params_from_numpy(params, "cpu")
    _, _, top_i = moe.route(pc, tp, torch.from_numpy(x).reshape(-1,
                                                                pc.d_model))
    np.testing.assert_array_equal(top_i.numpy(), _ref_route(rc, params, x))

    def ref_loss(xj, router):
        out, aux = RMoE.moe_ffn(rc, dict(params, router=router), xj)
        return (out * jnp.asarray(g)).sum() + 3.0 * aux, (out, aux)

    (_, (want_out, want_aux)), (gx, gr) = jax.value_and_grad(
        ref_loss, argnums=(0, 1), has_aux=True)(
            jnp.asarray(x), jnp.asarray(params["router"]))

    xt = torch.from_numpy(x).requires_grad_()
    tp["router"].requires_grad_()
    out, aux = moe.moe_ffn(pc, tp, xt)
    ((out * torch.from_numpy(g)).sum() + 3.0 * aux).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=0,
                               atol=1e-5)
    assert aux.item() > 0
    for got, want in ((xt.grad, gx), (tp["router"].grad, gr)):
        w = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())


def test_capacity_drops_overflow_as_the_reference():
    """At capacity factor 0.5 half of the (token, expert) pairs cannot
    fit: the dropped pairs add nothing, in both packages alike."""
    arch = "qwen3-moe-30b-a3b"
    rc, pc, params, x, _ = _setup(arch, "capacity", seed=3)
    rc = dataclasses.replace(rc, moe_capacity_factor=0.5)
    pc = dataclasses.replace(pc, moe_capacity_factor=0.5)
    want, _ = RMoE.moe_ffn(rc, params, jnp.asarray(x))
    got, _ = moe.moe_ffn(pc, params_from_numpy(params, "cpu"),
                         torch.from_numpy(x))
    full, _ = moe.moe_ffn(dataclasses.replace(pc, moe_impl="ragged"),
                          params_from_numpy(params, "cpu"),
                          torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert not torch.allclose(got, full, atol=1e-3)


def test_expert_products_take_bf16_segments():
    """``_ExpertMM`` at bf16 (the card's dtype) against one product per
    expert segment, forward and dx, with an empty expert."""
    rng = np.random.default_rng(1)
    sizes = [5, 0, 9, 2]
    x = torch.from_numpy(rng.standard_normal((16, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 32, 48)).astype(np.float32))
    xb, wb = x.bfloat16().requires_grad_(), w.bfloat16()
    offs = torch.tensor(np.cumsum(sizes), dtype=torch.int32)
    y = moe._ExpertMM.apply(xb, wb, offs)
    dy = torch.from_numpy(rng.standard_normal((16, 48)).astype(np.float32))
    (y.float() * dy).sum().backward()
    ends = np.cumsum(sizes)
    starts = ends - sizes
    want = torch.cat([xb[s:e].float() @ wb[i].float()
                      for i, (s, e) in enumerate(zip(starts, ends))])
    want_dx = torch.cat([dy[s:e].bfloat16().float() @ wb[i].float().T
                         for i, (s, e) in enumerate(zip(starts, ends))])
    np.testing.assert_allclose(y.float().detach().numpy(),
                               want.detach().numpy(),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(xb.grad.float().numpy(), want_dx.numpy(),
                               rtol=2e-2, atol=2e-2)


def test_mesh_dispatch_is_refused():
    """The reference's expert-parallel dispatch: each model rank's (T, d)
    partial over its E/m experts (``_expert_parallel_moe`` with a
    ``ModelAxis`` of 2, no collective inside it), summed over the two
    ranks, is the single-device dispatch, for either impl (the capacity
    dispatch's slots and drops are the dense one's at the same C).  A
    device mesh itself is refused: the dispatch takes the model axis
    (``tp=``), not a mesh."""
    from repro_torch.models.layers import ModelAxis
    for impl in ("ragged", "capacity"):
        _, pc, params, x, _ = _setup("qwen3-moe-30b-a3b", impl)
        tp_ = params_from_numpy(params, "cpu")
        xf = torch.from_numpy(x).reshape(-1, pc.d_model)
        E, k, T, d = pc.num_experts, pc.num_experts_per_tok, xf.shape[0], \
            pc.d_model
        _, top_w, top_i = moe.route(pc, tp_, xf)
        flat_e = top_i.reshape(-1)
        whole = (moe._capacity_moe_dense if impl == "capacity"
                 else moe._ragged_moe)
        if impl == "capacity":
            want = whole(pc, tp_, xf, flat_e, top_w, E, k, T, d, xf.dtype)
        else:
            want = whole(tp_, xf, flat_e, top_w, E, k, T, d, xf.dtype)
        got = sum(moe._expert_parallel_moe(
            pc, dict(tp_, w_in=tp_["w_in"][r * E // 2:(r + 1) * E // 2],
                     w_out=tp_["w_out"][r * E // 2:(r + 1) * E // 2]),
            xf, flat_e, top_w, E, k, T, d, xf.dtype, ModelAxis(None, 2, r))
            for r in range(2))
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5)
        with pytest.raises(TypeError):
            moe.moe_ffn(pc, tp_, torch.from_numpy(x), mesh=object())


def test_router_logits_do_not_depend_on_the_batch():
    """The router's f32 products take ROUTER_ROWS rows each, the last
    block zero-padded: the logits of a token's row are bit-equal whether
    its batch has 1000 or 2600 rows, and equal the plain product."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2600, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
    full = moe._router_logits(x, w)
    assert full.shape == (2600, 8)
    assert torch.equal(moe._router_logits(x[:1000], w), full[:1000])
    np.testing.assert_allclose(full.numpy(), (x @ w).numpy(), rtol=0,
                               atol=1e-4)
