"""The port's RG-LRU block (``models/rglru.py``) and the activations it
uses (``models/layers.py``) held against the JAX reference on the CPU:
the log-depth scan with and without an initial state, the Lambda init,
the whole block (forward, gradients, and the one-token decode against
the scan's continuation).

Inputs are drawn with numpy from fixed seeds and fed to both sides;
weights come from the reference's ``rglru_init`` through
``models/convert.py``.  Reduced recurrentgemma-9b (width 256) in
float32, S = 128.  Tolerances:
  * the scan: 1e-5 of the largest |h| (the port's Hillis-Steele tree
    and JAX's associative_scan add the same terms in other orders, at
    most log2 S + 1 roundings each);
  * block forward values: 1e-5 absolute on O(1) values;
  * gradients: 1e-4 of the tensor's largest |value|;
  * the decode against the scan's continuation, within the port: 1e-5;
  * activations: gelu (tanh form) 1e-6 relative plus 1e-6 absolute
    (its far negative tail, ~1e-4, comes from other tanh routines);
    softplus 1e-6 relative; the softplus gradient 1e-6.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.models import model as RM  # noqa: F401  (import order)
from repro.models import layers as RL
from repro.models import rglru as RG

from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import rglru as G
from repro_torch.models.convert import params_from_numpy

from torch_train_common import one_torch_thread  # noqa: F401

SEQ = 128


def _cfgs():
    return (dataclasses.replace(ref_get_config("recurrentgemma-9b")
                                .reduced(), dtype="float32"),
            dataclasses.replace(get_config("recurrentgemma-9b").reduced(),
                                dtype="float32"))


def _params(ref_cfg, seed=0):
    p = jax.tree.map(np.asarray, RG.rglru_init(jax.random.PRNGKey(seed),
                                               ref_cfg))
    rng = np.random.default_rng(seed)
    w = ref_cfg.lru_width
    p["b_a"] = (rng.standard_normal(w) * 0.5).astype(np.float32)
    p["b_i"] = (rng.standard_normal(w) * 0.5).astype(np.float32)
    return p


def _close(got, want, frac):
    w = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), w, rtol=0,
                               atol=frac * max(np.abs(w).max(), 1e-30))


# ---------------------------------------------------------- activations
def test_activations_match_jax():
    x = np.linspace(-30.0, 30.0, 601, dtype=np.float32)
    t = torch.from_numpy(x).requires_grad_()
    np.testing.assert_allclose(L.gelu(t).detach().numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    sp = L.softplus(t)
    np.testing.assert_allclose(sp.detach().numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=0)
    sp.sum().backward()
    want = np.asarray(jax.grad(lambda a: jax.nn.softplus(a).sum())(
        jnp.asarray(x)))
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=0, atol=1e-6)


def test_grad_cast_casts_the_cotangent():
    x = torch.ones(3, dtype=torch.bfloat16, requires_grad=True)
    y = L.grad_cast(x)
    assert torch.equal(y, x)
    (y.float() * torch.tensor([1.0, 1.0 / 3, 2.0])).sum().backward()
    assert x.grad.dtype == torch.bfloat16
    want = RL.grad_cast(jnp.ones(3, jnp.bfloat16))
    assert str(want.dtype) == "bfloat16"


# ----------------------------------------------------------------- scan
@pytest.mark.parametrize("S", [SEQ, 100, 1])
@pytest.mark.parametrize("with_h0", [False, True])
def test_lru_scan_matches_reference(S, with_h0):
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, (2, S, 64)).astype(np.float32)
    b = rng.standard_normal((2, S, 64)).astype(np.float32)
    h0 = rng.standard_normal((2, 64)).astype(np.float32) if with_h0 \
        else None
    want = jax.jit(RG._lru_scan)(jnp.asarray(a), jnp.asarray(b),
                                 None if h0 is None else jnp.asarray(h0))
    got = G._lru_scan(torch.from_numpy(a), torch.from_numpy(b),
                      None if h0 is None else torch.from_numpy(h0))
    _close(got.numpy(), want, 1e-5)
    # the scan is the recurrence
    h = np.zeros((2, 64), np.float32) if h0 is None else h0
    for t in range(S):
        h = a[:, t] * h + b[:, t]
    _close(got[:, -1].numpy(), h, 1e-5)


def test_rglru_init_draws_the_reference_distribution():
    """a^c = sqrt(u), u ~ U(0.9^2, 0.999^2): the decay at r = 1 lies in
    (0.9, 0.999), spread across it, on both sides."""
    ref_cfg, cfg = _cfgs()
    g = torch.Generator().manual_seed(0)
    p = G.rglru_init(cfg, torch.float32, generator=g, device="cpu",
                     layers=2)
    want = RG.rglru_init(jax.random.PRNGKey(0), ref_cfg)
    assert p["lam"].shape == (2, cfg.lru_width)
    for lam in (p["lam"].numpy(), np.asarray(want["lam"])):
        ac = np.exp(-G._C * np.log1p(np.exp(lam)))
        assert ac.min() > 0.9 - 1e-6 and ac.max() < 0.999 + 1e-6
        assert ac.min() < 0.92 and ac.max() > 0.99
    for k, v in want.items():
        assert tuple(p[k].shape[1:]) == tuple(v.shape), k


# ---------------------------------------------------------------- block
def test_rglru_block_forward_and_gradients_match_reference():
    ref_cfg, cfg = _cfgs()
    p = _params(ref_cfg)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, SEQ, cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal((2, SEQ, cfg.d_model)).astype(np.float32)

    def ref_f(xx, pp):
        y, _ = RG.rglru_block(ref_cfg, pp, xx)
        return (y * ct).sum(), y

    (_, want), (wgx, wgp) = jax.jit(jax.value_and_grad(
        ref_f, argnums=(0, 1), has_aux=True))(
        jnp.asarray(x), jax.tree.map(jnp.asarray, p))
    tp = {k: v.requires_grad_() for k, v in params_from_numpy(
        p, "cpu").items()}
    tx = torch.from_numpy(x).requires_grad_()
    got, _ = G.rglru_block(cfg, tp, tx)
    (got * torch.from_numpy(ct)).sum().backward()
    _close(got.detach().numpy(), want, 1e-5)
    _close(tx.grad.numpy(), wgx, 1e-4)
    assert wgp.keys() == tp.keys()
    for k in wgp:
        _close(tp[k].grad.numpy(), wgp[k], 1e-4)


def test_rglru_block_decode_continues_the_scan():
    """Prefill 20 tokens into a cache, then decode 4 one at a time: each
    output equals the cacheless block over all 24 at its position, and
    the reference's own cached decode."""
    ref_cfg, cfg = _cfgs()
    p = _params(ref_cfg, seed=5)
    tp = params_from_numpy(p, "cpu")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    tx = torch.from_numpy(x)
    cache = G.RGLRUCache.init(2, cfg, device="cpu")
    with torch.no_grad():
        full, _ = G.rglru_block(cfg, tp, tx)
        out, c = G.rglru_block(cfg, tp, tx[:, :20], cache=cache)
        assert c is cache
        steps = [out] + [G.rglru_block(cfg, tp, tx[:, t:t + 1],
                                       cache=cache)[0]
                         for t in range(20, 24)]
    got = torch.cat(steps, dim=1).numpy()
    _close(got, full.numpy(), 1e-5)
    rcache = RG.RGLRUCache.init(2, ref_cfg)
    jp = jax.tree.map(jnp.asarray, p)
    block = jax.jit(lambda xx, c: RG.rglru_block(ref_cfg, jp, xx, cache=c))
    ys = []
    for lo, hi in ((0, 20),) + tuple((t, t + 1) for t in range(20, 24)):
        y, rcache = block(jnp.asarray(x[:, lo:hi]), rcache)
        ys.append(np.asarray(y))
    _close(got, np.concatenate(ys, axis=1), 1e-5)
    _close(cache.h.numpy(), rcache.h, 1e-5)
    _close(cache.conv.numpy(), rcache.conv, 1e-6)
