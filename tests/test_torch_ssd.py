"""The port's Mamba-2 SSD mixer (``models/ssd.py``) held against the JAX
reference (``repro.models.ssd``) on the CPU: the causal conv, the
segment-sum decay, the chunked scan with an initial state, the whole
block (forward, gradients, and the one-token decode against the scan's
continuation), and ROADMAP C7, the reference's NaN gradient at full
width.

Inputs are drawn with numpy from fixed seeds and fed to both sides;
weights come from the reference's ``ssd_init`` through
``models/convert.py``.  Reduced mamba2-2.7b (d_model 256, 32 heads of
16, state 16, chunk 32) in float32 unless stated, S = 128 (four
chunks).  Tolerances:
  * forward values: 1e-5 absolute on O(1) values (the same f32 products,
    summed in other orders);
  * gradients: 1e-4 of the tensor's largest |value| (the same, through
    the backward);
  * the decode against the scan's continuation, within the port: 1e-4
    (the recurrent and the chunked forms sum the same terms in other
    orders);
  * bf16 conv: exact (both sides multiply and add in bf16 in the same
    order);
  * C7 at full width: the port's input gradient against the reference's
    with the mask applied before ``exp`` (monkeypatched for that test
    only): 1e-3 of its largest |value|, sums over 12368-wide products.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.models import model as RM  # noqa: F401  (resolves the import
from repro.models import ssd as RS    # cycle of the reference's models)

from repro_torch.configs import get_config
from repro_torch.models import ssd as S
from repro_torch.models.convert import params_from_numpy

from torch_train_common import one_torch_thread  # noqa: F401

SEQ = 128


def _cfgs(dtype="float32", reduced=True):
    ref, port = ref_get_config("mamba2-2.7b"), get_config("mamba2-2.7b")
    if reduced:
        ref, port = ref.reduced(), port.reduced()
    return (dataclasses.replace(ref, dtype=dtype),
            dataclasses.replace(port, dtype=dtype))


def _params(ref_cfg, seed=0):
    p = jax.tree.map(np.asarray, RS.ssd_init(jax.random.PRNGKey(seed),
                                             ref_cfg))
    rng = np.random.default_rng(seed)
    # nonzero D, dt_bias and A_log, so every term of the block counts
    H = ref_cfg.ssm_nheads
    p["A_log"] = (rng.standard_normal(H) * 0.5).astype(np.float32)
    p["D"] = (1.0 + rng.standard_normal(H) * 0.1).astype(np.float32)
    p["dt_bias"] = (rng.standard_normal(H) * 0.5).astype(np.float32)
    return p


def _close(got, want, frac):
    w = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), w, rtol=0,
                               atol=frac * max(np.abs(w).max(), 1e-30))


# ---------------------------------------------------------------- units
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv_matches_reference(dtype, with_tail):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 24, 40)).astype(np.float32)
    w = rng.standard_normal((4, 40)).astype(np.float32)
    tail = rng.standard_normal((2, 3, 40)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = RS._causal_conv(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                           jnp.asarray(tail, jdt) if with_tail else None)
    got = S._causal_conv(torch.from_numpy(x).to(tdt),
                         torch.from_numpy(w).to(tdt),
                         torch.from_numpy(tail).to(tdt) if with_tail
                         else None)
    assert got.dtype == tdt
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_segsum_decay_values_and_gradient():
    """The lower triangle and the zeros above it are the reference's;
    where the upper triangle would overflow (dt summing past 88 over the
    chunk), the port's gradient stays finite and the reference's is
    NaN."""
    rng = np.random.default_rng(2)
    dA = -np.abs(rng.standard_normal((3, 32))).astype(np.float32)
    cs = np.cumsum(dA, axis=-1)
    want = RS._segsum_decay(jnp.asarray(cs))
    got = S._segsum_decay(torch.from_numpy(cs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)
    assert np.all(np.triu(got.numpy()[0], 1) == 0)
    big = np.cumsum(np.full((1, 32), -4.0, np.float32), axis=-1)  # 128
    g = jax.grad(lambda c: RS._segsum_decay(c).sum())(jnp.asarray(big))
    assert np.isnan(np.asarray(g)).any()
    t = torch.from_numpy(big).requires_grad_()
    S._segsum_decay(t).sum().backward()
    assert torch.isfinite(t.grad).all()


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_scan_matches_reference(with_state):
    ref_cfg, cfg = _cfgs()
    B, H, P, N = 2, cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, SEQ, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, SEQ, H)))).astype(
        np.float32) * 0.3
    A = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    Bm = rng.standard_normal((B, SEQ, H, N)).astype(np.float32)
    Cm = rng.standard_normal((B, SEQ, H, N)).astype(np.float32)
    s0 = (rng.standard_normal((B, H, P, N)).astype(np.float32)
          if with_state else None)
    wy, ws = RS.ssd_scan(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)),
                         cfg.ssm_chunk,
                         init_state=None if s0 is None else jnp.asarray(s0))
    gy, gs = S.ssd_scan(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)),
                        cfg.ssm_chunk,
                        init_state=None if s0 is None
                        else torch.from_numpy(s0))
    _close(gy.numpy(), wy, 1e-5)
    _close(gs.numpy(), ws, 1e-5)


def test_ssd_scan_refuses_partial_chunks():
    x = torch.zeros((1, 48, 2, 4))
    with pytest.raises(ValueError, match="whole chunks"):
        S.ssd_scan(x, torch.zeros((1, 48, 2)), torch.zeros(2),
                   torch.zeros((1, 48, 2, 3)), torch.zeros((1, 48, 2, 3)),
                   32)


# ---------------------------------------------------------------- block
def _block_grads(ref_cfg, cfg, p, x, ct):
    """(ref out, ref grads, port out, port grads) of sum(out * ct) with
    respect to x and every float param."""
    def ref_f(xx, pp):
        y, _ = RS.ssd_block(ref_cfg, pp, xx)
        return (y.astype(jnp.float32) * ct).sum(), y

    (_, want), (wgx, wgp) = jax.jit(jax.value_and_grad(
        ref_f, argnums=(0, 1), has_aux=True))(
        jnp.asarray(x), jax.tree.map(jnp.asarray, p))
    tp = {k: v.requires_grad_() for k, v in params_from_numpy(
        p, "cpu").items()}
    tx = torch.from_numpy(x).requires_grad_()
    got, _ = S.ssd_block(cfg, tp, tx)
    (got.float() * torch.from_numpy(ct)).sum().backward()
    return want, (wgx, wgp), got, (tx.grad, {k: v.grad for k, v in
                                             tp.items()})


def test_ssd_block_forward_and_gradients_match_reference():
    ref_cfg, cfg = _cfgs()
    p = _params(ref_cfg)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, SEQ, cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal((2, SEQ, cfg.d_model)).astype(np.float32)
    want, (wgx, wgp), got, (ggx, ggp) = _block_grads(ref_cfg, cfg, p, x, ct)
    _close(got.detach().numpy(), want, 1e-5)
    _close(ggx.numpy(), wgx, 1e-4)
    assert ggp.keys() == wgp.keys()
    for k in wgp:
        _close(ggp[k].numpy(), wgp[k], 1e-4)


def test_ssd_block_decode_continues_the_scan():
    """Prefill 32 tokens into a cache, then decode 4 one at a time: each
    output equals the cacheless block over all 36 tokens (chunk 4) at
    its position, and the reference's own cached decode."""
    ref_cfg, cfg = _cfgs()
    p = _params(ref_cfg, seed=5)
    tp = params_from_numpy(p, "cpu")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 36, cfg.d_model)).astype(np.float32)
    tx = torch.from_numpy(x)
    cache = S.SSDCache.init(2, cfg, device="cpu")
    rcache = RS.SSDCache.init(2, ref_cfg)
    with torch.no_grad():
        full, _ = S.ssd_block(cfg, tp, tx, chunk=4)
        out, c = S.ssd_block(cfg, tp, tx[:, :32], cache=cache)
        assert c is cache
        steps = [out]
        for t in range(32, 36):
            steps.append(S.ssd_block(cfg, tp, tx[:, t:t + 1],
                                     cache=cache)[0])
    got = torch.cat(steps, dim=1).numpy()
    _close(got, full.numpy(), 1e-4)
    jp = jax.tree.map(jnp.asarray, p)
    block = jax.jit(lambda xx, c: RS.ssd_block(ref_cfg, jp, xx, cache=c))
    ys = []
    for lo, hi in ((0, 32),) + tuple((t, t + 1) for t in range(32, 36)):
        y, rcache = block(jnp.asarray(x[:, lo:hi]), rcache)
        ys.append(np.asarray(y))
    _close(got, np.concatenate(ys, axis=1), 1e-5)
    _close(cache.state.numpy(), rcache.state, 1e-5)
    _close(cache.conv.numpy(), rcache.conv, 1e-6)


# ------------------------------------------------------------------ C7
def test_full_width_gradient_c7(monkeypatch):
    """One mamba2-2.7b ssd_block at full width (d_model 2560, in_proj
    2560 -> 12368, 80 heads, state 128), B = 1, S = 128 (one chunk),
    float32: dt sums past 88 over the chunk, so the reference's exp of
    the unmasked upper triangle overflows and its input gradient is NaN
    (asserted, so that a repair upstream shows here).  The port's is
    finite, and equal to the reference's with the mask applied first."""
    ref_cfg, cfg = _cfgs(reduced=False)
    p = jax.tree.map(np.asarray, RS.ssd_init(jax.random.PRNGKey(0),
                                             ref_cfg))
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, cfg.ssm_chunk, cfg.d_model)).astype(
        np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)

    def ref_grad():
        f = lambda xx, pp: (RS.ssd_block(ref_cfg, pp, xx)[0] * ct).sum()
        return np.asarray(jax.jit(jax.grad(f))(
            jnp.asarray(x), jax.tree.map(jnp.asarray, p)))

    g_nan = ref_grad()
    assert np.isnan(g_nan).all()

    def masked_first(dA_cs):
        L = dA_cs.shape[-1]
        diff = dA_cs[..., :, None] - dA_cs[..., None, :]
        mask = jnp.tril(jnp.ones((L, L), bool))
        return jnp.where(mask, jnp.exp(jnp.where(mask, diff, 0.0)), 0.0)

    monkeypatch.setattr(RS, "_segsum_decay", masked_first)
    want = ref_grad()
    tx = torch.from_numpy(x).requires_grad_()
    y, _ = S.ssd_block(cfg, params_from_numpy(p, "cpu"), tx)
    (y * torch.from_numpy(ct)).sum().backward()
    got = tx.grad.numpy()
    assert np.isfinite(got).all() and np.isfinite(want).all()
    _close(got, want, 1e-3)
