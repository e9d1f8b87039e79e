"""The port's local attention and ring caches (``models/attention.py``)
held against the JAX reference on the CPU: the windowed training path
(``_Flash`` with a window) forward and VJP against ``_make_flash``, the
ring's slot count, its writes, its one-token decode past a wrap against
the reference's, a prompt through a ring against windowed attention, and
reduced recurrentgemma-9b decoding token by token past its 64-key window
against the reference's ``decode_step``.

Inputs are drawn with numpy from fixed seeds and fed to both sides, in
float32.  Tolerances:
  * attention values and gradients: 1e-5 of the tensor's largest
    |value| (the same products; the key chunks are walked in other
    orders);
  * the model's logits over 100 decode steps: 1e-4 of their largest
    |value| (the same function through three layers; the RG-LRU and
    conv states carry the step-to-step rounding differences);
  * ring contents: exact (copies).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.models import model as RM
from repro.models import attention as RA

from repro_torch.configs import get_config
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_numpy

from torch_train_common import one_torch_thread  # noqa: F401

B, H, KV, HD = 2, 4, 2, 32


def _close(got, want, frac):
    w = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), w, rtol=0,
                               atol=frac * max(np.abs(w).max(), 1e-30))


def _qkv(S, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, HD)).astype(np.float32),
            rng.standard_normal((B, S, KV, HD)).astype(np.float32),
            rng.standard_normal((B, S, KV, HD)).astype(np.float32))


# ------------------------------------------------------- training path
@pytest.mark.parametrize("window,chunk", [(64, 32), (16, 128), (None, 32)])
def test_windowed_flash_forward_and_vjp_match_make_flash(window, chunk):
    S = 128
    q, k, v = _qkv(S, 1)
    ct = np.random.default_rng(2).standard_normal(q.shape).astype(
        np.float32)
    f = RA._make_flash(0, S, True, window, chunk)
    want, vjp = jax.vjp(f, *(jnp.asarray(t) for t in (q, k, v)))
    wq, wk, wv = vjp(jnp.asarray(ct))
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    got = A.chunked_attention(tq, tk, tv, q_offset=0, kv_len=S, causal=True,
                              window=window, chunk=chunk)
    (got * torch.from_numpy(ct)).sum().backward()
    _close(got.detach().numpy(), want, 1e-5)
    for g, w in ((tq.grad, wq), (tk.grad, wk), (tv.grad, wv)):
        _close(g.numpy(), w, 1e-5)
    if window is not None:         # the window masks keys at S = 128
        full = RA._make_flash(0, S, True, None, chunk)(
            *(jnp.asarray(t) for t in (q, k, v)))
        assert np.abs(np.asarray(full) - np.asarray(want)).max() > 1e-2


# ---------------------------------------------------------------- rings
def test_ring_caches_hold_min_buf_window_slots():
    """A ring is never rounded up to whole decode chunks: it holds
    min(buf, sliding_window) slots, where a full cache holds whole
    DECODE_CHUNKs."""
    c = A.KVCache.init(2, 64, KV, HD, torch.float32, device="cpu",
                       ring=True)
    assert c.k.shape[1] == 64
    assert A.KVCache.init(2, 64, KV, HD, torch.float32,
                          device="cpu").k.shape[1] == A.DECODE_CHUNK
    rg = get_config("recurrentgemma-9b").reduced()       # window 64
    for buf, slots in ((300, 64), (24, 24)):
        caches = M.init_caches(rg, 2, buf, device="cpu")
        kinds = {j: type(c).__name__ for j, c in caches[0].items()}
        assert kinds == {"0": "RGLRUCache", "1": "RGLRUCache",
                         "2": "KVCache"}
        assert caches[0]["2"].k.shape == (1, 2, slots, rg.num_kv_heads,
                                          rg.head_dim)
        want = RM.init_caches(ref_get_config("recurrentgemma-9b").reduced(),
                              2, buf, ring=False)
        for j in caches[0]:
            for a, b in zip(caches[0][j], want[0][j]):
                assert tuple(a.shape) == tuple(b.shape), j
    tl = get_config("tinyllama-1.1b").reduced()
    assert M.init_caches(tl, 1, 300, True,
                         device="cpu")[0]["0"].k.shape[2] == 64
    assert M.init_caches(tl, 1, 300,
                         device="cpu")[0]["0"].k.shape[2] == 512


def test_ring_update_keeps_the_last_keys():
    """A 20-key prompt into 8 slots leaves positions 12..19, each in
    slot position % 8; a per-row position is refused."""
    cache = A.KVCache.init(1, 8, 1, 1, torch.float32, device="cpu",
                           ring=True)
    k = torch.arange(20, dtype=torch.float32).reshape(1, 20, 1, 1)
    A.cache_update(cache, k, k, 0, ring=True)
    assert cache.k.flatten().tolist() == [16, 17, 18, 19, 12, 13, 14, 15]
    A.cache_update(cache, k[:, :1] + 100, k[:, :1] + 100, 20, ring=True)
    assert cache.k.flatten().tolist()[4] == 100
    with pytest.raises(ValueError, match="per-row"):
        A.cache_update(cache, k[:, :1], k[:, :1], torch.tensor([3]),
                       ring=True)
    with pytest.raises(ValueError, match="per-row"):
        A.ring_attention(k[:, :1], k[:, :1], k[:, :1], cache,
                         torch.tensor([3]))


@pytest.mark.parametrize("pos", [200, 10])
def test_ring_decode_matches_reference(pos):
    """One token at *pos* through a 64-slot ring (full past a wrap at
    pos 200, partly filled at 10): the reference's write and
    count-masked decode, the same output and ring."""
    slots = 64
    rng = np.random.default_rng(pos)
    ring_k = rng.standard_normal((B, slots, KV, HD)).astype(np.float32)
    ring_v = rng.standard_normal((B, slots, KV, HD)).astype(np.float32)
    q, k, v = _qkv(1, pos + 1)
    rc = RA.cache_update(RA.KVCache(jnp.asarray(ring_k),
                                    jnp.asarray(ring_v)),
                         jnp.asarray(k), jnp.asarray(v), pos, ring=True)
    want = RA.decode_attention(jnp.asarray(q), rc, pos, window=None,
                               ring=True)
    cache = A.KVCache(torch.from_numpy(ring_k.copy()),
                      torch.from_numpy(ring_v.copy()))
    got = A.ring_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), cache, pos)
    _close(got.numpy(), want, 1e-5)
    np.testing.assert_array_equal(cache.k.numpy(), np.asarray(rc.k))
    np.testing.assert_array_equal(cache.v.numpy(), np.asarray(rc.v))


@pytest.mark.parametrize("S0,slots", [(24, 64), (100, 64)])
def test_ring_prompt_is_windowed_causal_attention(S0, slots):
    """A prompt of S0 tokens through an empty ring, then 10 more tokens
    at once, then one: each output equals causal attention with the
    ring's window over the whole sequence at its positions (the
    cacheless forward's attention), a prompt longer than the ring
    included; the ring ends holding the last keys."""
    S = S0 + 11
    q, k, v = (torch.from_numpy(t) for t in _qkv(S, 7))
    want = A.chunked_attention(q, k, v, q_offset=0, kv_len=S, causal=True,
                               window=slots, chunk=32)
    cache = A.KVCache.init(B, slots, KV, HD, torch.float32, device="cpu",
                           ring=True)
    outs = [A.ring_attention(q[:, lo:hi], k[:, lo:hi], v[:, lo:hi], cache,
                             lo)
            for lo, hi in ((0, S0), (S0, S0 + 10), (S0 + 10, S))]
    _close(torch.cat(outs, dim=1).numpy(), want.numpy(), 1e-5)
    last = torch.arange(S - min(S, slots), S)
    torch.testing.assert_close(cache.k[:, last % slots], k[:, last],
                               rtol=0, atol=0)


# --------------------------------------------------------------- model
def test_model_decodes_past_the_window_like_reference():
    """Reduced recurrentgemma-9b (rglru, rglru, local_attn; window 64) in
    float32 decodes 100 tokens one at a time from position 0 over caches
    of buf 256 (the local layer's ring: 64 slots, wrapped at 64): logits
    at every step against the reference's ``decode_step``, jitted."""
    rc = dataclasses.replace(ref_get_config("recurrentgemma-9b").reduced(),
                             dtype="float32")
    cfg = dataclasses.replace(get_config("recurrentgemma-9b").reduced(),
                              dtype="float32")
    params = jax.tree.map(np.asarray, RM.init_model(jax.random.PRNGKey(0),
                                                    rc))
    steps = 100
    toks = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (B, steps)).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, params)
    step = jax.jit(lambda t, pos, c: RM.decode_step(rc, jp, None, None, t,
                                                    pos, c))
    rcaches = RM.init_caches(rc, B, 256, ring=False)
    caches = M.init_caches(cfg, B, 256, device="cpu")
    assert caches[0]["2"].k.shape[2] == 64
    tp = params_from_numpy(params, "cpu")
    want, got = [], []
    with torch.no_grad():
        for t in range(steps):
            lg, rcaches = step(jnp.asarray(toks[:, t:t + 1]),
                               jnp.int32(t), rcaches)
            want.append(np.asarray(lg[:, 0]))
            got.append(M.decode_step(cfg, tp, None, None,
                                     torch.from_numpy(toks[:, t:t + 1]), t,
                                     caches)[0][:, 0].numpy())
    _close(np.stack(got), np.stack(want), 1e-4)
