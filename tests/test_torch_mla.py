"""The port's Multi-head Latent Attention (``models/mla.py``) held against
the JAX reference (``repro.models.mla``) on the CPU, and the plain
``_Flash`` at the widths the new families give it.

Reduced deepseek-v2-lite-16b in float32: d_model 256, 4 heads of q/k
width 48 (nope 32 + rope 16) and v width 32, kv_lora 64; weights from
the reference's ``mla_init`` through ``models/convert.py`` with a
nonzero ``kv_norm``.  Inputs are drawn with numpy.  ``mla_block`` in
every mode: train/prefill without a cache; prefill into a full cache and
into a ring; absorbed decode at a scalar position, at per-row positions
and through a ring past its wrap; outputs and caches compared (the
port's full caches hold whole decode chunks, so they are wider than the
reference's; the extra columns stay zero), and the decode's independence
of the cache width.  On the CPU the expand path's attention is the plain
chunk scan (at the card's widths it is the flash kernel: qk 192 / v 128
for deepseek).

Tolerances: 1e-5 absolute on O(1) outputs and caches (the same f32
products, summed in other orders); ``_Flash``'s gradients 1e-4 of the
tensor's largest |value| (the same, through the backward).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.models import model as RM  # noqa: F401  (resolves the import
from repro.models import attention as RA  # cycle of the reference's models)
from repro.models import mla as RMLA

from repro_torch.configs import get_config
from repro_torch.models import attention, mla
from repro_torch.models.convert import params_from_numpy

from torch_train_common import one_torch_thread  # noqa: F401

B, S = 2, 12
ARCH = "deepseek-v2-lite-16b"


def _setup(seed=0):
    rc, pc = (dataclasses.replace(c.reduced(), dtype="float32")
              for c in (ref_get_config(ARCH), get_config(ARCH)))
    params = jax.tree.map(np.asarray, RMLA.mla_init(jax.random.PRNGKey(seed),
                                                    rc))
    rng = np.random.default_rng(seed)
    params["kv_norm"] = (rng.standard_normal(params["kv_norm"].shape)
                         * 0.1).astype(np.float32)
    x = rng.standard_normal((B, S + 4, rc.d_model)).astype(np.float32)
    return rc, pc, params, x


def _pos(pos, S_):
    """(B, S_) positions from an int or a per-row (B,) array."""
    p = np.asarray(pos).reshape(-1, 1) + np.arange(S_)
    return np.broadcast_to(p, (B, S_)).astype(np.int32)


def _run(rc, pc, params, tp, x, pos, cache_j, cache_t, ring):
    """The block at *pos* on both sides; returns (ref out, ref cache,
    port out) with the port's cache updated in place."""
    S_ = x.shape[1]
    pj = jnp.asarray(pos) if np.ndim(pos) else pos
    want, new = RMLA.mla_block(rc, params, jnp.asarray(x),
                               positions=jnp.asarray(_pos(pos, S_)),
                               cache=cache_j, cache_pos=pj, ring=ring)
    pt = torch.from_numpy(np.asarray(pos)) if np.ndim(pos) else pos
    got, same = mla.mla_block(pc, tp, torch.from_numpy(x),
                              positions=torch.from_numpy(_pos(pos, S_)),
                              cache=cache_t, cache_pos=pt, ring=ring)
    assert same is cache_t
    return want, new, got


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(want), rtol=0, atol=atol)


def _close_cache(ct, cj):
    """The port's cache against the reference's: a full cache of the
    port holds whole decode chunks, so it is wider; its extra columns
    stay zero."""
    w = cj.latent.shape[1]
    for got, want in ((ct.latent, cj.latent), (ct.rope, cj.rope)):
        _close(got[:, :w], want)
        assert not got[:, w:].any()


def test_train_path_matches_reference():
    rc, pc, params, x = _setup()
    tp = params_from_numpy(params, "cpu")
    want, _ = RMLA.mla_block(rc, params, jnp.asarray(x[:, :S]),
                             positions=jnp.asarray(_pos(0, S)))
    got, cache = mla.mla_block(pc, tp, torch.from_numpy(x[:, :S]),
                               positions=torch.from_numpy(_pos(0, S)))
    assert cache is None
    _close(got, want)


@pytest.mark.parametrize("decode", ["scalar", "per_row"])
def test_full_cache_prefill_then_absorbed_decode(decode):
    """Prefill S tokens into a 16-slot cache, then four absorbed decode
    steps; per-row positions put the rows at depths S and S - 3."""
    rc, pc, params, x = _setup(1)
    tp = params_from_numpy(params, "cpu")
    cj = RMLA.MLACache.init(B, 16, rc, jnp.float32)
    ct = mla.MLACache.init(B, 16, pc, torch.float32, device="cpu")
    want, cj, got = _run(rc, pc, params, tp, x[:, :S], 0, cj, ct, False)
    _close(got, want)
    _close_cache(ct, cj)
    pos = S if decode == "scalar" else np.array([S, S - 3], np.int32)
    for i in range(4):
        want, cj, got = _run(rc, pc, params, tp, x[:, S + i:S + i + 1], pos,
                             cj, ct, False)
        _close(got, want)
        _close_cache(ct, cj)
        pos = pos + 1


def test_ring_prefill_then_decode_past_the_wrap():
    """A 6-token prompt into an 8-slot ring, then six decode steps at
    positions 6..11: the ring wraps at 8 and keeps the last 8 keys."""
    rc, pc, params, x = _setup(2)
    tp = params_from_numpy(params, "cpu")
    cj = RMLA.MLACache.init(B, 8, rc, jnp.float32)
    ct = mla.MLACache.init(B, 8, pc, torch.float32, device="cpu",
                           ring=True)
    want, cj, got = _run(rc, pc, params, tp, x[:, :6], 0, cj, ct, True)
    _close(got, want)
    _close_cache(ct, cj)
    for pos in range(6, 12):
        want, cj, got = _run(rc, pc, params, tp, x[:, pos:pos + 1], pos, cj,
                             ct, True)
        _close(got, want)
        _close_cache(ct, cj)


def test_ring_refuses_per_row_positions():
    _, pc, params, x = _setup()
    ct = mla.MLACache.init(B, 8, pc, torch.float32, device="cpu",
                           ring=True)
    pos = torch.tensor([3, 4])
    with pytest.raises(ValueError, match="ring"):
        mla.mla_block(pc, params_from_numpy(params, "cpu"),
                      torch.from_numpy(x[:, :1]),
                      positions=pos[:, None], cache=ct, cache_pos=pos,
                      ring=True)


def test_absorbed_decode_row_blocks_leave_products_unchanged():
    """``row_block`` runs the absorbed decode's products a block of rows
    at a time (``_rows_einsum``): on the CPU the same values."""
    rc, pc, params, x = _setup(3)
    tp = params_from_numpy(params, "cpu")
    outs = []
    for rb in (None, 1):
        ct = mla.MLACache.init(B, 16, pc, torch.float32, device="cpu")
        mla.mla_block(pc, tp, torch.from_numpy(x[:, :S]),
                      positions=torch.from_numpy(_pos(0, S)), cache=ct,
                      cache_pos=0)
        outs.append(mla.mla_block(
            pc, tp, torch.from_numpy(x[:, S:S + 1]),
            positions=torch.from_numpy(_pos(S, 1)), cache=ct, cache_pos=S,
            row_block=rb)[0])
    _close(outs[1], outs[0].numpy(), atol=1e-6)


@pytest.mark.parametrize("hd,vd,causal,chunk", [(48, 32, True, 8),
                                                (80, 80, False, 16)])
def test_plain_flash_at_the_new_widths(hd, vd, causal, chunk):
    """``_Flash`` (the plain chunk scan forward on the CPU and the plain
    backward everywhere) against the reference's ``_make_flash``: q/k 48
    with v 32 (reduced MLA), and 80 non-causal (hubert-xlarge's head
    dim), over 20 keys in chunks that pad the last one."""
    rng = np.random.default_rng(hd)
    Bq, Sq, H = 2, 20, 3
    q, k = (rng.standard_normal((Bq, Sq, H, hd)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((Bq, Sq, H, vd)).astype(np.float32)
    do = rng.standard_normal((Bq, Sq, H, vd)).astype(np.float32)
    f = RA._make_flash(0, Sq, causal, None, chunk)
    want, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    want_g = vjp(jnp.asarray(do))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = attention.chunked_attention(qt, kt, vt, q_offset=0, kv_len=Sq,
                                      causal=causal, window=None,
                                      chunk=chunk)
    assert out.shape == (Bq, Sq, H, vd)
    _close(out, want)
    out.backward(torch.from_numpy(do))
    for got, w in zip((qt.grad, kt.grad, vt.grad), want_g):
        w = np.asarray(w)
        _close(got, w, atol=1e-4 * np.abs(w).max())


def test_absorbed_decode_does_not_depend_on_the_cache_width():
    """A full cache holds whole ``DECODE_CHUNK``-key chunks and the
    absorbed decode scans them with an online softmax: a row's decode
    output and its cache are bit-equal in a 256-key and a 768-key cache
    (fused serving sizes caches by the batch's longest prompt)."""
    _, pc, params, x = _setup(4)
    tp = params_from_numpy(params, "cpu")
    outs = []
    for buf in (16, 700):
        ct = mla.MLACache.init(B, buf, pc, torch.float32, device="cpu")
        mla.mla_block(pc, tp, torch.from_numpy(x[:, :S]),
                      positions=torch.from_numpy(_pos(0, S)), cache=ct,
                      cache_pos=0)
        outs.append((mla.mla_block(
            pc, tp, torch.from_numpy(x[:, S:S + 1]),
            positions=torch.from_numpy(_pos(S, 1)), cache=ct,
            cache_pos=torch.tensor([S, S - 2]))[0], ct.latent.shape[1]))
    assert [w for _, w in outs] == [256, 768]
    assert torch.equal(outs[0][0], outs[1][0])
