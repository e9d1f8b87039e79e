"""The port's training kernels held against the JAX reference on the CPU:
the ragged backward kernels (dgrad, xa, dxa, wgrad), the ragged autograd
Function, and the flash-attention Function with its lse.

Both sides get the same inputs, drawn with a seeded numpy RNG.  On a CPU
tensor every port wrapper runs its plain PyTorch version; the JAX side
runs the Pallas kernels in interpret mode and the flash custom VJP, as
the reference's own tests do.  Tolerances:
  * f32 inputs (the algorithm under test): 1e-5 relative, and 1e-5 of
    the largest |value| absolute — the two sides sum the same products in
    another order, and a gradient summed over many tokens carries a few
    f32 ulps of its largest terms into its small entries;
  * bf16 inputs (the rounding points under test): 2e-2 relative, and 2e-2
    of the largest |value| absolute — one bf16 ulp (2^-8 relative) of a
    masked intermediate (xa, dxa, p, ds) may round the other way when
    the f32 sums before it differ in their last bits;
  * entries the reference leaves undefined (other segments of xa and
    dxa): the port's must be exactly zero.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import lora as ref_lora
from repro.kernels import ops as ref_ops
from repro.kernels import ragged as ref_ragged
from repro.models import attention as ref_attn

from repro_torch.core import lora
from repro_torch.kernels import flash_attention, fused_lora, ops, ragged
from repro_torch.models import attention

RANKS = (4, 8, 20, 3)
TILE_LAYOUTS = [(0, 0, 1, 2, 2, 2, 3), (3, 1, 1, 0), (2,), (0, 1, 2, 3),
                (1, 1, 3, 3, 3)]          # last: adapters 0 and 2 own none
BLOCK_T, D_IN, D_OUT = 8, 32, 48


def _tol(dtype, want):
    """(rtol, atol) of the file's stated tolerances for *want*."""
    scale = max(float(np.abs(want).max()), 1.0)
    if dtype == "float32":
        return 1e-5, 1e-5 * scale
    return 2e-2, 2e-2 * scale


def _close(got: torch.Tensor, want, dtype):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    rtol, atol = _tol(dtype, want)
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               rtol=rtol, atol=atol)


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor."""
    j = jnp.asarray(a)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype == "bfloat16":
        return j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


def _case(tile_jobs, dtype, seed):
    """Packed pair with dead lanes zero, activations and cotangents, on
    both sides, plus both sides' metadata."""
    rng = np.random.default_rng(seed)
    lay = ref_lora.RankLayout(RANKS, 8)
    act = np.asarray(lay.active_cols)
    A = (rng.standard_normal((D_IN, lay.total)) * act[None]).astype(np.float32)
    B = (rng.standard_normal((lay.total, D_OUT)) * act[:, None] * 0.5
         ).astype(np.float32)
    T = len(tile_jobs) * BLOCK_T
    x = rng.standard_normal((T, D_IN)).astype(np.float32)
    dy = rng.standard_normal((T, D_OUT)).astype(np.float32)
    j, t = zip(*(_pair(a, dtype) for a in (x, A, B, dy)))
    metas = (ref_ragged.RaggedMeta.build(tile_jobs, lay),
             ragged.RaggedMeta.build(tile_jobs, lora.RankLayout(RANKS, 8)))
    return j, t, metas


def _own_segments(tile_jobs):
    """(T, R) bool: the packed columns of each token's own adapter."""
    lay = lora.RankLayout(RANKS, 8)
    mask = np.zeros((len(tile_jobs) * BLOCK_T, lay.total), bool)
    for i, k in enumerate(tile_jobs):
        off, rp = lay.slice_of(k)
        mask[i * BLOCK_T:(i + 1) * BLOCK_T, off:off + rp] = True
    return mask


# ------------------------------------------------------------ kernels
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tile_jobs", TILE_LAYOUTS)
def test_dgrad_plain_matches_pallas(tile_jobs, dtype):
    (xj, Aj, Bj, dyj), (xt, At, Bt, dyt), (mj, mt) = _case(tile_jobs, dtype, 1)
    want = ref_ragged.ragged_lora_dgrad(dyj, Aj, Bj, mj, block_t=BLOCK_T,
                                        interpret=True)
    got = ragged.ragged_lora_dgrad(dyt, At, Bt, mt, block_t=BLOCK_T)
    assert got.dtype == torch.float32 and got.shape == (len(xt), D_IN)
    _close(got, want, dtype)


@pytest.mark.parametrize("which", ["xa", "dxa"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tile_jobs", TILE_LAYOUTS)
def test_packed_xa_dxa_plain_match_pallas(tile_jobs, dtype, which):
    (xj, Aj, Bj, dyj), (xt, At, Bt, dyt), (mj, mt) = _case(tile_jobs, dtype, 2)
    if which == "xa":
        want = ref_ragged.ragged_xa(xj, Aj, mj, block_t=BLOCK_T,
                                    interpret=True)
        got = ragged.ragged_xa(xt, At, mt, block_t=BLOCK_T)
    else:
        want = ref_ragged.ragged_dxa(dyj, Bj, mj, block_t=BLOCK_T,
                                     interpret=True)
        got = ragged.ragged_dxa(dyt, Bt, mt, block_t=BLOCK_T)
    assert got.dtype == xt.dtype and got.shape == (len(xt), mt.total_r)
    own = _own_segments(tile_jobs)
    # only the token's own segment is defined by the reference
    _close(got[torch.from_numpy(own)],
           np.asarray(jnp.asarray(want, jnp.float32))[own], dtype)
    assert not got[torch.from_numpy(~own)].any()


@pytest.mark.parametrize("operand", ["dB", "dA"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tile_jobs", TILE_LAYOUTS)
def test_wgrad_plain_matches_pallas(tile_jobs, dtype, operand):
    """u is the packed operand (xa or dxa) with the reference's own zeros
    outside each token's segment; rows of adapters without tiles are
    zero on both sides."""
    (xj, Aj, Bj, dyj), (xt, At, Bt, dyt), (mj, mt) = _case(tile_jobs, dtype, 3)
    own = _own_segments(tile_jobs)
    if operand == "dB":
        u = ragged.ragged_xa(xt, At, mt, block_t=BLOCK_T)
        vj, vt = dyj, dyt
    else:
        u = ragged.ragged_dxa(dyt, Bt, mt, block_t=BLOCK_T)
        vj, vt = xj, xt
    uj = jnp.asarray(u.float().numpy() * own).astype(vj.dtype)
    want = ref_ragged.ragged_wgrad(uj, vj, mj, block_t=BLOCK_T,
                                   interpret=True)
    got = ragged.ragged_wgrad(u, vt, mt, block_t=BLOCK_T)
    assert got.dtype == torch.float32 and got.shape == (mt.total_r,
                                                        vt.shape[1])
    _close(got, want, dtype)
    empty = ~np.asarray(mt.visited_rows)
    assert not got[torch.from_numpy(empty)].any()


def test_wgrad_runs_fold_the_wgrad_flat_order():
    """The wgrad kernel's walk covers exactly the token tiles of
    ``wgrad_flat``, in order: the device tables it reads (each tile's
    adapter; each adapter's first packed column and padded width) name,
    for every rank tile of ``wgrad_flat``, its adapter's tiles, and the
    pieces it cuts them into (``piece_start`` in csrc/lora_tile.cuh:
    ``wgrad_pieces``'s rule) hold those tiles in tile order.  An
    adapter with no tile has no piece."""
    lay = lora.RankLayout((8, 16, 40, 3), 16)
    meta = ragged.RaggedMeta.build((0, 0, 2, 2, 2, 1, 2, 0), lay)
    tile_jobs, seg = (t.numpy() for t in ragged._device_wgrad_tables(
        meta, torch.device("cpu")))
    assert tile_jobs.tolist() == list(meta.tile_jobs)
    pieces = fused_lora.wgrad_pieces(tile_jobs.tolist())
    tile, rtile, _ = meta.wgrad_flat
    for k, (off, width) in enumerate(seg.tolist()):
        assert (off, width) == (lay.offsets[k], lay.r_pads[k])
        walked = [t for t0, t1, pk in pieces if pk == k
                  for t in range(t0, t1)]
        for rt in range(off // meta.r_blk, (off + width) // meta.r_blk):
            assert walked == tile[rtile == rt].tolist(), (k, rt)
    # adapter 3 (rank 3) owns no tile: no piece
    assert not [p for p in pieces if p[2] == 3]
    assert not (rtile == lay.offsets[3] // meta.r_blk).any()


# ------------------------------------------------ the ragged Function
_ROWS, _SEQ = (2, 1, 1, 2), 8


def _lora_inputs(dtype, seed=5):
    rng = np.random.default_rng(seed)
    lay = ref_lora.RankLayout(RANKS, 8)
    act = np.asarray(lay.active_cols)
    A = (rng.standard_normal((D_IN, lay.total)) * act[None]).astype(np.float32)
    B = (rng.standard_normal((lay.total, D_OUT)) * act[:, None] * 0.5
         ).astype(np.float32)
    ids = np.repeat(np.arange(len(RANKS)), np.asarray(_ROWS) * _SEQ
                    ).astype(np.int32)
    x = rng.standard_normal((len(ids), D_IN)).astype(np.float32)
    w = rng.standard_normal((len(ids), D_OUT)).astype(np.float32)
    scal = (16.0 / np.asarray(RANKS)).astype(np.float32)
    return lay, x, A, B, ids, w, scal


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_function_grads_match_jax(dtype):
    lay, x, A, B, ids, w, scal = _lora_inputs(dtype)

    def ref_loss(x, A, B):
        y = ref_ops.fused_lora_ragged(
            x, A, B, jnp.asarray(ids), jnp.asarray(scal), lay,
            impl="pallas", block_t=BLOCK_T, slice_rows=_ROWS, seq_len=_SEQ,
            solo_rows=_ROWS)
        return (y.astype(jnp.float32) * jnp.asarray(w)).sum()

    (xj, xt), (Aj, At), (Bj, Bt) = (_pair(a, dtype) for a in (x, A, B))
    want = jax.grad(ref_loss, argnums=(0, 1, 2))(xj, Aj, Bj)
    xt, At, Bt = (t.requires_grad_() for t in (xt, At, Bt))
    sc = torch.from_numpy(scal).requires_grad_()
    y = ops.fused_lora_ragged(xt, At, Bt, torch.from_numpy(ids), sc,
                              lora.RankLayout(RANKS, 8), impl="cuda",
                              block_t=BLOCK_T, slice_rows=_ROWS,
                              seq_len=_SEQ)
    y.backward(torch.from_numpy(w).to(y.dtype))
    for got, ref in zip((xt.grad, At.grad, Bt.grad), want):
        assert got.dtype == xt.dtype
        _close(got, ref, dtype)
    assert sc.grad is None            # scalings are constants: no gradient


def test_ragged_function_backward_runs_the_four_plain_kernels(monkeypatch):
    """On a CPU tensor the backward goes through B2-B5's plain versions
    (dgrad once, xa once, dxa once, wgrad twice), not through autograd
    of the plain forward."""
    calls = []
    for name in ("ragged_lora_dgrad_plain", "ragged_xa_plain",
                 "ragged_dxa_plain", "ragged_wgrad_plain"):
        fn = getattr(ragged, name)
        monkeypatch.setattr(ragged, name,
                            lambda *a, _fn=fn, _n=name, **k:
                            calls.append(_n) or _fn(*a, **k))
    lay, x, A, B, ids, w, scal = _lora_inputs("float32")
    xt, At, Bt = (torch.from_numpy(a).requires_grad_() for a in (x, A, B))
    y = ops.fused_lora_ragged(xt, At, Bt, torch.from_numpy(ids),
                              torch.from_numpy(scal),
                              lora.RankLayout(RANKS, 8), impl="cuda",
                              block_t=BLOCK_T, slice_rows=_ROWS,
                              seq_len=_SEQ)
    assert calls == []
    y.backward(torch.from_numpy(w))
    assert sorted(calls) == sorted(["ragged_lora_dgrad_plain",
                                    "ragged_xa_plain", "ragged_dxa_plain",
                                    "ragged_wgrad_plain",
                                    "ragged_wgrad_plain"])


def test_masked_route_refuses_to_run_under_grad(monkeypatch):
    """The masked route under grad: a uniform layout (MultiLoRA.apply's
    stacked views) and a batch without a static tile map (densified) both
    run, and their backward goes through B7/B8's plain versions on a CPU
    tensor (grouped_matmul three times, grouped_wgrad twice), not through
    autograd of the plain forward; without grad the route runs too."""
    from repro_torch.kernels import fused_lora
    calls = []
    for name in ("grouped_matmul_plain", "grouped_wgrad_plain"):
        fn = getattr(fused_lora, name)
        monkeypatch.setattr(fused_lora, name,
                            lambda *a, _fn=fn, _n=name, **k:
                            calls.append(_n) or _fn(*a, **k))
    want = ["grouped_matmul_plain"] * 3 + ["grouped_wgrad_plain"] * 2
    rng = np.random.default_rng(0)
    ranks = (8, 3)                        # uniform pads: the masked route
    A = torch.from_numpy(rng.standard_normal((D_IN, 16)).astype(np.float32))
    B = torch.from_numpy(rng.standard_normal((16, D_OUT)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((2 * BLOCK_T, D_IN)
                                             ).astype(np.float32))
    ids = torch.repeat_interleave(torch.arange(2), BLOCK_T).int()
    ctx = lora.MultiLoRA(adapter_ids=torch.arange(2).int(),
                         ranks=torch.tensor(ranks).int(),
                         scalings=torch.tensor([2.0, 5.0]), impl="cuda",
                         block_t=BLOCK_T,
                         layout=lora.RankLayout(ranks, 8), rows_all=(1, 1))
    xs = x.reshape(2, BLOCK_T, D_IN)
    y = ctx.apply(xs, {"A": A.requires_grad_(), "B": B})
    assert calls == []
    y.sum().backward()
    assert sorted(calls) == want and A.grad.shape == A.shape
    calls.clear()
    A32 = torch.from_numpy(rng.standard_normal((D_IN, 32)).astype(
        np.float32)).requires_grad_()
    B32 = torch.from_numpy(rng.standard_normal((32, D_OUT)).astype(
        np.float32))
    ops.fused_lora_ragged(x, A32, B32, ids, torch.tensor([2.0, 5.0]),
                          lora.RankLayout((8, 20), 8), impl="cuda",
                          block_t=BLOCK_T).sum().backward()   # no tile map
    assert sorted(calls) == want and A32.grad.shape == A32.shape
    with torch.no_grad():
        assert ctx.apply(xs, {"A": A, "B": B}).shape == (2, BLOCK_T, D_OUT)


# -------------------------------------------------------------- flash
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,chunk", [(32, 16), (24, 16)])
@pytest.mark.parametrize("groups", [1, 2, 4])
def test_flash_function_matches_make_flash(groups, S, chunk, dtype):
    """Forward, lse and (dq, dk, dv) of ``_Flash`` against the reference's
    flash custom VJP, causal, GQA with *groups* query heads per kv head;
    S=24 with chunk 16 pads the last key chunk."""
    rng = np.random.default_rng(groups * 100 + S)
    B, H, hd = 2, 4, 16
    KV = H // groups
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    do = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    (qj, qt), (kj, kt), (vj, vt), (doj, dot) = (_pair(a, dtype)
                                                for a in (q, k, v, do))
    f = ref_attn._make_flash(0, S, True, None, chunk)
    want_out, vjp = jax.vjp(f, qj, kj, vj)
    want_grads = vjp(doj)
    _, want_lse = ref_attn._chunked_attention_fwd(
        qj, kj, vj, q_offset=0, kv_len=S, causal=True, window=None,
        chunk=chunk)

    qt, kt, vt = (t.requires_grad_() for t in (qt, kt, vt))
    out = attention.chunked_attention(qt, kt, vt, q_offset=0, kv_len=S,
                                      causal=True, window=None, chunk=chunk)
    assert out.dtype == qt.dtype
    _close(out, want_out, dtype)
    out.backward(dot)
    for got, ref in zip((qt.grad, kt.grad, vt.grad), want_grads):
        assert got.dtype == qt.dtype
        _close(got, ref, dtype)
    # the lse the forward saves: the CPU route's chunk scan, and the
    # flash kernel's plain version, both against the reference's
    _, lse = attention._chunked_attention_fwd(
        qt.detach(), kt.detach(), vt.detach(), q_offset=0, kv_len=S,
        causal=True, window=None, chunk=chunk)
    _close(lse, want_lse, "float32" if dtype == "float32" else dtype)
    flat = lambda t, n: t.detach().transpose(1, 2).reshape(B * n, S, hd)
    _, lse_k = flash_attention.flash_attention_fwd(
        flat(qt, H).contiguous(), flat(kt, KV).contiguous(),
        flat(vt, KV).contiguous(), causal=True, kv_groups=groups)
    _close(lse_k.reshape(B, H, S), want_lse, dtype)
