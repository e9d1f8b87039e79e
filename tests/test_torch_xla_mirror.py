"""The port's "torch" LoRA path (``_MaskedTorch``, ``_RaggedTorch``) held
against the reference's "xla" path on the CPU, on the same numpy-seeded
inputs: the cases of tests/test_kernels.py (the "xla" ones),
tests/test_ragged_kernels.py and tests/test_backward_kernels.py (the
train-step cases are in tests/test_torch_xla_train.py).

Tolerances: outputs and gradients within 1e-5 absolute + 1e-5 relative
in f32, and 2e-2 + 2e-2 in bf16 (both sides round at the same points and
sum the same f32 products in other orders); gradients are divided by the
leaf's largest |value| first, as the reference's own tests divide them,
so that the bound is relative to the tensor.  XLA on the
CPU refuses bf16 x bf16 -> f32 products (ROADMAP §C4), so the bf16 cases
feed the reference's "xla" the same bf16 values as f32 arrays: the port
rounds xa and the output to bf16 where the reference would, one bf16 ulp
(2^-8 relative) of each rounded value, so a bf16 output too is divided
by its largest |value| before the 2e-2 bound (an output near zero sums
rounded terms of the tensor's scale).
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.lora import RankLayout as RefLayout
from repro.kernels import ops as ref_ops

from repro_torch.core.lora import MultiLoRA, RankLayout
from repro_torch.kernels import ops

TOL = {np.float32: 1e-5, ml_dtypes.bfloat16: 2e-2}


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _jnp(a) -> jax.Array:
    """A reference operand: bf16 values as f32 (see the module note)."""
    a = np.asarray(a)
    return jnp.asarray(a.astype(np.float32) if a.dtype == ml_dtypes.bfloat16
                       else a)


def _close(got, want, tol, normalize=False):
    g, w = _np(got), _np(want)
    if normalize:
        scale = max(float(np.abs(w).max()), 1e-6)
        g, w = g / scale, w / scale
    np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


# ------------------------------------------------------------ masked
def make_case(rng, T, K, d_in, d_out, r_pad, dtype, block_t):
    """tests/test_backward_kernels.py's case: B offset so that dB (and y,
    hence dx) are informative; sorted, tile-aligned adapter ids."""
    x = rng.standard_normal((T, d_in)).astype(dtype)
    A = (rng.standard_normal((K, d_in, r_pad)) * 0.3).astype(dtype)
    B = ((rng.standard_normal((K, r_pad, d_out)) * 0.3) + 0.1).astype(dtype)
    ranks = rng.integers(1, r_pad + 1, size=K).astype(np.int32)
    scal = (16.0 / ranks).astype(np.float32)
    tiles = rng.integers(0, K, size=T // block_t)
    ids = np.sort(np.repeat(tiles, block_t)).astype(np.int32)
    return x, A, B, ids, ranks, scal


def _masked_pair(x, A, B, ids, ranks, scal, eq):
    """(y, dx, dA, dB) of sum(y²) through JAX's "xla" and the port's
    "torch" on the same inputs."""
    jx = [_jnp(a) for a in (x, A, B, ids, ranks, scal)]

    def f(x_, A_, B_):
        y = ref_ops.fused_lora(x_, A_, B_, jx[3], jx[4], jx[5], impl="xla",
                               equal_segments=eq)
        return (y.astype(jnp.float32) ** 2).sum()
    want = jax.jit(lambda *a: (
        ref_ops.fused_lora(*a, *jx[3:], impl="xla", equal_segments=eq),
        *jax.grad(f, argnums=(0, 1, 2))(*a)))(*jx[:3])
    tx, tA, tB = (_t(a).requires_grad_() for a in (x, A, B))
    y = ops.fused_lora(tx, tA, tB, _t(ids), _t(ranks), _t(scal),
                       impl="torch", equal_segments=eq)
    (y.float() ** 2).sum().backward()
    return (y, tx.grad, tA.grad, tB.grad), want


# tests/test_kernels.py:57 (the "xla" case) and the sweep of
# tests/test_backward_kernels.py:79, all through the one-hot fallback
SWEEP = [
    # T, K, d_in, d_out, r_pad, dtype, block_t
    (64, 3, 32, 48, 8, np.float32, 8),
    (64, 2, 32, 48, 8, np.float32, 8),
    (128, 4, 64, 64, 16, np.float32, 16),
    (128, 3, 48, 96, 8, ml_dtypes.bfloat16, 8),
    (64, 2, 32, 640, 8, np.float32, 8),
    (64, 6, 32, 64, 8, np.float32, 8),
]


@pytest.mark.parametrize("T,K,d_in,d_out,r_pad,dtype,block_t", SWEEP)
def test_masked_torch_matches_xla(T, K, d_in, d_out, r_pad, dtype, block_t):
    rng = np.random.default_rng(0)
    case = make_case(rng, T, K, d_in, d_out, r_pad, dtype, block_t)
    got, want = _masked_pair(*case, eq=False)
    _close(got[0], want[0], TOL[dtype], normalize=dtype != np.float32)
    for g, w in zip(got[1:], want[1:]):
        _close(g, w, TOL[dtype], normalize=True)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_masked_torch_equal_segments_matches_xla(dtype):
    """tests/test_backward_kernels.py:88: every adapter owns T / K tokens,
    the segment-dense batched path and its wgrads."""
    T, K, d_in, d_out, r_pad = 64, 4, 32, 40, 8
    rng = np.random.default_rng(1)
    x = rng.standard_normal((T, d_in)).astype(dtype)
    A = (rng.standard_normal((K, d_in, r_pad)) * 0.3).astype(dtype)
    B = ((rng.standard_normal((K, r_pad, d_out)) * 0.3) + 0.1).astype(dtype)
    ranks = np.asarray([3, 8, 5, 1], np.int32)
    scal = (16.0 / ranks).astype(np.float32)
    ids = np.repeat(np.arange(K), T // K).astype(np.int32)
    got, want = _masked_pair(x, A, B, ids, ranks, scal, eq=True)
    _close(got[0], want[0], TOL[dtype], normalize=dtype != np.float32)
    for g, w in zip(got[1:], want[1:]):
        _close(g, w, TOL[dtype], normalize=True)
    # the fallback gives the same values on the same layout
    got_fb, _ = _masked_pair(x, A, B, ids, ranks, scal, eq=False)
    for g, w in zip(got_fb, got):
        _close(g, w, TOL[dtype], normalize=True)


@pytest.mark.parametrize("route", ["masked", "ragged"])
def test_scaling_gets_no_gradient(route):
    """tests/test_backward_kernels.py:122: the scalings are alpha / r
    constants, never trained; the reference returns a float0 cotangent,
    the port's Functions return None."""
    rng = np.random.default_rng(3)
    x, A, B, ids, ranks, scal = make_case(rng, 32, 2, 16, 16, 8,
                                          np.float32, 8)
    s = _t(scal).requires_grad_()
    tx = _t(x).requires_grad_()
    if route == "masked":
        y = ops.fused_lora(tx, _t(A), _t(B), _t(ids), _t(ranks), s,
                           impl="torch")
    else:
        lay = RankLayout((3, 8), multiple=8)
        Ap = _t(A.transpose(1, 0, 2).reshape(16, -1))
        Bp = _t(B.reshape(-1, 16))
        y = ops.fused_lora_ragged(tx, Ap, Bp, _t(ids), s, lay, impl="torch")
    (y ** 2).sum().backward()
    assert s.grad is None and tx.grad is not None


# ------------------------------------------------------------ ragged
def make_packed_case(rng, ranks, rows, d_in, d_out, seq, block_t,
                     dtype=np.float32):
    """tests/test_ragged_kernels.py's packed pair and job-major geometry:
    rows[k] sequences of seq tokens per job (0 = empty adapter)."""
    layout = RefLayout(tuple(ranks), multiple=8)
    R = layout.total
    Ap = (rng.standard_normal((d_in, R)) * 0.3).astype(dtype)
    Bp = ((rng.standard_normal((R, d_out)) * 0.3) + 0.1).astype(dtype)
    act = np.asarray(layout.active_cols)
    Ap *= act[None, :].astype(dtype)
    Bp *= act[:, None].astype(dtype)
    tile_jobs = sum(([k] * (rows[k] * seq // block_t)
                     for k in range(len(ranks))), [])
    ids = np.repeat(tile_jobs, block_t).astype(np.int32)
    x = rng.standard_normal((len(ids), d_in)).astype(dtype)
    scal = (16.0 / np.asarray(ranks)).astype(np.float32)
    return layout, Ap, Bp, x, ids, scal, tuple(rows)


CASES = [
    # ranks, rows (0 = empty adapter), equal_segments
    ((4,), (2,), False),
    ((64,), (2,), True),
    ((4, 1, 64, 8), (2, 1, 3, 2), False),
    ((8, 8, 16, 8), (2, 2, 2, 2), True),
    ((4, 1, 64, 8), (2, 1, 3, 0), False),          # empty adapter
    ((4, 4, 4, 4, 4, 4, 4, 64), (1,) * 8, True),   # the bench layout
    ((2, 64, 1, 8, 32, 4, 16, 3), (1, 2, 1, 0, 2, 1, 1, 1), False),
    ((16, 4, 64, 8), (2, 2, 2, 2), True),          # a non-contiguous bucket
]


def _ragged_pair(layout, Ap, Bp, x, ids, scal, rows, eq, seq, bt,
                 slice_rows="rows"):
    srows = rows if slice_rows == "rows" else slice_rows

    def call_ref(x_, A_, B_):
        return ref_ops.fused_lora_ragged(
            x_, A_, B_, jnp.asarray(ids), jnp.asarray(scal), layout,
            impl="xla", block_t=bt, equal_segments=eq, slice_rows=srows,
            seq_len=seq, solo_rows=rows)

    jx, jA, jB = (_jnp(a) for a in (x, Ap, Bp))
    want = jax.jit(lambda *a: (call_ref(*a), *jax.grad(
        lambda *b: (call_ref(*b).astype(jnp.float32) ** 2).sum(),
        argnums=(0, 1, 2))(*a)))(jx, jA, jB)
    tx, tA, tB = (_t(a).requires_grad_() for a in (x, Ap, Bp))
    lay = RankLayout(layout.ranks, layout.multiple)
    y = ops.fused_lora_ragged(tx, tA, tB, _t(ids), _t(scal), lay,
                              impl="torch", block_t=bt, equal_segments=eq,
                              slice_rows=srows, seq_len=seq)
    (y.float() ** 2).sum().backward()
    return (y, tx.grad, tA.grad, tB.grad), want


@pytest.mark.parametrize("ranks,rows,eq", CASES)
def test_ragged_torch_matches_xla(ranks, rows, eq):
    """tests/test_ragged_kernels.py:66 for "torch": forward, dx, dA and dB
    against the reference's "xla" on every claimed layout (mixed ranks,
    rank 1, an empty adapter, equal and unequal segments)."""
    rng = np.random.default_rng(abs(hash((ranks, rows))) % 2 ** 31)
    seq, bt = 8, 8
    case = make_packed_case(rng, ranks, rows, 32, 48, seq, bt)
    got, want = _ragged_pair(*case, eq=eq, seq=seq, bt=bt)
    _close(got[0], want[0], 1e-5)
    for g, w in zip(got[1:], want[1:]):
        _close(g, w, 1e-5, normalize=True)


def test_ragged_torch_bf16_matches_xla():
    rng = np.random.default_rng(4)
    seq, bt = 8, 8
    case = make_packed_case(rng, (8, 8, 16, 8), (2, 2, 2, 2), 32, 48, seq,
                            bt, dtype=ml_dtypes.bfloat16)
    for eq in (True, False):
        got, want = _ragged_pair(*case, eq=eq, seq=seq, bt=bt)
        _close(got[0], want[0], 2e-2, normalize=True)
        for g, w in zip(got[1:], want[1:]):
            _close(g, w, 2e-2, normalize=True)


def test_ragged_torch_without_static_rows_takes_the_fallback():
    """tests/test_ragged_kernels.py:161: with no static tile map
    (slice_rows=None, the contiguous nano split) "torch" takes the exact
    per-bucket one-hot fallback, as the reference's "xla" does; it never
    densifies to the masked family."""
    rng = np.random.default_rng(9)
    seq, bt = 8, 8
    case = make_packed_case(rng, (4, 64), (2, 2), 32, 48, seq, bt)
    got, want = _ragged_pair(*case, eq=False, seq=seq, bt=bt,
                             slice_rows=None)
    _close(got[0], want[0], 1e-5)
    for g, w in zip(got[1:], want[1:]):
        _close(g, w, 1e-5, normalize=True)


def test_uniform_rank_layout_dispatches_to_masked_torch(monkeypatch):
    """tests/test_ragged_kernels.py:210 for "torch": uniform padded widths
    route MultiLoRA.apply to the masked family (values still the
    reference's), heterogeneous widths to the ragged one."""
    from repro.core.lora import MultiLoRA as RefMultiLoRA
    rng = np.random.default_rng(11)
    seq, bt = 8, 8
    layout, Ap, Bp, x, ids, scal, rows = make_packed_case(
        rng, (4, 8, 8), (2, 1, 1), 32, 48, seq, bt)
    assert layout.is_uniform
    nb = x.shape[0] // seq
    ref_ctx = RefMultiLoRA(adapter_ids=jnp.asarray(ids.reshape(nb, seq)[:, 0]),
                           ranks=jnp.asarray((4, 8, 8), jnp.int32),
                           scalings=jnp.asarray(scal), impl="xla",
                           block_t=bt, layout=layout, rows_all=rows)
    want = ref_ctx.apply(jnp.asarray(x).reshape(nb, seq, -1),
                         {"A": jnp.asarray(Ap), "B": jnp.asarray(Bp)})

    calls = []
    real_masked, real_ragged = ops.fused_lora, ops.fused_lora_ragged
    monkeypatch.setattr(ops, "fused_lora", lambda *a, **k: (
        calls.append(("masked", k["impl"])), real_masked(*a, **k))[1])
    monkeypatch.setattr(ops, "fused_lora_ragged", lambda *a, **k: (
        calls.append(("ragged", k["impl"])), real_ragged(*a, **k))[1])
    ctx = MultiLoRA(adapter_ids=_t(ids.reshape(nb, seq)[:, 0]),
                    ranks=torch.tensor((4, 8, 8), dtype=torch.int32),
                    scalings=_t(scal), impl="torch", block_t=bt,
                    layout=RankLayout((4, 8, 8), 8), rows_all=rows)
    y = ctx.apply(_t(x).reshape(nb, seq, -1), {"A": _t(Ap), "B": _t(Bp)})
    _close(y, want, 1e-5)
    assert calls == [("masked", "torch")]

    layout2, Ap2, Bp2, x2, ids2, scal2, rows2 = make_packed_case(
        rng, (4, 64), (2, 2), 32, 48, seq, bt)
    nb2 = x2.shape[0] // seq
    ctx2 = MultiLoRA(adapter_ids=_t(ids2.reshape(nb2, seq)[:, 0]),
                     ranks=torch.tensor((4, 64), dtype=torch.int32),
                     scalings=_t(scal2), impl="torch", block_t=bt,
                     layout=RankLayout((4, 64), 8), rows_all=rows2)
    ctx2.apply(_t(x2).reshape(nb2, seq, -1), {"A": _t(Ap2), "B": _t(Bp2)})
    assert calls[-1] == ("ragged", "torch")
