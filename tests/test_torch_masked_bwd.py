"""The masked LoRA family's backward in the port held against the JAX
reference on the CPU: the grouped product (B7) and the grouped weight
gradient (B8), their oracles, and the masked autograd Function.

Both sides get the same inputs, drawn with a seeded numpy RNG.  On a CPU
tensor the port's wrappers run their plain PyTorch versions; the JAX side
runs the Pallas kernels in interpret mode, as the reference's own tests
do.  Tolerances (those of tests/test_torch_ragged_bwd.py, for the same
reasons):
  * f32 inputs: 1e-5 relative and 1e-5 of the largest |value| absolute —
    the same products summed in another order;
  * bf16 inputs: 2e-2 relative and 2e-2 of the largest |value| absolute —
    one bf16 ulp (2^-8 relative) of a rounded intermediate (dxa, xa, the
    kernel's own bf16 output) may round the other way;
  * adapters that own no token tile: the port's wgrad is exactly zero.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import lora as ref_lora
from repro.kernels import fused_lora as ref_fl
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracles

from repro_torch.core import lora
from repro_torch.kernels import fused_lora, ops
from repro_torch.kernels import ref as oracles

BLOCK_T, D_IN, D_OUT, RP = 8, 32, 48, 16
# (name, tile map, K): sorted; a nano slice that starts in the middle of
# adapter 1; one that omits adapter 1; one adapter only
TILE_MAPS = [("sorted", (0, 0, 1, 2, 2, 3), 4),
             ("mid_adapter", (1, 2, 2, 3), 4),
             ("omits_one", (0, 0, 2, 2, 3), 4),
             ("k1", (0, 0, 0), 1)]
TM_IDS = [name for name, _, _ in TILE_MAPS]


def _tol(dtype, want):
    scale = max(float(np.abs(want).max()), 1.0)
    if dtype == "float32":
        return 1e-5, 1e-5 * scale
    return 2e-2, 2e-2 * scale


def _close(got: torch.Tensor, want, dtype):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    rtol, atol = _tol(dtype, want)
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               rtol=rtol, atol=atol)


def _jt(a: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor."""
    j, t = jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))
    if dtype == "bfloat16":
        return j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


def _packed_views(A: np.ndarray, B: np.ndarray, dtype: str):
    """Stacked (K, D_IN, RP)/(K, RP, D_OUT) numpy pair -> the port's
    strided views of a packed (D_IN, K*RP)/(K*RP, D_OUT) pair, the
    operands MultiLoRA.apply hands the masked family."""
    K = A.shape[0]
    _, At = _jt(np.ascontiguousarray(A.transpose(1, 0, 2)
                                     ).reshape(D_IN, K * RP), dtype)
    _, Bt = _jt(B.reshape(K * RP, D_OUT), dtype)
    return (At, Bt, lambda a: a.reshape(D_IN, K, RP).movedim(-2, -3),
            lambda b: b.reshape(K, RP, D_OUT))


def _operands(which, tile_map, K, dtype, seed):
    """(x, W) of one of the three grouped products of the masked
    backward, on both sides; the port's W is a strided view."""
    rng = np.random.default_rng(seed)
    T = len(tile_map) * BLOCK_T
    A = rng.standard_normal((K, D_IN, RP)).astype(np.float32)
    B = (rng.standard_normal((K, RP, D_OUT)) * 0.5).astype(np.float32)
    At, Bt, st_a, st_b = _packed_views(A, B, dtype)
    if which == "xa":              # x · A[k], A stored
        x = rng.standard_normal((T, D_IN)).astype(np.float32)
        Wj, Wt = _jt(A, dtype)[0], st_a(At)
    elif which == "dxa":           # dy_s · B[k]^T, a transposed view
        x = rng.standard_normal((T, D_OUT)).astype(np.float32)
        Wj, Wt = jnp.swapaxes(_jt(B, dtype)[0], 1, 2), st_b(Bt).transpose(1, 2)
    else:                          # dx = dxa · A[k]^T, a transposed view
        x = rng.standard_normal((T, RP)).astype(np.float32)
        Wj, Wt = jnp.swapaxes(_jt(A, dtype)[0], 1, 2), st_a(At).transpose(1, 2)
    xj, xt = _jt(x, dtype)
    assert Wt.stride(-1) == 1 or Wt.stride(-2) == 1
    assert K == 1 or not Wt.is_contiguous()
    return (xj, Wj), (xt, Wt)


# ------------------------------------------------------------ B7
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["xa", "dxa", "dx"])
@pytest.mark.parametrize("name,tile_map,K", TILE_MAPS, ids=TM_IDS)
def test_grouped_matmul_plain_matches_pallas(name, tile_map, K, which,
                                             dtype):
    (xj, Wj), (xt, Wt) = _operands(which, tile_map, K, dtype, seed=1)
    tmj = jnp.asarray(tile_map, jnp.int32)
    want = ref_fl.grouped_matmul_pallas(xj, Wj, tmj, block_t=BLOCK_T,
                                        interpret=True)
    got = fused_lora.grouped_matmul_cuda(
        xt, Wt, torch.tensor(tile_map, dtype=torch.int32), block_t=BLOCK_T)
    assert got.dtype == xt.dtype and got.shape == (xt.shape[0],
                                                   Wt.shape[-1])
    _close(got, want, dtype)
    # ... and both equal the oracles, which equal each other
    ids = np.repeat(np.asarray(tile_map), BLOCK_T).astype(np.int32)
    oracle = oracles.grouped_matmul_ref(xt, Wt, torch.from_numpy(ids))
    _close(oracle, ref_oracles.grouped_matmul_ref(xj, Wj, jnp.asarray(ids)),
           dtype)
    _close(got, np.asarray(oracle.float()), dtype)


# ------------------------------------------------------------ B8
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("operand", ["dA", "dB"])
@pytest.mark.parametrize("name,tile_map,K", TILE_MAPS, ids=TM_IDS)
def test_grouped_wgrad_plain_matches_pallas(name, tile_map, K, operand,
                                            dtype):
    """dA = wgrad(x, dxa) (wide x, narrow g) and dB = wgrad(xa, dy_s)
    (narrow x, wide g)."""
    rng = np.random.default_rng(2)
    T = len(tile_map) * BLOCK_T
    wide = rng.standard_normal((T, D_IN)).astype(np.float32)
    narrow = rng.standard_normal((T, RP)).astype(np.float32)
    x, g = (wide, narrow) if operand == "dA" else (narrow, wide)
    (xj, xt), (gj, gt) = _jt(x, dtype), _jt(g, dtype)
    tmj = jnp.asarray(tile_map, jnp.int32)
    want = ref_fl.grouped_wgrad_pallas(xj, gj, tmj, K, block_t=BLOCK_T,
                                       interpret=True)
    got = fused_lora.grouped_wgrad_cuda(
        xt, gt, torch.tensor(tile_map, dtype=torch.int32), K,
        block_t=BLOCK_T)
    assert got.dtype == torch.float32 and got.shape == (K, x.shape[1],
                                                        g.shape[1])
    _close(got, want, dtype)
    for k in set(range(K)) - set(tile_map):
        assert (got[k] == 0).all()
    ids = np.repeat(np.asarray(tile_map), BLOCK_T).astype(np.int32)
    oracle = oracles.grouped_wgrad_ref(xt, gt, torch.from_numpy(ids), K)
    _close(oracle, ref_oracles.grouped_wgrad_ref(xj, gj, jnp.asarray(ids), K),
           dtype)
    _close(got, oracle.numpy(), dtype)


# ------------------------------------------- the masked Function
RANKS_UNIFORM = (16, 5, 12, 9)      # all pad to 16 at multiple 16
RANKS_MIXED = (4, 20, 8, 30)        # pads 16/32/16/32: densified to 32
_ROWS, _SEQ = (2, 1, 1, 2), 8


def _fn_inputs(ranks, seed):
    rng = np.random.default_rng(seed)
    lay = ref_lora.RankLayout(ranks, 16)
    act = np.asarray(lay.active_cols)
    A = (rng.standard_normal((D_IN, lay.total)) * act[None]).astype(np.float32)
    B = (rng.standard_normal((lay.total, D_OUT)) * act[:, None] * 0.5
         ).astype(np.float32)
    ids = np.repeat(np.arange(len(ranks)), np.asarray(_ROWS) * _SEQ
                    ).astype(np.int32)
    x = rng.standard_normal((len(ids), D_IN)).astype(np.float32)
    w = rng.standard_normal((len(ids), D_OUT)).astype(np.float32)
    scal = (16.0 / np.asarray(ranks)).astype(np.float32)
    return lay, x, A, B, ids, w, scal


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_function_grads_match_jax_uniform(dtype):
    """A uniform layout: the packed pair's stacked views go through
    ``ops.fused_lora(impl="cuda")``, the reference's through
    ``fused_lora(impl="pallas")`` (its custom VJP)."""
    lay, x, A, B, ids, w, scal = _fn_inputs(RANKS_UNIFORM, 3)
    K = len(RANKS_UNIFORM)
    A_st = np.ascontiguousarray(A.reshape(D_IN, K, RP).transpose(1, 0, 2))
    B_st = B.reshape(K, RP, D_OUT)

    def ref_loss(x, A, B):
        y = ref_ops.fused_lora(x, A, B, jnp.asarray(ids),
                               jnp.asarray(RANKS_UNIFORM, jnp.int32),
                               jnp.asarray(scal), impl="pallas",
                               block_t=BLOCK_T)
        return (y.astype(jnp.float32) * jnp.asarray(w)).sum()

    (xj, xt), (Aj, _), (Bj, _) = (_jt(a, dtype) for a in (x, A_st, B_st))
    want = jax.grad(ref_loss, argnums=(0, 1, 2))(xj, Aj, Bj)
    _, Ap = _jt(A, dtype)
    _, Bp = _jt(B, dtype)
    xt, Ap, Bp = (t.requires_grad_() for t in (xt, Ap, Bp))
    sc = torch.from_numpy(scal).requires_grad_()
    y = ops.fused_lora(xt, Ap.reshape(D_IN, K, RP).movedim(-2, -3),
                       Bp.reshape(K, RP, D_OUT), torch.from_numpy(ids),
                       torch.tensor(RANKS_UNIFORM, dtype=torch.int32), sc,
                       impl="cuda", block_t=BLOCK_T)
    y.backward(torch.from_numpy(w).to(y.dtype))
    assert xt.grad.dtype == xt.dtype
    _close(xt.grad, want[0], dtype)
    _close(Ap.grad.reshape(D_IN, K, RP).movedim(1, 0), want[1], dtype)
    _close(Bp.grad.reshape(K, RP, D_OUT), want[2], dtype)
    assert sc.grad is None            # scalings are constants: no gradient


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_function_grads_match_jax_densified_mixed(dtype):
    """A mixed layout without a static tile map (``slice_rows=None``, a
    contiguous nano slice): both sides densify to the widest segment and
    take the masked family."""
    lay, x, A, B, ids, w, scal = _fn_inputs(RANKS_MIXED, 4)

    def ref_loss(x, A, B):
        y = ref_ops.fused_lora_ragged(
            x, A, B, jnp.asarray(ids), jnp.asarray(scal), lay,
            impl="pallas", block_t=BLOCK_T, slice_rows=None)
        return (y.astype(jnp.float32) * jnp.asarray(w)).sum()

    (xj, xt), (Aj, At), (Bj, Bt) = (_jt(a, dtype) for a in (x, A, B))
    want = jax.grad(ref_loss, argnums=(0, 1, 2))(xj, Aj, Bj)
    xt, At, Bt = (t.requires_grad_() for t in (xt, At, Bt))
    y = ops.fused_lora_ragged(xt, At, Bt, torch.from_numpy(ids),
                              torch.from_numpy(scal),
                              lora.RankLayout(RANKS_MIXED, 16), impl="cuda",
                              block_t=BLOCK_T, slice_rows=None)
    y.backward(torch.from_numpy(w).to(y.dtype))
    for got, ref in zip((xt.grad, At.grad, Bt.grad), want):
        assert got.dtype == xt.dtype
        _close(got, ref, dtype)


def test_grouped_wrappers_refuse_bad_input_before_any_build():
    """A wrong shape raises on any device, before a kernel is built."""
    tm = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):      # T not whole tiles
        fused_lora.grouped_matmul_cuda(torch.zeros((12, 8)),
                                       torch.zeros((1, 8, 16)), tm,
                                       block_t=8)
    with pytest.raises(ValueError):      # W's d_in does not match x
        fused_lora.grouped_matmul_cuda(torch.zeros((16, 8)),
                                       torch.zeros((1, 4, 16)), tm,
                                       block_t=8)
    with pytest.raises(ValueError):      # g's rows do not match x
        fused_lora.grouped_wgrad_cuda(torch.zeros((16, 8)),
                                      torch.zeros((8, 16)), tm, 1,
                                      block_t=8)


@pytest.mark.parametrize("T,d_out,block_t,sms,want", [
    # main path: 8192 tokens, tiles of 128, an H100's 132 SMs
    (8192, 16, 128, 132, (True, 64)),        # xa, r_pad 16
    (8192, 64, 128, 132, (True, 64)),        # dxa, r_pad 64
    (4096, 64, 128, 132, (True, 32)),        # half a step
    (2048, 64, 128, 132, (True, 16)),        # a nano slice
    (8192, 2048, 128, 132, (False, 64)),     # dx = dxa . A^T
    (512, 256, 32, 8, (True, 32)),           # block_t 32: <= 32
    (512, 256, 16, 8, (True, 16)),           # d_out 256: narrow
    (512, 2048, 48, 8, (False, 16))])        # 48 = 3 x 16
def test_grouped_geometry(T, d_out, block_t, sms, want):
    """The grouped product's launch geometry: narrow when d_out <= 256,
    rows per CTA dividing block_t (a CTA's rows share one adapter), the
    largest that still gives 90% of the SMs a CTA on the narrow
    output."""
    got = fused_lora.grouped_geometry(T, d_out, block_t, sms)
    assert got == want
    assert block_t % got[1] == 0 and T % got[1] == 0


def test_grouped_geometry_refuses_partial_tiles():
    with pytest.raises(ValueError, match="multiple of 16"):
        fused_lora.grouped_geometry(64, 16, 8, 132)
