"""The weight gradients' summation order in the port (B5 ragged_wgrad, B8
grouped_wgrad): the host rule that cuts the token tiles into pieces,
the plain versions against the JAX reference's Pallas kernels in
interpret mode, and the two plain versions against each other.

The CUDA kernels of both families sum through one routine of
``csrc/lora_tile.cuh`` in the order of ``fused_lora.wgrad_pieces``: chunks
of ``WGRAD_CHUNK_TILES`` token tiles at absolute tile positions, one f32
partial per maximal run of one adapter's tiles inside a chunk, partials
added in tile order.  The plain versions take the same order, so on one
uniform layout B5 and B8 agree bit for bit, here as on the card.
Tolerances against the reference (those of tests/test_torch_masked_bwd.py):
f32 inputs 1e-5 relative and 1e-5 of the largest |value| absolute (the
same products summed in another order); bf16 inputs 2e-2 of each (one
ulp of a bf16 input rounding the other way).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import lora as ref_lora
from repro.kernels import ragged as ref_ragged

from repro_torch.core import lora
from repro_torch.kernels import fused_lora, ragged

BLOCK_T, D, RP = 8, 40, 16
# the four tile maps of tests/test_torch_masked_bwd.py: sorted; a nano
# slice that starts in the middle of adapter 1; one that omits adapter
# 1; one adapter only
TILE_MAPS = [("sorted", (0, 0, 1, 2, 2, 3), 4),
             ("mid_adapter", (1, 2, 2, 3), 4),
             ("omits_one", (0, 0, 2, 2, 3), 4),
             ("k1", (0, 0, 0), 1)]
TM_IDS = [name for name, _, _ in TILE_MAPS]


def _close(got: torch.Tensor, want, dtype):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    scale = max(float(np.abs(want).max()), 1.0)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * scale)


def _t(a: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


@pytest.mark.parametrize("chunk", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("tile_map", [(0, 0, 1, 2, 2, 3),
                                      (1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 3),
                                      (0, 2, 2, 0, 0), (5,), (3, 3, 3, 3)])
def test_wgrad_pieces_match_a_direct_count(tile_map, chunk):
    """Every tile in exactly one piece, pieces in tile order, each inside
    one chunk and one adapter, and as many pieces as tiles that start a
    chunk or change the adapter."""
    pieces = fused_lora.wgrad_pieces(tile_map, chunk)
    starts = sum(1 for t, k in enumerate(tile_map)
                 if t % chunk == 0 or k != tile_map[t - 1])
    assert len(pieces) == starts
    covered = [t for t0, t1, _ in pieces for t in range(t0, t1)]
    assert covered == list(range(len(tile_map)))
    for t0, t1, k in pieces:
        assert t0 // chunk == (t1 - 1) // chunk
        assert set(tile_map[t0:t1]) == {k}


def test_wgrad_chunk_is_a_constant_of_the_design():
    assert fused_lora.WGRAD_CHUNK_TILES == 4
    assert fused_lora.wgrad_pieces((0,) * 9) == [(0, 4, 0), (4, 8, 0),
                                                 (8, 9, 0)]


@pytest.mark.parametrize("operand", ["dB", "dA"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,tile_map,K", TILE_MAPS, ids=TM_IDS)
def test_ragged_wgrad_plain_matches_pallas_on_masked_tile_maps(
        name, tile_map, K, dtype, operand):
    """The reordered plain B5 against the reference's ragged wgrad kernel
    over the masked family's four tile maps (uniform r_pad 16: rank
    {16, 5, 12, 9}[:K]); rows of adapters without tiles are zero."""
    ranks = (16, 5, 12, 9)[:K]
    lay = lora.RankLayout(ranks, RP)
    ref_lay = ref_lora.RankLayout(ranks, RP)
    rng = np.random.default_rng(7)
    T = len(tile_map) * BLOCK_T
    ids = np.repeat(np.asarray(tile_map), BLOCK_T)
    own = np.zeros((T, lay.total), bool)
    for t, k in enumerate(ids):
        own[t, lay.offsets[k]:lay.offsets[k] + RP] = True
    u = (rng.standard_normal((T, lay.total)) * own).astype(np.float32)
    v = rng.standard_normal((T, D)).astype(np.float32)
    if operand == "dA":         # u = dxa, v = x: (R, d_in) = dA^T
        v = v * 0.5
    ut, vt = _t(u, dtype), _t(v, dtype)
    uj, vj = (jnp.asarray(a.float().numpy()).astype(
        jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
        for a in (ut, vt))
    want = ref_ragged.ragged_wgrad(
        uj, vj, ref_ragged.RaggedMeta.build(tile_map, ref_lay),
        block_t=BLOCK_T, interpret=True)
    meta = ragged.RaggedMeta.build(tile_map, lay)
    got = ragged.ragged_wgrad(ut, vt, meta, block_t=BLOCK_T)
    assert got.dtype == torch.float32 and got.shape == (lay.total, D)
    _close(got, want, dtype)
    assert not got[torch.from_numpy(~meta.visited_rows)].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,tile_map,K", TILE_MAPS, ids=TM_IDS)
def test_plain_b5_and_b8_are_bit_equal_on_a_uniform_layout(name, tile_map,
                                                           K, dtype):
    """dB = wgrad(xa, dy_s) and dA = wgrad(x, dxa) through both families
    on one uniform layout: the same products, the same pieces, the same
    order -- equal bit for bit."""
    lay = lora.RankLayout((16, 16, 12, 16)[:K], RP)
    meta = ragged.RaggedMeta.build(tile_map, lay)
    rng = np.random.default_rng(11)
    T = len(tile_map) * BLOCK_T
    narrow = _t(rng.standard_normal((T, RP)).astype(np.float32), dtype)
    wide = _t(rng.standard_normal((T, D)).astype(np.float32), dtype)
    ids = torch.from_numpy(np.repeat(np.asarray(tile_map), BLOCK_T))
    cols = torch.as_tensor(lay.offsets)[ids][:, None] + torch.arange(RP)
    packed = torch.zeros((T, lay.total), dtype=narrow.dtype).scatter_(
        1, cols, narrow)
    tm = torch.tensor(tile_map, dtype=torch.int32)
    dB8 = fused_lora.grouped_wgrad_cuda(narrow, wide, tm, K, block_t=BLOCK_T)
    dB5 = ragged.ragged_wgrad(packed, wide, meta, block_t=BLOCK_T)
    assert torch.equal(dB8, dB5.reshape(K, RP, D))
    dA8 = fused_lora.grouped_wgrad_cuda(wide, narrow, tm, K, block_t=BLOCK_T)
    dA5 = ragged.ragged_wgrad(packed, wide, meta, block_t=BLOCK_T)
    assert torch.equal(dA8, dA5.reshape(K, RP, D).transpose(1, 2))


def test_plain_grouped_wgrad_adds_the_pieces_in_tile_order():
    """out[k] is ((0 + P_0) + P_1) + ... over adapter k's pieces, each P
    the piece's f32 product: the plain version is the kernel's order
    step by step, not one sum over all of an adapter's tokens."""
    rng = np.random.default_rng(3)
    tile_map = (0,) * 9 + (1,) * 3
    T = len(tile_map) * BLOCK_T
    x = torch.from_numpy(rng.standard_normal((T, RP)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32))
    got = fused_lora.grouped_wgrad_plain(
        x, g, torch.tensor(tile_map, dtype=torch.int32), 3, block_t=BLOCK_T)
    want = torch.zeros((3, RP, D))
    for t0, t1, k in [(0, 4, 0), (4, 8, 0), (8, 9, 0), (9, 12, 1)]:
        rows = slice(t0 * BLOCK_T, t1 * BLOCK_T)
        want[k] = want[k] + x[rows].T @ g[rows]
    assert torch.equal(got, want)
    assert not got[2].any()
