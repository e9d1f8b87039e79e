"""The ragged backward's LoRA kernels (B2 ``ragged_lora_dgrad``, B3
``ragged_xa``, B4 ``ragged_dxa``) on the shared Hopper routine
(``csrc/lora_fwd.cuh``, its Backward orientation and its phase 1 alone),
on the CPU.

What can be held here without a card: the launch geometry the wrappers
pick (a pure function of T, the output width, block_t and the SM count),
what the CUDA sources promise (the grid covers rows and output columns
only, nothing is atomic, B2-B4 have no kernel of their own beside the
routine, the retired WMMA routine is gone), the operand checks the
wrappers make before any build (driven through the wrappers themselves
on ``meta`` tensors, which pass every check but the device's), and the
plain versions against the JAX package's Pallas kernels in interpret
mode at layouts the new geometry meets: token tiles of 64, 32 and 16
rows, d_in != d_out, a segment 72 lanes wide (not a multiple of 64) and
one 24 wide (not a multiple of 16: the next adapter's lanes are read and
must not count), an adapter that owns no tile, and the last segment
ending at R.  Tolerances as in ``test_torch_ragged_bwd.py``: f32 inputs
1e-5 relative and 1e-5 of the largest |value| absolute (the two sides
sum the same products in another order); bf16 inputs 2e-2 of each (one
bf16 ulp of a masked dxa or xa lane may round the other way); xa and
dxa outside each token's own segment exactly zero on the port's side.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import lora as ref_lora
from repro.kernels import ragged as ref_ragged

from repro_torch.core import lora
from repro_torch.kernels import build, fused_lora, ragged

CSRC = Path(fused_lora.__file__).parent / "csrc"
H100_SMS = 132


def _code(name: str) -> str:
    return re.sub(r"//[^\n]*", "", (CSRC / name).read_text())


# ----------------------------------------------------------- geometry
@pytest.mark.parametrize("T,d_in,block_t,want", [
    (8192, 2048, 128, (64, 1)),     # training step (q/o and k/v: dx 2048)
    (8192, 8192, 128, (64, 1)),     # command-r's d_model
    (4096, 2048, 128, (32, 1)),     # a 4096-token group
    (2048, 2048, 128, (16, 1)),     # the 2048-token slice
    (1024, 2048, 128, (16, 3)),     # 64 row CTAs: columns split
    (64, 2048, 64, (16, 16)),       # one 64-row tile
    (16, 2048, 16, (16, 16)),       # one 16-row tile
    (480, 256, 48, (16, 2)),        # block_t 48 = 3 x 16
])
def test_lora_bwd_geometry(T, d_in, block_t, want):
    """B2 takes the routine's geometry over dx's d_in columns: the
    largest of 64, 32, 16 rows dividing block_t whose row CTAs give 90%
    of the SMs one (else 16), columns split only where they leave more
    than 10% idle, never into more CTAs than 128-column blocks.  B3 and
    B4 take the same rows and no split.  No row block spans two token
    tiles (two adapters)."""
    rows, splits = fused_lora.lora_fwd_geometry(T, d_in, block_t, H100_SMS)
    assert (rows, splits) == want
    assert fused_lora.lora_packed_rows(T, block_t, H100_SMS) == rows
    assert block_t % rows == 0 and T % rows == 0
    row_ctas = T // rows
    assert (splits > 1) == (10 * row_ctas < 9 * H100_SMS)
    assert splits <= -(-d_in // fused_lora.LORA_FWD_COL_BLOCK)
    for i in range(row_ctas):
        assert (i * rows) // block_t == ((i + 1) * rows - 1) // block_t


def test_lora_packed_rows_refuses_partial_tiles():
    with pytest.raises(ValueError, match="multiple of 16"):
        fused_lora.lora_packed_rows(64, 8, H100_SMS)


# ------------------------------------------------------------ sources
def test_bwd_sources_run_the_shared_routine():
    """B2, B3 and B4 launch the LoRA routine (B2 its Backward
    orientation; B3 and B4 its phase 1 alone, Forward and Backward), and
    ragged_bwd.cu has no kernel of its own for them; the routine's grids
    cover token rows and output columns only, each CTA walks the whole
    contraction and all of its segment's lanes, and nothing is atomic;
    the old WMMA routine (lora_rows, xa_rows, xa_times_b) is gone."""
    bwd, routine = _code("ragged_bwd.cu"), _code("lora_fwd.cuh")
    for text in (bwd, routine):
        assert "atomic" not in text.lower()
    assert "__global__" not in bwd
    assert "lora_fwd::launch<float, lora_fwd::Backward>(" in bwd
    for orient in ("Forward", "Backward"):
        assert f"lora_fwd::launch_packed<lora_fwd::{orient}>(" in bwd
    assert re.findall(r"const dim3 grid\((.*)\);", routine) == [
        "o.T / BM, (o.d_n + per - 1) / per", "o.T / BM"]
    assert "blockIdx.z" not in routine
    assert re.findall(r"blockIdx\.y", routine) == ["blockIdx.y"]
    assert routine.count(
        "for (int lane0 = 0; lane0 < wpad; lane0 += kLanes)") == 2
    assert "const int n_st = (d_k + kK - 1) / kK;" in routine
    assert "wmma" not in routine
    tile = _code("lora_tile.cuh")
    for gone in ("lora_rows", "xa_rows", "xa_times_b", "Smem", "stage_x",
                 "col_groups"):
        assert not re.search(rf"\b{gone}\b", tile), gone
    assert not hasattr(build, "col_groups")


# --------------------------------------------------- operand checks
def _no_build(monkeypatch):
    def refuse(name):
        raise AssertionError(f"built {name} before the operand checks")
    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(build, "build_all", lambda: refuse("all"))


def _call(kernel, ranks=(8, 16), multiple=8, dtype=torch.bfloat16,
          strided=False, block_t=16):
    """The wrapper on meta tensors: every check but the device's can pass.
    ``strided`` hands it a column slice (not contiguous) as its first
    operand."""
    lay = lora.RankLayout(ranks, multiple)
    meta = ragged.RaggedMeta.build((0, 1), lay)
    T, d_in, d_out, R = 2 * block_t, 32, 48, lay.total

    def t(*shape, dt=torch.bfloat16):
        return torch.zeros(shape, dtype=dt, device="meta")

    first = (t(T, 2 * (d_in if kernel == "xa" else d_out), dt=dtype)
             [:, :d_in if kernel == "xa" else d_out] if strided else
             t(T, d_in if kernel == "xa" else d_out, dt=dtype))
    if kernel == "dgrad":
        return ragged.ragged_lora_dgrad(first, t(d_in, R), t(R, d_out), meta,
                                        block_t=block_t)
    if kernel == "xa":
        return ragged.ragged_xa(first, t(d_in, R), meta, block_t=block_t)
    return ragged.ragged_dxa(first, t(R, d_out), meta, block_t=block_t)


@pytest.mark.parametrize("case,match", [
    (dict(dtype=torch.float32), "bf16"),
    (dict(strided=True), "contiguous"),
    (dict(ranks=(4, 8), multiple=4), "16-byte units"),    # R = 12
    (dict(block_t=8), "multiple of 16"),
    (dict(ranks=(8, 264)), "wider than 256"),
    (dict(), "device"),                       # all fine but the device
])
@pytest.mark.parametrize("kernel", ["dgrad", "xa", "dxa"])
def test_bwd_wrappers_refuse_before_any_build(kernel, case, match,
                                              monkeypatch):
    _no_build(monkeypatch)
    before = (ragged.ragged_lora_dgrad.launches, ragged.ragged_xa.launches,
              ragged.ragged_dxa.launches)
    with pytest.raises(ValueError, match=match):
        _call(kernel, **case)
    assert (ragged.ragged_lora_dgrad.launches, ragged.ragged_xa.launches,
            ragged.ragged_dxa.launches) == before


# ------------------------------------------- plain vs Pallas, new cases
RANKS = (20, 3, 70)          # pads 24, 8, 72: R = 104, the last ends at R
# (token tiles' adapters, block_t, d_in, d_out): adapter 1 owns no tile
# in the first two; every case reaches the last segment
CASES = [((2, 0, 2), 64, 32, 48), ((0, 2, 2, 0), 32, 48, 16),
         ((1, 2, 0), 16, 32, 48)]


def _tol(dtype, want):
    scale = max(float(np.abs(want).max()), 1.0)
    if dtype == "float32":
        return 1e-5, 1e-5 * scale
    return 2e-2, 2e-2 * scale


def _close(got: torch.Tensor, want, dtype):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    rtol, atol = _tol(dtype, want)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=atol)


def _pair(a: np.ndarray, dtype: str):
    j = jnp.asarray(a)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype == "bfloat16":
        return j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["dgrad", "xa", "dxa"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_bwd_plain_matches_pallas_at_new_geometry(case, kernel, dtype):
    tile_jobs, block_t, d_in, d_out = CASES[case]
    rng = np.random.default_rng(40 + case)
    ref_lay = ref_lora.RankLayout(RANKS, 8)
    lay = lora.RankLayout(RANKS, 8)
    assert lay.total == ref_lay.total == sum(lay.r_pads)
    act = np.asarray(ref_lay.active_cols)
    A = (rng.standard_normal((d_in, lay.total)) * act[None]
         ).astype(np.float32) / 4
    B = (rng.standard_normal((lay.total, d_out)) * act[:, None]
         ).astype(np.float32) / 8
    T = len(tile_jobs) * block_t
    x = rng.standard_normal((T, d_in)).astype(np.float32)
    dy = rng.standard_normal((T, d_out)).astype(np.float32)
    (xj, xt), (Aj, At), (Bj, Bt), (dyj, dyt) = (
        _pair(a, dtype) for a in (x, A, B, dy))
    mj = ref_ragged.RaggedMeta.build(tile_jobs, ref_lay)
    mt = ragged.RaggedMeta.build(tile_jobs, lay)
    if kernel == "dgrad":
        want = ref_ragged.ragged_lora_dgrad(dyj, Aj, Bj, mj, block_t=block_t,
                                            interpret=True)
        got = ragged.ragged_lora_dgrad(dyt, At, Bt, mt, block_t=block_t)
        assert got.dtype == torch.float32 and got.shape == (T, d_in)
        _close(got, want, dtype)
        return
    if kernel == "xa":
        want = ref_ragged.ragged_xa(xj, Aj, mj, block_t=block_t,
                                    interpret=True)
        got = ragged.ragged_xa(xt, At, mt, block_t=block_t)
    else:
        want = ref_ragged.ragged_dxa(dyj, Bj, mj, block_t=block_t,
                                     interpret=True)
        got = ragged.ragged_dxa(dyt, Bt, mt, block_t=block_t)
    assert got.dtype == xt.dtype and got.shape == (T, lay.total)
    own = np.zeros((T, lay.total), bool)      # each token's own segment
    for i, k in enumerate(tile_jobs):
        off, rp = lay.slice_of(k)
        own[i * block_t:(i + 1) * block_t, off:off + rp] = True
    assert own[:, -1].any()                   # the last segment is read
    _close(got[torch.from_numpy(own)],
           np.asarray(jnp.asarray(want, jnp.float32))[own], dtype)
    assert not got[torch.from_numpy(~own)].any()
