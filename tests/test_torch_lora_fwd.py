"""The LoRA forward kernels (B1 ``ragged_lora_fwd``, B6 ``fused_lora_cuda``)
and their shared Hopper routine (``csrc/lora_fwd.cuh``), on the CPU.

What can be held here without a card: the launch geometry the wrappers
pick (a pure function of T, d_out, block_t and the SM count), what the
CUDA source promises about the summation (never split over CTAs, no
atomics), the operand checks the wrappers make before any build, and
the plain versions against the JAX package's Pallas kernels (interpret
mode) at the row counts and widths the new geometry reaches: 16 and 48
token rows, r_pad 256.  Tolerances as in ``test_torch_kernels.py``: 1e-5
for f32 inputs (the two sides sum the same products in another order),
2e-2 for bf16 (one bf16 ulp of an xa lane may round the other way).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import lora as ref_lora
from repro.kernels import fused_lora as ref_fused
from repro.kernels import ragged as ref_ragged

from repro_torch.core import lora
from repro_torch.kernels import build, fused_lora, ragged

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
CSRC = Path(fused_lora.__file__).parent / "csrc"
H100_SMS = 132


# ----------------------------------------------------------- geometry
@pytest.mark.parametrize("T,d_out,block_t,want", [
    (64, 2048, 16, (16, 16)),       # fused decode: 4 row CTAs
    (64, 256, 16, (16, 2)),         # fused decode, k/v projection
    (16, 2048, 16, (16, 16)),       # solo decode
    (12288, 2048, 16, (16, 1)),     # fused prefill (64 x 192)
    (3072, 2048, 16, (16, 1)),      # solo prefill
    (8192, 2048, 128, (64, 1)),     # training step
    (8192, 256, 128, (64, 1)),
    (4096, 2048, 128, (32, 1)),     # N = 2 slice
    (2048, 2048, 128, (16, 1)),     # N = 4 slice
    (1024, 2048, 128, (16, 3)),     # N = 8 slice: 64 row CTAs
    (64, 2048, 64, (16, 16)),       # one 64-row tile
    (480, 2048, 48, (16, 5)),       # block_t 48 = 3 x 16
])
def test_lora_fwd_geometry(T, d_out, block_t, want):
    """Rows a CTA: the largest of 64, 32, 16 dividing block_t whose row
    CTAs give 90% of the SMs one (else 16); the columns are split only
    where the row CTAs leave more than 10% idle, never into more CTAs
    than 128-column blocks, and no row block spans two token tiles (so
    two adapters)."""
    rows, splits = fused_lora.lora_fwd_geometry(T, d_out, block_t, H100_SMS)
    assert (rows, splits) == want
    assert block_t % rows == 0 and T % rows == 0
    row_ctas = T // rows
    assert (splits > 1) == (10 * row_ctas < 9 * H100_SMS)
    assert splits <= -(-d_out // fused_lora.LORA_FWD_COL_BLOCK)
    for i in range(row_ctas):
        assert (i * rows) // block_t == ((i + 1) * rows - 1) // block_t


def test_lora_fwd_geometry_refuses_partial_tiles():
    with pytest.raises(ValueError, match="multiple of 16"):
        fused_lora.lora_fwd_geometry(64, 2048, 8, H100_SMS)


def test_lora_fwd_source_never_splits_the_contraction():
    """The routine's grid covers rows and output columns only, each CTA
    walks the whole of d_in and of the segment's lanes itself, and
    nothing is atomic: an element's sum does not depend on the launch
    geometry (what keeps fused == solo and B1 == B6 == the B7 pair)."""
    src = (CSRC / "lora_fwd.cuh").read_text()
    code = re.sub(r"//[^\n]*", "", src)
    for name in ("lora_fwd.cuh", "fused_lora.cu", "ragged_lora.cu"):
        text = re.sub(r"//[^\n]*", "", (CSRC / name).read_text())
        assert "atomic" not in text.lower(), name
    assert re.findall(r"const dim3 grid\((.*)\);", code) == [
        "o.T / BM, (o.d_n + per - 1) / per", "o.T / BM"]
    assert "blockIdx.z" not in code
    assert "const int n_st = (d_k + kK - 1) / kK;" in code
    assert "for (int i = 0; i < n_st; ++i)" in code
    assert "for (int lane0 = 0; lane0 < wpad; lane0 += kLanes)" in code
    assert "for (int rc = 0; rc < n_rc; ++rc)" in code
    for name in ("fused_lora.cu", "ragged_lora.cu"):   # one routine
        text = (CSRC / name).read_text()
        assert "__global__" not in text and "lora_fwd::launch<" in text


# --------------------------------------------------- operand checks
def _no_build(monkeypatch):
    def refuse(name):
        raise AssertionError(f"built {name} before the operand checks")
    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(build, "build_all", lambda: refuse("all"))


def _masked(r_pad=16, dtype=torch.bfloat16, a_ld=None,
            tm_dtype=torch.int32):
    """Masked-kernel operands: A the packed pair's strided stacked view
    (K, d_in, r_pad), or with a_ld a slice of wider rows."""
    K, d_in, d_out, T = 2, 32, 48, 32
    x = torch.zeros((T, d_in), dtype=dtype)
    if a_ld is None:
        A = torch.zeros((d_in, K * r_pad), dtype=torch.bfloat16)
        A = A.reshape(d_in, K, r_pad).movedim(-2, -3)
    else:
        A = torch.zeros((K, d_in, a_ld), dtype=torch.bfloat16)[..., :r_pad]
    B = torch.zeros((K, r_pad, d_out), dtype=torch.bfloat16)
    return (x, A, B, torch.zeros(T // 16, dtype=tm_dtype),
            torch.full((K,), r_pad, dtype=torch.int32))


@pytest.mark.parametrize("case,match", [
    (dict(r_pad=264), "r_pad > 256"),
    (dict(r_pad=12), "multiples of 8"),        # a 24-byte A row
    (dict(r_pad=16, a_ld=20), "multiples of 8"),     # A rows of 20
    (dict(dtype=torch.float32), "bf16"),
    (dict(tm_dtype=torch.int64), "int32"),
    (dict(), "device"),                        # all fine but the CPU
])
def test_fused_lora_refuses_before_any_build(case, match, monkeypatch):
    _no_build(monkeypatch)
    x, A, B, tm, rk = _masked(**case)
    with pytest.raises(ValueError, match=match):
        fused_lora.check_fused_lora_operands(x, A, B, tm, rk, 16)


@pytest.mark.parametrize("ranks,d_in,dtype,match", [
    ((8, 264), 32, torch.bfloat16, "wider than 256"),
    ((8, 16), 36, torch.bfloat16, "multiples of 8"),
    ((8, 16), 32, torch.float32, "bf16"),
    ((8, 16), 32, torch.bfloat16, "device"),   # all fine but the CPU
])
def test_ragged_lora_fwd_refuses_before_any_build(ranks, d_in, dtype, match,
                                                  monkeypatch):
    _no_build(monkeypatch)
    lay = lora.RankLayout(ranks, 8)
    meta = ragged.RaggedMeta.build((0, 1), lay)
    x = torch.zeros((32, d_in), dtype=dtype)
    A = torch.zeros((d_in, lay.total), dtype=torch.bfloat16)
    B = torch.zeros((lay.total, 48), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=match):
        ragged.check_kernel_operands("ragged_lora_fwd",
                                     (("x", x), ("A", A), ("B", B)), 16,
                                     meta, (d_in, 48))


def test_fwd_wrappers_take_the_plain_version_on_the_cpu(monkeypatch):
    """A CPU tensor runs the plain version: no build, no launch count."""
    _no_build(monkeypatch)
    x, A, B, tm, rk = _masked()
    before = fused_lora.fused_lora_cuda.launches
    y = fused_lora.fused_lora_cuda(x, A, B, tm, rk, block_t=16)
    assert y.shape == (32, 48)
    assert fused_lora.fused_lora_cuda.launches == before
    lay = lora.RankLayout((8, 16), 8)
    meta = ragged.RaggedMeta.build((0, 1), lay)
    before = ragged.ragged_lora_fwd.launches
    y = ragged.ragged_lora_fwd(torch.zeros((32, 32)),
                               torch.zeros((32, lay.total)),
                               torch.zeros((lay.total, 48)), meta,
                               block_t=16)
    assert y.shape == (32, 48) and ragged.ragged_lora_fwd.launches == before


# ------------------------------------------- plain vs Pallas, new cases
def _pair(a: np.ndarray, dtype: str):
    j = jnp.asarray(a)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype == "bfloat16":
        return j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


def _close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# (token tiles' adapters, block_t, ranks): one 16-row tile (decode's
# solo row block), three 16-row tiles (48 rows), and a 256-lane segment
FWD_CASES = [((0,), 16, (4, 8, 20)), ((2, 0, 2), 16, (4, 8, 20)),
             ((1, 0), 16, (250, 8))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(FWD_CASES)))
def test_ragged_fwd_plain_matches_pallas_at_new_geometry(case, dtype):
    tile_jobs, block_t, ranks = FWD_CASES[case]
    rng = np.random.default_rng(case)
    d_in, d_out = 32, 48
    ref_lay = ref_lora.RankLayout(ranks, 8)
    act = np.asarray(ref_lay.active_cols)
    A = (rng.standard_normal((d_in, ref_lay.total)) * act[None]
         ).astype(np.float32) / 4
    B = (rng.standard_normal((ref_lay.total, d_out)) * act[:, None]
         ).astype(np.float32) / 8
    x = rng.standard_normal((len(tile_jobs) * block_t, d_in)
                            ).astype(np.float32)
    (xj, xt), (Aj, At), (Bj, Bt) = (_pair(a, dtype) for a in (x, A, B))
    want = ref_ragged.ragged_lora_fwd(
        xj, Aj, Bj, ref_ragged.RaggedMeta.build(tile_jobs, ref_lay),
        block_t=block_t, interpret=True)
    got = ragged.ragged_lora_fwd(
        xt, At, Bt, ragged.RaggedMeta.build(tile_jobs,
                                            lora.RankLayout(ranks, 8)),
        block_t=block_t)
    assert max(lora.RankLayout(ranks, 8).r_pads) <= 256
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tile_map,r_pad", [((1,), 16), ((2, 0, 2), 16),
                                            ((0, 1), 256)])
def test_masked_fwd_plain_matches_pallas_at_new_geometry(tile_map, r_pad,
                                                         dtype):
    rng = np.random.default_rng(r_pad + len(tile_map))
    K, block_t, d_in, d_out = 3, 16, 24, 40
    ranks = np.asarray([3, r_pad, r_pad - 5], np.int32)
    A = rng.standard_normal((K, d_in, r_pad)).astype(np.float32) / 4
    B = rng.standard_normal((K, r_pad, d_out)).astype(np.float32) / 8
    x = rng.standard_normal((len(tile_map) * block_t, d_in)
                            ).astype(np.float32)
    (xj, xt), (Aj, At), (Bj, Bt) = (_pair(a, dtype) for a in (x, A, B))
    tm = np.asarray(tile_map, np.int32)
    want = ref_fused.fused_lora_pallas(xj, Aj, Bj, jnp.asarray(tm),
                                       jnp.asarray(ranks), block_t=block_t,
                                       interpret=True)
    got = fused_lora.fused_lora_cuda(xt, At, Bt, torch.from_numpy(tm),
                                     torch.from_numpy(ranks),
                                     block_t=block_t)
    assert got.dtype == xt.dtype
    _close(got, want, TOL[dtype])
