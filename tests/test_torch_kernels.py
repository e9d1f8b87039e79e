"""The PyTorch port's kernels and host contracts held against the JAX
reference on the CPU.

Both sides get the same inputs, drawn with a seeded numpy RNG.  On a CPU
tensor every port kernel wrapper runs its plain PyTorch version; the JAX
side runs the Pallas kernels in interpret mode, as the reference's own
tests do.  Tolerances:
  * f32 inputs (the algorithm under test): 1e-5 — the two sides sum
    the same products in another order;
  * bf16 inputs (the rounding points under test: xa rounded to bf16
    before the second product, bf16 outputs): 2e-2 at O(1) values — one
    bf16 ulp (2^-8 relative) of an xa lane may round the other way when
    the f32 sums differ in their last bits.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import ARCH_IDS, get_config as ref_get_config
from repro.core import jobs as ref_jobs
from repro.core import lora as ref_lora
from repro.kernels import flash_attention as ref_flash
from repro.kernels import fused_lora as ref_fused
from repro.kernels import ops as ref_ops
from repro.kernels import ragged as ref_ragged
from repro.kernels import ref as ref_ref

from repro_torch.configs import get_config
from repro_torch.core import jobs, lora
from repro_torch.kernels import flash_attention, fused_lora, ops, ragged, ref

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor."""
    j = jnp.asarray(a)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype == "bfloat16":
        return j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


def _close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _packed(rng, ranks, d_in, d_out, multiple=8):
    """Packed ragged pair with the kernel invariant (dead lanes zero)."""
    lay = ref_lora.RankLayout(tuple(ranks), multiple)
    act = np.asarray(lay.active_cols)
    A = (rng.standard_normal((d_in, lay.total)) * act[None]).astype(np.float32)
    B = (rng.standard_normal((lay.total, d_out)) * act[:, None]
         ).astype(np.float32) * 0.5
    return lay, A, B


# ---------------------------------------------------- (a) ragged kernel
RANKS = (4, 8, 20, 3)
TILE_LAYOUTS = [(0, 0, 1, 2, 2, 2, 3), (3, 1, 1, 0), (2,), (0, 1, 2, 3),
                (1, 1, 3, 3, 3)]          # last: adapters 0 and 2 own none


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tile_jobs", TILE_LAYOUTS)
def test_ragged_fwd_plain_matches_pallas(tile_jobs, dtype):
    rng = np.random.default_rng(len(tile_jobs))
    block_t, d_in, d_out = 8, 32, 48
    lay, A, B = _packed(rng, RANKS, d_in, d_out)
    x = rng.standard_normal((len(tile_jobs) * block_t, d_in)).astype(np.float32)
    (xj, xt), (Aj, At), (Bj, Bt) = (_pair(a, dtype) for a in (x, A, B))
    want = ref_ragged.ragged_lora_fwd(
        xj, Aj, Bj, ref_ragged.RaggedMeta.build(tile_jobs, lay),
        block_t=block_t, interpret=True)
    port_lay = lora.RankLayout(RANKS, 8)
    got = ragged.ragged_lora_fwd(
        xt, At, Bt, ragged.RaggedMeta.build(tile_jobs, port_lay),
        block_t=block_t)
    assert got.dtype == torch.float32
    _close(got, want, TOL[dtype])


# ---------------------------------------------------- (b) masked kernel
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tile_map", [(0, 1, 2, 1, 0), (2, 2, 2), (1,)])
def test_masked_fwd_plain_matches_pallas(tile_map, dtype):
    rng = np.random.default_rng(7)
    K, r_pad, block_t, d_in, d_out = 3, 8, 8, 24, 40
    ranks = np.asarray([3, 8, 5], np.int32)
    A = rng.standard_normal((K, d_in, r_pad)).astype(np.float32)
    B = rng.standard_normal((K, r_pad, d_out)).astype(np.float32) * 0.5
    x = rng.standard_normal((len(tile_map) * block_t, d_in)).astype(np.float32)
    (xj, xt), (Aj, At), (Bj, Bt) = (_pair(a, dtype) for a in (x, A, B))
    tm = np.asarray(tile_map, np.int32)
    want = ref_fused.fused_lora_pallas(xj, Aj, Bj, jnp.asarray(tm),
                                       jnp.asarray(ranks), block_t=block_t,
                                       interpret=True)
    got = fused_lora.fused_lora_cuda(xt, At, Bt, torch.from_numpy(tm),
                                     torch.from_numpy(ranks), block_t=block_t)
    assert got.dtype == xt.dtype
    _close(got, want, TOL[dtype])


# ----------------------------------------------------- (c) flash kernel
@pytest.mark.parametrize("causal,Sq,Skv", [(True, 32, 32), (False, 32, 32),
                                           (False, 16, 48)])
def test_flash_plain_matches_pallas(causal, Sq, Skv):
    rng = np.random.default_rng(Sq + Skv)
    q = rng.standard_normal((3, Sq, 16)).astype(np.float32)
    k = rng.standard_normal((3, Skv, 16)).astype(np.float32)
    v = rng.standard_normal((3, Skv, 16)).astype(np.float32)
    want = ref_flash.flash_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=16, block_k=16, interpret=True)
    got, _ = flash_attention.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal)
    _close(got, want, TOL["float32"])


@pytest.mark.parametrize("hd,causal", [(32, True), (128, True),
                                       (32, False), (128, False)])
def test_flash_plain_matches_pallas_at_kernel_head_dims(hd, causal):
    """The plain version at head dims 32 and 128 (the kernel's other
    instantiations) against the reference's Pallas kernel in interpret
    mode, with a GQA ratio of 2 (the reduced configs' heads) and
    ragged 40-row sequences; f32, the algorithm under test."""
    rng = np.random.default_rng(hd + causal)
    S, groups = 40, 2
    q = rng.standard_normal((4, S, hd)).astype(np.float32)
    k = rng.standard_normal((2, S, hd)).astype(np.float32)
    v = rng.standard_normal((2, S, hd)).astype(np.float32)
    rep = lambda a: jnp.repeat(jnp.asarray(a), groups, axis=0)
    want = ref_flash.flash_attention_fwd(
        jnp.asarray(q), rep(k), rep(v), causal=causal, block_q=8,
        block_k=8, interpret=True)
    got, lse = flash_attention.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, kv_groups=groups)
    assert got.shape == (4, S, hd) and lse.shape == (4, S)
    _close(got, want, TOL["float32"])


@pytest.mark.parametrize("groups", [2, 4])
def test_flash_kv_groups_matches_repeated_heads(groups):
    """Reading kv head bh // groups equals the reference's repeated kv."""
    rng = np.random.default_rng(groups)
    q = rng.standard_normal((2 * groups, 32, 16)).astype(np.float32)
    k = rng.standard_normal((2, 32, 16)).astype(np.float32)
    v = rng.standard_normal((2, 32, 16)).astype(np.float32)
    rep = lambda a: jnp.repeat(jnp.asarray(a), groups, axis=0)
    want = ref_flash.flash_attention_ref(jnp.asarray(q), rep(k), rep(v))
    got, _ = flash_attention.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        kv_groups=groups)
    _close(got, want, TOL["float32"])


# ------------------------------------------------------ (d) dispatch
_JAX_IMPL = {"ref": "ref", "loop": "loop", "cuda": "pallas"}
_DISPATCH = [
    # ranks, rows per job, seq, static tile map given
    ((4, 8, 20, 3), (2, 1, 1, 2), 8, True),
    ((4, 8, 20, 3), (2, 1, 1, 2), 8, False),     # no tile map: fallback
    ((16, 4), (1, 3), 16, True),
]


@pytest.mark.parametrize("impl", ["ref", "loop", "cuda"])
@pytest.mark.parametrize("case", range(len(_DISPATCH)))
def test_fused_lora_ragged_dispatch_matches_reference(case, impl):
    ranks, rows, seq, static = _DISPATCH[case]
    rng = np.random.default_rng(case)
    block_t, d_in, d_out = 8, 32, 24
    lay, A, B = _packed(rng, ranks, d_in, d_out)
    ids = np.repeat(np.arange(len(ranks)), np.asarray(rows) * seq
                    ).astype(np.int32)
    x = rng.standard_normal((len(ids), d_in)).astype(np.float32)
    scal = (16.0 / np.asarray(ranks)).astype(np.float32)
    rk = np.asarray(ranks, np.int32)
    slice_rows = tuple(rows) if static else None
    want = ref_ops.fused_lora_ragged(
        jnp.asarray(x), jnp.asarray(A), jnp.asarray(B), jnp.asarray(ids),
        jnp.asarray(scal), lay, impl=_JAX_IMPL[impl], block_t=block_t,
        slice_rows=slice_rows, seq_len=seq,
        solo_rows=tuple(rows) if static else (), ranks=jnp.asarray(rk))
    got = ops.fused_lora_ragged(
        torch.from_numpy(x), torch.from_numpy(A), torch.from_numpy(B),
        torch.from_numpy(ids), torch.from_numpy(scal),
        lora.RankLayout(ranks, 8), impl=impl, block_t=block_t,
        slice_rows=slice_rows, seq_len=seq, ranks=torch.from_numpy(rk))
    _close(got, want, TOL["float32"])


@pytest.mark.parametrize("impl", ["ref", "loop", "cuda"])
def test_fused_lora_masked_dispatch_matches_reference(impl):
    rng = np.random.default_rng(11)
    K, r_pad, block_t, d_in, d_out = 3, 8, 8, 16, 24
    ranks = np.asarray([2, 8, 5], np.int32)
    ids = np.repeat(np.asarray([1, 0, 2, 2], np.int32), block_t)
    A = rng.standard_normal((K, d_in, r_pad)).astype(np.float32)
    B = rng.standard_normal((K, r_pad, d_out)).astype(np.float32)
    x = rng.standard_normal((len(ids), d_in)).astype(np.float32)
    scal = (16.0 / ranks).astype(np.float32)
    want = ref_ops.fused_lora(*map(jnp.asarray, (x, A, B, ids, ranks, scal)),
                              impl=_JAX_IMPL[impl], block_t=block_t)
    got = ops.fused_lora(*map(torch.from_numpy, (x, A, B, ids, ranks, scal)),
                         impl=impl, block_t=block_t)
    _close(got, want, TOL["float32"])


@pytest.mark.parametrize("ranks", [(8, 3, 6), (4, 8, 20, 3)])
def test_multilora_apply_routes_match_reference(ranks):
    """Uniform padded widths take the masked family, mixed ones the
    ragged family — on both sides, with the same values."""
    rng = np.random.default_rng(sum(ranks))
    block_t, d_in, d_out, seq = 8, 16, 24, 8
    lay, A, B = _packed(rng, ranks, d_in, d_out)
    rows = tuple(1 for _ in ranks)
    aid = np.arange(len(ranks), dtype=np.int32)
    x = rng.standard_normal((len(ranks), seq, d_in)).astype(np.float32)
    scal = (16.0 / np.asarray(ranks)).astype(np.float32)
    ctx = ref_lora.MultiLoRA(adapter_ids=jnp.asarray(aid),
                             ranks=jnp.asarray(ranks, jnp.int32),
                             scalings=jnp.asarray(scal), impl="pallas",
                             block_t=block_t, layout=lay, rows_all=rows)
    want = ctx.apply(jnp.asarray(x), {"A": jnp.asarray(A),
                                      "B": jnp.asarray(B)})
    port = lora.MultiLoRA(adapter_ids=torch.from_numpy(aid),
                          ranks=torch.tensor(ranks, dtype=torch.int32),
                          scalings=torch.from_numpy(scal), impl="cuda",
                          block_t=block_t, layout=lora.RankLayout(ranks, 8),
                          rows_all=rows)
    assert port.layout.is_uniform == lay.is_uniform
    got = port.apply(torch.from_numpy(x), {"A": torch.from_numpy(A),
                                           "B": torch.from_numpy(B)})
    _close(got, want, TOL["float32"])


@pytest.mark.parametrize("impl", ["torch", "xla"])
def test_unported_impls_raise(impl):
    """The reference's name "xla" is refused; its port "torch" runs (the
    masked mirror of "xla": zero adapters give a zero delta)."""
    x = torch.zeros((8, 4))
    call = lambda: ops.fused_lora(
        x, torch.zeros((1, 4, 8)), torch.zeros((1, 8, 4)),
        torch.zeros(8, dtype=torch.int32), torch.ones(1, dtype=torch.int32),
        torch.ones(1), impl=impl, block_t=8)
    if impl == "torch":
        assert torch.equal(call(), torch.zeros((8, 4)))
        return
    with pytest.raises(ValueError):
        call()


@pytest.mark.parametrize("fn", ["rank_mask", "fused_lora_ref",
                                "fused_lora_loop", "grouped_matmul_ref"])
def test_oracles_match_reference(fn):
    rng = np.random.default_rng(3)
    K, r, d_in, d_out, T = 3, 8, 12, 10, 20
    ids = rng.integers(0, K, T).astype(np.int32)
    ranks = np.asarray([3, 8, 5], np.int32)
    scal = (16.0 / ranks).astype(np.float32)
    x = rng.standard_normal((T, d_in)).astype(np.float32)
    A = rng.standard_normal((K, d_in, r)).astype(np.float32)
    B = rng.standard_normal((K, r, d_out)).astype(np.float32)
    args = {"rank_mask": (rng.standard_normal((T, r)).astype(np.float32),
                          ids, ranks),
            "fused_lora_ref": (x, A, B, ids, ranks, scal),
            "fused_lora_loop": (x, A, B, ids, ranks, scal),
            "grouped_matmul_ref": (x, A, ids)}[fn]
    want = getattr(ref_ref, fn)(*map(jnp.asarray, args))
    got = getattr(ref, fn)(*map(torch.from_numpy, args))
    _close(got, want, TOL["float32"])


# --------------------------------------------- (e) host-side contracts
RANK_MIXES = [(4,), (64,), (4, 1, 64, 8), (8, 8, 16, 8), (2, 64, 1, 8, 32),
              (16, 16, 12, 16), (8, 16, 32, 64)]


@pytest.mark.parametrize("multiple", [8, 16])
@pytest.mark.parametrize("ranks", RANK_MIXES)
def test_rank_layout_and_ragged_meta_fields(ranks, multiple):
    a = ref_lora.RankLayout(ranks, multiple)
    b = lora.RankLayout(ranks, multiple)
    for f in ("num_jobs", "r_pads", "is_uniform", "offsets", "total",
              "max_r_pad", "buckets"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("col_jobs", "active_cols"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.slice_of(len(ranks) - 1) == b.slice_of(len(ranks) - 1)
    assert lora.pad_rank(ranks[0], multiple) == \
        ref_lora.pad_rank(ranks[0], multiple)

    rng = np.random.default_rng(len(ranks) * multiple)
    tile_jobs = tuple(sorted(rng.integers(0, len(ranks), 6).tolist()))
    ma = ref_ragged.RaggedMeta.build(tile_jobs, a)
    mb = ragged.RaggedMeta.build(tile_jobs, b)
    assert dataclasses.asdict(ma) == dataclasses.asdict(mb)
    for fa, fb in zip(ma.fwd_flat + ma.wgrad_flat,
                      mb.fwd_flat + mb.wgrad_flat):
        np.testing.assert_array_equal(fa, fb)
    np.testing.assert_array_equal(ma.visited_rows, mb.visited_rows)
    # the CUDA kernel's per-tile table: (first column, width, true rank)
    want = [(b.offsets[k], b.r_pads[k], b.ranks[k]) for k in tile_jobs]
    assert mb.tile_table.tolist() == [list(t) for t in want]


@pytest.mark.parametrize("rows,seq,block_t,order", [
    ((2, 1, 3), 8, 8, None), ((2, 1, 3), 4, 8, None), ((1, 2), 16, 8, (1, 0)),
    ((3, 5), 1, 16, None), ((16, 16, 16, 16), 1, 16, None)])
def test_tile_jobs_static_and_host_helpers(rows, seq, block_t, order):
    assert ops._tile_jobs_static(rows, seq, block_t, order) == \
        ref_ops._tile_jobs_static(rows, seq, block_t, order)
    for b in (1, 2):
        assert jobs.tile_rows(rows[0], seq, block_t, shards=b) == \
            ref_jobs.tile_rows(rows[0], seq, block_t, shards=b)
    n = sum(rows) * seq
    assert fused_lora._fit_block(n, block_t * 3) == \
        ref_fused._fit_block(n, block_t * 3)


def test_lora_spec_and_pack_helpers_match_reference():
    spec = jobs.LoRAJobSpec("a", rank=8, batch_size=2)
    assert dataclasses.asdict(spec) == dataclasses.asdict(
        ref_jobs.LoRAJobSpec("a", rank=8, batch_size=2))
    assert spec.scaling == 2.0
    rng = np.random.default_rng(5)
    lay_r = ref_lora.RankLayout((4, 12, 1), 8)
    lay_p = lora.RankLayout((4, 12, 1), 8)
    _, A, B = _packed(rng, (4, 12, 1), 6, 5)
    for rm in (None, 24):
        for w, g in zip(ref_lora.unpack_dense(jnp.asarray(A), jnp.asarray(B),
                                              lay_r, rm),
                        lora.unpack_dense(torch.from_numpy(A),
                                          torch.from_numpy(B), lay_p, rm)):
            _close(g, w, 0.0)
    for k in range(3):
        w = ref_lora.extract_adapter({"A": A, "B": B}, lay_r, k)
        g = lora.extract_adapter({"A": torch.from_numpy(A),
                                  "B": torch.from_numpy(B)}, lay_p, k)
        for n in "AB":
            _close(g[n], w[n], 0.0)
    pairs = [ref_lora.extract_adapter({"A": A, "B": B}, lay_r, k)
             for k in range(3)]
    w = ref_lora.merge_adapter_pair(
        [{n: jnp.asarray(p[n]) for n in "AB"} for p in pairs], lay_r)
    g = lora.merge_adapter_pair(
        [{n: torch.from_numpy(np.ascontiguousarray(p[n])) for n in "AB"}
         for p in pairs], lay_p)
    for n in "AB":
        _close(g[n], w[n], 0.0)


# --------------------------------------------------------- (f) configs
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_copies_match_reference(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(ref_get_config(arch))
    assert dataclasses.asdict(get_config(arch + "-reduced")) == \
        dataclasses.asdict(ref_get_config(arch).reduced())


# ------------------------------------------------- (g) import hygiene
def test_port_imports_no_jax_and_no_reference():
    code = ("import sys, repro_torch, repro_torch.configs, repro_torch.core, "
            "repro_torch.kernels, repro_torch.models, repro_torch.serve, "
            "repro_torch.checkpoint, repro_torch.core.ssm, "
            "repro_torch.models.model, repro_torch.models.convert, "
            "repro_torch.optim, repro_torch.data, repro_torch.elastic, "
            "repro_torch.train.train_loop, repro_torch.launch.train, "
            "repro_torch.core.nanobatch, repro_torch.elastic.migrate, "
            "repro_torch.elastic.runtime, "
            "repro_torch.checkpoint.checkpoint, repro_torch.models.quant, "
            "repro_torch.core.throughput, repro_torch.core.scheduler, "
            "repro_torch.launch.mesh, repro_torch.elastic.engine, "
            "repro_torch.cluster, repro_torch.cluster.trace, "
            "repro_torch.cluster.simulator, repro_torch.cluster.baselines, "
            "repro_torch.cluster.metrics, repro_torch.train.serve\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n"
            "assert 'torch' in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("hd,dtype,match", [
    (80, torch.bfloat16, "head dim"), (96, torch.bfloat16, "head dim"),
    (64, torch.float32, "bf16"), (64, torch.bfloat16, "device")])
def test_flash_kernel_refuses_what_it_does_not_take(hd, dtype, match):
    """The Hopper flash kernel takes head dims 32, 64 and 128 in bf16 on a
    CUDA device: the check the wrapper makes before any build refuses the
    rest."""
    q = torch.zeros((8, 16, hd), dtype=dtype)
    kv = torch.zeros((2, 16, hd), dtype=dtype)
    with pytest.raises(ValueError, match=match):
        flash_attention.check_kernel_operands(q, kv, kv)


@pytest.mark.parametrize("hd", [32, 64, 128, 80, 96, 192, 256])
def test_flash_kernel_head_dims(hd):
    """Head dims 32, 64 and 128 in bf16 pass every check but the device
    (a CPU tensor here); 80, 96, 192 and 256 are refused for their head
    dim, before any build."""
    q = torch.zeros((8, 16, hd), dtype=torch.bfloat16)
    kv = torch.zeros((2, 16, hd), dtype=torch.bfloat16)
    taken = hd in flash_attention.KERNEL_HEAD_DIMS
    assert taken == (hd in (32, 64, 128))
    with pytest.raises(ValueError, match="device" if taken else "head dim"):
        flash_attention.check_kernel_operands(q, kv, kv)


def test_cuda_wrappers_refuse_bad_input_before_any_build():
    """A wrong shape or dtype raises on any device, before a kernel is
    built."""
    with pytest.raises(ValueError):
        ragged.ragged_lora_fwd(torch.zeros((12, 4)), torch.zeros((4, 8)),
                               torch.zeros((8, 4)),
                               ragged.RaggedMeta.build(
                                   (0,), lora.RankLayout((8,), 8)),
                               block_t=8)
    meta = ragged.RaggedMeta.build((0,), lora.RankLayout((8,), 8))
    with pytest.raises(ValueError):
        ragged.ragged_lora_dgrad(torch.zeros((8, 4)), torch.zeros((4, 16)),
                                 torch.zeros((8, 4)), meta, block_t=8)
    with pytest.raises(ValueError):
        ragged.ragged_wgrad(torch.zeros((8, 8)), torch.zeros((16, 4)), meta,
                            block_t=8)
    with pytest.raises(ValueError):
        flash_attention.flash_attention_fwd(torch.zeros((3, 8, 16)),
                                            torch.zeros((2, 8, 16)),
                                            torch.zeros((2, 8, 16)))
    q8 = torch.zeros((16, 32), dtype=torch.int8)
    with pytest.raises(ValueError):          # x and q do not chain
        fused_lora.dequant_matmul_cuda(torch.zeros((8, 24)), q8,
                                       torch.ones(32))
    with pytest.raises(ValueError):          # q not int8
        fused_lora.dequant_matmul_cuda(torch.zeros((8, 16)),
                                       torch.zeros((16, 32)), torch.ones(32))
    with pytest.raises(ValueError):          # scale not f32 of (N,)
        fused_lora.dequant_matmul_cuda(torch.zeros((8, 16)), q8,
                                       torch.ones(16))
