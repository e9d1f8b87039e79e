"""Tensor parallelism (``tp_mode="auto"``) for every model family and the
int8 backbone (ROADMAP A8b, A8c) on the CPU: four gloo ranks (one spawn
for the file, tests/torch_sharded_worker.py, scenario ``tpf_parity``)
train reduced f32 deepseek-v2-lite-16b (MLA, and its MoE expert
parallel), mamba2-2.7b (SSD), recurrentgemma-9b (RG-LRU and local
attention), hubert-xlarge (the audio front end, a non-causal encoder),
internvl2-26b (the VLM front end) and tinyllama-1.1b with its backbone
in int8 through ``GroupRuntime(tp_mode="auto")``, job set "rag" (ranks 4
and 64: the ragged kernels' plain versions), impl "cuda", block_t 8, 2
steps: at data 1 x model 2 on each pair of the world, and mamba2 and
recurrentgemma also at data 1 x model 4 (mamba2's 8 B/C groups 2 a
rank; recurrentgemma's 2 kv heads each shared by 2 ranks).

Every run is held against the reference's single-device step on the
same batches, frames and patches (``_ref_run``; the int8 run against
the reference's int8 step, its backbone quantized by the reference) at
the sharded tests' bars (tests/torch_sharded_common.py: per-job losses
at 1e-4, adapters and moments within 2.5e-2 and within 1e-5 for over
85% of the coordinates, Adam steps exactly); every rank's adapters and
moments are bit-equal; each rank holds only its slices (``sharding/
rules.executed_cut``: the runtime specs, and where the port departs
from them, the SSD segments, MLA's whole ``w_kv_a``, RG-LRU's
row-parallel ``w_out``), its int8 codes and scales cut as the dense
leaves they stand for.  A rank's cut of the reference's int8 tree carried across
(``models/convert``) equals the same cut of the reference's arrays.
"""
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.core.jobs import LoRAJobSpec as RefSpec
from repro.models import model as RM  # noqa: F401  (the import cycle)
from repro.models import quant as RQ
from repro.sharding import rules as ref_rules

from repro_torch.data.pipeline import frontend_inputs
from repro_torch.models import model as M
from repro_torch.models.convert import adapters_from_numpy, params_from_numpy
from repro_torch.models.quant import QuantTensor
from repro_torch.models.ssd import NGROUPS
from repro_torch.sharding import rules

import torch_sharded_common as C
import torch_sharded_worker as W
from torch_train_common import one_torch_thread  # noqa: F401


def _ref_cfg(key):
    return W.tpf_cfg(key, ref_get_config)


def _ref_run(key, weights, steps=2) -> dict:
    """The reference's single-device step, *steps* times, on the batches
    the port's runtime draws: the reference's ``FusedBatcher`` (seed 0),
    a front end's frames or patches drawn for the chunk of 2 steps at
    once from ``default_rng(0)`` (``GroupRuntime``'s draw); "q8" with its
    backbone quantized by the reference's ``quantize_params``."""
    from repro.core import ssm as rs
    from repro.core.ssm import SharedSuperModel as RefSSM
    from repro.data.pipeline import FusedBatcher as RefBatcher
    from repro.optim import adamw as ra
    rcfg, pcfg = _ref_cfg(key), W.tpf_cfg(key)
    specs = W.specs("rag", RefSpec)
    K = len(specs)
    params, adapters = (jax.tree.map(jnp.asarray, t) for t in weights)
    if key == "q8":
        params = RQ.quantize_params(params)
    ssm = RefSSM(rcfg, specs, impl="ref", block_t=W.BT)
    fb = RefBatcher(specs, rcfg.vocab_size, block_t=W.BT, seed=0)
    chunk = [fb.next_batch() for _ in range(steps)]
    stacked = {k: np.stack([b[k] for b in chunk]) for k in chunk[0]}
    stacked = frontend_inputs(pcfg, stacked, np.random.default_rng(0))

    def loss(ad, nb, denom):
        lora = ssm.lora_ctx(nb["adapter_ids"])
        total, aux = RM.loss_fn(rcfg, params, ad, lora, nb, remat=False,
                                per_job_denom=denom)
        return total, aux["per_job"]

    grad = jax.jit(jax.grad(loss, has_aux=True))
    opt = ra.init(adapters, per_job=K)
    losses = []
    for i in range(steps):
        nb = {k: jnp.asarray(v[i]) for k, v in stacked.items()}
        denom = rs._per_job_token_counts(nb, K, causal=rcfg.causal)
        g, pj = grad(adapters, nb, denom)
        g = jax.tree.map(lambda t: t.astype(jnp.float32), g)
        adapters, opt = ra.update(g, opt, adapters, lr=W.LR,
                                  col_jobs=ssm.layout.col_jobs)
        losses.append(np.asarray(pj, np.float64))
    return {"losses": np.asarray(losses),
            "adapters": W.flat(jax.tree.map(np.asarray, adapters)),
            "mu": W.flat(jax.tree.map(np.asarray, opt.mu)),
            "nu": W.flat(jax.tree.map(np.asarray, opt.nu)),
            "step": np.asarray(opt.step).tolist(),
            "steps_done": {s.job_id: steps for s in specs}}


def _ref_weights(key):
    """The reference's (params, adapters) of job set "rag" on *key*'s
    config, drawn from PRNGKey(SEED) by its jitted ``init`` (an eager
    init draws other values from the same key), as numpy."""
    from repro.core.ssm import SharedSuperModel as RefSSM
    ssm = RefSSM(_ref_cfg(key), W.specs("rag", RefSpec), impl="xla",
                 block_t=W.BT)
    return jax.tree.map(np.asarray, jax.jit(ssm.init)(
        jax.random.PRNGKey(W.SEED)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results, with the reference's runs made while the
    ranks work, four configs at a time in processes of their own (each
    compiles its own steps: one after another they take a minute)."""
    keys = list(W.TPF_ARCHS)
    with ProcessPoolExecutor(4, mp_context=mp.get_context("spawn")) as pool:
        weights = dict(zip(keys, pool.map(_ref_weights, keys)))
        inputs = {f"tpf:{k}": {"params": params_from_numpy(w[0], "cpu"),
                               "adapters": adapters_from_numpy(w[1], "cpu")}
                  for k, w in weights.items()}
        handle = C.spawn(W.TP_FAMILIES, tmp_path_factory.mktemp("tpf"),
                         inputs)
        ref = dict(zip(keys, pool.map(_ref_run, keys,
                                      [weights[k] for k in keys])))
    return {"ranks": C.collect(handle), "ref": ref}


def _all(runs):
    return [C.result(runs["ranks"], "tpf_parity", r) for r in range(4)]


def _local_shapes(key, m, index) -> dict:
    """{leaf path: shape} of model rank *index*'s executed cut of *key*'s
    backbone (int8 for "q8": codes and scales as two leaves)."""
    cfg = W.tpf_cfg(key)
    full = M.init_model(cfg, device="meta")
    if key == "q8":
        from repro_torch.models.quant import quantize_params
        full = quantize_params(M.init_model(cfg, device="cpu"))
    cut = rules.shard_params(full, M.init_model(cfg, device="meta"), m,
                             index, cfg=cfg)
    return {k: tuple(v.shape) for k, v in W.flat_q(cut).items()}


CASES = [(k, "m2") for k in W.TPF_ARCHS] + [(k, "m4") for k in W.TPF_M4]


@pytest.mark.parametrize("key,mesh", CASES)
def test_family_over_a_model_axis_matches_the_reference(runs, key, mesh):
    """Each family's run on every rank against the reference's
    single-device step; every rank's trainable state bit-equal."""
    m = 2 if mesh == "m2" else 4
    got = [res[mesh][key] for res in _all(runs)]
    for r, g in enumerate(got):
        C.compare(runs["ref"][key], g)
        assert g["model_axis"] == (m, r % m)
    for part in ("adapters", "mu", "nu"):
        for g in got[1:]:
            assert all(np.array_equal(g[part][k], got[0][part][k])
                       for k in got[0][part]), (key, mesh, part)


@pytest.mark.parametrize("key,mesh", CASES)
def test_each_rank_holds_only_its_slices(runs, key, mesh):
    """Every backbone leaf a rank holds has its executed cut's shape, the
    leaves the model axis splits are smaller than whole, and the int8
    run's projections stay int8 codes with f32 scales."""
    m = 2 if mesh == "m2" else 4
    whole = _local_shapes(key, 1, 0)
    for r, res in enumerate(_all(runs)):
        g = res[mesh][key]
        want = _local_shapes(key, m, r % m)
        assert g["shapes"] == want, key
        cut = {k for k in want if want[k] != whole[k]}
        assert any(k.endswith(("wq", "w_in", "w_x", "wq/q")) for k in cut)
        if key == "q8":
            assert g["dtypes"]["segments/0/0/attn/wo/q"] == "torch.int8"
            assert g["dtypes"]["segments/0/0/attn/wo/scale"] == \
                "torch.float32"
            # a row block keeps every column's scale
            assert "segments/0/0/attn/wo/scale" not in cut
            assert "segments/0/0/attn/wq/scale" in cut


def _ref_int8(key):
    rcfg = _ref_cfg(key)
    return jax.tree.map(np.asarray, jax.jit(lambda k: RQ.quantize_params(
        RM.init_model(k, rcfg)))(jax.random.PRNGKey(W.SEED)))


@pytest.mark.parametrize("key", ["q8", "mb"])
def test_a_ranks_int8_slices_are_the_references_arrays_cut(key):
    """The reference's int8 tree carried across (``params_from_numpy``)
    and cut by ``shard_params``: each rank's codes and scales equal the
    same cut made by hand of the reference's arrays (a column block of
    q and of the scales; a row block of q with every scale; SSD's
    in-projection segment by segment, dt whole)."""
    cfg = W.tpf_cfg(key)
    ref = _ref_int8(key)
    port = params_from_numpy(ref, "cpu")
    full = M.init_model(cfg, device="meta")
    blk = ref["segments"][0]["0"]
    for m in (2, 4):
        for i in range(m):
            cut = rules.shard_params(port, full, m, i,
                                     cfg=cfg)
            got = cut["segments"][0]["0"]
            if key == "q8":
                a = blk["attn"]
                n = a["wq"].q.shape[-1] // m
                col = slice(i * n, (i + 1) * n)
                np.testing.assert_array_equal(got["attn"]["wq"].q.numpy(),
                                              a["wq"].q[..., col])
                np.testing.assert_array_equal(
                    got["attn"]["wq"].scale.numpy(), a["wq"].scale[..., col])
                r = a["wo"].q.shape[-2] // m
                np.testing.assert_array_equal(
                    got["attn"]["wo"].q.numpy(),
                    a["wo"].q[..., i * r:(i + 1) * r, :])
                np.testing.assert_array_equal(
                    got["attn"]["wo"].scale.numpy(), a["wo"].scale)
                f = blk["ffn"]["down"].q.shape[-2] // m
                np.testing.assert_array_equal(
                    got["ffn"]["down"].q.numpy(),
                    blk["ffn"]["down"].q[..., i * f:(i + 1) * f, :])
            else:
                di, N, H = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_nheads
                P, G = di // H, NGROUPS
                h = H // m
                g = G // m
                z = np.arange(i * h * P, (i + 1) * h * P)
                gb = np.arange(i * g * N, (i + 1) * g * N)
                cols = np.concatenate([z, di + z, 2 * di + gb,
                                       2 * di + G * N + gb,
                                       2 * di + 2 * G * N + np.arange(H)])
                w_in = blk["ssd"]["w_in"]
                np.testing.assert_array_equal(
                    got["ssd"]["w_in"].q.numpy(), w_in.q[..., cols])
                np.testing.assert_array_equal(
                    got["ssd"]["w_in"].scale.numpy(), w_in.scale[..., cols])
                np.testing.assert_array_equal(
                    got["ssd"]["conv_w"].numpy().astype(np.float32),
                    np.asarray(blk["ssd"]["conv_w"], np.float32)[
                        ..., np.concatenate([z, di + gb, di + G * N + gb])])
                w_out = blk["ssd"]["w_out"]
                np.testing.assert_array_equal(
                    got["ssd"]["w_out"].q.numpy(),
                    w_out.q[..., i * h * P:(i + 1) * h * P, :])


def test_param_specs_of_an_int8_tree_match_the_reference():
    """``param_specs`` of a quantized tree equal the reference's leaf by
    leaf, a QuantTensor's codes and scales replicated (no rule names
    them); ``shard_params`` cuts them all the same (the test above)."""
    for key in ("q8", "mb", "ds"):
        rp = jax.eval_shape(lambda: RQ.quantize_params(RM.init_model(
            jax.random.PRNGKey(0), _ref_cfg(key))))
        pp = _quantized_meta(key)
        for sizes in ({"data": 2, "model": 2}, {"data": 1, "model": 4}):
            for drop in ((), ("D", "B")):
                want = _flat_specs(ref_rules.param_specs(sizes, rp,
                                                         drop=drop))
                got = _flat_specs(rules.param_specs(sizes, pp, drop=drop))
                assert got == want, (key, sizes, drop)
                assert any(k.endswith("/q") for k in got)


def _quantized_meta(key):
    from repro_torch.models.quant import quantize_params
    return quantize_params(M.init_model(W.tpf_cfg(key), device="cpu"))


def _flat_specs(tree, path=()):
    """{path: spec tuple} of a spec tree, a QuantTensor's two specs as
    leaves "q" and "scale"."""
    if isinstance(tree, dict):
        return {p: v for k, t in tree.items()
                for p, v in _flat_specs(t, path + (str(k),)).items()}
    if isinstance(tree, list):
        return {p: v for i, t in enumerate(tree)
                for p, v in _flat_specs(t, path + (str(i),)).items()}
    if isinstance(tree, QuantTensor) or type(tree).__name__ == "QuantTensor":
        return {"/".join(path + ("q",)): tuple(tree.q),
                "/".join(path + ("scale",)): tuple(tree.scale)}
    return {"/".join(path): tuple(tree)}


@pytest.mark.parametrize("arch,m", [
    ("deepseek-v2-lite-16b", 16), ("mamba2-2.7b", 16), ("mamba2-2.7b", 4),
    ("recurrentgemma-9b", 16), ("hubert-xlarge", 16),
    ("internvl2-26b", 16)])
def test_runtime_cache_and_param_layout_of_the_families(arch, m):
    """At full size on ``meta`` tensors: each family's caches made for a
    model rank (``init_caches(tp=)``) have the local shapes of
    ``runtime_cache_specs`` (SSD's conv tail a ``Cut``; MLA's latent
    whole), and no mixer of the family runs whole at m
    (``whole_mixers``)."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import ModelAxis
    cfg = get_config(arch)
    assert M.whole_mixers(cfg, m) == ()
    if not cfg.supports_decode():
        return
    whole = M.init_caches(cfg, 4, 256, device="meta")
    sizes = {"data": 1, "model": m}
    specs = rules.runtime_cache_specs(sizes, whole, cfg)
    for i in (0, m - 1):
        loc = M.init_caches(cfg, 4, 256, device="meta",
                            tp=ModelAxis(None, m, i))
        for seg_w, seg_s, seg_l in zip(whole, specs, loc):
            for k in seg_w:
                for t, s, lt in zip(seg_w[k], seg_s[k], seg_l[k]):
                    assert tuple(lt.shape) == rules.local_shape(
                        tuple(t.shape), s, sizes), (arch, k, s)
    if arch == "mamba2-2.7b":
        conv = specs[0]["0"].conv[-1]
        assert isinstance(conv, rules.Cut)
        # m 16: 2 ranks share a group; m 4: 2 groups a rank
        N, di = cfg.ssm_state, cfg.ssm_d_inner
        assert conv.width == di // m + 2 * N * max(1, NGROUPS // m)


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_int8_partials_round_to_the_whole_product(impl):
    """The int8 product's f32 partials (``ops.dequant_matmul_f32``: a
    row-parallel rank's; ``ops.dequant_dx_f32``: a column-parallel
    rank's dx) are the whole product's unrounded values: two row blocks'
    partials sum, rounded once, to ``dequant_matmul`` within one bf16
    rounding, one partial alone rounds to it exactly, and the dx partial
    rounds to ``dequant_matmul``'s backward exactly, for each impl (on
    the CPU "cuda" is its kernel's plain version)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.quant import quantize_array
    g = torch.Generator().manual_seed(0)
    w = torch.randn((64, 48), generator=g) / 8
    qt = quantize_array(w)
    x = torch.randn((16, 64), generator=g).to(torch.bfloat16)
    whole = ops.dequant_matmul(x, qt.q, qt.scale, impl=impl)
    f32 = ops.dequant_matmul_f32(x, qt.q, qt.scale, impl)
    assert f32.dtype == torch.float32
    assert torch.equal(f32.to(torch.bfloat16), whole)
    parts = sum(ops.dequant_matmul_f32(x[:, r], qt.q[r], qt.scale, impl)
                for r in (slice(0, 32), slice(32, 64)))
    diff = (parts.to(torch.bfloat16).float() - whole.float()).abs()
    assert (diff <= whole.float().abs() * 2 ** -8 + 1e-6).all()
    xg = x.clone().requires_grad_(True)
    dy = torch.randn((16, 48), generator=g).to(torch.bfloat16)
    ops.dequant_matmul(xg, qt.q, qt.scale, impl=impl).backward(dy)
    dx = ops.dequant_dx_f32(dy, qt.q, qt.scale, impl)
    assert torch.equal(dx.to(torch.bfloat16), xg.grad)
