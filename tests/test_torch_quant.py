"""The port's int8 quantized backbone (``models/quant.py``, the dequant
matmul of ``kernels/fused_lora.py`` / ``kernels/ops.py``) held against
the JAX reference on the CPU, on reduced tinyllama-1.1b.

Inputs come from seeded numpy RNGs and the reference's ``init_model``
/ ``init_adapters`` (exported with ``np.asarray``, carried across with
``models/convert.py``).  The reference's dequant impl is set to
"pallas" (its kernel in interpret mode) for the duration of each test
that trains or serves, and set back to its default "xla" afterwards: the
knob is process-wide.  The port's "cuda" impl runs its kernel's plain
version on CPU tensors.  Tolerances:
  * quantization codes and scales: exact — both compute amax / 127, the
    division and the half-to-even rounding in f32;
  * the dequant product in f32: 1e-6 relative, plus 1e-6 of the output's
    largest |value| absolute (near-zero outputs cancel, and the two
    frameworks sum the 48 products in other orders); in bf16: at most one
    bf16 ulp of the reference's value (the f32 sums differ in their last
    bits and may round to the neighbouring bf16); at these sizes every
    entry comes out bit-equal, and the test asserts over 90% of them,
    leaving room for another BLAS's summation order;
  * dx in f32: 1e-5 relative and absolute, as tests/test_quant.py;
  * ``train_group`` losses in f32: 1e-5 relative, as
    tests/test_torch_train.py; int8 against bf16 within 0.05 relative, the
    reference's own bar (tests/test_quant.py);
  * served token ids: exact (greedy argmax over f32 logits); fused ==
    solo within the port: exact;
  * elastic: the migrated job's losses against its control run at
    tests/test_torch_elastic.py's 1e-5 relative and 1e-6 absolute.
"""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.core.jobs import LoRAJobSpec as RefSpec
from repro.core.lora import RankLayout as RefRankLayout
from repro.kernels import fused_lora as ref_fl
from repro.kernels import ops as ref_ops
from repro.models import model as RM
from repro.models import quant as ref_quant
from repro.serve import AdapterPool as RefPool
from repro.serve import ServeEngine as RefEngine
from repro.serve import ServeRequest as RefRequest
from repro.train.train_loop import train_group as ref_train_group

from repro_torch.configs import get_config
from repro_torch.core.jobs import LoRAJobSpec
from repro_torch.core.lora import RankLayout
from repro_torch.elastic.runtime import GroupRuntime
from repro_torch.kernels import fused_lora as fl
from repro_torch.kernels import ops
from repro_torch.models import model as M
from repro_torch.models import quant
from repro_torch.models.convert import (adapters_from_numpy,
                                        params_from_numpy, to_numpy)
from repro_torch.serve import AdapterPool, ServeEngine, ServeRequest
from repro_torch.train.train_loop import train_group

BT = 16
SEQ = 32
LR = 1e-2


def _cfgs(dtype="bfloat16"):
    ref = dataclasses.replace(ref_get_config("tinyllama-1.1b").reduced(),
                              dtype=dtype)
    port = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                               dtype=dtype)
    return ref, port


@pytest.fixture
def ref_pallas_dequant():
    """The reference's dequant impl set to its Pallas kernel, restored
    to the default "xla" however the test ends."""
    ref_quant.set_dequant_impl("pallas")
    try:
        yield
    finally:
        ref_quant.set_dequant_impl("xla")


def _quant_leaves(tree, path=()):
    """{key path: leaf} of nested dicts and lists; a quantized weight of
    either package (a node with ``q`` and ``scale``) is one leaf."""
    if isinstance(tree, dict):
        return {p: v for k, t in tree.items()
                for p, v in _quant_leaves(t, path + (k,)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, t in enumerate(tree)
                for p, v in _quant_leaves(t, path + (str(i),)).items()}
    return {path: tree}


def _np(a) -> np.ndarray:
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


# ------------------------------------------------------- (1) format
def test_quantize_params_codes_equal_reference():
    """The reference's bf16 params quantized by each package: every
    code and scale equal; the same leaves quantized and left dense."""
    ref_cfg, _ = _cfgs()
    params = jax.tree.map(np.asarray,
                          RM.init_model(jax.random.PRNGKey(0), ref_cfg))
    want = _quant_leaves(jax.tree.map(
        np.asarray, ref_quant.quantize_params(
            jax.tree.map(jnp.asarray, params), "int8")))
    port_params = params_from_numpy(params, "cpu")
    qp = quant.quantize_params(port_params, "int8")
    got = _quant_leaves(to_numpy(qp))
    assert got.keys() == want.keys()
    n_quant = 0
    for p, w in want.items():
        g = got[p]
        if isinstance(w, ref_quant.QuantTensor):
            assert isinstance(g, quant.QuantTensor), p
            assert g.q.dtype == np.int8 and g.scale.dtype == np.float32
            np.testing.assert_array_equal(g.q, np.asarray(w.q), err_msg=p)
            np.testing.assert_array_equal(g.scale, np.asarray(w.scale),
                                          err_msg=p)
            n_quant += 1
        else:
            assert not isinstance(g, quant.QuantTensor), p
            np.testing.assert_array_equal(g, _np(w), err_msg=p)
    # 7 projections per layer, one scanned stack each
    assert n_quant == 7
    for name in ("embed", "head", "ln_f"):
        assert not isinstance(qp[name], quant.QuantTensor)
    assert quant.TARGET_LEAVES == ref_quant.TARGET_LEAVES
    assert quant.is_quantized(qp) and not quant.is_quantized(port_params)
    assert quant.backbone_dtype(qp) == "int8"
    assert quant.backbone_dtype(port_params) == "bf16"
    # idempotent: a quantized tree's QuantTensors are reused as they are
    again = quant.quantize_params(qp, "int8")
    for p, leaf in _quant_leaves(qp).items():
        assert _quant_leaves(again)[p] is leaf
    assert quant.quantize_params(port_params, None) is port_params
    with pytest.raises(ValueError):
        quant.quantize_params(port_params, "int4")


def test_moe_expert_slabs_stay_dense():
    """The walk leaves a MoE dict's expert slabs (beside its router)
    dense, as the reference's, and quantizes the same names elsewhere."""
    rng = np.random.default_rng(0)
    w = lambda *s: rng.standard_normal(s).astype(np.float32)
    tree = {"ffn": {"router": w(8, 4), "w_in": w(4, 8, 6),
                    "w_out": w(4, 6, 8),
                    "shared": {"gate": w(8, 6), "up": w(8, 6)}},
            "ssd": {"w_in": w(8, 12), "w_out": w(12, 8), "D": w(4)}}
    got = quant.quantize_params(params_from_numpy(tree, "cpu"), "int8")
    want = ref_quant.quantize_params(jax.tree.map(jnp.asarray, tree),
                                     "int8")
    for p, leaf in _quant_leaves(want).items():
        mine = _quant_leaves(got)[p]
        assert isinstance(leaf, ref_quant.QuantTensor) == isinstance(
            mine, quant.QuantTensor), p
    assert not isinstance(got["ffn"]["w_in"], quant.QuantTensor)
    assert isinstance(got["ssd"]["w_in"], quant.QuantTensor)


# ---------------------------------------------- (2) the product
def _operands(T, dtype, seed=1, d_in=48, d_out=80):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, d_in)).astype(np.float32)
    w = (rng.standard_normal((d_in, d_out)) * 0.3).astype(np.float32)
    qt = ref_quant.quantize_array(jnp.asarray(w))
    q, s = np.asarray(qt.q), np.asarray(qt.scale)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return (jx, jnp.asarray(q), jnp.asarray(s),
            tx, torch.from_numpy(q.copy()), torch.from_numpy(s.copy()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [64, 40])
def test_dequant_matmul_matches_reference(T, dtype):
    """The port's plain version, its "cuda" wrapper and its "cuda" impl
    (CPU tensors: the plain version) against the reference's "xla" impl
    and its Pallas kernel in interpret mode; T = 40 is not a tile
    multiple."""
    jx, jq, js, tx, tq, ts = _operands(T, dtype)
    wants = [ref_ops.dequant_matmul(jx, jq, js, impl="xla"),
             ref_fl.dequant_matmul_pallas(jx, jq, js, interpret=True)]
    gots = [fl.dequant_matmul_plain(tx, tq, ts),
            fl.dequant_matmul_cuda(tx, tq, ts),
            ops.dequant_matmul(tx, tq, ts, impl="cuda"),
            ops.dequant_matmul(tx, tq, ts, impl="torch")]
    for want in wants:
        w = np.asarray(want.astype(jnp.float32))
        for got in gots:
            assert got.dtype == getattr(torch, dtype)
            g = got.float().numpy()
            if dtype == "float32":
                np.testing.assert_allclose(g, w, rtol=1e-6,
                                           atol=1e-6 * np.abs(w).max())
            else:
                ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w),
                                                          1e-30))) - 7)
                assert (np.abs(g - w) <= ulp).all()
                assert np.mean(g == w) > 0.9, np.mean(g == w)
    assert fl.dequant_matmul_cuda.launches == 0     # CPU: no kernel


def test_dequant_token_tile_does_not_depend_on_rows():
    """B10's launch grid covers (T, N) in one tile shape whatever the row
    count: a row's output must be the same bits in a 16-row decode step
    and an 8192-row training step.  The tile is a constant of the CUDA
    source, and its launcher derives the grid from T and N alone."""
    src = (Path(fl.__file__).parent / "csrc" / "dequant.cu").read_text()
    tile = {k: int(v) for k, v in
            re.findall(r"constexpr int (kB[MN]) = (\d+);", src)}
    assert tile == {"kBM": 256, "kBN": 128}
    launcher = src[src.index('extern "C" int dequant_matmul_launch'):]
    assert re.findall(r"const dim3 grid\((.*)\);", launcher) == [
        "(N + kBN - 1) / kBN, (T + kBM - 1) / kBM"]


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_dequant_matmul_dx_matches_reference(impl):
    """dx of sum(y^2) through the port's impl against jax.grad through
    the reference's Pallas custom VJP (f32); q and scale get none."""
    jx, jq, js, tx, tq, ts = _operands(32, "float32", seed=2, d_in=24,
                                       d_out=40)
    want = jax.grad(lambda x_: (ref_ops.dequant_matmul(
        x_, jq, js, impl="pallas") ** 2).sum())(jx)
    x = tx.clone().requires_grad_()
    (ops.dequant_matmul(x, tq, ts, impl=impl) ** 2).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------ (4) qdot
def test_qdot_dispatch_batched_and_stacked_slicing():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((16, 24)).astype(np.float32)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    qt = quant.quantize_array(torch.from_numpy(w))
    tx = torch.from_numpy(x)
    y_plain = quant.qdot(tx, torch.from_numpy(w))
    y_quant = quant.qdot(tx, qt)
    assert y_quant.shape == y_plain.shape == (2, 5, 24)
    want = ref_quant.qdot(jnp.asarray(x), ref_quant.quantize_array(
        jnp.asarray(w)))
    np.testing.assert_allclose(y_quant.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(y_quant, tx @ quant.asarray(qt), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError):
        quant.set_dequant_impl("xla")
    assert quant.get_dequant_impl() == "cuda"
    # a scanned (L, d_in, d_out) stack slices codes and scales together
    ws = rng.standard_normal((3, 8, 10)).astype(np.float32)
    stack = quant.quantize_array(torch.from_numpy(ws))
    ref_stack = ref_quant.quantize_array(jnp.asarray(ws))
    for i in range(3):
        layer = M._tree_map(lambda v: v[i], {"w": stack})["w"]
        assert isinstance(layer, quant.QuantTensor)
        assert layer.shape == (8, 10) and layer.scale.shape == (10,)
        np.testing.assert_array_equal(layer.q.numpy(),
                                      np.asarray(ref_stack.q[i]))
        np.testing.assert_array_equal(layer.scale.numpy(),
                                      np.asarray(ref_stack.scale[i]))
    first = M._unstack({"w": stack})["w"]
    assert torch.equal(first.q, stack.q[0])


# ------------------------------------------------------- (5) train
def _specs(cls, ranks=(4, 20, 8), batch=(2, 1, 1)):
    return [cls(f"job-{i}", rank=r, batch_size=b, seq_len=SEQ)
            for i, (r, b) in enumerate(zip(ranks, batch))]


def _train_weights(ref_cfg, seed=0):
    """Reference params + packed adapters (numpy trees), B nonzero."""
    from repro.core.ssm import SharedSuperModel as RefSSM
    ssm = RefSSM(ref_cfg, _specs(RefSpec), impl="pallas", block_t=BT)
    params, adapters = ssm.init(jax.random.PRNGKey(seed))
    params = jax.tree.map(np.asarray, params)
    adapters = jax.tree.map(np.asarray, adapters)
    act = np.asarray(ssm.layout.active_cols)
    rng = np.random.default_rng(seed)

    def fill_b(tree):
        for k, v in tree.items():
            if k == "B":
                tree[k] = (rng.standard_normal(v.shape) * 0.05
                           * act[:, None]).astype(np.float32)
            elif isinstance(v, dict):
                fill_b(v)
    for seg in adapters["segments"]:
        fill_b(seg)
    return params, adapters


def test_train_group_quantized_matches_reference(ref_pallas_dequant):
    """3 steps in chunks of 2 over an int8 backbone (f32 activations),
    the same weights and data streams: the port's per-step per-job
    losses against the reference's (ragged Pallas kernels, Pallas
    dequant); the port's int8 run against its run over the unquantized
    backbone within the reference's 0.05; the returned params
    quantized, the adapters not."""
    ref_cfg, cfg = _cfgs("float32")
    params, adapters = _train_weights(ref_cfg)
    want = ref_train_group(
        ref_cfg, _specs(RefSpec), steps=3, lr=LR, seed=0, impl="pallas",
        block_t=BT, adaptive_nano=False, nano_batches=1, remat=True,
        chunk_size=2, quantize="int8",
        params=jax.tree.map(jnp.asarray, params),
        adapters=jax.tree.map(jnp.asarray, adapters))
    kw = dict(steps=3, lr=LR, seed=0, impl="cuda", block_t=BT, chunk_size=2,
              adaptive_nano=False, device="cpu")
    got = train_group(cfg, _specs(LoRAJobSpec),
                      params=params_from_numpy(params, "cpu"),
                      adapters=adapters_from_numpy(adapters, "cpu"),
                      quantize="int8", **kw)
    dense = train_group(cfg, _specs(LoRAJobSpec),
                        params=params_from_numpy(params, "cpu"),
                        adapters=adapters_from_numpy(adapters, "cpu"), **kw)
    lq = np.stack(got["report"].per_job_losses)
    np.testing.assert_allclose(lq, np.stack(want["report"].per_job_losses),
                               rtol=1e-5)
    lb = np.stack(dense["report"].per_job_losses)
    assert np.max(np.abs(lb - lq) / np.abs(lb)) < 0.05, (lb, lq)
    assert not np.array_equal(lb, lq)          # the int8 backbone ran
    assert quant.is_quantized(got["params"])
    assert not quant.is_quantized(got["adapters"])
    assert got["runtime"].quantize == "int8"


# ------------------------------------------------------- (6) serve
def _serve_weights(ref_cfg, ranks, seed=0):
    lay = RefRankLayout(tuple(ranks), 8)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    params = jax.tree.map(np.asarray, RM.init_model(k1, ref_cfg))
    adapters = jax.tree.map(np.asarray, RM.init_adapters(
        k2, ref_cfg, jnp.asarray(ranks, jnp.int32), layout=lay))
    rng = np.random.default_rng(seed)

    def fill_b(tree):
        for k, v in tree.items():
            if k == "B":
                act = np.asarray(lay.active_cols)[:, None]
                tree[k] = (rng.standard_normal(v.shape) * 0.05 * act
                           ).astype(np.float32)
            elif isinstance(v, dict):
                fill_b(v)
    for seg in adapters["segments"]:
        fill_b(seg)
    return lay, params, adapters


@pytest.mark.parametrize("ranks", [(8, 4, 16), (8, 3, 6)])   # mixed, uniform
def test_serve_quantized_token_ids_match_reference(ranks,
                                                   ref_pallas_dequant):
    """``ServeEngine(quantize="int8")``: the port's greedy tokens equal
    the reference's ("pallas" LoRA and dequant kernels), and each
    request's fused tokens equal its solo tokens."""
    ref_cfg, cfg = _cfgs("float32")
    lay, params, adapters = _serve_weights(ref_cfg, ranks)
    specs = [LoRAJobSpec(f"ad{i}", rank=r, batch_size=1)
             for i, r in enumerate(ranks)]
    ref_pool = RefPool(ref_cfg, capacity=len(ranks), multiple=8)
    ref_pool.publish_group(specs, adapters, lay)
    pool = AdapterPool(cfg, capacity=len(ranks), multiple=8, device="cpu")
    pool.publish_group(specs, adapters_from_numpy(adapters, "cpu"),
                       RankLayout(tuple(ranks), 8))
    ref = RefEngine(ref_cfg, jax.tree.map(jnp.asarray, params), ref_pool,
                    impl="pallas", block_t=8, quantize="int8")
    port = ServeEngine(cfg, params_from_numpy(params, "cpu"), pool,
                       impl="cuda", block_t=8, quantize="int8")
    assert quant.is_quantized(port.params)
    rng = np.random.default_rng(0)
    reqs = [dict(prompt=rng.integers(1, cfg.vocab_size,
                                     size=int(rng.integers(3, 15)),
                                     dtype=np.int32),
                 adapter=specs[i % len(specs)].job_id, max_new_tokens=3)
            for i in range(4)]
    want = ref.serve([RefRequest(**r) for r in reqs])
    got = port.serve([ServeRequest(**r) for r in reqs])
    for a, b in zip(want, got):
        assert a.adapter == b.adapter and a.prompt_len == b.prompt_len
        assert a.tokens.tolist() == b.tokens.tolist()
    for r, f in zip(reqs, got):
        solo = port.serve([ServeRequest(**r)])[0]
        assert np.array_equal(f.tokens, solo.tokens)


# ----------------------------------------------------- (7) elastic
def test_quantized_group_migration_reuses_codes():
    """A quantized group (jobs a, b) trains k steps; job a moves alone
    into a new group built from the group's already quantized params
    and trains k more.  Its codes are the donor's (no second
    quantization) and its losses are those of a control run of a alone
    over the same int8 backbone for 2k steps."""
    _, cfg = _cfgs("float32")
    job_a, job_b = _specs(LoRAJobSpec, ranks=(4, 20), batch=(2, 1))
    k = 2
    params = M.init_model(cfg, seed=7, device="cpu")
    kw = dict(lr=LR, impl="cuda", block_t=BT, remat=False, device="cpu",
              quantize="int8")
    group = GroupRuntime.from_specs(cfg, [job_a, job_b], params=params,
                                    seed=3, **kw)
    start = group.export(job_a.job_id)
    group.run(k)
    moved = GroupRuntime.from_states(cfg, group.params,
                                     [group.export(job_a.job_id)], **kw)
    for p, leaf in _quant_leaves(group.params).items():
        if isinstance(leaf, quant.QuantTensor):
            assert _quant_leaves(moved.params)[p] is leaf, p
    moved.run(k)
    control = GroupRuntime.from_states(cfg, group.params, [start], **kw)
    control.run(2 * k)
    got = ([l[0] for l in group.report.per_job_losses]
           + [l[0] for l in moved.report.per_job_losses])
    want = [l[0] for l in control.report.per_job_losses]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert moved.export(job_a.job_id).opt_step == 2 * k
