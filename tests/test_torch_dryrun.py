"""The production dry run's port (``repro_torch.launch.{dryrun,
step_analysis,roofline}``) and the cache rules
(``sharding/rules.cache_specs``, ``runtime_cache_specs``) held against the
reference on the CPU.

  * ``cache_specs`` equal the reference's ``cache_shardings`` leaf by
    leaf, for every registry decoder config's ``init_caches`` (full and
    ring caches) over tests/test_torch_sharding_rules.py's geometries,
    the reference's side on an ``AbstractMesh``;
  * ``model_flops_estimate`` equals the reference's for every arch and
    shape;
  * the step analysis's FLOPs of the meshless reduced-tinyllama steps
    against the reference's ``hlo_analysis.analyze`` of the same steps
    compiled on one CPU device: train (remat and not) within 5%
    (measured +1.5% / -2.2%: the two frameworks' backward passes do
    not run the same products), prefill within 1% (measured 0.0%),
    decode at least the reference's and within 10% (measured +7.4%: the
    port's decode attention runs over whole 256-key chunks of its cache,
    ``models/attention.DECODE_CHUNK``);
  * the collective bytes of a decode step at data 1 x model 2 over a
    fake world of 2 equal the count derived from the layer pattern
    (``test_collectives_of_a_decode_step``);
  * one full-width production row, tinyllama-1.1b x decode_32k x 16x16,
    ends ``ok`` with its resident and cache bytes a rank equal to their
    closed forms, deepseek-v2-lite-16b x train_4k (MLA over the model
    axis, ROADMAP A8c) ends ``ok`` and fits, and smollm-360m ends ``ok``
    with its attention whole on every rank (A4: its 15 heads over 16
    ranks); each row's 2-D layout columns (A8e) add up from its executed
    ones (all in a subprocess: a dry run makes a fake world of its own,
    which no later test in the worker may see).
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import AbstractMesh

from repro.configs import get_config as ref_get_config
from repro.configs.base import InputShape as RefShape
from repro.configs.registry import get_shape as ref_get_shape
from repro.core.jobs import LoRAJobSpec as RefSpec
from repro.core.ssm import SharedSuperModel as RefSSM
from repro.launch import hlo_analysis as HA
from repro.launch import roofline as ref_roofline
from repro.models import model as RM
from repro.optim import adamw as ref_adamw
from repro.optim.schedule import constant as ref_constant
from repro.sharding import rules as ref_rules

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.configs.base import InputShape
from repro_torch.configs.registry import get_shape
from repro_torch.core.jobs import LoRAJobSpec
from repro_torch.core.ssm import SharedSuperModel
from repro_torch.launch import roofline
from repro_torch.launch import step_analysis as SA
from repro_torch.launch.dryrun import dryrun_one
from repro_torch.launch.mesh import fake_world, make_local_mesh
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.optim.schedule import constant
from repro_torch.sharding import rules

from test_torch_sharding_rules import GEOMETRIES
from torch_train_common import one_torch_thread  # noqa: F401

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECODERS = sorted(a for a in ARCH_IDS if get_config(a).supports_decode())


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return {p: v for k, t in tree.items()
                for p, v in _flat(t, path + (str(k),)).items()}
    if isinstance(tree, list):
        return {p: v for i, t in enumerate(tree)
                for p, v in _flat(t, path + (str(i),)).items()}
    return {"/".join(path): tree}


# ------------------------------------------------------ cache rules
@pytest.mark.parametrize("arch", DECODERS)
def test_cache_specs_match_the_reference(arch):
    """Every leaf of every cache type (KV, MLA, SSD, RG-LRU; stacked or
    not), full and ring, over every geometry: the reference's
    ``PartitionSpec`` entries, the head-dim fallback and the divisibility
    rule included."""
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    for ring in (False, True):
        want_caches = jax.eval_shape(
            lambda: RM.init_caches(rcfg, 32, 64, ring))
        caches = M.init_caches(cfg, 32, 64, ring, device="meta")
        for sizes in GEOMETRIES:
            mesh = AbstractMesh(tuple(sizes.values()), tuple(sizes))
            want = ref_rules.cache_shardings(mesh, want_caches, rcfg)
            got = rules.cache_specs(sizes, caches, cfg)
            assert len(got) == len(want)
            for g_seg, w_seg in zip(got, want):
                assert g_seg.keys() == w_seg.keys()
                for k in g_seg:
                    assert type(g_seg[k]).__name__ == type(w_seg[k]).__name__
                    assert tuple(g_seg[k]) == tuple(
                        tuple(s.spec) for s in w_seg[k]), (arch, ring,
                                                           sizes, k)


def test_runtime_cache_specs_split_or_share_the_kv_heads():
    """The executed layout: kv heads over "model" where m divides them,
    else one head a rank (``KVShare``); the batch over the batch axes
    where it divides; never the head dim; a whole mixer's (ROADMAP A4)
    over the batch axes only."""
    cfg = get_config("tinyllama-1.1b")                  # 4 kv heads
    caches = M.init_caches(cfg, 128, 64, device="meta")
    for sizes, kv in (({"data": 2, "model": 2}, "model"),
                      ({"data": 16, "model": 16}, rules.KVShare()),
                      ({"pod": 2, "data": 16, "model": 16}, rules.KVShare()),
                      ({"data": 5, "model": 4}, "model")):
        spec = rules.runtime_cache_specs(sizes, caches, cfg)[0]["0"].k
        b = ("pod", "data") if "pod" in sizes else (
            "data" if 128 % sizes["data"] == 0 else None)
        assert spec == (None, b, None, kv, None), (sizes, spec)
        loc = rules.local_shape(caches[0]["0"].k.shape, spec, sizes)
        assert loc[3] == (1 if isinstance(kv, rules.KVShare) else 4 //
                          sizes["model"])
    # a model axis of 3 over 32 query heads would split a head: the
    # attention runs whole, its caches split over the batch axes only
    spec = rules.runtime_cache_specs({"data": 1, "model": 3}, caches,
                                     cfg)[0]["0"].k
    assert spec == (None, "data", None, None, None)


def test_shard_params_cuts_a_shared_kv_head_whole():
    """Under kv replication a rank's wk/wv/bk/bv are its one kv head
    whole (head index // (m / KV)), the other leaves the rules' blocks."""
    cfg = dataclasses.replace(get_config("qwen1.5-110b").reduced(),
                              num_heads=8, num_kv_heads=2)
    params = M.init_model(cfg, seed=0, device="cpu")
    full = M.init_model(cfg, device="meta")
    hd = cfg.head_dim
    for i in range(4):
        cut = rules.shard_params(params, full, 4, i, cfg=cfg)
        a, w = cut["segments"][0]["0"]["attn"], \
            params["segments"][0]["0"]["attn"]
        h = i // 2
        for name in ("wk", "wv", "bk", "bv"):
            assert torch.equal(a[name], w[name][..., h * hd:(h + 1) * hd])
        q = w["wq"].shape[-1] // 4
        assert torch.equal(a["wq"], w["wq"][..., i * q:(i + 1) * q])


# --------------------------------------------------- model FLOPs
@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_model_flops_estimate_matches_the_reference(arch):
    for name in INPUT_SHAPES:
        for training in (False, True):
            assert roofline.model_flops_estimate(
                get_config(arch), get_shape(name), training) == \
                ref_roofline.model_flops_estimate(
                    ref_get_config(arch), ref_get_shape(name), training)


# --------------------------------------- FLOPs against the reference
RANKS, BATCH, SEQ, BT, B = (4, 20, 8), (2, 1, 1), 32, 16, 4


def _ssms():
    rcfg = dataclasses.replace(ref_get_config("tinyllama-1.1b").reduced(),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              dtype="float32")
    spec = lambda cls: [cls(f"job-{i}", rank=r, batch_size=b, seq_len=SEQ)
                        for i, (r, b) in enumerate(zip(RANKS, BATCH))]
    return (RefSSM(rcfg, spec(RefSpec), impl="xla", block_t=BT),
            SharedSuperModel(cfg, spec(LoRAJobSpec), impl="torch",
                             block_t=BT), rcfg)


def _ref_flops(fn, *args) -> float:
    return HA.analyze(jax.jit(fn).lower(*args).compile().as_text()).flops


def _ints(**cols):
    return {k: torch.empty(v, dtype=torch.int32, device="meta")
            for k, v in cols.items()}


@pytest.mark.parametrize("step", ["train_remat", "train", "prefill",
                                  "decode"])
def test_flops_match_the_reference_hlo_analysis(step):
    rs, ps, rcfg = _ssms()
    rp, ra = jax.eval_shape(lambda: rs.init(jax.random.PRNGKey(0)))
    pm, am = ps.init(device="meta")
    i32, S = jnp.int32, jax.ShapeDtypeStruct
    if step.startswith("train"):
        remat = step == "train_remat"
        want = _ref_flops(
            rs.make_train_step(lr_fn=ref_constant(1e-3), remat=remat), rp,
            ra, jax.eval_shape(lambda: ref_adamw.init(ra)),
            {"tokens": S((B, SEQ), i32), "labels": S((B, SEQ), i32),
             "adapter_ids": S((B,), i32)})
        got = SA.analyze(ps.make_train_step(lr_fn=constant(1e-3),
                                            remat=remat),
                         (pm, am, adamw.init(am, per_job=3),
                          _ints(tokens=(B, SEQ), labels=(B, SEQ),
                                adapter_ids=(B,))))[0].flops
        assert abs(got / want - 1) <= 0.05, (got, want)
    elif step == "prefill":
        shape = dict(name="p", seq_len=64, global_batch=B, kind="prefill")
        want = _ref_flops(rs.make_prefill_step(RefShape(**shape)), rp, ra,
                          {"tokens": S((B, 64), i32),
                           "adapter_ids": S((B,), i32)})
        got = SA.analyze(ps.make_prefill_step(InputShape(**shape)),
                         (pm, am, _ints(tokens=(B, 64),
                                        adapter_ids=(B,))))[0].flops
        assert abs(got / want - 1) <= 0.01, (got, want)
    else:
        shape = dict(name="d", seq_len=64, global_batch=B, kind="decode")
        rstep, pstep = rs.make_serve_step(), ps.make_serve_step()
        want = _ref_flops(
            lambda p, a, c, b: rstep(p, a, c, b, 5), rp, ra,
            jax.eval_shape(lambda: RM.init_caches(rcfg, B, 64, False)),
            {"tokens": S((B, 1), i32), "adapter_ids": S((B,), i32)})
        got = SA.analyze(
            lambda p, a, c, b: pstep(p, a, c, b, 5),
            (pm, am, ps.init_decode_caches(InputShape(**shape),
                                           device="meta"),
             _ints(tokens=(B, 1), adapter_ids=(B,))))[0].flops
        assert want <= got <= 1.10 * want, (got, want)


# ---------------------------------------------------- collectives
def test_collectives_of_a_decode_step():
    """A decode step of reduced f32 tinyllama (L 2 layers, d 256, H 4 x
    hd 32, vocab 512) over B rows at data 1 x model 2, in a fake world of
    2.  By hand from the layer pattern, per rank:

      * all-reduce (f32 sums): the vocab-split embedding's lookup (B x
        d), and in each layer the row-parallel wo and down products'
        partials (B x d each): 2L + 1 of B·d·4 bytes;
      * all-gather: in each layer o's LoRA input gathered whole (B x
        H/m·hd, f32), and the head's vocab blocks (B x V/m): L + 1.

    The column products' forwards and the k/v cuts make none."""
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              dtype="float32")
    rows = 8
    jobs = [LoRAJobSpec(f"c{i}", rank=r, batch_size=rows, seq_len=BT)
            for i, r in enumerate((4, 16))]
    ssm = SharedSuperModel(cfg, jobs, impl="torch", block_t=BT)
    shape = InputShape("c", 64, 2 * rows, "decode")
    Bt, L, d, m = 2 * rows, cfg.num_layers, cfg.d_model, 2
    with fake_world(2, 1):
        mesh = make_local_mesh(model=2)
        full = M.init_model(cfg, device="meta")
        params = rules.shard_params(full, full, m, 1, cfg=cfg)
        _, adapters = ssm.init(device="meta")
        caches = ssm.init_decode_caches(shape, device="meta", mesh=mesh)
        step = ssm.make_serve_step(mesh=mesh)
        rep, (logits, _) = SA.analyze(
            lambda p, a, c, b: step(p, a, c, b, 5),
            (params, adapters, caches, _ints(tokens=(Bt, 1),
                                             adapter_ids=(Bt,))))
    assert tuple(logits.shape) == (Bt, 1, cfg.vocab_size)
    assert rep.collective_counts == {"all-reduce": 2 * L + 1,
                                     "all-gather": L + 1}
    assert rep.collective_bytes == {
        "all-reduce": (2 * L + 1) * Bt * d * 4,
        "all-gather": (L * Bt * cfg.q_dim // m + Bt * cfg.vocab_size // m)
        * 4}
    assert all(len(r) == 2 for _, r in rep.collective_groups)
    assert {roofline.link_of(r) for _, r in rep.collective_groups} == \
        {"nvlink"}


# -------------------------------------------------- production rows
def _closed_forms():
    """tinyllama-1.1b's resident and cache bytes a rank at decode_32k on
    16 x 16: the backbone's Megatron blocks (vocab 32000/16; q/o 2048/16
    columns; k/v one of the 4 kv heads whole, 64 columns; gate/up/down
    5632/16), f32 norms whole; the four adapters (ranks 16/8/4/2 padded
    to 16 each: R 64) whole in f32; the caches' 128/16 rows of one kv
    head over 32768 keys in bf16."""
    L, d, V, ff, hd, m = 22, 2048, 32000, 5632, 64, 16
    layer = d * (d // m) * 2 + d * hd * 2 + d * (ff // m) * 3
    bf16 = 2 * (V // m * d * 2 + L * layer)
    f32 = 4 * (L * 2 * d + d)
    R = 64
    lora = 4 * L * R * ((d + d) * 2 + (d + 4 * hd) * 2)
    caches = 2 * L * (128 // 16) * 32768 * 1 * hd * 2
    return bf16 + f32 + lora, caches


def test_production_rows():
    code = ("import json\n"
            "from repro_torch.launch.dryrun import dryrun_one\n"
            "rows = [dryrun_one('tinyllama-1.1b', 'decode_32k', "
            "verbose=False), dryrun_one('deepseek-v2-lite-16b', "
            "'train_4k', verbose=False), dryrun_one('smollm-360m', "
            "'train_4k', verbose=False)]\n"
            "print(json.dumps(rows, default=str))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    ok, mla, whole = json.loads(out.stdout.strip().splitlines()[-1])
    assert ok["status"] == "ok", ok
    resident, caches = _closed_forms()
    assert ok["resident_bytes"] == resident
    assert ok["cache_bytes"] == caches
    assert ok["fits"] and ok["peak_bytes"] > resident + caches
    assert ok["model_axis"] == 16 and ok["rows_per_rank"] == 8
    # MLA over the model axis (ROADMAP A8c) runs: 16 heads, one a rank
    assert mla["status"] == "ok" and mla["fits"], mla
    assert mla["model_axis"] == 16
    # smollm's 15 heads over 16 ranks: its attention runs whole on every
    # rank, the rest of the layer cut (A4)
    assert whole["status"] == "ok" and whole["whole_mixers"] == ["attn"]
    assert whole["model_axis"] == 16
    # the reference's 2-D layout beside the executed one (A8e): the
    # executed peak with the 2-D weights for the 1-D ones, one layer's
    # gathered slabs and the residual split over "model"; the gathers on
    # the data group's link (across nodes); one FLOPs count for both
    for row in (ok, mla, whole):
        assert row["param_bytes_2d"] < row["param_bytes"]
        assert row["resident_bytes_2d"] == (row["resident_bytes"]
                                            - row["param_bytes"]
                                            + row["param_bytes_2d"])
        assert row["peak_bytes_2d"] == (
            row["peak_bytes"] - row["param_bytes"] + row["param_bytes_2d"]
            + row["fsdp_gather_max_layer_bytes"]
            - row["saved_residual_bytes"] + row["saved_residual_bytes_2d"])
        assert row["collective_bytes_by_link_2d"]["network"] == \
            pytest.approx(row["collective_bytes_by_link"].get("network", 0)
                          + row["fsdp_gather_bytes"], rel=1e-12)
        assert row["t_collective_s_2d"] > row["t_collective_s"]
        assert not [k for k in row if "flops" in k and k.endswith("_2d")]
    assert ok["fsdp_gather_passes"] == 1 and ok["saved_residual_bytes"] == 0
    assert mla["fsdp_gather_passes"] == whole["fsdp_gather_passes"] == 2
    assert whole["saved_residual_bytes_2d"] * 16 == \
        whole["saved_residual_bytes"] > 0


@pytest.mark.parametrize("shape,status,roadmap", [
    ("prefill_32k", "ok", None), ("decode_32k", "skipped", None),
    ("long_500k", "skipped", None)])
def test_encoder_rows(shape, status, roadmap):
    """hubert-xlarge's serve rows: a decode shape is skipped, as the
    reference's ``applicable`` skips it; its prefill, which the
    reference builds, runs (ROADMAP A9: the cached encoder prefill,
    16 heads over the 16 model ranks, caches by the runtime specs)."""
    row = dryrun_one("hubert-xlarge", shape, verbose=False)
    assert row["status"] == status, row
    assert row.get("roadmap") == roadmap
    if status == "ok":
        assert row["fits"] and row["peak_bytes"] > row["resident_bytes"]
        assert row["whole_mixers"] == [] and row["rows_per_rank"] == 2


def test_fake_world_refuses_a_process_with_a_group(tmp_path):
    """A dry run never runs over a real group, nor leaves one behind: in
    a process that has a process group ``fake_world`` refuses, and on
    exit it destroys the group it made."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_mesh
    init_mesh(0, 1, f"file://{tmp_path}/s", "gloo")
    try:
        with pytest.raises(RuntimeError, match="process group"):
            with fake_world(2, 0):
                pass
    finally:
        dist.destroy_process_group()
    with fake_world(2, 0):
        assert dist.get_world_size() == 2
    assert not dist.is_initialized()


def test_meta_as_card_is_this_threads_and_meta_only():
    """The analysis's card path (``layers.meta_as_card``) reaches only
    meta tensors, only in the thread that entered it, and only while
    inside: a CPU tensor keeps its path, another thread sees no stand-in,
    and on exit a meta tensor takes the CPU's branches again."""
    import threading
    from repro_torch.models import layers
    flash = lambda *a, **k: None
    meta, cpu = torch.empty(2, device="meta"), torch.empty(2)
    seen = {}
    assert not layers.on_card(meta) and layers.meta_flash() is None
    with layers.meta_as_card(flash):
        assert layers.on_card(meta) and layers.meta_flash() is flash
        assert not layers.on_card(cpu)
        other = threading.Thread(target=lambda: seen.update(
            card=layers.on_card(meta), flash=layers.meta_flash()))
        other.start()
        other.join()
    assert seen == {"card": False, "flash": None}
    assert not layers.on_card(meta) and layers.meta_flash() is None


@pytest.mark.parametrize("arch", ["hubert-xlarge", "internvl2-26b",
                                  "tinyllama-1.1b"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_model_batch_matches_the_references_make_batch(arch, shape):
    """The dry run's inputs of a train or prefill step
    (``dryrun._model_batch``) have the names, shapes and dtypes of the
    reference's ``make_batch`` stand-ins at the same rows: an audio
    config's frames, a VLM's patches before its text, the labels over
    the text."""
    from repro_torch.launch.dryrun import _model_batch
    rows = 8
    want = RM.input_specs(ref_get_config(arch), ref_get_shape(shape),
                          batch_override=rows)
    got = _model_batch(get_config(arch), rows, get_shape(shape).seq_len,
                       train=shape == "train_4k")
    assert got.pop("adapter_ids").shape == (rows,)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in got.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()
        if shape == "train_4k" or k != "labels"}
