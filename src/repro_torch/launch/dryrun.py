"""The production dry run (port of the reference's ``launch/dryrun.py``).

For every assigned (architecture x input shape) on the production mesh,
16 x 16 ("data", "model") or 2 x 16 x 16 with "pod", it builds the step
one rank runs there (the train step, ``make_train_step(mesh=,
tp_mode="auto")``; the prefill step; the decode step over the rank's
caches), runs it once on meta tensors in a fake world of 256 or 512
ranks (``launch/mesh.fake_world``, ``launch/step_analysis``) and prices
what it counted at the H100's data sheet peaks (``launch/roofline``).
Nothing is allocated and nothing runs on a card: the numbers are a
model of the step, per rank.

What it copies from the reference: the group (``make_group``, one job of
each rank in GROUP_RANKS, equal rows), the capacity MoE dispatch, the
three step kinds and their shapes (``build``, the reference's
``dryrun.py:61-117``).  What is the port's own: the layout a rank runs
(Megatron 1-D tensor parallelism over "model" with the kv heads split
or shared, the rows over "data" with "pod" folded in, the weights
replicated over "data": ``sharding/rules.shard_params``), the eager
route ``impl="torch"`` (the reference's dry run compiles ``impl="xla"``),
and the gradients' ``grad_sync="psum"``, one all-reduce of the adapters'
partial gradients over "data", as the reference's runtime reduces them.

Beside the executed layout every ``ok`` row prices the reference's own
dry-run layout (``layout_2d``, the ``*_2d`` columns): the weights 2-D
with their "D" dim over "data", each layer's FSDP all-gathers, at most
one layer's gathered slabs live, and the residual stream's saved
activations split over "model" ("sp").  A mixer the model axis would
split through a head runs whole on every rank (``whole_mixers``).

Every row ends in a status: ``ok`` (with ``fits`` and ``fits_2d``: the
peak within the card's 80 GB under each layout), ``skipped`` (no decode
for an encoder, as ``applicable`` says) or ``fail`` (an exception).

Usage:
    python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
    python -m repro_torch.launch.dryrun --all --both-meshes [--out rows.json]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from typing import Dict, List

import torch

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, applicable, get_config
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.configs.registry import get_shape
from repro_torch.core.jobs import LoRAJobSpec
from repro_torch.core.ssm import SharedSuperModel
from repro_torch.launch import roofline as RL
from repro_torch.launch import step_analysis as SA
from repro_torch.launch.mesh import (data_group, fake_world,
                                     make_production_mesh, model_group)
from repro_torch.models import model as M
from repro_torch.models.layers import dtype_of
from repro_torch.optim import adamw
from repro_torch.optim.schedule import constant
from repro_torch.sharding import rules

# paper §4.1: ranks sampled from {2,4,8,16} — the dry-run group uses one
# of each so the fused kernel sees heterogeneous ranks.
GROUP_RANKS = (16, 8, 4, 2)
# the rank whose step is analyzed (every rank of a mesh runs the same
# shapes; its groups' placement on nodes is every rank's)
DRY_RANK = 0


def make_group(cfg: ModelConfig, shape: InputShape) -> List[LoRAJobSpec]:
    B = shape.global_batch
    K = min(len(GROUP_RANKS), B)
    while B % K:                      # equal segments (comm-free dispatch)
        K -= 1
    jobs = [LoRAJobSpec(job_id=f"dry-{i}", rank=GROUP_RANKS[i % 4],
                        batch_size=B // K, seq_len=shape.seq_len,
                        base_model=cfg.name)
            for i in range(K)]
    return jobs


def tree_bytes(tree) -> int:
    """The bytes of a tree's tensors (numel x itemsize)."""
    return sum(t.numel() * t.element_size() for t in SA._tensors(tree))


def _int_batch(rows: int, cols: Dict[str, int]) -> dict:
    """Meta int32 leaves of *rows* rows (``cols``: name -> width; 0 for
    a (rows,) leaf)."""
    return {k: torch.empty((rows, w) if w else (rows,), dtype=torch.int32,
                           device="meta") for k, w in cols.items()}


def _model_batch(cfg: ModelConfig, rows: int, S: int, train: bool) -> dict:
    """Meta model inputs of a train or prefill step of *rows* rows of *S*
    positions, as the reference's ``make_batch`` lays them out: an audio
    config's frames (rows, S, frontend_dim), a VLM's patches (rows,
    num_patches, frontend_dim) before its S - num_patches tokens, else S
    tokens; labels over the text for training; the adapter ids."""
    text = {"audio": 0, "vlm": S - cfg.num_patches}.get(cfg.family, S)
    batch = _int_batch(rows, dict({"tokens": text} if text else {},
                                  **({"labels": text or S} if train else {}),
                                  adapter_ids=0))
    if cfg.family in ("audio", "vlm"):
        n = S if cfg.family == "audio" else cfg.num_patches
        key = "frames" if cfg.family == "audio" else "patches"
        batch[key] = torch.empty((rows, n, cfg.frontend_dim),
                                 dtype=dtype_of(cfg), device="meta")
    return batch


def build(cfg: ModelConfig, shape: InputShape, mesh, nano_batches: int = 1,
          remat: bool = True):
    """(step, its inputs as ``meta`` tensors, the inputs by name) of this
    rank's *shape* step on *mesh*."""
    _, m, mi = model_group(mesh)
    _, D, _ = data_group(mesh, "data")
    train = shape.kind == "train"
    ssm = SharedSuperModel(cfg, make_group(cfg, shape), impl="torch",
                           block_t=128, data_shards=D if train else 1)
    full = M.init_model(cfg, device="meta")
    parts = {"params": rules.shard_params(full, full, m, mi, cfg=cfg),
             "adapters": M.init_adapters(cfg, ssm.ranks.tolist(),
                                         layout=ssm.layout, device="meta")}
    S = shape.seq_len
    if train:
        rows = sum(ssm.rows_per_job()) // D
        parts["opt_state"] = adamw.init(parts["adapters"],
                                        per_job=ssm.num_jobs)
        parts["batch"] = _model_batch(cfg, rows, S, train=True)
        fn = ssm.make_train_step(lr_fn=constant(1e-3),
                                 nano_batches=nano_batches, remat=remat,
                                 mesh=mesh, tp_mode="auto",
                                 grad_sync="psum")
        return fn, (parts["params"], parts["adapters"], parts["opt_state"],
                    parts["batch"]), parts
    idx = ssm.serve_rows(mesh)
    rows = sum(ssm.rows_per_job()) if idx is None else len(idx)
    if shape.kind == "prefill":
        parts["batch"] = _model_batch(cfg, rows, S, train=False)
        fn = ssm.make_prefill_step(shape, with_cache=True, mesh=mesh)
        return fn, (parts["params"], parts["adapters"], parts["batch"]), \
            parts
    # decode: ONE new token against a seq_len cache
    parts["caches"] = ssm.init_decode_caches(shape, device="meta", mesh=mesh)
    parts["batch"] = _int_batch(rows, {"tokens": 1, "adapter_ids": 0})
    step = ssm.make_serve_step(ring=shape.sliding_window_variant, mesh=mesh)
    pos = S - 1

    def fn(params, adapters, caches, batch):
        return step(params, adapters, caches, batch, pos)
    return fn, (parts["params"], parts["adapters"], parts["caches"],
                parts["batch"]), parts


# ------------------------------------------ the reference's 2-D layout
def _unit(cfg: ModelConfig, path) -> tuple:
    """The gather unit of a backbone leaf under FSDP: one layer (a cycle
    of a scanned segment, each layer of an unrolled one) or one top-level
    weight (the embedding, the head, the front end)."""
    if path[0] != "segments":
        return (path[0],)
    seg = M.segment_plan(cfg)[int(path[1])]
    return ("segments", path[1]) if seg.scanned else tuple(path[:3])


def param_bytes_2d(cfg: ModelConfig, axis_sizes: Dict[str, int]) -> int:
    """One rank's bytes of the backbone under the reference's dry-run
    layout (``rules.param_specs`` with the "D" tag kept: each weight's
    Megatron dim over "model" and its other matmul dim over "data",
    ``src/repro/launch/dryrun.py:83``)."""
    full = M.init_model(cfg, device="meta")
    specs = rules.param_specs(axis_sizes, full)
    total = [0]

    def add(path, t):
        spec = rules._get(specs, path)
        total[0] += (math.prod(rules.local_shape(t.shape, spec, axis_sizes))
                     * t.element_size())
        return t
    rules._walk(full, add)
    return total[0]


def fsdp_gathers(cfg: ModelConfig, axis_sizes: Dict[str, int]
                 ) -> Dict[tuple, int]:
    """{gather unit: bytes one rank receives when the unit's "D" slabs
    are all-gathered over "data"}: each leaf the 2-D specs split over
    "data", its share under the runtime specs ("D" dropped: the slab the
    rank computes with) less its 2-D shard.  A scanned segment's unit is
    one cycle (its leaves' bytes over the cycles)."""
    full = M.init_model(cfg, device="meta")
    two = rules.param_specs(axis_sizes, full)
    one = rules.runtime_param_specs(axis_sizes, full)
    out: Dict[tuple, int] = {}

    def add(path, t):
        s2, s1 = rules._get(two, path), rules._get(one, path)
        b2 = math.prod(rules.local_shape(t.shape, s2, axis_sizes))
        b1 = math.prod(rules.local_shape(t.shape, s1, axis_sizes))
        if b1 == b2:
            return t
        key = _unit(cfg, path)
        per = (b1 - b2) * t.element_size()
        if len(key) == 2:               # a scanned segment: per cycle
            per //= M.segment_plan(cfg)[int(key[1])].repeats
        out[key] = out.get(key, 0) + per
        return t
    rules._walk(full, add)
    return out


def saved_residual_bytes(cfg: ModelConfig, shape: InputShape, rows: int,
                         remat: bool) -> int:
    """The residual stream's activations a train step keeps for its
    backward, one rank of *rows* rows: one (rows, S, d) tensor a layer
    (the input its norm saves), or with *remat* one checkpoint a cycle
    of a scanned segment.  0 for a serve step (no backward)."""
    if shape.kind != "train":
        return 0
    n = sum(seg.repeats * (1 if seg.scanned and remat else len(seg.specs))
            for seg in M.segment_plan(cfg))
    item = torch.empty((), dtype=dtype_of(cfg)).element_size()
    return n * rows * shape.seq_len * cfg.d_model * item


def layout_2d(cfg: ModelConfig, shape: InputShape, mesh_sizes: Dict[str, int],
              rows: int, remat: bool, executed: Dict, data_link: str
              ) -> Dict:
    """The row's numbers under the reference's dry-run layout beside the
    executed ones (*executed*: the analysis's param, resident and peak
    bytes and its collective bytes by link): the weights 2-D
    (``param_bytes_2d``); each layer's "D" slabs all-gathered over
    "data" before use (``fsdp_gathers``), once in the forward and once
    more for a train step's backward (the remat recompute and the
    backward share the re-gathered slab), priced on the data group's
    link; at most one unit's gathered slabs live at once; the residual
    stream's saved activations split over "model" (the reference's "sp",
    ``src/repro/sharding/specs.py:85-93``) and, for a batch under 16,
    over "data" too.  FLOPs do not change."""
    m, D = mesh_sizes.get("model", 1), mesh_sizes.get("data", 1)
    p2 = param_bytes_2d(cfg, mesh_sizes)
    gathers = fsdp_gathers(cfg, mesh_sizes)
    passes = 2 if shape.kind == "train" else 1
    per_step = passes * sum(
        b * (M.segment_plan(cfg)[int(k[1])].repeats if len(k) == 2 else 1)
        for k, b in gathers.items())
    saved = saved_residual_bytes(cfg, shape, rows, remat)
    sp = m * (D if shape.global_batch < 16 else 1)
    saved2 = saved // sp
    peak2 = (executed["peak"] - executed["params"] + p2
             + max(gathers.values(), default=0) - (saved - saved2))
    coll = dict(executed["coll"])
    coll[data_link] = coll.get(data_link, 0.0) + per_step
    return {"param_bytes_2d": p2,
            "resident_bytes_2d": executed["resident"] - executed["params"]
            + p2,
            "fsdp_gather_bytes": per_step, "fsdp_gather_passes": passes,
            "fsdp_gather_max_layer_bytes": max(gathers.values(), default=0),
            "saved_residual_bytes": saved,
            "saved_residual_bytes_2d": saved2,
            "peak_bytes_2d": peak2, "mem_gb_per_device_2d": peak2 / 1e9,
            "fits_2d": peak2 <= RL.HBM_BYTES,
            "collective_bytes_by_link_2d": coll,
            "t_collective_s_2d": RL.collective_time(coll)}


def dryrun_one(arch: str, shape_name: str, multi_pod: bool = False,
               verbose: bool = True, nano_batches: int = 1,
               remat: bool = True, drill: int = 0) -> Dict:
    """One (arch, shape, mesh) row; runs in a fake world of its own (a
    process that has a process group is refused)."""
    # the reference's TPU path: the capacity expert dispatch
    cfg = dataclasses.replace(get_config(arch), moe_impl="capacity")
    shape = get_shape(shape_name)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    head = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    if not applicable(arch, shape_name):
        return dict(head, status="skipped",
                    reason="encoder-only arch has no decode step")
    t0 = time.time()
    chips = 512 if multi_pod else 256
    try:
        with fake_world(chips, DRY_RANK):
            mesh = make_production_mesh(multi_pod=multi_pod)
            m = model_group(mesh)[1]
            fn, args, parts = build(cfg, shape, mesh,
                                    nano_batches=nano_batches, remat=remat)
            rep, _ = SA.analyze(fn, args)
            dgroup, D, _ = data_group(mesh, "data")
            data_link = RL.link_of(tuple(
                torch.distributed.get_process_group_ranks(dgroup)))
            sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
        coll = {}
        for (kind, ranks), b in rep.collective_groups.items():
            link = RL.link_of(ranks)
            coll[link] = coll.get(link, 0.0) + b
        resident = sum(tree_bytes(parts[k]) for k in
                       ("params", "adapters", "opt_state") if k in parts)
        rows = int(parts["batch"]["adapter_ids"].shape[0])
        two = layout_2d(cfg, shape, {k: int(v) for k, v in sizes.items()},
                        rows, remat, {"peak": rep.peak_bytes,
                                      "params": tree_bytes(parts["params"]),
                                      "resident": resident, "coll": coll},
                        data_link)
        rl = RL.RooflineReport(
            arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
            flops=rep.flops, flops_f32=rep.flops_f32,
            eager_bytes=rep.eager_bytes, coll_bytes=coll,
            model_flops=RL.model_flops_estimate(cfg, shape,
                                                shape.kind == "train"),
            peak_bytes=rep.peak_bytes, resident_bytes=resident)
        out = dict(head, status="ok", analysis_s=time.time() - t0,
                   model_axis=m, data_shards=D, ops=rep.ops,
                   whole_mixers=list(M.whole_mixers(cfg, m)),
                   rows_per_rank=rows,
                   param_bytes=tree_bytes(parts["params"]),
                   flops=rep.flops, flops_f32=rep.flops_f32,
                   f32_share=rep.flops_f32 / max(rep.flops, 1.0),
                   eager_bytes=rep.eager_bytes,
                   collective_bytes=rep.collective_bytes,
                   collective_counts=rep.collective_counts,
                   collective_bytes_by_link=coll,
                   collectives=rep.describe_collectives(),
                   peak_bytes=rep.peak_bytes, resident_bytes=resident,
                   cache_bytes=tree_bytes(parts.get("caches", [])),
                   batch_bytes=tree_bytes(parts["batch"]),
                   **rl.row(), **two)
        if verbose:
            print(f"[{arch} x {shape_name} x {mesh_name}] OK "
                  f"({out['analysis_s']:.1f}s analysis, {rep.ops} ops)")
            print(f"  peak {rep.peak_bytes / 1e9:.2f} GB/rank (fits "
                  f"{RL.CARD}'s 80 GB: {rl.fits}), resident "
                  f"{resident / 1e9:.2f} GB")
            print(f"  2-D layout: peak {two['peak_bytes_2d'] / 1e9:.2f} "
                  f"GB/rank (fits: {two['fits_2d']}), resident "
                  f"{two['resident_bytes_2d'] / 1e9:.2f} GB, FSDP gathers "
                  f"{two['fsdp_gather_bytes'] / 1e9:.2f} GB/step, saved "
                  f"residual {two['saved_residual_bytes'] / 1e9:.2f} -> "
                  f"{two['saved_residual_bytes_2d'] / 1e9:.2f} GB, "
                  f"collective {two['t_collective_s_2d'] * 1e3:.2f}ms")
            print(f"  per-rank: flops={rep.flops:.3e} (f32: "
                  f"{out['f32_share']:.0%}) eager bytes="
                  f"{rep.eager_bytes:.3e}")
            print(f"  collectives: {out['collectives']}")
            print(f"  roofline (H100 data sheet peaks): compute="
                  f"{rl.t_compute * 1e3:.2f}ms memory="
                  f"{rl.t_memory * 1e3:.2f}ms collective="
                  f"{rl.t_collective * 1e3:.2f}ms -> {rl.bottleneck}-bound"
                  f"  useful={rl.useful_flops_frac:.2f}")
        if drill:
            print("  -- top collective contributors --")
            for (kind, ranks), b in sorted(rep.collective_groups.items(),
                                           key=lambda x: -x[1])[:drill]:
                print(f"    {b / 1e9:8.2f} GB  {kind} over {len(ranks)} "
                      f"ranks ({RL.link_of(ranks)})")
            print("  -- top memory-traffic ops --")
            for name, b in rep.top_ops[:drill]:
                print(f"    {b / 1e9:8.2f} GB  {name}")
        return out
    except Exception as e:
        if verbose:
            print(f"[{arch} x {shape_name} x {mesh_name}] FAIL: {e}")
            traceback.print_exc()
        return dict(head, status="fail", error=f"{type(e).__name__}: {e}",
                    analysis_s=time.time() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS))
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--nano-batches", type=int, default=1)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--drill", type=int, default=0,
                    help="print top-N collective/memory-traffic "
                         "contributors")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.all or not args.arch else [args.arch]
    shapes = (list(INPUT_SHAPES) if args.all or not args.shape
              else [args.shape])
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    t0 = time.time()
    results = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                results.append(dryrun_one(arch, shape, mp,
                                          nano_batches=args.nano_batches,
                                          remat=not args.no_remat,
                                          drill=args.drill))
    count = {s: sum(1 for r in results if r["status"] == s)
             for s in ("ok", "refused", "skipped", "fail")}
    print(f"\n=== dry-run: {count['ok']} ok / {count['refused']} refused / "
          f"{count['skipped']} skipped / {count['fail']} failed of "
          f"{len(results)} ({time.time() - t0:.1f} s) ===")
    for r in results:
        if r["status"] == "fail":
            print(f"  FAIL {r['arch']} x {r['shape']} x {r['mesh']}: "
                  f"{r['error']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2, default=str)
        print(f"wrote {args.out}")
    return 0 if not count["fail"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
