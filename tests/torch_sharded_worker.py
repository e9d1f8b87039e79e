"""Rank side of the port's sharded tests (tests/test_torch_sharded_
{parity,runtime}.py).  Imports torch and the port only, never JAX.

``main`` is the target of ``torch.multiprocessing.start_processes`` with
the spawn method: each rank joins a gloo world through a ``file://``
store (never a TCP port: the test files run side by side), takes one
torch thread, runs the named scenarios in order on the CPU and saves
``{scenario: result}`` to ``<out>/<rank>.pt``.  A scenario that raises
ends the rank (its peers then fail in their next collective and end
too): gloo matches collectives by order, so a rank that skipped ahead
would pair collectives of different scenarios.  A scenario on a
two-rank mesh runs on both pairs of a four-rank world at once
(``pair_mesh``), each pair its own group.

Inputs (``<inputs>.pt``, written by the test process): for each job set,
the reference's backbone and adapter initializations as the port's
tensor trees, so that the test can hold every run against the
reference's single-device ``GroupRuntime`` too.
"""
import copy
import dataclasses
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core.jobs import LoRAJobSpec, tile_rows
from repro_torch.elastic.runtime import GroupRuntime
from repro_torch.optim import adamw

BT, SEQ, LR, SEED = 8, 32, 1e-2, 7
KW = dict(lr=LR, block_t=BT, remat=False, chunk_size=2, seed=0,
          device="cpu")

# the job sets of the scenarios (the reference's tests/sharded_worker.py)
JOBS = {
    "k4": [("j0", 2, 4), ("j1", 4, 4), ("j2", 8, 4), ("j3", 16, 4)],
    "k1": [("solo-job", 8, 3)],
    "unequal": [("big", 4, 4), ("small", 8, 2)],
    "ab": [("a", 4, 4), ("b", 8, 4)],
    "rag": [("rag-a", 4, 4), ("rag-b", 64, 4)],
    "mig": [("mig-a", 4, 2), ("mig-b", 8, 2)],
}


def cfg_f32():
    return dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                               dtype="float32")


def specs(name, cls=LoRAJobSpec):
    return [cls(j, rank=r, batch_size=b, seq_len=SEQ)
            for j, r, b in JOBS[name]]


def flat(tree, path=()):
    """{key path: float64 numpy} of a nested dict/list tree."""
    if isinstance(tree, dict):
        return {p: v for k, t in tree.items()
                for p, v in flat(t, path + (k,)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, t in enumerate(tree)
                for p, v in flat(t, path + (str(i),)).items()}
    return {"/".join(path): np.asarray(tree.detach().cpu().double()
                                       if torch.is_tensor(tree) else tree,
                                       np.float64)}


def summary(rt) -> dict:
    """What the tests compare of a finished runtime."""
    rep = rt.report
    return {"losses": np.asarray(rep.per_job_losses, np.float64),
            "adapters": flat(rt.adapters), "mu": flat(rt.opt_state.mu),
            "nu": flat(rt.opt_state.nu),
            "step": rt.opt_state.step.cpu().numpy().tolist(),
            "steps_done": dict(rt.steps_done),
            "nano": list(rep.nano_history),
            "step_times": list(rep.step_times)}


def runtime(inputs, key, mesh=None, **kw):
    """A fresh runtime of job set *key* from the reference's init."""
    w = inputs[key]
    return GroupRuntime.from_specs(cfg_f32(), specs(key),
                                   params=w["params"],
                                   adapters=w["adapters"],
                                   mesh=mesh, **dict(KW, **kw))


def run(inputs, key, steps, mesh=None, **kw) -> dict:
    rt = runtime(inputs, key, mesh, **kw)
    rt.run(steps)
    return summary(rt)


# --------------------------------------------------------------- meshes
def world_mesh(model=1):
    from repro_torch.launch.mesh import make_local_mesh
    return make_local_mesh(model=model)


def pair_mesh():
    """A two-rank mesh: ranks {0, 1} and {2, 3} of a four-rank world each
    form one (every rank builds both groups; it keeps its own)."""
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    return init_device_mesh("cpu", (n // 2, 2),
                            mesh_dim_names=("pair", "data"))["data"]


# ------------------------------------------------------------ scenarios
def parity_k4_hetero_ranks(inputs):
    """K=4, mixed ranks, equal rows, a 2x2 mesh (4-way rows)."""
    mesh = world_mesh(model=2)
    assert dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)) == \
        {"data": 2, "model": 2}
    rt = runtime(inputs, "k4", mesh, impl="torch")
    assert rt.data_shards == 4              # "dp" folds both axes
    ids = torch.zeros((rt.batcher.total_rows() // 4,), dtype=torch.int32)
    assert rt.ssm.lora_ctx(ids, group=rt._group).equal_segments
    rt.run(4)
    return summary(rt)


def parity_k1_nondivisible_rows(inputs):
    """K=1: batch 3 pads to 4 rows on a 4-way mesh."""
    assert tile_rows(3, SEQ, BT, shards=4) == 4
    rt = runtime(inputs, "k1", world_mesh(), impl="torch")
    assert rt.batcher.rows_per_job() == [4]
    rt.run(4)
    return summary(rt)


def parity_unequal_segments(inputs):
    """Unequal rows per job: the one-hot fallback, two ranks."""
    return run(inputs, "unequal", 4, pair_mesh(), impl="torch")


def parity_psum_mode(inputs):
    """grad_sync="psum" with the autodiffed "ref" impl, four ranks."""
    return run(inputs, "ab", 4, world_mesh(), impl="ref", grad_sync="psum")


def parity_cuda_gather(inputs):
    """The "cuda" impl (its kernels' plain versions on the CPU), exact
    gathered wgrads, two ranks."""
    return run(inputs, "ab", 2, pair_mesh(), impl="cuda")


def gather_solo_bitexact(inputs):
    """all-gather + solo-order copy puts every row where it belongs."""
    from repro_torch.kernels.ops import gather_solo
    from repro_torch.launch.mesh import data_group
    group, D, s = data_group(world_mesh())
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((16, 5)).astype(np.float32))
    perm = torch.from_numpy(rng.permutation(16))
    n = 16 // D
    out = gather_solo(x[s * n:(s + 1) * n], group, perm, 16)
    want = torch.zeros_like(x)
    want[perm] = x
    assert torch.equal(out, want)
    # a slice: half of every shard's rows, the rest of the buffer zeros
    half = torch.cat([perm[r * n:r * n + n // 2] for r in range(D)])
    part = gather_solo(x[s * n:s * n + n // 2], group, half, 16)
    want_p = torch.zeros_like(x)
    want_p[half] = x[torch.cat([torch.arange(r * n, r * n + n // 2)
                                for r in range(D)])]
    assert torch.equal(part, want_p)
    return {"out": out.numpy(), "want": want.numpy()}


def local_mesh_clamps(inputs):
    """make_local_mesh clamps the model degree to a divisor."""
    from repro_torch.launch.mesh import make_local_mesh
    n = dist.get_world_size()
    got = {}
    for req in (1, 2, 3, n, 2 * n):
        mesh = make_local_mesh(model=req)
        got[req] = {k: int(v) for k, v in zip(mesh.mesh_dim_names,
                                                mesh.mesh.shape)}
    return {"world": n, "shapes": got}


def nano_regranulation_sharded(inputs):
    """N = 1 and the job-wise N = 2 on two ranks; AIMD's legal set."""
    mesh = pair_mesh()
    r1 = run(inputs, "ab", 2, mesh, impl="torch")
    r2 = run(inputs, "ab", 2, mesh, impl="torch", nano_batches=2)
    # the uniform layout's masked kernels on job-wise slices (their
    # wgrads over the full batch's tile map, the other slices' rows
    # gathered as zeros)
    r2c = run(inputs, "ab", 2, mesh, impl="cuda", nano_batches=2,
              nano_order="rank_desc")
    r3 = runtime(inputs, "ab", mesh, impl="cuda", adaptive_nano=True)
    assert r3.ssm.layout.is_uniform
    rows_loc = [r // 2 for r in r3.batcher.rows_per_job()]
    return {"n1": r1, "n2": r2, "n2_cuda": r2c,
            "legal": list(r3.aimd._legal), "rows_loc": rows_loc}


def ragged_mixed_rank_parity(inputs):
    """Ranks 4 and 64 (padded 8 and 64): the ragged route in both sync
    modes and both impls, two ranks."""
    mesh = pair_mesh()
    rt = runtime(inputs, "rag", mesh, impl="cuda")
    widths = sorted({int(s) for t in adamw.tree_leaves(rt.adapters)
                     for s in t.shape[-2:]})
    out = {"r_pads": list(rt.ssm.layout.r_pads), "widths": widths}
    rt.run(2)
    out["cuda"] = summary(rt)
    out["torch"] = run(inputs, "rag", 2, mesh, impl="torch")
    out["psum"] = run(inputs, "rag", 2, mesh, impl="cuda",
                      grad_sync="psum")
    return out


def ragged_nano_rank_desc_order(inputs):
    """N = 2 job-wise slices, segments in job order and rank-descending
    order, "torch" and "cuda" (static per-slice tile maps)."""
    mesh = pair_mesh()
    kw = dict(nano_batches=2)
    return {"job": run(inputs, "rag", 2, mesh, impl="torch", **kw),
            "rank_desc": run(inputs, "rag", 2, mesh, impl="torch",
                             nano_order="rank_desc", **kw),
            "cuda_rank_desc": run(inputs, "rag", 2, mesh, impl="cuda",
                                  nano_order="rank_desc", **kw)}


def migration_across_meshes(inputs):
    """a alone 2 steps -> merged with a fresh b on a 4-way mesh 2 steps
    -> a alone again 2 steps, against a alone throughout."""
    cfg = cfg_f32()
    params = inputs["mig"]["params"]

    def st_a():
        return copy.deepcopy(inputs["mig"]["states"][0])

    def st_b():
        return copy.deepcopy(inputs["mig"]["states"][1])
    kw = dict(KW, impl="torch")
    ref = GroupRuntime.from_states(cfg, params, [st_a()], **kw)
    ref_losses = [l[0] for l in ref.run(6).per_job_losses]
    ra = GroupRuntime.from_states(cfg, params, [st_a()], **kw)
    ra.run(2)
    merged = GroupRuntime.from_states(cfg, params,
                                      [ra.export("mig-a"), st_b()],
                                      mesh=world_mesh(), **kw)
    assert merged.data_shards == dist.get_world_size()
    step0 = merged.opt_state.step.tolist()
    merged.run(2)
    back = GroupRuntime.from_states(cfg, params, [merged.export("mig-a")],
                                    **kw)
    back.run(2)
    got = ([l[0] for l in ra.report.per_job_losses]
           + [l[0] for l in merged.report.per_job_losses]
           + [l[0] for l in back.report.per_job_losses])
    st, ref_st = back.export("mig-a"), ref.export("mig-a")
    return {"got": np.asarray(got), "ref": np.asarray(ref_losses),
            "step0": step0, "opt_step": st.opt_step,
            "steps_done": st.steps_done,
            "adapter": flat(st.adapter), "ref_adapter": flat(ref_st.adapter),
            "mu": flat(st.mu), "ref_mu": flat(ref_st.mu),
            "merged_losses": np.asarray(merged.report.per_job_losses)}


def checkpoints_and_publish_on_rank0(inputs, out_dir):
    """Rank 0 of each pair writes the checkpoints and publishes; after
    the barrier every rank restores the same state."""
    from repro_torch.elastic.migrate import JobTrainState
    from repro_torch.serve import AdapterPool
    mesh = pair_mesh()
    pair = dist.get_rank() // 2
    ckpt = os.path.join(out_dir, f"ckpt-pair{pair}")
    os.makedirs(ckpt, exist_ok=True)
    pool = AdapterPool(cfg_f32(), device="cpu")
    rt = runtime(inputs, "ab", mesh, impl="cuda", checkpoint_dir=ckpt,
                 checkpoint_every=1, publish_pool=pool, publish_every=1)
    rt.run(2)
    restored = {}
    for spec in rt.specs:
        st = JobTrainState.from_checkpoint(
            os.path.join(ckpt, f"{spec.job_id}.npz"), spec, cfg_f32())
        mine = rt.export(spec.job_id)
        assert st.opt_step == mine.opt_step == 2
        assert st.steps_done == 2
        for k in mine.adapter:
            assert torch.equal(st.adapter[k], mine.adapter[k]), k
        restored[spec.job_id] = flat(st.adapter)
    return {"published": {n: pool.version_of(n) for n in pool.names},
            "shard": rt._shard, "restored": restored}


def aimd_agrees_across_ranks(inputs):
    """AIMD fed from rank-local clocks would part the ranks; with one
    rank slowed on purpose, every rank still picks the same N (it is
    fed the all-reduced max) and records the same step times."""
    mesh = pair_mesh()
    rt = runtime(inputs, "ab", mesh, impl="cuda", adaptive_nano=True,
                 aimd_max_n=4)
    for _ in range(6):
        pending = rt.dispatch_chunk(2)
        time.sleep(0.05 * (1 + rt._shard))      # the ranks' clocks part
        rt.collect_chunk(pending)
    return {"nano": list(rt.report.nano_history),
            "step_times": list(rt.report.step_times),
            "losses": np.asarray(rt.report.per_job_losses)}


def engine_on_a_mesh(inputs):
    """ElasticEngine(mesh=...): a two-job group trained on two ranks,
    then a job removed (dissolve and export on every rank)."""
    from repro_torch.elastic.engine import ElasticEngine
    w = inputs["ab"]
    eng = ElasticEngine(cfg_f32(), params=w["params"], impl="torch",
                        block_t=BT, lr=LR, remat=False, chunk_size=2,
                        mesh=pair_mesh(), device="cpu")
    for s in specs("ab"):
        eng.add_job(s, init_seed=11)
    rt = eng.ensure_group(("a", "b"))
    assert rt.data_shards == 2
    rt.run(2)
    out = summary(rt)
    st = eng.remove_job("a")
    out["removed_steps"] = (st.opt_step, st.steps_done)
    return out


def make_train_step_on_a_mesh(inputs):
    """``SharedSuperModel.make_train_step(mesh=...)`` called directly on
    this rank's rows of one fused batch."""
    from repro_torch.core.ssm import SharedSuperModel
    from repro_torch.data.pipeline import FusedBatcher, shard_permutation
    from repro_torch.launch.mesh import data_group
    from repro_torch.optim.schedule import constant
    mesh = pair_mesh()
    _, D, s = data_group(mesh)
    cfg, jobs, w = cfg_f32(), specs("ab"), inputs["ab"]
    ssm = SharedSuperModel(cfg, jobs, impl="cuda", block_t=BT,
                           data_shards=D)
    fb = FusedBatcher(jobs, cfg.vocab_size, block_t=BT, shards=D)
    batch = fb.next_batch()
    perm = shard_permutation(fb.rows_per_job(), D)
    n = perm.size // D
    mine = {k: torch.from_numpy(np.ascontiguousarray(v[perm[s * n:
                                                          (s + 1) * n]]))
            for k, v in batch.items()}
    step = ssm.make_train_step(lr_fn=constant(LR), remat=False, mesh=mesh)
    adapters = w["adapters"]
    ad, opt, m = step(w["params"], adapters,
                      adamw.init(adapters, per_job=len(jobs)), mine)
    return {"per_job": m["per_job_loss"].numpy(), "adapters": flat(ad),
            "batch": {k: v for k, v in batch.items()}}


PARITY = ["parity_k4_hetero_ranks", "parity_k1_nondivisible_rows",
          "parity_unequal_segments", "parity_psum_mode",
          "parity_cuda_gather", "gather_solo_bitexact", "local_mesh_clamps"]
RUNTIME = ["nano_regranulation_sharded", "ragged_mixed_rank_parity",
           "ragged_nano_rank_desc_order", "migration_across_meshes",
           "checkpoints_and_publish_on_rank0", "aimd_agrees_across_ranks",
           "engine_on_a_mesh", "make_train_step_on_a_mesh"]


def main(rank, world, store, inputs_path, out_dir, names):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_mesh
    init_mesh(rank, world, f"file://{store}", "gloo")
    inputs = torch.load(inputs_path, weights_only=False)
    results = {}
    try:
        for name in names:
            fn = globals()[name]
            t0 = time.perf_counter()
            if name == "checkpoints_and_publish_on_rank0":
                res = fn(inputs, out_dir)
            else:
                res = fn(inputs)
            results[name] = {"ok": True, "res": res,
                             "s": time.perf_counter() - t0}
    except Exception:
        results[name] = {"ok": False, "err": traceback.format_exc()}
    finally:
        torch.save(results, os.path.join(out_dir, f"{rank}.pt"))
    if all(r["ok"] for r in results.values()):
        dist.destroy_process_group()
