"""Rank side of the port's sharded tests (tests/test_torch_sharded_
{parity,runtime}.py, the controller's and the pipeline's:
tests/test_torch_{controller,faults}_sharded.py,
tests/test_torch_pipeline.py).  Imports torch and the port only, never
JAX.

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
import inspect
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
    "pl": [("pl-a", 4, 8), ("pl-b", 64, 8)],
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
    """What the tests compare of a finished runtime (a pipeline's trees
    assembled whole: a collective over its slice)."""
    rep = rt.report
    adapters, opt = rt.whole_state()
    return {"losses": np.asarray(rep.per_job_losses, np.float64),
            "adapters": flat(adapters), "mu": flat(opt.mu),
            "nu": flat(opt.nu),
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


# ---------------------------------------------- the controller on a pool
# The reference's controller scenarios (tests/sharded_worker.py:385-691)
# on the four ranks of the world: ClusterController(device="cpu") over
# the pool of ranks, impl "cuda" (its kernels' plain versions), f32.
CTL_JOBS = [("g0j0", 4), ("g0j1", 8), ("g1j0", 4), ("g1j1", 8)]
CTL_GROUPS = [("g0j0", "g0j1"), ("g1j0", "g1j1")]
CTL_BUDGET = 12                    # steps of the fault scenarios' jobs


def ctl_specs(budget=10_000):
    return {j: LoRAJobSpec(j, rank=r, batch_size=2, seq_len=SEQ,
                           base_model=cfg_f32().name, steps_budget=budget)
            for j, r in CTL_JOBS}


def controller(conc, seed=3, **kw):
    from repro_torch.cluster.controller import ClusterController
    cfg = cfg_f32()
    return ClusterController(lambda m: cfg, impl="cuda", block_t=BT, lr=LR,
                             remat=False, chunk_size=2, concurrency=conc,
                             seed=seed, device="cpu", **kw)


def ctl_inputs(budget=CTL_BUDGET) -> dict:
    """Port-drawn initial states and backbone for the controller
    scenarios that are not held against the reference."""
    from repro_torch.core.lora import pad_rank
    from repro_torch.elastic.migrate import JobTrainState
    from repro_torch.models import model as M
    cfg, specs = cfg_f32(), ctl_specs(budget)
    states = {j: JobTrainState.fresh(specs[j], cfg, 100 + i,
                                     r_pad=pad_rank(r, multiple=8))
              for i, (j, r) in enumerate(CTL_JOBS)}
    return {"ctl": {"params": M.init_model(cfg, seed=5, device="cpu"),
                    "states": states}}


def admit(ctl, inputs, ids, budget=10_000):
    """Submit *ids* with the reference's initial states and backbone
    (``inputs["ctl"]``), as the test process's controllers do."""
    ctl._backbones[cfg_f32().name] = inputs["ctl"]["params"]
    specs = ctl_specs(budget)
    for j in ids:
        ctl.submit(specs[j], state=copy.deepcopy(inputs["ctl"]["states"][j]))


def decisions(ctl) -> dict:
    """What every rank of a pool must agree on (times excluded)."""
    return {"devices": sorted((list(g), list(d))
                              for g, d in ctl.group_devices().items()),
            "regroups": [(ev.mode, ev.groups_built, ev.groups_dissolved,
                          sorted(ev.fence_steps.items()))
                         for ev in ctl.regroup_log],
            "failures": [(r.kind, list(r.gkey), sorted(r.steps_lost.items()),
                          sorted(r.restored_from_checkpoint),
                          sorted(r.restarted_fresh), list(r.poisoned),
                          list(r.quarantined_devices),
                          sorted(r.attempts.items()))
                         for r in ctl.failure_log],
            "quarantined": sorted(ctl.quarantined),
            "regroup_events": ctl.regroup_events,
            "finished": sorted(ctl.finished)}


def local_group(ctl, gkeys):
    """The one group of *gkeys* this rank runs, and its runtime."""
    mine = [g for g in gkeys if ctl._slots[g].engine is not None]
    assert len(mine) == 1, (dist.get_rank(), mine)
    return mine[0], ctl._slots[mine[0]].runtime(mine[0])


def state_of(st) -> dict:
    return {"adapter": flat(st.adapter), "mu": flat(st.mu),
            "nu": flat(st.nu), "opt_step": st.opt_step,
            "steps_done": st.steps_done}


def first_losses(ctl, gkey, job=0):
    """Job *job*'s per-step losses of group *gkey*, from its first rank."""
    rt = ctl._slots[gkey].runtime(gkey)
    mine = [float(l[job]) for l in rt.report.per_job_losses] \
        if rt is not None else None
    return ctl.first_rank_value(gkey, mine)


def until(cond, limit=240.0):
    """Poll *cond* (a collective on every rank, so every rank leaves the
    loop on the same round)."""
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < limit, "scenario hung"
        time.sleep(0.05)


def all_ranks(ctl, flag) -> bool:
    return all(ctl._gather(bool(flag)))


def ctl_concurrent_parity(inputs):
    """Two 2-job groups on disjoint 2-rank slices, threads and
    sequential (tests/sharded_worker.py:391): this rank's group's
    trajectory and state under each mode, and the decisions."""
    out = {}
    for conc in ("threads", "sequential"):
        ctl = controller(conc)
        admit(ctl, inputs, [j for j, _ in CTL_JOBS])
        ctl.apply_grouping(CTL_GROUPS, chips=[2, 2])
        devs = ctl.group_devices()
        assert all(len(d) == 2 for d in devs.values()), devs
        assert not (set(devs[CTL_GROUPS[0]]) & set(devs[CTL_GROUPS[1]]))
        assert ctl.concurrency == conc and ctl.partition
        ctl.run(6)
        g, rt = local_group(ctl, CTL_GROUPS)
        assert rt.data_shards == 2
        out[conc] = {"gkey": g, "run": summary(rt),
                     "decisions": decisions(ctl)}
    return out


def ctl_repartition_migration(inputs):
    """A job solo on one rank, fused on four, solo again, against solo
    throughout (tests/sharded_worker.py:420); then the incremental
    regroup on a full pool."""
    k = 2
    ga, gab = ("g0j0",), ("g0j0", "g0j1")
    ref = controller("sequential")
    admit(ref, inputs, ga)
    ref.apply_grouping([ga], chips=[1])
    assert ref.group_devices()[ga] == (0,)
    ref.run(3 * k)
    ref_losses = first_losses(ref, ga)

    ctl = controller("sequential")
    admit(ctl, inputs, ga)
    ctl.apply_grouping([ga], chips=[1])
    ctl.run(k)
    got = list(first_losses(ctl, ga))
    admit(ctl, inputs, ("g0j1",))               # arrival -> repartition
    ctl.apply_grouping([gab], chips=[4])
    assert len(ctl.group_devices()[gab]) == 4
    assert ctl._slots[gab].runtime(gab).data_shards == 4
    ctl.run(k)
    got += first_losses(ctl, gab)
    st_b = ctl.remove_job("g0j1")               # completion -> repartition
    ctl.apply_grouping([ga], chips=[1])
    ctl.run(k)
    got += first_losses(ctl, ga)
    out = {"got": np.asarray(got), "ref": np.asarray(ref_losses),
           "b_steps": (st_b.steps_done, st_b.opt_step),
           "regroup_events": ctl.regroup_events,
           "steps_done": ctl.steps_done("g0j0"),
           "state": state_of(ctl.job_state("g0j0")),
           "ref_state": state_of(ref.job_state("g0j0")),
           "decisions": decisions(ctl)}
    # incremental regroup on a FULL pool: ensure_group allocates AFTER
    # dissolving the superseded slot, so the freed ranks are reusable
    ctl2 = controller("sequential")
    admit(ctl2, inputs, gab)
    ctl2.ensure_group(gab, chips=4)
    full = len(ctl2.group_devices()[gab])
    ctl2.ensure_group(ga, chips=1)
    out["incremental"] = (full, ctl2.group_devices()[ga])
    return out


def ctl_overlapped_migration(inputs):
    """Two pumping groups merged onto the whole pool while they step
    (tests/sharded_worker.py:478): the overlapped handoff, then the
    merged group run on; a stop-the-world run cut at the same fences."""
    ctl = controller("threads")
    admit(ctl, inputs, [j for j, _ in CTL_JOBS])
    merged = CTL_GROUPS[0] + CTL_GROUPS[1]
    ctl.apply_grouping(CTL_GROUPS, chips=[2, 2])
    ctl.begin(100_000)            # effectively: pump until drained below
    until(lambda: min(ctl.steps_done(j) for j in merged) >= 4)
    assert ctl.prewarm([merged], chips=[4]) == 1   # sources keep stepping
    ctl.apply_grouping([merged], chips=[4])
    ev = ctl.regroup_log[-1]
    out = {"event": {"mode": ev.mode, "compile_s": ev.compile_s,
                     "assemble_s": ev.assemble_s, "stall_s": ev.stall_s,
                     "dissolved": ev.groups_dissolved,
                     "built": ev.groups_built},
           "fence_steps": dict(ev.fence_steps),
           "devices": ctl.group_devices()[merged]}
    until(lambda: ctl.steps_done(merged[0]) - ev.fence_steps[merged[0]]
          >= 4)
    ctl.drain()
    fence = ev.fence_steps
    extra = {j: ctl.steps_done(j) - fence[j] for j in merged}
    assert len(set(extra.values())) == 1, extra    # members step together
    r = next(iter(extra.values()))
    ref = controller("sequential")
    admit(ref, inputs, [j for j, _ in CTL_JOBS])
    ref.apply_grouping(CTL_GROUPS, chips=[2, 2])
    g, rt = local_group(ref, CTL_GROUPS)
    rt.run(fence[g[0]])
    ref._barrier()
    ref.apply_grouping([merged], chips=[4])
    ref._slots[merged].runtime(merged).run(r)
    out["states"] = {j: state_of(ctl.job_state(j)) for j in merged}
    out["ref_states"] = {j: state_of(ref.job_state(j)) for j in merged}
    out["decisions"] = decisions(ctl)
    return out


def ctl_fixed_mesh(inputs):
    """Every group on the world's mesh (``fixed_mesh``), sequential and
    roundrobin: each group's trajectory on every rank."""
    out = {}
    for conc in ("sequential", "roundrobin"):
        ctl = controller(conc, fixed_mesh=world_mesh())
        assert not ctl.partition
        admit(ctl, inputs, [j for j, _ in CTL_JOBS])
        ctl.apply_grouping(CTL_GROUPS, chips=[2, 2])
        ctl.run(4)
        out[conc] = {"+".join(g): summary(ctl._slots[g].runtime(g))
                     for g in CTL_GROUPS}
        out[conc]["shards"] = [ctl._slots[g].runtime(g).data_shards
                               for g in CTL_GROUPS]
        out[conc]["decisions"] = decisions(ctl)
    return out


def ctl_execution_backend(inputs):
    """``ExecutionBackend(mesh=)`` and ``(devices=)`` each measure a
    positive step (tests/sharded_worker.py:693); "ref" falls back to
    "psum"."""
    from repro_torch.cluster.execution import ExecutionBackend
    from repro_torch.core.jobs import JobRuntimeState
    from repro_torch.core.scheduler import Group
    cfg = cfg_f32()
    specs = [LoRAJobSpec("x1", rank=4, batch_size=2, seq_len=SEQ,
                         base_model="tinyllama-1.1b"),
             LoRAJobSpec("x2", rank=8, batch_size=2, seq_len=SEQ,
                         base_model="tinyllama-1.1b")]
    group = Group(jobs=[JobRuntimeState(spec=s) for s in specs], chips=2)
    out = {"decisions": []}
    for name, kw in (("mesh", dict(mesh=world_mesh())),
                     ("devices", dict(devices=["cpu"] * 4))):
        be = ExecutionBackend(impl="cuda", block_t=BT, seed=0,
                              device="cpu", **kw)
        t = be.observe(cfg, group, predicted=1e-3, now=0.0)
        ctl = be.controller
        out[name] = {"t": t, "records": [r.measured for r in be.records],
                     "partition": ctl.partition,
                     "devices": ctl.group_devices()[("x1", "x2")],
                     "grad_sync": be._engine_kwargs["grad_sync"]}
        out["decisions"].append(decisions(ctl))
    be2 = ExecutionBackend(impl="ref", block_t=BT, mesh=world_mesh(),
                           seed=0, device="cpu")
    out["ref_grad_sync"] = be2._engine_kwargs["grad_sync"]
    return out


def ctl_trace(inputs):
    """A short ``TraceRunner`` trace over the partitioned pool: every
    job completes."""
    from repro_torch.cluster.controller import run_trace
    from repro_torch.cluster.harness import TraceRunner
    ctl = controller("threads", seed=0)
    ctl.register_cfg(cfg_f32().name, cfg_f32())
    jobs = [LoRAJobSpec(f"t{i}", rank=r, batch_size=2, seq_len=SEQ,
                        base_model=cfg_f32().name, steps_budget=4,
                        arrival_time=float(i), max_slowdown=2.0)
            for i, r in enumerate((4, 8, 16, 4))]
    res = run_trace(TraceRunner(ctl, jobs, arrival_window_s=1.0,
                                poll_s=0.05, max_wall_s=180.0))
    return {"completed": sorted(res.completed), "lost": res.lost,
            "timed_out": res.timed_out, "wall_s": res.wall_s,
            "steps": {j: ctl.steps_done(j) for j in sorted(res.logs)},
            "decisions": decisions(ctl)}


# ----------------------------------------------------- faults on a pool
def _ft_setup(inputs, kind, phase, out_dir, tag):
    """Two 2-job groups on disjoint 2-rank slices, checkpoints every
    chunk, one scripted fault on group B's first member
    (tests/sharded_worker.py:529)."""
    from repro_torch.cluster.faults import FaultPlan, FaultSpec
    ckpt = os.path.join(out_dir, f"ckpt-{tag}")
    os.makedirs(ckpt, exist_ok=True)
    plan = FaultPlan([FaultSpec(kind, job_id="g1j0", at_step=4,
                                phase=phase)])
    ctl = controller("threads", checkpoint_dir=ckpt, checkpoint_every=1,
                     fault_plan=plan, max_restarts=3, backoff_base_s=0.02,
                     stuck_after=None)
    admit(ctl, inputs, [j for j, _ in CTL_JOBS], budget=CTL_BUDGET)
    ctl.apply_grouping(CTL_GROUPS, chips=[2, 2])
    return ctl, plan


def _ft_reference(inputs):
    """The fault-free sequential run of the same partition."""
    ref = controller("sequential")
    admit(ref, inputs, [j for j, _ in CTL_JOBS], budget=CTL_BUDGET)
    ref.apply_grouping(CTL_GROUPS, chips=[2, 2])
    g, rt = local_group(ref, CTL_GROUPS)
    rt.run(CTL_BUDGET)
    ref._barrier()
    return ref, g, rt


def _first_failure(ctl):
    recs = []
    until(lambda: recs.extend(ctl.supervise(reschedule=False)) or recs)
    return recs[0]


def ft_worker_death(inputs, out_dir):
    """A worker killed mid-chunk in group B (tests/sharded_worker.py:595):
    A's pump untouched, B restored from its checkpoints and rebuilt,
    replay-exact from the checkpoint step on."""
    ref, g_ref, rt_ref = _ft_reference(inputs)
    ref_losses = np.asarray(rt_ref.report.per_job_losses)
    ctl, plan = _ft_setup(inputs, "worker_death", "inflight", out_dir,
                          "death")
    ga, gb = CTL_GROUPS
    ctl.begin(until_budget=True)
    w_a = ctl._workers.get(ga)
    rec = _first_failure(ctl)
    out = {"rec": (rec.kind, rec.gkey, sorted(rec.restored_from_checkpoint),
                   rec.restarted_fresh, rec.poisoned,
                   dict(rec.steps_lost)),
           "fired": len(plan.fired), "group": g_ref,
           "a_same": w_a is None or (ctl._workers.get(ga) is w_a
                                     and w_a.exception is None),
           "quarantined": sorted(ctl.quarantined)}
    ckpt_step = min(ctl._parked[j].steps_done for j in gb)
    out["ckpt_step"] = ckpt_step
    time.sleep(0.05)                       # let the retry backoff pass
    res = ctl.apply_grouping([ga, gb], chips=[2, 2])
    out["keep_build"] = (res["keep"], res["build"])
    until(lambda: all_ranks(ctl, all(w.done.is_set()
                                     for w in ctl._workers.values())))
    assert all(w.exception is None for w in ctl._workers.values())
    g, rt = local_group(ctl, CTL_GROUPS)
    assert g == g_ref
    out["post"] = np.asarray(rt.report.per_job_losses)
    out["ref_losses"] = ref_losses
    out["a_bit_equal"] = g != ga or np.array_equal(
        np.asarray(rt.report.per_job_losses), ref_losses)
    ctl.reap_completed()
    out["finished"] = sorted(ctl.finished)
    out["steps"] = {j: ctl.steps_done(j) for j, _ in CTL_JOBS}
    out["states"] = {j: state_of(ctl.job_state(j)) for j, _ in CTL_JOBS}
    out["ref_states"] = {j: state_of(ref.job_state(j)) for j, _ in CTL_JOBS}
    out["decisions"] = decisions(ctl)
    return out


def ft_submesh_loss(inputs, out_dir):
    """Group B's slice lost (tests/sharded_worker.py:659): its ranks
    quarantined for good, B rebuilt on disjoint ranks, every job at its
    budget on the shrunken pool."""
    ctl, _ = _ft_setup(inputs, "submesh_loss", "boundary", out_dir, "loss")
    ga, gb = CTL_GROUPS
    lost = set(ctl.group_devices()[gb])
    ctl.begin(until_budget=True)
    rec = _first_failure(ctl)
    out = {"rec": (rec.kind, rec.gkey, list(rec.quarantined_devices),
                   dict(rec.steps_lost)),
           "lost": sorted(lost), "quarantined": sorted(ctl.quarantined),
           "available": ctl.available_device_ids()}
    time.sleep(0.05)
    ctl.apply_grouping([ga, gb], chips=[2, 2])
    out["devices_after"] = {"+".join(g): list(d)
                            for g, d in ctl.group_devices().items()}
    until(lambda: all_ranks(ctl, all(w.done.is_set()
                                     for w in ctl._workers.values())))
    assert all(w.exception is None for w in ctl._workers.values())
    ctl.reap_completed()
    out["finished"] = sorted(ctl.finished)
    out["steps"] = {j: ctl.steps_done(j) for j, _ in CTL_JOBS}
    out["quarantined_end"] = sorted(ctl.quarantined)
    out["decisions"] = decisions(ctl)
    return out


def ctl_pool_of_two(inputs):
    """A pool of two devices (two ranks): partitioned, threads."""
    ctl = controller(None, devices=["cpu", "cpu"])
    admit(ctl, inputs, CTL_GROUPS[0])
    ctl.apply_grouping([CTL_GROUPS[0][:1], CTL_GROUPS[0][1:]],
                       chips=[1, 1])
    ctl.run(2)
    return {"devices": [str(d) for d in ctl.devices],
            "partition": ctl.partition, "concurrency": ctl.concurrency,
            "groups": decisions(ctl)["devices"],
            "steps": ctl.steps_done(CTL_GROUPS[0][0])}


# ------------------------------------------------------- pipeline mode
# The reference's pipeline scenarios (tests/sharded_worker.py:225-300,
# tests/test_lossless.py's pipeline case) and the port's own, on the four
# ranks of the world: P = 2 x D = 2 over the world, P = 2 x D = 1 on the
# two 2-rank slices of ``partition_mesh([2, 2], stages=2)``.
PIPE = dict(tp_mode="pipeline", pipeline_stages=2)
PIPE_RUNS = {"g2_rank_desc": dict(nano_batches=2, nano_order="rank_desc"),
             "g4_job": dict(nano_batches=4),
             "psum2": dict(nano_batches=2, grad_sync="psum")}


def pipe_world():
    from repro_torch.launch.mesh import make_local_mesh
    return make_local_mesh(stages=2)


def pipe_pairs():
    """This rank's 2-rank slice, its stage groups made by every rank."""
    from repro_torch.launch.mesh import partition_mesh
    return partition_mesh([2, 2], stages=2)[dist.get_rank() // 2]


def pipe_run(inputs, key, mesh, steps=2, **kw) -> dict:
    """A pipeline run of job set *key*: its summary, its occupancy
    counters and its step accounting."""
    rt = runtime(inputs, key, mesh, impl="cuda", **dict(PIPE, **kw))
    rt.run(steps)
    m = rt.report.last_metrics
    return dict(summary(rt), useful=np.asarray(m["pipe_useful_slots"]),
                slots=np.asarray(m["pipe_slots"]), n=rt.n,
                stages=rt.pipeline_stages, shards=rt.data_shards,
                stage=rt._stage_idx)


def pipe_parity(inputs):
    """The mixed-rank set ("pl", ranks 4 and 64, batch 8) as P = 2 x
    D = 2 over the world in three runs (gather N = 2 "rank_desc", gather
    N = 4 "job", psum N = 2) and as P = 2 x D = 1 on each 2-rank slice;
    beside each, the data-parallel run over the same data shards (D = 2
    on a 2-rank slice, D = 1 on one rank) with the same N, nano order
    and grad sync."""
    from repro_torch.launch.mesh import partition_mesh
    world = pipe_world()
    assert world.shape == {"stage": 2, "data": 2}
    out = {name: pipe_run(inputs, "pl", world, **kw)
           for name, kw in PIPE_RUNS.items()}
    pairs = partition_mesh([2, 2])[dist.get_rank() // 2]
    out["dp"] = {name: run(inputs, "pl", 2, pairs, impl="cuda", **kw)
                 for name, kw in PIPE_RUNS.items()}
    out["d1"] = pipe_run(inputs, "pl", pipe_pairs(),
                         **PIPE_RUNS["g2_rank_desc"])
    ones = partition_mesh([1, 1, 1, 1])[dist.get_rank()]
    out["dp1"] = run(inputs, "pl", 2, ones, impl="cuda",
                     **PIPE_RUNS["g2_rank_desc"])
    return out


def pipe_uniform(inputs):
    """The uniform set ("ab", ranks 4 and 8 in 8-wide segments: the
    masked kernels' route), P = 2 x D = 2, gather N = 2, beside its D = 2
    data-parallel run."""
    from repro_torch.launch.mesh import partition_mesh
    got = pipe_run(inputs, "ab", pipe_world(), nano_batches=2)
    rt = runtime(inputs, "ab", pipe_world(), impl="cuda", **PIPE)
    got["uniform"] = rt.ssm.layout.is_uniform
    pairs = partition_mesh([2, 2])[dist.get_rank() // 2]
    got["dp"] = run(inputs, "ab", 2, pairs, impl="cuda", nano_batches=2)
    return got


def tail_cfg():
    """recurrentgemma-9b reduced and cut to 7 layers: a scanned 2-cycle
    stack and an unscanned one-layer tail."""
    return dataclasses.replace(get_config("recurrentgemma-9b").reduced(),
                               dtype="float32", num_layers=7)


def pipe_unscanned_tail(inputs):
    """P = 2 x D = 2 on the 7-layer recurrentgemma: the tail (segment 1)
    runs on stage 1 only; after each step its adapter leaves and moments
    are returned from every rank (the test holds them equal), and the
    run's summary (against the meshless run at the bars)."""
    cfg, w = tail_cfg(), inputs["tail"]
    rt = GroupRuntime.from_specs(cfg, specs("ab"), params=w["params"],
                                 adapters=w["adapters"], mesh=pipe_world(),
                                 **dict(KW, impl="cuda", chunk_size=1,
                                        nano_batches=2, **PIPE))
    tails = []
    for _ in range(2):
        rt.run(1)
        tails.append({"adapters": flat(rt.adapters["segments"][1]),
                      "mu": flat(rt.opt_state.mu["segments"][1])})
    return {"tails": tails, "run": summary(rt), "stage": rt._stage_idx}


def pipe_residency(inputs):
    """Each rank holds its stage's cycles of the scanned stack (backbone,
    adapters, both moments) and nothing else of it, with the f32 and
    with the int8 backbone (a QuantTensor's codes and scales cut
    together), the latter then trained two steps."""
    from repro_torch.models import quant
    w = inputs["pl"]
    out = {}
    for qz in (None, "int8"):
        rt = runtime(inputs, "pl", pipe_world(), impl="cuda",
                     quantize=qz, nano_batches=2, **PIPE)
        s = rt._stage_idx
        full_p = quant.quantize_params(w["params"], qz)
        seg_p, seg_f = rt.params["segments"][0], full_p["segments"][0]
        leaves = {}
        for k, t in flat_q(seg_p).items():
            want = flat_q(seg_f)[k][s:s + 1]
            leaves["params/" + k] = (list(t.shape), bool(torch.equal(
                t, want)))
        for part, tree, full in (
                ("adapters", rt.adapters, w["adapters"]),
                ("mu", rt.opt_state.mu, None), ("nu", rt.opt_state.nu, None)):
            for k, t in flat_t(tree).items():
                ok = True if full is None else bool(torch.equal(
                    t, flat_t(full)[k][s:s + 1]))
                leaves[f"{part}/{k}"] = (list(t.shape), ok)
        out[str(qz)] = {"leaves": leaves, "stage": s,
                        "quant": isinstance(seg_p["0"]["attn"]["wq"],
                                            quant.QuantTensor)}
        if qz:
            rt.run(2)
            out["int8_run"] = summary(rt)
    return out


def flat_t(tree, path=()):
    """{key path: tensor} of a nested dict/list tree of tensors."""
    if isinstance(tree, dict):
        return {p: v for k, t in tree.items()
                for p, v in flat_t(t, path + (k,)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, t in enumerate(tree)
                for p, v in flat_t(t, path + (str(i),)).items()}
    return {"/".join(path): tree}


def flat_q(tree):
    """``flat_t`` with a QuantTensor's codes and scales as two leaves."""
    from repro_torch.models.quant import QuantTensor
    out = {}
    for k, v in flat_t(tree).items():
        if isinstance(v, QuantTensor):
            out[k + "/q"], out[k + "/scale"] = v.q, v.scale
        else:
            out[k] = v
    return out


def pipe_legality(inputs):
    """The reference's contracts: a requested N below the depth snaps to
    a legal count; a depth that does not divide the slice, or the
    stack, and a depth of 1 raise ValueError naming the problem; every
    rank raises the same."""
    from repro_torch.launch.mesh import make_local_mesh
    rt = runtime(inputs, "pl", pipe_world(), impl="cuda", nano_batches=1,
                 **PIPE)
    out = {"snapped": rt.n, "legal_n1": None}
    errs = {}
    for name, kw in (("slice", dict(pipeline_stages=3)),
                     ("stack", dict(pipeline_stages=4)),
                     ("depth1", dict(pipeline_stages=1))):
        try:
            runtime(inputs, "pl", make_local_mesh(), impl="cuda",
                    tp_mode="pipeline", **kw)
            errs[name] = None
        except ValueError as e:
            errs[name] = str(e)
    out["errors"] = errs
    return out


def pipe_migration(inputs):
    """solo k -> fused with a rank-64 peer into a P = 2 x D = 2 group k
    -> extracted and solo again k (tests/test_lossless.py's pipeline
    case): the stitched trajectory and the final state against solo
    throughout, the rank-4 job's slices 4 wide, Adam steps exact."""
    cfg, params, k = cfg_f32(), inputs["pmig"]["params"], 2
    kw = dict(KW, impl="cuda")

    def st(i):
        return copy.deepcopy(inputs["pmig"]["states"][i])
    ref = GroupRuntime.from_states(cfg, params, [st(0)], **kw)
    ref_losses = [l[0] for l in ref.run(3 * k).per_job_losses]
    ra = GroupRuntime.from_states(cfg, params, [st(0)], **kw)
    ra.run(k)
    rb = GroupRuntime.from_states(cfg, params, [st(1)], **kw)
    rb.run(k)
    merged = GroupRuntime.from_states(
        cfg, params, [ra.export("small"), rb.export("wide")],
        mesh=pipe_world(), nano_batches=2, **dict(kw, **PIPE))
    step0 = merged.opt_state.step.tolist()
    merged.run(k)
    small = merged.export("small")
    widths = sorted({int(v.shape[-1] if n.endswith("A") else v.shape[-2])
                     for n, v in small.adapter.items()})
    back = GroupRuntime.from_states(cfg, params, [small], **kw)
    back.run(k)
    got = ([l[0] for l in ra.report.per_job_losses]
           + [l[0] for l in merged.report.per_job_losses]
           + [l[0] for l in back.report.per_job_losses])
    have, want = back.export("small"), ref.export("small")
    return {"got": np.asarray(got), "ref": np.asarray(ref_losses),
            "step0": step0, "n": merged.n, "widths": widths,
            "merged_opt_step": small.opt_step,
            "opt_step": (have.opt_step, want.opt_step),
            "steps_done": (have.steps_done, want.steps_done),
            "adapter": flat(have.adapter), "ref_adapter": flat(want.adapter),
            "mu": flat(have.mu), "ref_mu": flat(want.mu),
            "nu": flat(have.nu), "ref_nu": flat(want.nu)}


def pipe_engine(inputs):
    """``ElasticEngine(tp_mode="pipeline")`` over the world: the "ab"
    group trained two steps, then a job removed (every rank exports)."""
    from repro_torch.elastic.engine import ElasticEngine
    w = inputs["ab"]
    eng = ElasticEngine(cfg_f32(), params=w["params"], impl="cuda",
                        block_t=BT, lr=LR, remat=False, chunk_size=2,
                        mesh=world_mesh(), nano_batches=2, device="cpu",
                        **PIPE)
    for s in specs("ab"):
        eng.add_job(s, init_seed=11)
    rt = eng.ensure_group(("a", "b"))
    assert rt.pipeline_stages == 2 and rt.data_shards == 2
    rt.run(2)
    out = summary(rt)
    st = eng.remove_job("a")
    out["removed"] = (st.opt_step, st.steps_done, flat(st.adapter))
    return out


def pipe_controller(inputs):
    """``ClusterController(partition=True, tp_mode="pipeline",
    pipeline_stages=2)``: CTL_GROUPS on the two 2-rank slices (P = 2 x
    D = 1 each), run 4 steps; this rank's group's losses, the job
    states and the decisions.  Then a depth of 3 refused at partition
    time, on every rank."""
    ctl = controller("threads", partition=True, **PIPE)
    admit(ctl, inputs, [j for j, _ in CTL_JOBS])
    ctl.apply_grouping(CTL_GROUPS, chips=[2, 2])
    g, rt = local_group(ctl, CTL_GROUPS)
    assert rt.pipeline_stages == 2 and rt.data_shards == 1
    ctl.run(4)
    out = {"gkey": g, "n": rt.n, "stage": rt._stage_idx,
           "losses": {"+".join(k): [first_losses(ctl, k, j)
                                    for j in range(2)]
                      for k in CTL_GROUPS},
           "states": {j: state_of(ctl.job_state(j)) for j, _ in CTL_JOBS},
           "decisions": decisions(ctl)}
    bad = controller("sequential", partition=True, tp_mode="pipeline",
                     pipeline_stages=3)
    admit(bad, inputs, CTL_GROUPS[0])
    try:
        bad.apply_grouping([CTL_GROUPS[0]], chips=[2])
        out["depth3"] = None
    except ValueError as e:
        out["depth3"] = str(e)
    return out


# ------------------------------------------- the MoE over a mesh (A3)
# Reduced MoE configs in f32 (tests/test_torch_moe_mesh.py): qwen3-moe
# with either dispatch, and deepseek-v2-lite (MLA + MoE, a dense head
# layer, a shared expert) cut to 3 layers, so that its scanned stack has
# the 2 cycles a 2-stage pipeline needs.
MOE_CFGS = {"qr": ("qwen3-moe-30b-a3b", "ragged", None),
            "qc": ("qwen3-moe-30b-a3b", "capacity", None),
            "ds": ("deepseek-v2-lite-16b", "ragged", 3)}
MOE_DP = {"qr": {"g1": {}, "p1": dict(grad_sync="psum"),
                 "g2": dict(nano_batches=2)},
          "qc": {"g1": {}, "g2": dict(nano_batches=2)},
          "ds": {"g1": {}, "p1": dict(grad_sync="psum")}}


def moe_cfg(key, get=None):
    arch, impl, layers = MOE_CFGS[key]
    cfg = (get or get_config)(arch).reduced()
    return dataclasses.replace(cfg, dtype="float32", moe_impl=impl,
                               **({"num_layers": layers} if layers else {}))


def moe_run(inputs, key, mesh, **kw) -> dict:
    w = inputs[key]
    rt = GroupRuntime.from_specs(moe_cfg(key), specs("ab"),
                                 params=w["params"], adapters=w["adapters"],
                                 mesh=mesh, **dict(KW, impl="cuda", **kw))
    rt.run(2)
    return dict(summary(rt), aux=np.asarray(rt.report.last_metrics["aux"]))


def moe_dp(inputs):
    """The MoE configs through ``tp_mode="dp"`` on each 2-rank pair
    (D = 2): gather and psum at N = 1, gather at N = 2 (job-wise nano
    slices)."""
    return {key: {name: moe_run(inputs, key, pair_mesh(), **kw)
                  for name, kw in runs.items()}
            for key, runs in MOE_DP.items()}


def moe_pipeline(inputs):
    """The MoE configs through ``tp_mode="pipeline"``, P = 2 x D = 1 on
    each 2-rank slice, N = 2 micro-batches."""
    return {key: moe_run(inputs, key, pipe_pairs(), nano_batches=2, **PIPE)
            for key in MOE_CFGS}


# ------------------------------------ tensor parallelism (A3, A4)
# tp_mode="auto" over ("data", "model") meshes: data 2 x model 2 over
# the world, data 1 x model 2 on each pair (tests/test_torch_tensor_
# parallel.py).  Job sets: "rag" (mixed ranks: the ragged kernels),
# "ab" (uniform: the masked kernels).
TP_RUNS = {"rag": ("tl", "rag", {}), "ab": ("tl", "ab", {}),
           "rag_psum": ("tl", "rag", dict(grad_sync="psum")),
           "qc": ("qc", "ab", {}), "qr": ("qr", "ab", {}),
           "qs": ("qs", "ab", {})}


def tp_cfg(key, get=None):
    """The port's config of a ``TP_RUNS`` key (*get*: the reference's
    registry instead): reduced f32 tinyllama ("tl"), a ``MOE_CFGS`` key,
    or "qs", the ragged qwen3-moe with one shared expert (its SwiGLU
    column/row parallel beside the expert-parallel dispatch)."""
    if key == "tl":
        return dataclasses.replace((get or get_config)(
            "tinyllama-1.1b").reduced(), dtype="float32")
    if key == "qs":
        return dataclasses.replace(moe_cfg("qr", get), num_shared_experts=1)
    return moe_cfg(key, get)


def tp_world():
    from repro_torch.launch.mesh import make_local_mesh
    return make_local_mesh(model=2)


def tp_pairs():
    """Data 1 x model 2 on each pair of the world: a (pair, data, model)
    mesh's ("data", "model") slice, its groups made by every rank."""
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (dist.get_world_size() // 2, 1, 2),
                            mesh_dim_names=("pair", "data", "model"))
    return mesh["data", "model"]


def tp_run(inputs, cfg_key, jobs, mesh, **kw) -> dict:
    from repro_torch.models import model as M
    from repro_torch.sharding.rules import runtime_param_specs
    w = inputs[f"{cfg_key}:{jobs}"]
    cfg = tp_cfg(cfg_key)
    rt = GroupRuntime.from_specs(cfg, specs(jobs), params=w["params"],
                                 adapters=w["adapters"], mesh=mesh,
                                 tp_mode="auto",
                                 **dict(KW, impl="cuda", **kw))
    rt.run(2)
    spec = runtime_param_specs({"data": 1, "model": 2},
                               M.init_model(cfg, device="meta"))
    def nbytes(tree):
        return sum(t.numel() * t.element_size()
                   for t in flat_t(tree).values())
    return dict(summary(rt), bytes=nbytes(rt.params),
                whole_bytes=nbytes(w["params"]),
                shapes={k: tuple(v.shape) for k, v in flat_t(rt.params)
                        .items()},
                specs=_flat_specs(spec),
                model_axis=rt.model_axis, shards=rt.data_shards,
                aux=np.asarray(rt.report.last_metrics["aux"]))


def _flat_specs(tree, path=()):
    if isinstance(tree, dict):
        return {p: v for k, t in tree.items()
                for p, v in _flat_specs(t, path + (k,)).items()}
    if isinstance(tree, list):
        return {p: v for i, t in enumerate(tree)
                for p, v in _flat_specs(t, path + (str(i),)).items()}
    return {"/".join(path): tree}


def tp_parity(inputs):
    """Every ``TP_RUNS`` run at data 1 x model 2 (each pair) and the
    dense ones at data 2 x model 2 (the world)."""
    pairs = tp_pairs()
    out = {"d1": {name: tp_run(inputs, c, j, pairs, **kw)
                  for name, (c, j, kw) in TP_RUNS.items()}}
    world = tp_world()
    out["d2"] = {name: tp_run(inputs, c, j, world, **kw)
                 for name, (c, j, kw) in TP_RUNS.items()}
    return out


def tp_step_and_engine(inputs):
    """``make_train_step(mesh=, tp_mode="auto")`` called directly on this
    rank's data shard's rows and its model slices; ``ElasticEngine(
    tp_mode="auto")`` over the world (data 2 x model 2): a two-job group
    trained 2 steps, then a job removed."""
    from repro_torch.core.ssm import SharedSuperModel
    from repro_torch.data.pipeline import FusedBatcher, shard_permutation
    from repro_torch.elastic.engine import ElasticEngine
    from repro_torch.launch.mesh import data_group, model_group
    from repro_torch.models import model as M
    from repro_torch.optim.schedule import constant
    from repro_torch.sharding.rules import shard_params
    mesh = tp_world()
    _, D, s = data_group(mesh, "data")
    _, m, mi = model_group(mesh)
    cfg, jobs, w = cfg_f32(), specs("ab"), inputs["tl:ab"]
    ssm = SharedSuperModel(cfg, jobs, impl="cuda", block_t=BT,
                           data_shards=D)
    fb = FusedBatcher(jobs, cfg.vocab_size, block_t=BT, shards=D)
    batch = fb.next_batch()
    perm = shard_permutation(fb.rows_per_job(), D)
    n = perm.size // D
    mine = {k: torch.from_numpy(np.ascontiguousarray(v[perm[s * n:
                                                          (s + 1) * n]]))
            for k, v in batch.items()}
    step = ssm.make_train_step(lr_fn=constant(LR), remat=False, mesh=mesh,
                               tp_mode="auto")
    params = shard_params(w["params"], M.init_model(cfg, device="meta"),
                          m, mi, cfg=cfg)
    adapters = w["adapters"]
    ad, _, met = step(params, adapters,
                      adamw.init(adapters, per_job=len(jobs)), mine)
    out = {"step": {"per_job": met["per_job_loss"].numpy(),
                    "adapters": flat(ad), "batch": dict(batch)}}
    eng = ElasticEngine(cfg, params=w["params"], impl="cuda", block_t=BT,
                        lr=LR, remat=False, chunk_size=2, mesh=mesh,
                        tp_mode="auto", device="cpu")
    for sp in jobs:
        eng.add_job(sp, init_seed=11)
    rt = eng.ensure_group(("a", "b"))
    assert rt.data_shards == 2 and rt.model_axis == (2, mi)
    rt.run(2)
    out["engine"] = summary(rt)
    st = eng.remove_job("a")
    out["removed_steps"] = (st.opt_step, st.steps_done)
    return out


def tp_controller(inputs):
    """``ClusterController(tp_mode="auto")`` over the pool: two 2-job
    groups on disjoint 2-rank slices, threads; the slices are 1-D, so
    each group runs the data-parallel step over its slice."""
    ctl = controller("threads", tp_mode="auto")
    admit(ctl, inputs, [j for j, _ in CTL_JOBS])
    ctl.apply_grouping(CTL_GROUPS, chips=[2, 2])
    ctl.run(4)
    g, rt = local_group(ctl, CTL_GROUPS)
    assert rt.tp_mode == "auto" and rt.data_shards == 2
    return {"gkey": g, "losses": [[float(l[j]) for l in
                                   rt.report.per_job_losses]
                                  for j in range(2)],
            "states": {j: state_of(ctl.job_state(j))
                       for j, _ in CTL_JOBS},
            "decisions": decisions(ctl)}


# ------------------------- tensor-parallel serving (ROADMAP A8a)
# The serve steps over ("data", "model") meshes (tests/test_torch_tp_
# serve.py): data 1 x model 2 on each pair (kv heads split), data 1 x
# model 4 over the world (each kv head shared by 2 ranks), data 2 x
# model 2 over the world (the batch's rows split in order too).  Job set:
# ranks 4 and 16 (pad 8/16 at block_t 8: the ragged kernels), TPS_ROWS
# rows a job, so a data rank's share is whole token tiles.
TPS_RANKS = (4, 16)
TPS_ROWS = 16
TPS_PROMPT = 8
TPS_DECODE = 8


def tps_specs(cls=LoRAJobSpec, ranks=TPS_RANKS, rows=TPS_ROWS):
    return [cls(f"tps-{i}", rank=r, batch_size=rows, seq_len=BT)
            for i, r in enumerate(ranks)]


def tps_shape(cls=None):
    from repro_torch.configs.base import InputShape
    return (cls or InputShape)("tps", TPS_PROMPT + TPS_DECODE,
                               TPS_ROWS * len(TPS_RANKS), "decode")


def tps_meshes():
    """The three serve meshes, made by every rank in one order."""
    return {"m2": tp_pairs(), "m4": world_mesh(model=4),
            "d2m2": tp_world()}


def tps_greedy(cfg, specs, params, adapters, toks, mesh, ring=False,
               row_block=None):
    """Prefill TPS_PROMPT tokens of this rank's rows of *toks* (the
    whole batch's prompts, job-major), then TPS_DECODE greedy steps:
    the logits of each step (B_loc, 1 + TPS_DECODE, V), the ids chosen
    (B_loc, 1 + TPS_DECODE), this rank's caches after the last step
    (the first layer's k and v, where it is an attention layer, and every
    leaf's shape) and where it sits."""
    from repro_torch.core.ssm import SharedSuperModel
    from repro_torch.launch.mesh import model_group
    from repro_torch.models import model as M
    from repro_torch.models.layers import ModelAxis
    from repro_torch.sharding.rules import shard_params
    ssm = SharedSuperModel(cfg, specs, impl="cuda", block_t=BT)
    idx = ssm.serve_rows(mesh)
    rows = (torch.arange(toks.shape[0]) if idx is None
            else torch.as_tensor(idx))
    ids = torch.arange(len(specs), dtype=torch.int32).repeat_interleave(
        torch.as_tensor(ssm.rows_per_job()))[rows]
    t = torch.as_tensor(toks)[rows]
    local, tp = params, None
    if mesh is not None:
        tp = ModelAxis(*model_group(mesh))
        local = shard_params(params, M.init_model(cfg, device="meta"),
                             tp.size, tp.index, cfg=cfg)
    prefill = ssm.make_prefill_step(tps_shape(), ring=ring, mesh=mesh)
    step = ssm.make_serve_step(ring=ring, mesh=mesh)
    lp, caches = prefill(local, adapters, {"tokens": t[:, :TPS_PROMPT],
                                           "adapter_ids": ids},
                         row_block and row_block * TPS_PROMPT)
    logits = [lp[:, 0]]
    for pos in range(TPS_PROMPT, TPS_PROMPT + TPS_DECODE):
        tok = logits[-1].argmax(-1).to(torch.int32)
        lg, _ = step(local, adapters, caches, {"tokens": tok[:, None],
                                               "adapter_ids": ids}, pos,
                     row_block)
        logits.append(lg[:, 0])
    lg = torch.stack(logits, dim=1)
    kv = caches[0]["0"]
    return {"rows": rows.numpy(), "logits": lg.numpy(),
            "ids": lg.argmax(-1).numpy(),
            "k": kv.k.numpy() if hasattr(kv, "k") else None,
            "v": kv.v.numpy() if hasattr(kv, "v") else None,
            "caches": {k: tuple(v.shape) for k, v in flat_t(
                [list(c.values()) for c in caches]).items()},
            "model_axis": None if tp is None else (tp.size, tp.index),
            "kv_head": None if tp is None or not cfg.num_kv_heads
            else tp.kv_head(cfg.num_kv_heads),
            "kv_local": None if tp is None else tp.kv_local(
                cfg.num_kv_heads)}


def solo_adapters(adapters, layout, k, multiple=BT):
    """Job *k*'s adapter alone, re-packed as a one-job group's."""
    from repro_torch.core.lora import (RankLayout, extract_adapter,
                                       merge_adapter_pair)
    lay = RankLayout((layout.ranks[k],), multiple=multiple)

    def walk(t):
        if isinstance(t, dict) and set(t) == {"A", "B"}:
            return merge_adapter_pair([extract_adapter(t, layout, k)], lay)
        if isinstance(t, dict):
            return {kk: walk(v) for kk, v in t.items()}
        return [walk(v) for v in t]
    return walk(adapters)


def tps_meshes_run(inputs):
    """Reduced f32 tinyllama served on each of the three meshes, and
    meshless."""
    w, toks = inputs["tps:tl"], inputs["tps:toks"]
    run = lambda mesh: tps_greedy(cfg_f32(), tps_specs(), w["params"],
                                  w["adapters"], toks, mesh)
    return dict({name: run(mesh) for name, mesh in tps_meshes().items()},
                meshless=run(None))


def tps_ring(inputs):
    """Every attention cache a ring (the sliding-window variant) at data
    1 x model 2 and data 1 x model 4, beside this rank's meshless ring
    serve (the reference prefills through a ring non-causally, ROADMAP
    C6: the port's own meshless run is the function)."""
    w, toks = inputs["tps:tl"], inputs["tps:toks"]
    run = lambda mesh: tps_greedy(cfg_f32(), tps_specs(), w["params"],
                                  w["adapters"], toks, mesh, ring=True)
    meshes = tps_meshes()
    return {"meshless": run(None), "m2": run(meshes["m2"]),
            "m4": run(meshes["m4"])}


def tps_fused_solo(inputs):
    """Fused vs solo under data 1 x model 2 and data 1 x model 4 (each kv
    head shared by 2 ranks): each job's rows served alone (its adapter
    re-packed as a one-job group) and inside the fused batch, every
    product and every sum over the model axis TPS_ROWS rows (their
    tokens in the prefill) at a time: the logits and ids of each."""
    from repro_torch.core.ssm import SharedSuperModel
    w, toks = inputs["tps:tl"], inputs["tps:toks"]
    cfg, specs = cfg_f32(), tps_specs()
    layout = SharedSuperModel(cfg, specs, block_t=BT).layout
    meshes = tps_meshes()
    out = {}
    for name in ("m2", "m4"):
        fused = tps_greedy(cfg, specs, w["params"], w["adapters"], toks,
                           meshes[name], row_block=TPS_ROWS)
        solo = [tps_greedy(cfg, [sp], w["params"],
                           solo_adapters(w["adapters"], layout, k),
                           toks[k * TPS_ROWS:(k + 1) * TPS_ROWS],
                           meshes[name], row_block=TPS_ROWS)
                for k, sp in enumerate(specs)]
        out[name] = {part: (fused[part], np.concatenate([s[part]
                                                         for s in solo]))
                     for part in ("logits", "ids")}
    return out


def tps_moe(inputs):
    """Reduced f32 qwen3-moe-30b-a3b (E 4: 2 experts a rank) served at
    data 1 x model 2."""
    w, toks = inputs["tps:qr"], inputs["tps:toks"]
    return tps_greedy(moe_cfg("qr"), tps_specs(), w["params"],
                      w["adapters"], toks, tp_pairs())


# ---------------- kv heads shared across model ranks (ROADMAP A4)
# Training at data 1 x model 4 over the world: reduced tinyllama's 2 kv
# heads, each held whole by 2 model ranks (tests/test_torch_kv_replicas
# .py), job sets "rag" (the ragged kernels) and "ab" (the masked ones).
KVR_JOBS = ("rag", "ab")


def kvr_runtime(inputs):
    """``GroupRuntime(tp_mode="auto")`` over data 1 x model 4, 2 steps a
    job set."""
    mesh = world_mesh(model=4)
    return {j: tp_run(inputs, "tl", j, mesh) for j in KVR_JOBS}


def kvr_step(inputs):
    """``make_train_step(mesh=, tp_mode="auto")`` called directly at data
    1 x model 4: step 1's losses and adapters of job set "rag"."""
    from repro_torch.core.ssm import SharedSuperModel
    from repro_torch.data.pipeline import FusedBatcher
    from repro_torch.launch.mesh import model_group
    from repro_torch.models import model as M
    from repro_torch.optim.schedule import constant
    from repro_torch.sharding.rules import shard_params
    mesh = world_mesh(model=4)
    _, m, mi = model_group(mesh)
    cfg, jobs, w = cfg_f32(), specs("rag"), inputs["tl:rag"]
    ssm = SharedSuperModel(cfg, jobs, impl="cuda", block_t=BT)
    fb = FusedBatcher(jobs, cfg.vocab_size, block_t=BT)
    batch = {k: torch.from_numpy(v) for k, v in fb.next_batch().items()}
    step = ssm.make_train_step(lr_fn=constant(LR), remat=False, mesh=mesh,
                               tp_mode="auto")
    params = shard_params(w["params"], M.init_model(cfg, device="meta"), m,
                          mi, cfg=cfg)
    wk = params["segments"][0]["0"]["attn"]["wk"]
    ad, _, met = step(params, w["adapters"],
                      adamw.init(w["adapters"], per_job=len(jobs)), batch)
    return {"per_job": met["per_job_loss"].numpy(), "adapters": flat(ad),
            "wk_shape": tuple(wk.shape), "model_axis": (m, mi)}


def _one_replica_backward(ctx, g):
    """A planted fault for ``layers._KVColumns``: each kv head's
    cotangent taken from its first replica alone (the ranks' blocks
    gathered), instead of the replicas' sum."""
    m = dist.get_world_size(ctx.group)
    blocks = [torch.empty_like(g) for _ in range(m)]
    dist.all_gather(blocks, g.contiguous(), group=ctx.group)
    r = m * (ctx.sl[0].stop - ctx.sl[0].start) // ctx.n
    return torch.cat(blocks[::r], dim=-1), None, None


def kvr_planted(inputs):
    """Job set "rag" at data 1 x model 4 with ``_one_replica_backward``
    in place of the replicas' sum."""
    from repro_torch.models import layers
    real = layers._KVColumns.backward
    layers._KVColumns.backward = staticmethod(_one_replica_backward)
    try:
        return tp_run(inputs, "tl", "rag", world_mesh(model=4))
    finally:
        layers._KVColumns.backward = real


# ------ the other families and the int8 backbone over a model axis
# (ROADMAP A8b, A8c; tests/test_torch_tp_families{,_serve}.py): reduced
# f32 configs through ``GroupRuntime(tp_mode="auto")`` at data 1 x model
# 2 on each pair, and at data 1 x model 4 over the world where the axis
# meets a shared layout (mamba2's B/C groups: 8 a rank at m 2, 2 at m 4;
# recurrentgemma's 2 kv heads, each shared by 2 ranks at m 4).  Job set
# "rag" (mixed ranks: the ragged kernels' plain versions).
TPF_ARCHS = {"ds": "deepseek-v2-lite-16b", "mb": "mamba2-2.7b",
             "rg": "recurrentgemma-9b", "hb": "hubert-xlarge",
             "iv": "internvl2-26b", "q8": "tinyllama-1.1b"}
TPF_M4 = ("mb", "rg")
TPF_DECODERS = ("ds", "mb", "rg", "iv")


def tpf_cfg(key, get=None):
    """The reduced f32 config of a ``TPF_ARCHS`` key (*get*: the
    reference's registry instead); deepseek's MoE takes the ragged
    dispatch (expert parallel over the model axis)."""
    cfg = dataclasses.replace((get or get_config)(TPF_ARCHS[key]).reduced(),
                              dtype="float32")
    if key == "ds":
        cfg = dataclasses.replace(cfg, moe_impl="ragged")
    return cfg


def tpf_run(inputs, key, mesh) -> dict:
    """Job set "rag" on config *key* through ``GroupRuntime(tp_mode=
    "auto")`` on *mesh*, 2 steps; "q8" with ``quantize="int8"``."""
    w = inputs[f"tpf:{key}"]
    rt = GroupRuntime.from_specs(
        tpf_cfg(key), specs("rag"), params=w["params"],
        adapters=w["adapters"], mesh=mesh, tp_mode="auto",
        quantize="int8" if key == "q8" else None,
        **dict(KW, impl="cuda"))
    rt.run(2)
    return dict(summary(rt), model_axis=rt.model_axis,
                shapes={k: tuple(v.shape)
                        for k, v in flat_q(rt.params).items()},
                dtypes={k: str(v.dtype)
                        for k, v in flat_q(rt.params).items()})


def tpf_parity(inputs):
    """Every ``TPF_ARCHS`` config at data 1 x model 2 (each pair), and
    ``TPF_M4`` at data 1 x model 4 (the world)."""
    pairs = tp_pairs()
    out = {"m2": {k: tpf_run(inputs, k, pairs) for k in TPF_ARCHS}}
    world = world_mesh(model=4)
    out["m4"] = {k: tpf_run(inputs, k, world) for k in TPF_M4}
    return out


def tpf_serve(inputs):
    """The decoders served meshless, at data 1 x model 2 (each pair) and,
    for ``TPF_M4``, at data 1 x model 4; fused vs solo under each mesh
    (each job's rows served alone, its adapter re-packed, every product
    and every sum over the model axis TPS_ROWS rows at a time)."""
    from repro_torch.core.ssm import SharedSuperModel
    meshes = {"m2": tp_pairs(), "m4": world_mesh(model=4)}
    sp = tps_specs()
    out = {}
    for key in TPF_DECODERS:
        cfg, w = tpf_cfg(key), inputs[f"tpfs:{key}"]
        layout = SharedSuperModel(cfg, sp, block_t=BT).layout
        toks = inputs["tpfs:toks"]

        def run(mesh, s=sp, ad=w["adapters"], rows=slice(None), rb=None):
            return tps_greedy(cfg, s, w["params"], ad, toks[rows], mesh,
                              row_block=rb)
        res = {"meshless": run(None)}
        for name in ("m2", "m4") if key in TPF_M4 else ("m2",):
            res[name] = run(meshes[name])
            fused = run(meshes[name], rb=TPS_ROWS)
            solo = [run(meshes[name], [s], solo_adapters(w["adapters"],
                                                         layout, k),
                        slice(k * TPS_ROWS, (k + 1) * TPS_ROWS), TPS_ROWS)
                    for k, s in enumerate(sp)]
            res[f"{name}_fused_solo"] = {
                part: (fused[part], np.concatenate([x[part] for x in solo]))
                for part in ("logits", "ids")}
        out[key] = res
    return out


# ------------- mixers a model axis would split run whole (ROADMAP A4)
# (tests/test_torch_whole_mixers.py): reduced f32 configs whose mixer
# the axis of 2 would cut through a head, through ``GroupRuntime(
# tp_mode="auto")``, job set "rag": attention of 3 query heads over 1 kv
# head ("wl", data 1 and data 2), MLA of 3 heads ("wm", its MoE expert
# parallel beside it), RG-LRU over 255 channels ("wr", local attention
# split beside it).  The rest of each layer is cut as the rules say.
WM_ARCHS = {"wl": "tinyllama-1.1b", "wm": "deepseek-v2-lite-16b",
            "wr": "recurrentgemma-9b"}
WM_D2 = ("wl",)


def wm_cfg(key, get=None):
    """The reduced f32 config of a ``WM_ARCHS`` key (*get*: the
    reference's registry instead), replaced so that a model axis of 2
    splits its mixer's heads or channels."""
    cfg = dataclasses.replace((get or get_config)(WM_ARCHS[key]).reduced(),
                              dtype="float32")
    if key == "wl":
        return dataclasses.replace(cfg, num_heads=3, num_kv_heads=1)
    if key == "wm":
        return dataclasses.replace(cfg, num_heads=3, num_kv_heads=3,
                                   moe_impl="ragged")
    return dataclasses.replace(cfg, lru_width=255)


def wm_run(inputs, key, mesh) -> dict:
    """Job set "rag" on config *key* through ``GroupRuntime(tp_mode=
    "auto")`` on *mesh*, 2 steps: the summary and the rank's leaves'
    shapes."""
    w = inputs[f"wm:{key}"]
    rt = GroupRuntime.from_specs(
        wm_cfg(key), specs("rag"), params=w["params"],
        adapters=w["adapters"], mesh=mesh, tp_mode="auto",
        **dict(KW, impl="cuda"))
    rt.run(2)
    return dict(summary(rt), model_axis=rt.model_axis, shards=rt.data_shards,
                shapes={k: tuple(v.shape) for k, v in flat_t(rt.params)
                        .items()})


def wm_serve(key, w, mesh) -> dict:
    """Job set "rag"'s prefill of 8 prompts of 16 tokens (an audio
    config: frames) and, for a decoder, 2 decode steps, meshless and on
    *mesh* (this rank's slices, its whole mixers whole): the last
    column's logits of each step and the rank's cache shapes."""
    from repro_torch.configs.base import InputShape
    from repro_torch.core.ssm import SharedSuperModel
    from repro_torch.launch.mesh import model_group
    from repro_torch.models import model as M
    from repro_torch.sharding.rules import shard_params
    cfg = wm_cfg(key) if key in WM_ARCHS else dataclasses.replace(
        get_config("hubert-xlarge").reduced(), dtype="float32")
    sp = specs("rag")
    shape = InputShape("p", 32, 8, "decode")
    g = torch.Generator().manual_seed(5)
    if cfg.family == "audio":
        batch = {"frames": torch.randn((8, 16, cfg.frontend_dim),
                                       generator=g) * 0.02}
    else:
        batch = {"tokens": torch.randint(1, cfg.vocab_size, (8, 18),
                                         generator=g, dtype=torch.int32)}
    batch["adapter_ids"] = torch.arange(2, dtype=torch.int32) \
        .repeat_interleave(4)
    out = {}
    for name, msh in (("meshless", None), ("mesh", mesh)):
        ssm = SharedSuperModel(cfg, sp, impl="cuda", block_t=BT)
        params = w["params"]
        if msh is not None:
            _, m, mi = model_group(msh)
            params = shard_params(params, M.init_model(cfg, device="meta"),
                                  m, mi, cfg=cfg)
        first = {k: (v[:, :16] if k == "tokens" else v)
                 for k, v in batch.items()}
        lg, caches = ssm.make_prefill_step(shape, mesh=msh)(
            params, w["adapters"], first)
        logits = [lg[:, 0]]
        if cfg.causal:
            step = ssm.make_serve_step(mesh=msh)
            for i in range(2):
                lg, caches = step(params, w["adapters"], caches,
                                  {"tokens": batch["tokens"][:, 16 + i:
                                                             17 + i],
                                   "adapter_ids": batch["adapter_ids"]},
                                  16 + i)
                logits.append(lg[:, 0])
        out[name] = {"logits": torch.stack(logits).numpy(),
                     "caches": {k: tuple(v.shape)
                                for k, v in flat_t(caches).items()}}
    return out


def wm_parity(inputs):
    """Every ``WM_ARCHS`` config at data 1 x model 2 (each pair), the
    ``WM_D2`` ones also at data 2 x model 2 (the world); the serve steps
    of "wl" and of reduced hubert-xlarge (its cached prefill, A9) at
    data 1 x model 2 beside the meshless ones."""
    pairs = tp_pairs()
    out = {"d1": {k: wm_run(inputs, k, pairs) for k in WM_ARCHS}}
    world = tp_world()
    out["d2"] = {k: wm_run(inputs, k, world) for k in WM_D2}
    out["serve"] = {k: wm_serve(k, inputs[f"wm:{k}"], pairs)
                    for k in ("wl", "hb")}
    return out


# -------------- a pipeline mesh with a model axis (ROADMAP A8d)
# ``make_local_mesh(model=2, stages=2)`` over the world: (stage 2, data
# 1, model 2), each model index a replica of the (stage, data) pipeline.
def ppm_parity(inputs, out_dir):
    """Job set "pl" (N = 2 "rank_desc") on the (2, 1, 2) mesh, beside the
    model-1 pipeline (P = 2 x D = 1) on each 2-rank slice; the mesh's
    layout and each rank's writer flag; its checkpoints written to
    *out_dir*."""
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(model=2, stages=2)
    kw = PIPE_RUNS["g2_rank_desc"]
    rt = runtime(inputs, "pl", mesh, impl="cuda", **dict(PIPE, **kw))
    rt.run(2)
    m = rt.report.last_metrics
    got = dict(summary(rt), useful=np.asarray(m["pipe_useful_slots"]),
               slots=np.asarray(m["pipe_slots"]), stage=rt._stage_idx,
               shards=rt.data_shards, model_axis=rt.model_axis,
               writer=rt._writer(), shape=dict(mesh.shape),
               grid=mesh.mesh.tolist(), replica=[list(r) for r in
                                                 mesh.ranks],
               resident=sum(t.numel() * t.element_size()
                            for t in flat_q(rt.params).values()))
    rt.save_checkpoints(str(out_dir))
    got["model1"] = pipe_run(inputs, "pl", pipe_pairs(), **kw)
    return got


TP_FAMILIES = ["tpf_parity"]
WHOLE_MIXERS = ["wm_parity", "ppm_parity"]
TP_FAMILIES_SERVE = ["tpf_serve"]
KV_REPLICAS = ["kvr_runtime", "kvr_step", "kvr_planted"]
TP_SERVE = ["tps_meshes_run", "tps_ring", "tps_fused_solo", "tps_moe"]
MOE_MESH = ["moe_dp", "moe_pipeline"]
TENSOR_PARALLEL = ["tp_parity", "tp_step_and_engine", "tp_controller"]
PIPELINE = ["pipe_parity", "pipe_uniform", "pipe_unscanned_tail",
            "pipe_residency", "pipe_legality", "pipe_migration",
            "pipe_engine", "pipe_controller"]
CONTROLLER = ["ctl_concurrent_parity", "ctl_repartition_migration",
              "ctl_overlapped_migration", "ctl_fixed_mesh",
              "ctl_execution_backend", "ctl_trace"]
FAULTS = ["ft_worker_death", "ft_submesh_loss"]
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
            if len(inspect.signature(fn).parameters) == 2:
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
