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
