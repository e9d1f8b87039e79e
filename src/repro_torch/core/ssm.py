"""Shared Super-Model (SSM) — the paper's core abstraction (§3.2), port
of the single-device part of ``repro.core.ssm``.

``SharedSuperModel`` consolidates K LoRA jobs sharing one frozen backbone
into a single executable model:

  * backbone operators run once over the *union* of all jobs' batches
    (job-major concatenation, tile-aligned — data/pipeline.FusedBatcher);
  * adapters stay job-private branches, packed ragged ``(L, d, R)`` /
    ``(L, R, d)`` with per-adapter padded rank segments
    (core/lora.RankLayout), run by the rank-bucketed ragged kernels;
  * per-job loss normalization keeps forward, backward and optimizer
    semantics identical to isolated training (the lossless claim), also
    under nano-batch grad accumulation (the batch split contiguously into
    N slices, per-job denominators taken over the full batch);
  * the serve steps (``make_prefill_step``, ``make_serve_step``) run the
    same fused batch through prefill and decode over full KV caches, ring
    caches (local attention, the sliding-window variant), MLA latent
    caches (full or ring) and recurrent state; an encoder (non-causal)
    prefills its caches and has no decode step.

``make_train_step(mesh=...)`` is the data-parallel sharded step
(``tp_mode="dp"``): every mesh axis folds into row sharding over a
``torch.distributed`` group, each rank runs the step on its shard's rows
(the shard-major layout of ``data/pipeline.shard_permutation``) and
holds the adapters and Adam state replicated.  With
``tp_mode="pipeline"`` it is the stage-partitioned step
(``_make_pipeline_step``): the group's slice is a (stage, data) mesh,
each stage holds its run of the scanned layer stack, and the jobs'
job-wise nano slices are the micro-batches of one GPipe schedule.
``pipeline_legal_stages``, ``scanned_segment_index`` and
``stage_slices`` say which depths a config allows and which leaves a
stage holds.  With ``tp_mode="auto"`` it is the reference's tensor
parallel step: rows over the mesh's "data" axis only, and over its
"model" axis Megatron 1-D tensor parallelism of the backbone (each rank
holds the slices ``sharding/rules.shard_params`` gives it: column
parallel q/k/v/gate/up, row parallel o/down, vocab-split embedding and
head, E/m experts a rank, MLA, SSD and RG-LRU by heads or channels, the
front ends' d_model columns, an int8 backbone's codes and scales cut as
the dense leaves; a mixer the axis would split through a head whole,
``models/model.whole_mixers``), the adapters and their Adam state whole on
every rank.  A MoE model runs through every mode: per shard (or micro)
under "dp" and "pipeline", expert parallel under "auto".
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.jobs import LoRAJobSpec, tile_rows
from repro_torch.core.lora import MultiLoRA, RankLayout
from repro_torch.models import model as M
from repro_torch.optim import adamw

TP_MODES = ("dp", "auto", "pipeline")


def check_tp_mode(tp_mode: str) -> None:
    """Refuse a tp_mode the reference does not have."""
    if tp_mode not in TP_MODES:
        raise ValueError(f"unknown tp_mode {tp_mode!r}")


@dataclass
class SharedSuperModel:
    """One fused group: frozen backbone + K packed adapters."""
    cfg: ModelConfig
    jobs: List[LoRAJobSpec]
    impl: str = "cuda"           # fused-LoRA impl (cuda|torch|ref|loop)
    block_t: int = 128           # token tile of the LoRA kernels
    data_shards: int = 1         # data-parallel degree: row counts pad so
    #                              every job splits evenly over the shards
    #                              with per-shard tile alignment

    ranks: np.ndarray = field(init=False)
    scalings: np.ndarray = field(init=False)
    layout: RankLayout = field(init=False)
    # (ranks, scalings, packed column -> job) per device, copied once: a
    # host-to-device copy per step would synchronize every dispatch
    _consts: Dict[torch.device, Tuple[torch.Tensor, ...]] = field(
        init=False, default_factory=dict, repr=False, compare=False)

    def __post_init__(self):
        assert self.jobs, "SSM needs at least one job"
        self.ranks = np.array([j.rank for j in self.jobs], np.int32)
        self.scalings = np.array([j.scaling for j in self.jobs], np.float32)
        # each job pads its OWN rank to a small multiple (the bf16 MMA
        # k-step caps it at 16), never to the group max: the packed
        # layout gives every adapter its own segment
        self.layout = RankLayout(tuple(int(r) for r in self.ranks),
                                 multiple=min(self.block_t, 16))

    @property
    def num_jobs(self) -> int:
        return len(self.jobs)

    def init(self, *, seed: int = 0, device="cuda") -> Tuple[dict, dict]:
        """(frozen backbone params, trainable packed adapter tree), drawn
        from seeded generators on *device*."""
        params = M.init_model(self.cfg, seed=seed, device=device)
        adapters = M.init_adapters(self.cfg, self.ranks.tolist(),
                                   seed=seed + 1, layout=self.layout,
                                   device=device)
        return params, adapters

    def rows_per_job(self) -> List[int]:
        """Tile/shard-aligned row count per job (mirrors FusedBatcher)."""
        return [tile_rows(j.batch_size, j.seq_len, self.block_t,
                          shards=self.data_shards) for j in self.jobs]

    def device_consts(self, device) -> Tuple[torch.Tensor, ...]:
        """(ranks, scalings, packed column -> job) on *device*, copied on
        first use."""
        dev = torch.device(device)
        if dev not in self._consts:
            self._consts[dev] = (
                torch.as_tensor(self.ranks, device=dev),
                torch.as_tensor(self.scalings, device=dev),
                torch.as_tensor(self.layout.col_jobs, dtype=torch.long,
                                device=dev))
        return self._consts[dev]

    def warm(self, device) -> None:
        """Everything a step reads from the host once, ahead of the first
        step on *device*: the device constants and, for the "cuda" impl on
        a CUDA device, the kernel libraries (built if missing) and the
        ragged kernels' tile tables of the full fused batch (with shards,
        of the local batch as well)."""
        dev = torch.device(device)
        self.device_consts(dev)
        if self.impl != "cuda" or dev.type != "cuda":
            return
        from repro_torch.kernels import build
        from repro_torch.kernels import ragged as rg
        from repro_torch.kernels.ops import _tile_jobs_static
        for name in build.SOURCES:
            build.load(name)
        rows = self.rows_per_job()
        for rs in {tuple(rows), tuple(r // self.data_shards for r in rows)}:
            tiles = _tile_jobs_static(rs, self.jobs[0].seq_len, self.block_t)
            if tiles is not None and not self.layout.is_uniform:
                meta = rg.RaggedMeta.build(tiles, self.layout)
                rg._device_table(meta, dev)
                rg._device_wgrad_tables(meta, dev)

    def lora_ctx(self, adapter_ids: torch.Tensor, *, group=None,
                 row_solo_pos: Optional[torch.Tensor] = None,
                 grad_sync: str = "gather",
                 nano_order: Optional[Tuple[int, ...]] = None,
                 rows: Optional[Sequence[int]] = None) -> MultiLoRA:
        """Apply context of one fused batch.  With a *group* the context
        is shard-local: *adapter_ids* covers one shard's rows, segment
        geometry is the per-shard layout (global rows / data_shards), and
        the exact wgrads reassemble solo order via *row_solo_pos* (the
        solo position of every shard's rows, shard-major).  ``nano_order``
        is the static job order of the segments inside a job-wise nano
        slice.  ``rows``: the per-job rows of the batch, where they are
        not ``rows_per_job`` (a data rank's share of a serve batch)."""
        if rows is None:
            rows = self.rows_per_job()
            if group is not None:
                rows = [r // self.data_shards for r in rows]
        ranks, scalings, _ = self.device_consts(adapter_ids.device)
        return MultiLoRA(adapter_ids=adapter_ids, ranks=ranks,
                         scalings=scalings, impl=self.impl,
                         block_t=self.block_t, seg_rows=max(rows),
                         equal_segments=len(set(rows)) == 1,
                         layout=self.layout, rows_all=tuple(rows),
                         nano_order=nano_order, group=group,
                         row_solo_pos=row_solo_pos,
                         shards=self.data_shards, grad_sync=grad_sync)

    # --------------------------------------------------------- train step
    def make_train_step(self, *, lr_fn: Callable, nano_batches: int = 1,
                        remat: bool = True, weight_decay: float = 0.0,
                        steps: Optional[int] = None, mesh=None,
                        grad_sync: str = "gather", tp_mode: str = "dp",
                        pipeline_stages: int = 1,
                        nano_order: str = "job",
                        data_axis: str = "data") -> Callable:
        """Build the fused train step: per-job-normalized loss, adapter
        grads by autograd through the kernels' Functions, one AdamW
        update with per-job step vectors over packed columns.

        ``nano_batches`` = N > 1 splits the batch contiguously into N
        slices (``_reshape_nano``) and accumulates their gradients in
        f32 before the one update; the per-job loss denominators are
        taken over the full batch first, so the step is the N = 1 step
        re-granulated.  A slice has no static tile map, so the "cuda"
        impl takes the masked family for it.

        ``steps`` != None returns the chunked variant: a loop over a
        (steps, ...) stack of staged batches carrying (adapters,
        opt_state), with metrics stacked per step (the reference's
        ``lax.scan`` over the chunk).

        ``mesh`` != None returns the SHARDED variant
        (``_make_sharded_step``): the returned function takes THIS
        rank's rows of the batch, in the shard-major layout.
        ``grad_sync`` picks the cross-shard gradient strategy: "gather"
        (exact: the kernels' shard-local backwards) or "psum" (one
        all-reduce of the partial gradients; the only mode "ref" and
        "loop" take).  ``nano_order`` ("job" or "rank_desc") orders the
        job segments inside each sharded nano slice.
        ``tp_mode="pipeline"`` with ``pipeline_stages`` P returns the
        stage-partitioned step (``_make_pipeline_step``); it takes this
        rank's data shard's rows and this stage's slice of the trees
        (``stage_slices``).  ``tp_mode="auto"`` returns the tensor
        parallel step: rows over *data_axis* only, and the backbone over
        the mesh's "model" axis (``_make_sharded_step``); it takes this
        rank's data shard's rows and its model slices of the backbone
        (``sharding/rules.shard_params``).  Without a mesh ``tp_mode``
        and ``pipeline_stages`` are ignored, as in the reference."""
        assert nano_order in ("job", "rank_desc"), nano_order
        if mesh is not None:
            check_tp_mode(tp_mode)
            if tp_mode == "pipeline":
                return self._make_pipeline_step(
                    lr_fn=lr_fn, nano_batches=nano_batches, remat=remat,
                    weight_decay=weight_decay, steps=steps, mesh=mesh,
                    grad_sync=grad_sync, stages=pipeline_stages,
                    nano_order=nano_order)
            return self._make_sharded_step(
                lr_fn=lr_fn, nano_batches=nano_batches, remat=remat,
                weight_decay=weight_decay, steps=steps, mesh=mesh,
                grad_sync=grad_sync, nano_order=nano_order,
                tp_mode=tp_mode, data_axis=data_axis)
        cfg, K = self.cfg, self.num_jobs

        def train_step(params, adapters, opt_state, batch):
            denom = _per_job_token_counts(batch, K, causal=cfg.causal)
            slices = [(nb, self.lora_ctx(nb["adapter_ids"]))
                      for nb in _reshape_nano(batch, nano_batches)]
            return self._update(params, adapters, opt_state, denom, slices,
                                lr_fn, remat, weight_decay)

        return train_step if steps is None else _chunked(train_step)

    def _update(self, params, adapters, opt_state, denom, slices, lr_fn,
                remat, weight_decay, reduce=None, tp=None):
        """The step's body over nano *slices*, (batch, LoRA context)
        pairs: gradients through ``loss_fn``, accumulated in f32 over
        more than one slice, optionally reduced (``reduce(grads,
        per_job, aux)``, the psum mode), then one AdamW update.  Returns
        (adapters, opt_state, metrics)."""
        cfg, K = self.cfg, self.num_jobs
        ad = adamw.tree_map(
            lambda _, t: t.detach().requires_grad_(True), adapters)
        leaves = list(adamw.tree_leaves(ad))

        def grad_fn(nb, lora):
            with torch.enable_grad():
                total, aux = M.loss_fn(cfg, params, ad, lora, nb,
                                       remat=remat, per_job_denom=denom,
                                       tp=tp)
                g = torch.autograd.grad(total, leaves)
            return g, aux["per_job"].detach(), aux["aux"].detach()

        if len(slices) == 1:
            g_leaves, per_job, moe_aux = grad_fn(*slices[0])
        else:
            g_leaves = [torch.zeros(t.shape, dtype=torch.float32,
                                    device=t.device) for t in leaves]
            per_job = torch.zeros((K,), dtype=torch.float32,
                                  device=denom.device)
            moe_aux = torch.zeros((), device=denom.device)
            for nb, lora in slices:
                g, pj, a = grad_fn(nb, lora)
                g_leaves = [a_ + b.float() for a_, b in zip(g_leaves, g)]
                per_job = per_job + pj
                moe_aux = moe_aux + a
        if reduce is not None:
            g_leaves, per_job, moe_aux = reduce(g_leaves, per_job, moe_aux)
        it = iter(g_leaves)
        grads = adamw.tree_map(lambda _, t: next(it), ad)
        lr = lr_fn(opt_state.step)
        new_adapters, new_opt = adamw.update(
            grads, opt_state, adapters, lr=lr, weight_decay=weight_decay,
            col_jobs=self.device_consts(denom.device)[2])
        # "aux": the MoE load-balance loss the step's total carried beside
        # the per-job losses (summed over nano slices; 0 without MoE)
        metrics = {"loss": per_job.sum(), "per_job_loss": per_job,
                   "lr": torch.as_tensor(lr), "aux": moe_aux}
        return new_adapters, new_opt, metrics

    def _make_sharded_step(self, *, lr_fn, nano_batches, remat,
                           weight_decay, steps, mesh, grad_sync,
                           nano_order, tp_mode="dp",
                           data_axis="data") -> Callable:
        """The data-parallel step over *mesh* (the reference's
        ``shard_map`` step, ``ssm.py:263``): the single-device body on
        this rank's rows.  ``tp_mode="dp"`` folds every mesh axis into
        rows; ``"auto"`` takes rows over *data_axis* only, and the mesh's
        "model" axis, when it has one of more than one rank, runs the
        backbone tensor parallel (``models/layers.ModelAxis``): every rank
        of the axis computes the same loss and the same adapter
        gradients, so the data axis's reduction below is the one there
        is.  A MoE model's router, dispatch and aux run on the shard's
        tokens, as the reference's shard_map runs them.  The per-job token
        denominators are all-reduced (integer-valued f32 sums, exact in
        any order) and clipped after the sum (a per-shard clip would
        inflate a job whose shard holds only padding); the loss the
        gradient flows through is the shard's partial; the adapter
        wgrads are either gathered-exact (the kernels' shard-local
        backwards, ``grad_sync="gather"``) or all-reduced with the
        metrics (``"psum"``).  The update then runs on the replicated
        state identically on every rank."""
        from repro_torch.data.pipeline import shard_permutation
        from repro_torch.launch.mesh import data_group, model_group
        from repro_torch.models.layers import ModelAxis
        cfg, K = self.cfg, self.num_jobs
        auto = tp_mode == "auto"
        mgroup, m, midx = model_group(mesh) if auto else (None, 1, 0)
        tp = ModelAxis(mgroup, m, midx) if m > 1 else None
        exact = grad_sync == "gather"
        assert grad_sync in ("gather", "psum"), grad_sync
        if exact and self.impl in ("ref", "loop"):
            raise ValueError(
                f"impl={self.impl!r} has no shard-local VJP for exact "
                "gathered wgrads; use impl='torch'/'cuda' or "
                "grad_sync='psum'")
        group, D, _ = data_group(mesh, data_axis if auto else None)
        assert self.data_shards == D, \
            (f"SSM built for data_shards={self.data_shards}, the mesh "
             f"runs {D}-way: construct SharedSuperModel(data_shards={D})")
        rows = self.rows_per_job()
        rows_loc = [r // D for r in rows]
        # the solo position of every shard's rows, (D, local rows): the
        # exact wgrads and the reported losses reassemble by it
        solo = torch.as_tensor(
            shard_permutation(rows, D).reshape(D, -1))
        seg_order = None
        if nano_batches > 1:
            g = math.gcd(*rows_loc)
            assert g % nano_batches == 0, \
                (f"nano_batches={nano_batches} must divide every job's "
                 f"per-shard rows {rows_loc}")
            if self.impl == "cuda":
                # the ragged kernels' static tile map: every job's slice
                # must stay whole token tiles
                S = self.jobs[0].seq_len
                assert all((r * S) % (nano_batches * self.block_t) == 0
                           for r in rows_loc), \
                    (f"nano_batches={nano_batches} breaks the token-tile "
                     f"alignment of per-shard rows {rows_loc} (seq_len="
                     f"{S}, block_t={self.block_t})")
            seg_order = tuple(
                sorted(range(K), key=lambda k: (-int(self.ranks[k]), k))
                if nano_order == "rank_desc" else range(K))
        nano_idx = torch.as_tensor(_nano_index(rows_loc, nano_batches,
                                               order=seg_order))
        on_device: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}

        def reduce(g_leaves, per_job, moe_aux):
            # classic DP: one all-reduce of every partial gradient (one
            # flat buffer) and of the metrics
            flat = torch.cat([t.reshape(-1) for t in g_leaves]
                             + [per_job, moe_aux.reshape(1)])
            dist.all_reduce(flat, group=group)
            out, at = [], 0
            for t in g_leaves:
                out.append(flat[at:at + t.numel()].view_as(t))
                at += t.numel()
            return out, flat[at:at + K], flat[at + K]

        def train_step(params, adapters, opt_state, batch):
            # batch: THIS shard's rows, shard-major layout
            dev = batch["adapter_ids"].device
            denom = _per_job_token_counts(batch, K, causal=cfg.causal,
                                          clip=False)
            dist.all_reduce(denom, group=group)
            denom = denom.clamp_min(1)
            if dev not in on_device:      # copied once, not every step
                on_device[dev] = (solo.to(dev), nano_idx.to(dev))
            row_solo, idx = on_device[dev]
            # the solo positions ride the batch through the nano split
            # (row i of the shard: every shard's row i), as in the
            # reference
            batch = dict(batch, _row_solo=row_solo.T)
            slices = []
            for nb in _reshape_nano_jobwise(batch, nano_batches, idx):
                rs = nb.pop("_row_solo").T.reshape(-1)
                slices.append((nb, self.lora_ctx(
                    nb["adapter_ids"], group=group, row_solo_pos=rs,
                    grad_sync=grad_sync, nano_order=seg_order)))
            return self._update(params, adapters, opt_state, denom, slices,
                                lr_fn, remat, weight_decay,
                                reduce=None if exact else reduce, tp=tp)

        return train_step if steps is None else _chunked(train_step)

    def _make_pipeline_step(self, *, lr_fn, nano_batches, remat,
                            weight_decay, steps, mesh, grad_sync, stages,
                            nano_order) -> Callable:
        """The stage-partitioned pipeline step (the reference's
        ``_make_pipeline_step``, ``ssm.py:426``).

        Layout.  The group's slice of P·D ranks is a (stage, data) mesh
        (``launch/mesh.stage_mesh``): stage s is the run of D ranks
        ``[s·D, (s+1)·D)``.  The one scanned segment's leaves (backbone,
        adapters, both Adam moments) are cut along their cycle axis, each
        stage holding its ``repeats / P`` contiguous cycles
        (``stage_slices``); the unscanned leaves are whole everywhere.
        Rows shard over the data axis only: every stage sees the same
        local rows, in ``shard_permutation`` order.  The N micro-batches
        are the job-wise nano slices of ``_nano_index`` ("rank_desc" puts
        the large-rank segments first), each a job-major mini fused batch
        with a static tile map, so the "cuda" impl keeps the ragged
        kernels on mixed ranks and the masked ones on uniform ranks.

        Schedule.  ``torch.distributed`` send and recv are not
        differentiable, so the schedule is explicit GPipe on every rank,
        which is the reference's: ``jax.grad`` of its tick loop runs every
        forward tick, then every backward tick in reverse.  Forward: for
        each micro in order, stage 0 embeds it and runs the pre-segments,
        a later stage receives it from the previous one as a detached
        leaf that requires grad; the stage runs its cycles and hands the
        output on (the last stage instead runs the tail segments, ``ln_f``,
        the head and the per-job loss of the micro, ``models/model
        .job_losses``, with the data group's denominators).  Backward, in
        reverse micro order: the last stage differentiates the micro's
        loss, a stage before it its output against the cotangent received
        from the next; each hands its input's gradient back.  A stage's
        adapter gradients of each micro are kept apart and summed in
        micro order in f32, as ``_update`` sums nano slices.  The
        reference's warm-up and cool-down ticks compute clipped repeats
        that get zero cotangent: they are not computed here, and
        ``pipe_slots`` still counts the (N + P - 1)·P slots of the
        schedule, ``pipe_useful_slots`` the N·P that carried a micro.

        Handoff.  Each hop is a broadcast on the two-rank group of the
        neighbouring stages at one data index (``launch/mesh.handoff``):
        gloo's point-to-point calls take host tensors only, so on a gloo
        group a CUDA activation goes through host memory.  Every rank of
        a stage issues its data group's gathers (the shard-local kernels,
        the reported losses) in the same order, and both ranks of a pair
        issue its handoffs in the same order (the N activations, then the
        N cotangents in reverse), so no wait closes a cycle.

        Model axis.  On the (stage, data, model) mesh of
        ``make_local_mesh(model=, stages=)`` the ``StageMesh`` is this
        rank's model index's (stage, data) grid: every model rank runs its
        (stage, data) rank's program on the same rows and whole stage
        weights, its handoffs and data groups within its model index, as
        the reference's ``shard_map`` (which names only "stage" and the
        data axis) runs it.

        Reduction.  With ``grad_sync="psum"`` the stage's gradients are
        all-reduced over its data group; "gather" needs nothing (the
        kernels' shard-local backwards make them exact).  Then one sum
        over the stage column: the unscanned segments' gradients (the
        pre-segments' live on stage 0, the tail's on the last stage,
        zeros elsewhere), the per-job losses and the occupancy count, so
        every stage updates the replicated leaves identically and
        reports the same metrics.  A MoE layer routes, dispatches and
        computes its aux on the micro's tokens on the stage that holds
        it (``ssm.py:452-456``), and the aux enters the micro's loss."""
        from repro_torch.data.pipeline import shard_permutation
        from repro_torch.launch.mesh import StageMesh, handoff, stage_mesh
        from repro_torch.models.layers import dtype_of, rms_norm
        cfg, K = self.cfg, self.num_jobs
        P = int(stages)
        if P < 2:
            raise ValueError(f"tp_mode='pipeline' needs pipeline_stages >= "
                             f"2 (got {P}); use tp_mode='dp'")
        exact = grad_sync == "gather"
        assert grad_sync in ("gather", "psum"), grad_sync
        if exact and self.impl in ("ref", "loop"):
            raise ValueError(
                f"impl={self.impl!r} has no shard-local VJP for exact "
                "gathered wgrads; use impl='torch'/'cuda' or "
                "grad_sync='psum'")
        plan = M.segment_plan(cfg)
        si = scanned_segment_index(cfg)
        check_stack_stages(cfg, P)
        seg_local = replace(plan[si], repeats=plan[si].repeats // P)
        sm = (mesh if isinstance(mesh, StageMesh) and mesh.stages == P
              else stage_mesh(mesh, P))
        D, s_me = sm.data, sm.stage
        first, last = s_me == 0, s_me == P - 1
        assert self.data_shards == D, \
            (f"SSM built for data_shards={self.data_shards}, the pipeline "
             f"mesh runs {D}-way data parallel: construct "
             f"SharedSuperModel(data_shards={D})")
        rows = self.rows_per_job()
        rows_loc = [r // D for r in rows]
        N = int(nano_batches)
        assert math.gcd(*rows_loc) % N == 0, \
            (f"nano_batches={N} must divide every job's per-shard rows "
             f"{rows_loc}")
        if self.impl == "cuda":
            S = self.jobs[0].seq_len
            assert all((r * S) % (N * self.block_t) == 0 for r in rows_loc), \
                (f"nano_batches={N} breaks the token-tile alignment of "
                 f"per-shard rows {rows_loc} (seq_len={S}, block_t="
                 f"{self.block_t})")
        seg_order = None
        if N > 1:
            seg_order = tuple(
                sorted(range(K), key=lambda k: (-int(self.ranks[k]), k))
                if nano_order == "rank_desc" else range(K))
        solo = torch.as_tensor(shard_permutation(rows, D).reshape(D, -1))
        nano_idx = torch.as_tensor(_nano_index(rows_loc, N, order=seg_order))
        on_device: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}
        act_dtype = dtype_of(cfg)
        prev_rank = sm.rank_of(s_me - 1) if not first else None
        next_rank = sm.rank_of(s_me + 1) if not last else None

        def micro_forward(params, ad_segs, nb, lora, denom):
            """One micro through this stage: (its input leaf or None, its
            output or, on the last stage, its loss, per-job losses or
            None, the aux of its MoE layers: on a stage before the last
            still differentiable, the part of the loss it owns)."""
            dev = nb["adapter_ids"].device
            if first:
                x, _ = M.embed_inputs(cfg, params, nb)
                x_in = None
            else:
                buf = torch.empty(_act_shape(cfg, nb), dtype=act_dtype,
                                  device=dev)
                x_in = handoff(buf, sm.prev_group,
                               prev_rank).requires_grad_(True)
                x = x_in
            B, S, _ = x.shape
            positions = torch.arange(S, device=dev)[None, :].expand(B, S)
            aux = torch.zeros((), device=dev)
            own = range(si + 1) if first else (
                range(si, len(plan)) if last else range(si, si + 1))
            for i in own:
                x, a = M._apply_segment(
                    cfg, seg_local if i == si else plan[i],
                    params["segments"][i], ad_segs[i], lora, x, positions,
                    None, None, remat=remat)
                aux = aux + a
            if not last:
                handoff(x.detach(), sm.next_group, sm.rank_of(s_me))
                return x_in, x, None, aux
            x = rms_norm(x, params["ln_f"], cfg.norm_eps)
            logits = M._logits(cfg, params, x)
            total, out = M.job_losses(cfg, logits, _text_off(cfg, nb), aux,
                                      lora, nb, per_job_denom=denom)
            return x_in, total, out["per_job"].detach(), aux.detach()

        def train_step(params, adapters, opt_state, batch):
            # batch: THIS data shard's rows (the same on every stage)
            dev = batch["adapter_ids"].device
            if dev not in on_device:      # copied once, not every step
                on_device[dev] = (solo.to(dev), nano_idx.to(dev))
            row_solo, idx = on_device[dev]
            denom = None
            if last:
                denom = _per_job_token_counts(batch, K, causal=cfg.causal,
                                              clip=False)
                dist.all_reduce(denom, group=sm.data_group)
                denom = denom.clamp_min(1)
            batch = dict(batch, _row_solo=row_solo.T)
            micros = []
            for nb in _reshape_nano_jobwise(batch, N, idx):
                rs = nb.pop("_row_solo").T.reshape(-1)
                micros.append((nb, self.lora_ctx(
                    nb["adapter_ids"], group=sm.data_group,
                    row_solo_pos=rs, grad_sync=grad_sync,
                    nano_order=seg_order)))
            ad = adamw.tree_map(
                lambda _, t: t.detach().requires_grad_(True), adapters)
            leaves = list(adamw.tree_leaves(ad))
            per_job = torch.zeros((K,), dtype=torch.float32, device=dev)
            aux = torch.zeros((), device=dev)
            kept = []
            with torch.enable_grad():
                for nb, lora in micros:           # forward, micro order
                    x_in, out, pj, a = micro_forward(
                        params, ad["segments"], nb, lora, denom)
                    kept.append((x_in, out, a))
                    aux = aux + a.detach()
                    if pj is not None:
                        per_job = per_job + pj
                per_micro = [None] * N
                for m in reversed(range(N)):      # backward, reverse order
                    x_in, out, a = kept[m]
                    kept[m] = None
                    inputs = leaves + ([x_in] if x_in is not None else [])
                    outs, g_outs = [out], None
                    if not last:
                        # the stage's differentiated loss: its MoE aux
                        # plus the output against the next stage's
                        # cotangent (the reference's where-masked total)
                        g_outs = [handoff(
                            torch.empty(out.shape, dtype=out.dtype,
                                        device=dev),
                            sm.next_group, next_rank)]
                        if a.requires_grad:
                            outs.append(a)
                            g_outs.append(torch.ones_like(a))
                    g = torch.autograd.grad(outs, inputs, grad_outputs=g_outs,
                                            allow_unused=True)
                    if x_in is not None:
                        handoff(g[-1], sm.prev_group, sm.rank_of(s_me))
                    per_micro[m] = [torch.zeros_like(t) if gm is None else gm
                                    for gm, t in zip(g, leaves)]
            if N == 1:
                g_leaves = per_micro[0]
            else:
                g_leaves = [torch.zeros(t.shape, dtype=torch.float32,
                                        device=t.device) for t in leaves]
                for gm in per_micro:
                    g_leaves = [a_ + b.float() for a_, b in zip(g_leaves, gm)]
            if not exact:
                g_leaves, per_job, aux = _all_reduce_flat(
                    g_leaves, per_job, aux, sm.data_group)
            # one sum over the stage column: the unscanned segments'
            # gradients (zeros off their owning stage), the per-job
            # losses (zeros off the last stage), the aux and the micros
            # each stage ran
            scanned = [p[1] == str(si) for p, _ in _leaf_paths(ad)]
            rest = [i for i, sc in enumerate(scanned) if not sc]
            useful = torch.full((1,), float(N), device=dev)
            red, per_job, aux, useful = _all_reduce_flat(
                [g_leaves[i] for i in rest], per_job, aux, sm.column_group,
                extra=useful)
            for i, t in zip(rest, red):
                g_leaves[i] = t
            it = iter(g_leaves)
            grads = adamw.tree_map(lambda _, t: next(it), ad)
            lr = lr_fn(opt_state.step)
            new_adapters, new_opt = adamw.update(
                grads, opt_state, adapters, lr=lr,
                weight_decay=weight_decay,
                col_jobs=self.device_consts(dev)[2])
            metrics = {"loss": per_job.sum(), "per_job_loss": per_job,
                       "lr": torch.as_tensor(lr), "aux": aux,
                       "pipe_useful_slots": useful.round().long()[0],
                       "pipe_slots": torch.tensor((N + P - 1) * P,
                                                  device=dev)}
            return new_adapters, new_opt, metrics

        return train_step if steps is None else _chunked(train_step)

    # --------------------------------------------------------- serve steps
    def serve_rows(self, mesh) -> Optional[np.ndarray]:
        """This rank's rows of a serve batch laid out as ``rows_per_job``
        (job-major) on *mesh*: the batch split in order over the data
        axis ("pod" folded into it, the reference's ``batch_shardings``)
        where that divides the rows; None (every row, on every data rank)
        where it does not (long_500k's batch of 1) or there is no
        mesh."""
        if mesh is None:
            return None
        from repro_torch.launch.mesh import data_group
        _, D, s = data_group(mesh, "data")
        B = sum(self.rows_per_job())
        if D == 1 or B % D:
            return None
        return np.arange(s * B // D, (s + 1) * B // D)

    def _serve_axes(self, mesh):
        """(ModelAxis or None, the per-job rows of this rank's serve
        batch or None) on *mesh* (None: no mesh)."""
        if mesh is None:
            return None, None
        from repro_torch.launch.mesh import model_group
        from repro_torch.models.layers import ModelAxis
        mgroup, m, midx = model_group(mesh)
        tp = ModelAxis(mgroup, m, midx) if m > 1 else None
        idx = self.serve_rows(mesh)
        if idx is None:
            return tp, None
        ends = np.cumsum(self.rows_per_job())
        starts = ends - np.asarray(self.rows_per_job())
        lo, hi = int(idx[0]), int(idx[-1]) + 1
        return tp, [max(0, min(e, hi) - max(b, lo))
                    for b, e in zip(starts.tolist(), ends.tolist())]

    def make_prefill_step(self, shape: InputShape, *, ring: bool = False,
                          with_cache: bool = True, mesh=None) -> Callable:
        """Prefill of a (B, S) prompt batch at position 0, every row the
        same width: ``prefill_step(params, adapters, batch)`` returns the
        last column's logits (B, 1, V) and, with ``with_cache``, the
        filled caches (allocated on the batch's device: full KV caches of
        ``shape.seq_len`` keys rounded up to whole decode chunks, rings of
        ``min(shape.seq_len, sliding_window)`` slots for local attention
        or, with ``ring``, for every attention layer, MLA latent caches
        of as many slots, recurrent state), else None.  Every model input
        of the batch (tokens, a VLM batch's patches) reaches the forward,
        as in the reference.  The attention over the prompt is the flash
        path (the kernel on the card) where it has no window; the LoRA
        delta takes the impl's kernels through ``lora_ctx``.  As in the
        reference, ``ring`` and not ``shape.sliding_window_variant``
        picks the caches.  An encoder (non-causal: hubert-xlarge) writes
        its caches and attends over the prompt's own keys, not causally
        (``attn_block``), as its cacheless forward does.

        ``mesh``: a ("data", "model") or ("pod", "data", "model") mesh.
        The step then takes this rank's rows (``serve_rows``) and its
        model slices of the backbone (``sharding/rules.shard_params``
        with the config's kv heads), runs the backbone tensor parallel
        over "model" (``models/layers.ModelAxis``), fills this rank's
        caches (its kv heads, ``runtime_cache_specs``) and returns the
        last column's logits over the whole vocab on every model rank
        (one all-gather of its vocab block).

        ``prefill_step(..., row_block=n)``: the dense products on n
        tokens at a time (``layers.dense``; a solo batch's rows times the
        prompt width gives every product a solo batch's shape, so fused
        and solo prefills write the same caches on the card)."""
        cfg = self.cfg
        tp, rows = self._serve_axes(mesh)

        @torch.no_grad()
        def prefill_step(params, adapters, batch,
                         row_block: Optional[int] = None):
            model_in = {k: v for k, v in batch.items()
                        if k not in ("adapter_ids", "labels", "loss_mask")}
            ids = batch["adapter_ids"]
            caches = (M.init_caches(cfg, ids.shape[0], shape.seq_len, ring,
                                    device=ids.device, tp=tp)
                      if with_cache else None)
            logits, _, _, _ = M.forward(
                cfg, params, adapters, self.lora_ctx(ids, rows=rows),
                model_in, caches=caches, cache_pos=0, ring=ring, tp=tp,
                last=tp is not None, row_block=row_block)
            return logits[:, -1:], caches

        return prefill_step

    def make_serve_step(self, *, ring: bool = False, mesh=None) -> Callable:
        """One decode step: ``serve_step(params, adapters, caches, batch,
        pos, row_block=None)`` runs ``batch["tokens"]`` (B, S >= 1) at
        position *pos* (an int, or a per-row (B,) tensor) over *caches*
        and returns (logits (B, S, V), caches).  The caches are written
        IN PLACE and the returned list is the one passed in (the
        reference returns new arrays): a caller that wants to decode a
        second sequence from the same prefix copies them first.
        ``ring``: every attention cache is a ring (local attention's are
        regardless); a ring takes an int position.  ``row_block``: rows
        per dense and decode-attention chunk product (``layers.dense``:
        fused and solo batches then decode the same bits on the card).
        ``mesh``: as ``make_prefill_step`` (this rank's rows, model
        slices and caches; the logits whole on every model rank).  An
        encoder has no decode: refused."""
        check_decoder(self.cfg)
        tp, rows = self._serve_axes(mesh)

        @torch.no_grad()
        def serve_step(params, adapters, caches, batch, pos,
                       row_block: Optional[int] = None):
            lora = self.lora_ctx(batch["adapter_ids"], rows=rows)
            return M.decode_step(self.cfg, params, adapters, lora,
                                 batch["tokens"], pos, caches, ring=ring,
                                 row_block=row_block, tp=tp)

        return serve_step

    def decode_buf(self, shape: InputShape) -> int:
        """KV buffer width of *shape*'s decode (the reference's value;
        ``init_decode_caches`` rounds a full cache up to whole decode
        chunks)."""
        return (min(shape.seq_len, self.cfg.sliding_window)
                if shape.sliding_window_variant else shape.seq_len)

    def init_decode_caches(self, shape: InputShape,
                           batch: Optional[int] = None, *,
                           device="cuda", mesh=None) -> list:
        """Zeroed caches for *batch* rows (default: the shape's global
        batch) on *device*: full KV caches of ``decode_buf`` keys rounded
        up to whole ``DECODE_CHUNK``-key chunks (``KVCache.init``), so
        wider than ``decode_buf``; rings of exactly ``min(decode_buf,
        sliding_window)`` slots for local attention and, for a
        ``sliding_window_variant`` shape, for every attention layer;
        recurrent state for the recurrent mixers.  ``mesh``: this rank's
        caches (its rows where ``serve_rows`` splits them, its kv
        heads)."""
        B = batch or shape.global_batch
        tp, rows = self._serve_axes(mesh)
        if rows is not None:
            B = sum(rows)
        return M.init_caches(self.cfg, B, self.decode_buf(shape),
                             shape.sliding_window_variant, device=device,
                             tp=tp)


def check_decoder(cfg: ModelConfig) -> None:
    """The decode step: a non-causal encoder (hubert-xlarge) has no next
    token to serve (the reference's tests skip it; its prefill step
    runs)."""
    if not cfg.supports_decode():
        raise ValueError(f"{cfg.name} is an encoder (causal=False): it has "
                         "no decode step (its prefill step runs)")


def _chunked(train_step: Callable) -> Callable:
    def chunked_step(params, adapters, opt_state, batches):
        """batches: the train_step batch dict with a leading (steps,)
        chunk axis.  The loop body is the exact single train_step."""
        ms = []
        for i in range(next(iter(batches.values())).shape[0]):
            adapters, opt_state, m = train_step(
                params, adapters, opt_state,
                {k: v[i] for k, v in batches.items()})
            ms.append(m)
        metrics = {k: torch.stack([m[k] for m in ms]) for k in ms[0]}
        return adapters, opt_state, metrics

    return chunked_step


def _per_job_token_counts(batch: Dict[str, torch.Tensor], K: int,
                          causal: bool, clip: bool = True) -> torch.Tensor:
    """Full-batch per-job loss-token counts (denominators), clipped at 1.
    ``clip=False`` returns the raw counts, for per-shard partials that
    are summed into a global denominator and clipped once there."""
    ids = batch["adapter_ids"]
    mask = batch.get("loss_mask")
    if mask is None:
        key = "labels" if "labels" in batch else "tokens"
        S = batch[key].shape[-1] - (1 if causal else 0)
        counts = torch.full(ids.shape, float(S), device=ids.device)
    else:
        m = mask[:, 1:] if causal else mask
        counts = m.float().sum(-1)
    onehot = F.one_hot(ids.long(), K).float()
    raw = onehot.T @ counts
    return raw.clamp_min(1) if clip else raw


def _reshape_nano(batch: Dict[str, torch.Tensor], n: int
                  ) -> List[Dict[str, torch.Tensor]]:
    """(R, ...) -> n contiguous slices of R/n rows each (the reference's
    (n, R/n, ...) scan input, as a list of views; n = 1: the batch)."""
    if n == 1:
        return [batch]
    rows = {x.shape[0] for x in batch.values()}
    assert len(rows) == 1 and rows.pop() % n == 0, (batch.keys(), n)
    m = next(iter(batch.values())).shape[0] // n
    return [{k: x[i * m:(i + 1) * m] for k, x in batch.items()}
            for i in range(n)]


def _reshape_nano_jobwise(batch: Dict[str, torch.Tensor], n: int,
                          idx: torch.Tensor
                          ) -> List[Dict[str, torch.Tensor]]:
    """The sharded step's job-aware nano split: slice i takes rows
    ``[i*r_j/n, (i+1)*r_j/n)`` of EVERY job, segments in the order
    ``idx`` (``_nano_index``, on the batch's device) lays out, so each
    slice is itself a job-major mini fused batch with a static tile map.
    n = 1: the batch as it is."""
    if n == 1:
        return [batch]
    return [{k: v.index_select(0, sel) for k, v in batch.items()}
            for sel in idx.split(idx.numel() // n)]


def _nano_index(rows: Sequence[int], n: int,
                order: Optional[Sequence[int]] = None) -> np.ndarray:
    """Static row permutation of the job-proportional nano/micro split:
    slice *i* takes rows ``[i*r_j/n, (i+1)*r_j/n)`` of every job, with
    segments inside a slice in *order* (default: job index order)."""
    order = list(order) if order is not None else list(range(len(rows)))
    assert sorted(order) == list(range(len(rows))), order
    offs = np.concatenate([[0], np.cumsum(rows)])
    return np.concatenate([
        np.arange(offs[j] + i * (rows[j] // n),
                  offs[j] + (i + 1) * (rows[j] // n))
        for i in range(n) for j in order])


def valid_nano_counts(rows: int, max_n: Optional[int] = None, *,
                      seg_rows: Optional[Sequence[int]] = None,
                      seq_len: int = 1,
                      block_t: int = 1,
                      stages: int = 1) -> List[int]:
    """Divisors of the fused row count (legal nano-batch counts), sorted
    ascending; O(sqrt(rows)) paired enumeration.

    ``seg_rows`` keeps only counts that leave every listed segment's
    per-slice token count whole token tiles: (seg_rows[j] * seq_len) %
    (n * block_t) == 0 for all j.  ``stages`` > 1 keeps only counts that
    cover a pipeline of that depth (n >= stages)."""
    small, large = [], []
    d = 1
    while d * d <= rows:
        if rows % d == 0:
            small.append(d)
            if d != rows // d:
                large.append(rows // d)
        d += 1
    out = small + large[::-1]
    if max_n is not None:
        out = [n for n in out if n <= max_n]
    if seg_rows is not None:
        out = [n for n in out
               if all((r * seq_len) % (n * block_t) == 0
                      for r in seg_rows)]
    if stages > 1:
        out = [n for n in out if n >= stages]
    return out


def pipeline_legal_stages(cfg: ModelConfig) -> List[int]:
    """Legal pipeline depths for *cfg*: divisors of the scanned stack's
    cycle count (each stage must hold a whole number of cycles)."""
    plan = M.segment_plan(cfg)
    idx = [i for i, s in enumerate(plan) if s.scanned]
    if len(idx) != 1:
        return [1]
    r = plan[idx[0]].repeats
    return [p for p in range(1, r + 1) if r % p == 0]


def scanned_segment_index(cfg: ModelConfig) -> int:
    """Index of THE scanned segment in ``segment_plan``: the layer stack
    pipeline mode partitions (the reference's function).  Exactly one is
    required."""
    idx = [i for i, s in enumerate(M.segment_plan(cfg)) if s.scanned]
    if len(idx) != 1:
        raise ValueError(
            f"pipeline mode needs exactly one scanned segment; "
            f"{cfg.name} has {len(idx)}")
    return idx[0]


def check_stack_stages(cfg: ModelConfig, stages: int) -> int:
    """*stages* if it divides the scanned stack's cycles, else the
    reference's ValueError naming the legal depths."""
    repeats = M.segment_plan(cfg)[scanned_segment_index(cfg)].repeats
    if repeats % int(stages):
        raise ValueError(
            f"stages={stages} does not divide the scanned stack's "
            f"{repeats} cycle(s); legal pipeline depths for {cfg.name}: "
            f"{pipeline_legal_stages(cfg)}")
    return int(stages)


def stage_slices(cfg: ModelConfig, tree: dict, stages: int,
                 stage: int) -> dict:
    """Stage *stage*'s part of a params-, adapters- or moments-shaped
    *tree* (the port of ``pipeline_stage_specs``: which leaves split over
    the stages, and how).  The scanned segment's leaves are cut along
    their leading cycle axis to the stage's ``repeats / stages``
    contiguous cycles and copied, so the rest of the stack's storage is
    not kept alive by a view; a ``QuantTensor``'s codes and scales are
    cut together.  Every other leaf is the caller's, shared."""
    si = scanned_segment_index(cfg)
    c = M.segment_plan(cfg)[si].repeats // check_stack_stages(cfg, stages)
    cut = lambda t: t[stage * c:(stage + 1) * c].clone()
    out = dict(tree)
    out["segments"] = [M._tree_map(cut, seg) if i == si else seg
                       for i, seg in enumerate(tree["segments"])]
    return out


def stage_flat(cfg: ModelConfig, flat: Dict[str, torch.Tensor],
               stages: int, stage: int) -> Dict[str, torch.Tensor]:
    """``stage_slices`` of a flat ``segments/i/...``-keyed dict (a job
    state's slices)."""
    si = scanned_segment_index(cfg)
    c = M.segment_plan(cfg)[si].repeats // check_stack_stages(cfg, stages)
    pre = f"segments/{si}/"
    return {k: v[stage * c:(stage + 1) * c].clone() if k.startswith(pre)
            else v for k, v in flat.items()}


def _leaf_paths(tree) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    """(key path, leaf) of every leaf, in ``adamw.tree_leaves`` order."""
    out = []
    adamw.tree_map(lambda p, t: out.append((p, t)), tree)
    return out


def _all_reduce_flat(leaves: List[torch.Tensor], per_job: torch.Tensor,
                     aux: torch.Tensor, group,
                     extra: Optional[torch.Tensor] = None):
    """Sum *leaves*, *per_job*, *aux* (and *extra*) over *group* in one
    all-reduce of one flat f32 buffer; returns them (leaves in their
    f32, as the sharded step's ``reduce`` returns them) in that order."""
    parts = [t.reshape(-1).float() for t in leaves] + [
        per_job, aux.reshape(1)] + ([extra] if extra is not None else [])
    flat = torch.cat(parts)
    dist.all_reduce(flat, group=group)
    out, at = [], 0
    for t in leaves:
        out.append(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
    K = per_job.numel()
    res = [out, flat[at:at + K], flat[at + K]]
    if extra is not None:
        res.append(flat[at + K + 1:])
    return tuple(res)


def _text_off(cfg: ModelConfig, batch: Dict[str, torch.Tensor]) -> int:
    """The text offset ``embed_inputs`` returns for *batch* (the VLM
    patches' count), computed without embedding."""
    return (int(batch["patches"].shape[1])
            if cfg.family == "vlm" and "patches" in batch else 0)


def _act_shape(cfg: ModelConfig, batch: Dict[str, torch.Tensor]
               ) -> Tuple[int, int, int]:
    """(B, S, d) of the residual stream ``embed_inputs`` makes of
    *batch*: what a pipeline stage receives."""
    if cfg.family == "audio":
        B, S = batch["frames"].shape[:2]
    else:
        B, S = batch["tokens"].shape[:2]
        S += _text_off(cfg, batch)
    return int(B), int(S), cfg.d_model
