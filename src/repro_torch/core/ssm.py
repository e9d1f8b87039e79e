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
    has no decode and is refused there.

``make_train_step(mesh=...)`` is the data-parallel sharded step
(``tp_mode="dp"``): every mesh axis folds into row sharding over a
``torch.distributed`` group, each rank runs the step on its shard's rows
(the shard-major layout of ``data/pipeline.shard_permutation``) and
holds the adapters and Adam state replicated.  Not ported yet, and
refused where asked for: ``tp_mode="auto"`` (tensor parallelism, ROADMAP
A4), pipeline mode (A2) and a MoE model over a mesh (A3);
``pipeline_legal_stages``, the scheduler's view of the pipeline depths a
config allows, is here.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
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

NO_PIPELINE = ("pipeline group execution (tp_mode='pipeline', "
               "pipeline_stages > 1) is not ported yet (ROADMAP A2, old "
               "A7b: multi-GPU pipeline mode)")
NO_AUTO_TP = ("tensor-parallel group execution (tp_mode='auto') is not "
              "ported yet (ROADMAP A4, old A7c: multi-GPU tensor "
              "parallelism)")


def check_tp_mode(tp_mode: str, pipeline_stages: int = 1) -> None:
    """Refuse what the port does not run over a mesh: only the
    data-parallel ``tp_mode="dp"`` is ported."""
    if tp_mode == "pipeline" or pipeline_stages > 1:
        raise NotImplementedError(NO_PIPELINE)
    if tp_mode == "auto":
        raise NotImplementedError(NO_AUTO_TP)
    if tp_mode != "dp":
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
                 nano_order: Optional[Tuple[int, ...]] = None) -> MultiLoRA:
        """Apply context of one fused batch.  With a *group* the context
        is shard-local: *adapter_ids* covers one shard's rows, segment
        geometry is the per-shard layout (global rows / data_shards), and
        the exact wgrads reassemble solo order via *row_solo_pos* (the
        solo position of every shard's rows, shard-major).  ``nano_order``
        is the static job order of the segments inside a job-wise nano
        slice."""
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
                        nano_order: str = "job") -> Callable:
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
        job segments inside each sharded nano slice.  ``tp_mode`` other
        than "dp" and pipeline stages are refused (``check_tp_mode``)."""
        assert nano_order in ("job", "rank_desc"), nano_order
        check_tp_mode(tp_mode, pipeline_stages)
        if mesh is not None:
            return self._make_sharded_step(
                lr_fn=lr_fn, nano_batches=nano_batches, remat=remat,
                weight_decay=weight_decay, steps=steps, mesh=mesh,
                grad_sync=grad_sync, nano_order=nano_order)
        cfg, K = self.cfg, self.num_jobs

        def train_step(params, adapters, opt_state, batch):
            denom = _per_job_token_counts(batch, K, causal=cfg.causal)
            slices = [(nb, self.lora_ctx(nb["adapter_ids"]))
                      for nb in _reshape_nano(batch, nano_batches)]
            return self._update(params, adapters, opt_state, denom, slices,
                                lr_fn, remat, weight_decay)

        return train_step if steps is None else _chunked(train_step)

    def _update(self, params, adapters, opt_state, denom, slices, lr_fn,
                remat, weight_decay, reduce=None):
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
                                       remat=remat, per_job_denom=denom)
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
                           nano_order) -> Callable:
        """The data-parallel step over *mesh* (the reference's
        ``tp_mode="dp"`` shard_map step, ``ssm.py:263``): the
        single-device body on this rank's rows.  The per-job token
        denominators are all-reduced (integer-valued f32 sums, exact in
        any order) and clipped after the sum (a per-shard clip would
        inflate a job whose shard holds only padding); the loss the
        gradient flows through is the shard's partial; the adapter
        wgrads are either gathered-exact (the kernels' shard-local
        backwards, ``grad_sync="gather"``) or all-reduced with the
        metrics (``"psum"``).  The update then runs on the replicated
        state identically on every rank."""
        from repro_torch.data.pipeline import shard_permutation
        from repro_torch.launch.mesh import data_group
        from repro_torch.models.moe import MOE_NO_MESH
        cfg, K = self.cfg, self.num_jobs
        if cfg.num_experts:
            raise NotImplementedError(MOE_NO_MESH)
        exact = grad_sync == "gather"
        assert grad_sync in ("gather", "psum"), grad_sync
        if exact and self.impl in ("ref", "loop"):
            raise ValueError(
                f"impl={self.impl!r} has no shard-local VJP for exact "
                "gathered wgrads; use impl='torch'/'cuda' or "
                "grad_sync='psum'")
        group, D, _ = data_group(mesh)
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
                                reduce=None if exact else reduce)

        return train_step if steps is None else _chunked(train_step)

    # --------------------------------------------------------- serve steps
    def make_prefill_step(self, shape: InputShape, *, ring: bool = False,
                          with_cache: bool = True) -> Callable:
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
        picks the caches.  An encoder has no decode: refused."""
        cfg = self.cfg
        _check_decoder(cfg)

        @torch.no_grad()
        def prefill_step(params, adapters, batch):
            model_in = {k: v for k, v in batch.items()
                        if k not in ("adapter_ids", "labels", "loss_mask")}
            B = batch["adapter_ids"].shape[0]
            caches = (M.init_caches(cfg, B, shape.seq_len, ring,
                                    device=batch["adapter_ids"].device)
                      if with_cache else None)
            logits, _, _, _ = M.forward(
                cfg, params, adapters, self.lora_ctx(batch["adapter_ids"]),
                model_in, caches=caches, cache_pos=0, ring=ring)
            return logits[:, -1:], caches

        return prefill_step

    def make_serve_step(self, *, ring: bool = False) -> Callable:
        """One decode step: ``serve_step(params, adapters, caches, batch,
        pos)`` runs ``batch["tokens"]`` (B, S >= 1) at position *pos* (an
        int, or a per-row (B,) tensor) over *caches* and returns (logits
        (B, S, V), caches).  The caches are written IN PLACE and the
        returned list is the one passed in (the reference returns new
        arrays): a caller that wants to decode a second sequence from the
        same prefix copies them first.  ``ring``: every attention cache is
        a ring (local attention's are regardless); a ring takes an int
        position.  An encoder has no decode: refused."""
        _check_decoder(self.cfg)

        @torch.no_grad()
        def serve_step(params, adapters, caches, batch, pos):
            lora = self.lora_ctx(batch["adapter_ids"])
            return M.decode_step(self.cfg, params, adapters, lora,
                                 batch["tokens"], pos, caches, ring=ring)

        return serve_step

    def decode_buf(self, shape: InputShape) -> int:
        """KV buffer width of *shape*'s decode (the reference's value;
        ``init_decode_caches`` rounds a full cache up to whole decode
        chunks)."""
        return (min(shape.seq_len, self.cfg.sliding_window)
                if shape.sliding_window_variant else shape.seq_len)

    def init_decode_caches(self, shape: InputShape,
                           batch: Optional[int] = None, *,
                           device="cuda") -> list:
        """Zeroed caches for *batch* rows (default: the shape's global
        batch) on *device*: full KV caches of ``decode_buf`` keys rounded
        up to whole ``DECODE_CHUNK``-key chunks (``KVCache.init``), so
        wider than ``decode_buf``; rings of exactly ``min(decode_buf,
        sliding_window)`` slots for local attention and, for a
        ``sliding_window_variant`` shape, for every attention layer;
        recurrent state for the recurrent mixers."""
        B = batch or shape.global_batch
        return M.init_caches(self.cfg, B, self.decode_buf(shape),
                             shape.sliding_window_variant, device=device)


def _check_decoder(cfg: ModelConfig) -> None:
    """The serve steps decode: a non-causal encoder (hubert-xlarge) has
    no next token to serve (the reference's tests skip it)."""
    if not cfg.supports_decode():
        raise ValueError(f"{cfg.name} is an encoder (causal=False): it has "
                         "no decode steps")


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
