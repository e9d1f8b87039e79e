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

Not ported yet, and refused where asked for: the sharded and pipeline
steps (ROADMAP queue A, multi-GPU); ``pipeline_legal_stages``, the
scheduler's view of the pipeline depths a config allows, is here.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.jobs import LoRAJobSpec, tile_rows
from repro_torch.core.lora import MultiLoRA, RankLayout
from repro_torch.models import model as M
from repro_torch.optim import adamw

NO_MESH = ("sharded and pipeline group execution are not ported yet "
           "(ROADMAP queue A: multi-GPU)")


@dataclass
class SharedSuperModel:
    """One fused group: frozen backbone + K packed adapters."""
    cfg: ModelConfig
    jobs: List[LoRAJobSpec]
    impl: str = "cuda"           # fused-LoRA impl (cuda|torch|ref|loop)
    block_t: int = 128           # token tile of the LoRA kernels

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
        """Tile-aligned row count per job (mirrors FusedBatcher)."""
        return [tile_rows(j.batch_size, j.seq_len, self.block_t)
                for j in self.jobs]

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
        ragged kernels' tile tables of the full fused batch."""
        dev = torch.device(device)
        self.device_consts(dev)
        if self.impl != "cuda" or dev.type != "cuda":
            return
        from repro_torch.kernels import build
        from repro_torch.kernels import ragged as rg
        from repro_torch.kernels.ops import _tile_jobs_static
        for name in build.SOURCES:
            build.load(name)
        tiles = _tile_jobs_static(self.rows_per_job(), self.jobs[0].seq_len,
                                  self.block_t)
        if tiles is not None and not self.layout.is_uniform:
            meta = rg.RaggedMeta.build(tiles, self.layout)
            rg._device_table(meta, dev)
            rg._device_wgrad_tables(meta, dev)

    def lora_ctx(self, adapter_ids: torch.Tensor) -> MultiLoRA:
        """Apply context of one fused batch (single device)."""
        rows = self.rows_per_job()
        ranks, scalings, _ = self.device_consts(adapter_ids.device)
        return MultiLoRA(adapter_ids=adapter_ids, ranks=ranks,
                         scalings=scalings, impl=self.impl,
                         block_t=self.block_t, seg_rows=max(rows),
                         equal_segments=len(set(rows)) == 1,
                         layout=self.layout, rows_all=tuple(rows))

    # --------------------------------------------------------- train step
    def make_train_step(self, *, lr_fn: Callable, nano_batches: int = 1,
                        remat: bool = True, weight_decay: float = 0.0,
                        steps: Optional[int] = None, mesh=None,
                        pipeline_stages: int = 1) -> Callable:
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
        ``lax.scan`` over the chunk).  Raises, on every device, for a
        mesh or pipeline stages, which the port does not run yet."""
        if mesh is not None or pipeline_stages > 1:
            raise NotImplementedError(NO_MESH)
        cfg, K = self.cfg, self.num_jobs

        def train_step(params, adapters, opt_state, batch):
            denom = _per_job_token_counts(batch, K, causal=cfg.causal)
            ad = adamw.tree_map(
                lambda _, t: t.detach().requires_grad_(True), adapters)
            leaves = list(adamw.tree_leaves(ad))

            def grad_fn(nb):
                with torch.enable_grad():
                    total, aux = M.loss_fn(cfg, params, ad,
                                           self.lora_ctx(nb["adapter_ids"]),
                                           nb, remat=remat,
                                           per_job_denom=denom)
                    g = torch.autograd.grad(total, leaves)
                return g, aux["per_job"].detach(), aux["aux"].detach()

            if nano_batches == 1:
                g_leaves, per_job, moe_aux = grad_fn(batch)
            else:
                g_leaves = [torch.zeros(t.shape, dtype=torch.float32,
                                        device=t.device) for t in leaves]
                per_job = torch.zeros((K,), dtype=torch.float32,
                                      device=denom.device)
                moe_aux = torch.zeros((), device=denom.device)
                for nb in _reshape_nano(batch, nano_batches):
                    g, pj, a = grad_fn(nb)
                    g_leaves = [a_ + b.float() for a_, b in zip(g_leaves, g)]
                    per_job = per_job + pj
                    moe_aux = moe_aux + a
            it = iter(g_leaves)
            grads = adamw.tree_map(lambda _, t: next(it), ad)
            lr = lr_fn(opt_state.step)
            new_adapters, new_opt = adamw.update(
                grads, opt_state, adapters, lr=lr,
                weight_decay=weight_decay,
                col_jobs=self.device_consts(denom.device)[2])
            # "aux": the MoE load-balance loss the step's total carried
            # beside the per-job losses (summed over nano slices; 0
            # without MoE layers)
            metrics = {"loss": per_job.sum(), "per_job_loss": per_job,
                       "lr": torch.as_tensor(lr), "aux": moe_aux}
            return new_adapters, new_opt, metrics

        if steps is None:
            return train_step

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


def _per_job_token_counts(batch: Dict[str, torch.Tensor], K: int,
                          causal: bool) -> torch.Tensor:
    """Full-batch per-job loss-token counts (denominators), clipped at 1."""
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
    return (onehot.T @ counts).clamp_min(1)


def _reshape_nano(batch: Dict[str, torch.Tensor], n: int
                  ) -> List[Dict[str, torch.Tensor]]:
    """(R, ...) -> n contiguous slices of R/n rows each (the reference's
    (n, R/n, ...) scan input, as a list of views)."""
    rows = {x.shape[0] for x in batch.values()}
    assert len(rows) == 1 and rows.pop() % n == 0, (batch.keys(), n)
    m = next(iter(batch.values())).shape[0] // n
    return [{k: x[i * m:(i + 1) * m] for k, x in batch.items()}
            for i in range(n)]


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
