"""Analytic throughput / cost model (scheduler + simulator + roofline):
a copy of ``repro.core.throughput`` for the port, held to it by the
tests, with the ``H100`` spec added beside ``V5E``.

Two-level methodology per paper §4.1: micro-benchmark-calibrated analytic
model standing in for the Sailor simulator.  The model prices one fused
group step as the max of three roofline terms (compute / HBM / collective)
on TPU-v5e constants, plus kernel-launch overheads — the same three terms
the dry-run roofline analysis derives from compiled HLO, so scheduler
decisions and EXPERIMENTS.md §Roofline speak the same language.

Key behaviours it must reproduce (paper §2, Fig. 2):
  * memory-bound (small-batch) jobs batch for ~free — weight reads
    amortize over the union batch;
  * compute-saturated jobs gain nothing and can regress when grouping
    forces cross-node collectives;
  * unfused per-adapter execution (mLoRA / w/o-Kernel-Fuser ablation)
    pays per-adapter launch overhead and loses overlap.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from functools import lru_cache

from repro_torch.configs.base import ModelConfig
from repro_torch.core.jobs import LoRAJobSpec


# ----------------------------------------------------------- hardware
@dataclass(frozen=True)
class HardwareSpec:
    """TPU v5e (assignment constants)."""
    peak_flops: float = 197e12          # bf16 / chip
    hbm_bw: float = 819e9               # bytes/s / chip
    ici_bw: float = 50e9                # bytes/s / link (intra-pod)
    dcn_bw: float = 6.25e9              # bytes/s / chip (cross-pod/node)
    chips_per_node: int = 8             # grouping tier granularity
    mfu_cap: float = 0.55               # achievable fraction of peak
    # small-GEMM efficiency: eff = mfu_cap * t/(t + sat_tokens) where t is
    # tokens-per-chip — mild occupancy penalty for tiny batches
    # (calibrated against the §4.1 micro-benchmarks, EXPERIMENTS.md).
    sat_tokens: float = 512.0
    launch_overhead: float = 30e-6      # per-kernel dispatch cost (s)
    kernels_per_layer: int = 8          # fused-path launches per layer
    sync_latency: float = 15e-6         # per-collective latency (s)
    step_overhead: float = 0.025        # per-step framework cost (s):
    # host dispatch, optimizer, data feed — amortized across a fused group
    hbm_capacity: float = 16e9          # bytes / chip (feasibility)
    # one-time cost of a group transition (pause + migrate + compile +
    # resume), before online calibration: dominated by the XLA recompile
    # of the rebuilt group's fused step.  The scheduler prices regroups
    # against it (payback-horizon gating) until measured stalls replace
    # it via OnlineCalibrator.observe_regroup.
    regroup_overhead: float = 30.0
    # backbone storage bytes per frozen parameter: 2.0 = bf16, 1.0 =
    # int8 (models/quant).  Prices BOTH the weight-streaming roofline
    # floor (group_step_cost) and the resident HBM shard (min_chips /
    # group_memory_bytes) — quantization halves each, which is exactly
    # what makes it a capacity AND bandwidth lever for memory-bound
    # fused groups.
    backbone_bytes_per_param: float = 2.0


V5E = HardwareSpec()

# NVIDIA H100 SXM5 (NVIDIA H100 Tensor Core GPU data sheet: 989 TFLOP/s
# dense bf16, 3.35 TB/s HBM3, 80 GB, NVLink 4 at 900 GB/s a GPU both ways
# through NVSwitch, so 450 GB/s each way; DGX H100 / HGX H100: 8 GPUs a
# node, one 400 Gb/s ConnectX-7 port a GPU across nodes, 50 GB/s).  The
# fitted constants (mfu_cap, launch_overhead, step_overhead) keep V5E's
# values here: OnlineCalibrator fits them from the card's measured steps.
H100 = dataclasses.replace(V5E, peak_flops=989e12, hbm_bw=3.35e12,
                           ici_bw=450e9, dcn_bw=50e9, chips_per_node=8,
                           hbm_capacity=80e9)

_BACKBONE_BYTES = {"bf16": 2.0, "int8": 1.0}


def with_backbone_dtype(hw: HardwareSpec, dtype: str) -> HardwareSpec:
    """HardwareSpec repriced for a backbone storage dtype tag."""
    bpp = _BACKBONE_BYTES[dtype]
    if hw.backbone_bytes_per_param == bpp:
        return hw
    return dataclasses.replace(hw, backbone_bytes_per_param=bpp)


# ----------------------------------------------------------- param math
@lru_cache(maxsize=256)
def param_counts(cfg: ModelConfig) -> Tuple[int, int]:
    """(total, active-per-token) backbone parameter counts."""
    d = cfg.d_model
    total = cfg.vocab_size * d
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * d
    from repro_torch.models.model import layer_specs
    for spec in layer_specs(cfg):
        if spec.mixer in ("attn", "local_attn"):
            t = d * cfg.q_dim * 2 + d * cfg.kv_dim * 2
        elif spec.mixer == "mla":
            qk = cfg.qk_nope_dim + cfg.qk_rope_dim
            t = (d * cfg.num_heads * qk
                 + d * (cfg.kv_lora_rank + cfg.qk_rope_dim)
                 + cfg.kv_lora_rank * cfg.num_heads * (cfg.qk_nope_dim
                                                       + cfg.v_head_dim)
                 + cfg.num_heads * cfg.v_head_dim * d)
        elif spec.mixer == "ssd":
            di, N, H = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_nheads
            d_in_proj = 2 * di + 2 * 8 * N + H
            t = d * d_in_proj + di * d + cfg.ssm_conv * (di + 2 * 8 * N)
        elif spec.mixer == "rglru":
            w = cfg.lru_width
            t = d * w * 2 + w * d + 2 * w * w + cfg.conv1d_width * w
        else:
            raise ValueError(spec.mixer)
        total += t
        if spec.ffn == "swiglu":
            total += 3 * d * cfg.d_ff
        elif spec.ffn == "moe":
            per_e = 3 * d * cfg.moe_d_ff
            total += cfg.num_experts * per_e + d * cfg.num_experts
            total += cfg.num_shared_experts * per_e
    return int(total), _active_params(cfg)


@lru_cache(maxsize=256)
def _active_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    act = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    from repro_torch.models.model import layer_specs
    for spec in layer_specs(cfg):
        if spec.mixer in ("attn", "local_attn"):
            act += d * cfg.q_dim * 2 + d * cfg.kv_dim * 2
        elif spec.mixer == "mla":
            qk = cfg.qk_nope_dim + cfg.qk_rope_dim
            act += (d * cfg.num_heads * qk
                    + d * (cfg.kv_lora_rank + cfg.qk_rope_dim)
                    + cfg.kv_lora_rank * cfg.num_heads * (cfg.qk_nope_dim
                                                          + cfg.v_head_dim)
                    + cfg.num_heads * cfg.v_head_dim * d)
        elif spec.mixer == "ssd":
            di, N, H = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_nheads
            act += d * (2 * di + 2 * 8 * N + H) + di * d
        elif spec.mixer == "rglru":
            w = cfg.lru_width
            act += d * w * 2 + w * d + 2 * w * w
        if spec.ffn == "swiglu":
            act += 3 * d * cfg.d_ff
        elif spec.ffn == "moe":
            act += (cfg.num_experts_per_tok + cfg.num_shared_experts) \
                * 3 * d * cfg.moe_d_ff
    return int(act)


@lru_cache(maxsize=1024)
def lora_param_count(cfg: ModelConfig, rank: int) -> int:
    from repro_torch.models.model import adapter_param_count
    return adapter_param_count(cfg, [rank])


@lru_cache(maxsize=256)
def lora_dims_per_rank(cfg: ModelConfig) -> int:
    """Σ over LoRA-targeted projections of (d_in + d_out), layer
    repeats included — the per-rank-lane parameter (and per-token-lane
    FLOP) footprint of one adapter."""
    return lora_param_count(cfg, 1)


def _padded_rank(rank: int) -> int:
    """What the ragged kernels compute/store per adapter: the runtime
    padding rule (core/lora.pad_rank) at the SSM's small-scale default
    lane multiple.  A real-TPU deployment pads to wider lanes (the
    SSM uses min(block_t, 16)); the oracle's constant multiple is an
    analytic-model simplification, same spirit as the fixed mfu/bw
    constants it sits next to."""
    from repro_torch.core.lora import pad_rank
    return pad_rank(rank, multiple=8)


# ----------------------------------------------------------- step model
@dataclass(frozen=True)
class StepCost:
    t_compute: float          # at workload-dependent efficiency
    t_compute_ideal: float    # at saturated mfu_cap (useful compute)
    t_memory: float
    t_comm: float
    t_overhead: float
    overlap: bool = True      # fused kernel + nano-batching hide comm

    @property
    def total(self) -> float:
        # fused path: comm overlaps with compute (nano-batch pipelining,
        # Eq. 1); naive/unfused execution exposes it additively.  The
        # memory floor (weight streaming) can't be hidden twice.
        if self.overlap:
            exposed = max(self.t_compute, self.t_comm)
        else:
            exposed = self.t_compute + self.t_comm
        return max(exposed, self.t_memory) + self.t_overhead

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_comm, "overhead": self.t_overhead}
        return max(terms, key=terms.get)

    @property
    def useful_fraction(self) -> float:
        """Fraction of the step doing saturated-efficiency compute — the
        'GPU utilization' the paper reports."""
        return min(1.0, self.t_compute_ideal / max(self.total, 1e-12))


def group_step_cost(cfg: ModelConfig, jobs: Sequence[LoRAJobSpec],
                    chips: int, *, hw: HardwareSpec = V5E,
                    spans_nodes: bool = False,
                    kernel_fused: bool = True,
                    nano_batches: int = 4,
                    ragged_kernels: bool = True) -> StepCost:
    """Price one fused step of *jobs* co-located on *chips* accelerators.

    ``ragged_kernels`` selects the LoRA-kernel pricing rule: True (the
    production rank-bucketed ragged path) prices each adapter's tokens
    at ITS OWN padded rank; False reproduces the masked max-rank
    baseline where every token pays the group-wide maximum — the waste
    that used to discourage exactly the heterogeneous fusions tLoRA
    exists to make cheap.

    Memoized on the workload signature — the scheduler probes the same
    candidate groups many times per round."""
    sig = (cfg.name, tuple(sorted((j.rank, j.batch_size, j.seq_len)
                                  for j in jobs)),
           chips, hw, spans_nodes, kernel_fused, nano_batches,
           ragged_kernels)
    hit = _COST_CACHE.get(sig)
    if hit is not None:
        return hit
    cost = _group_step_cost(cfg, jobs, chips, hw=hw,
                            spans_nodes=spans_nodes,
                            kernel_fused=kernel_fused,
                            nano_batches=nano_batches,
                            ragged_kernels=ragged_kernels)
    if len(_COST_CACHE) > 200_000:
        _COST_CACHE.clear()
    _COST_CACHE[sig] = cost
    return cost


_COST_CACHE: Dict = {}


def _group_step_cost(cfg: ModelConfig, jobs: Sequence[LoRAJobSpec],
                     chips: int, *, hw: HardwareSpec = V5E,
                     spans_nodes: bool = False,
                     kernel_fused: bool = True,
                     nano_batches: int = 4,
                     ragged_kernels: bool = True) -> StepCost:
    assert chips >= 1
    total_p, active_p = param_counts(cfg)
    tokens = sum(j.batch_size * j.seq_len for j in jobs)

    # LoRA training ≈ 2ND fwd + 2ND dx backprop; adapter wgrad negligible.
    flops = 4 * active_p * tokens
    # attention quadratic extra (full-attention layers, causal ÷2)
    n_attn = sum(1 for k in cfg.layer_kinds() if k == "full_attn")
    for j in jobs:
        flops += 4 * 2 * n_attn * cfg.q_dim * j.seq_len ** 2 * j.batch_size / 2

    # fused-LoRA kernel term (fwd 2 + dgrad 2 + wgrad 2 FLOPs per lane):
    # ragged kernels do true per-adapter padded-rank work; the masked
    # baseline pays the group max on every token.  Negligible for
    # homogeneous small-rank groups, but K·r_max pricing over-penalized
    # mixed-rank fusions by up to r_max/r_j per member.
    dims = lora_dims_per_rank(cfg)
    r_max_pad = _padded_rank(max(j.rank for j in jobs))
    lora_lane_tokens = 0.0
    for j in jobs:
        r_eff = _padded_rank(j.rank) if ragged_kernels else r_max_pad
        lora_lane_tokens += j.batch_size * j.seq_len * r_eff
    flops += 6 * lora_lane_tokens * dims

    # efficiency saturates with per-chip workload (small-GEMM occupancy —
    # the residual capacity complementarity exploits, §3.4)
    tpc = tokens / chips
    eff = hw.mfu_cap * tpc / (tpc + hw.sat_tokens)
    t_compute = flops / (chips * hw.peak_flops * max(eff, 1e-6))
    t_compute_ideal = flops / (chips * hw.peak_flops * hw.mfu_cap)

    # weight traffic: every chip streams its weight shard once per pass
    # (fwd + bwd-recompute + bwd) per nano-batch — batching amortizes this
    # across the union batch; isolated small jobs pay it alone.  Adapter
    # streaming (and the same-shaped AdamW moments) rides along at
    # PADDED width: the ragged layout stores Σ r_pad_j lanes, the
    # masked baseline K·r_max — 16x more for a {4,...,4,64} group.
    lora_pad_params = sum(
        (_padded_rank(j.rank) if ragged_kernels else r_max_pad) * dims
        for j in jobs)
    wbytes = (total_p * hw.backbone_bytes_per_param
              + lora_pad_params * 2) / chips
    t_memory = wbytes * 3 * max(1, nano_batches if kernel_fused else 1) \
        / hw.hbm_bw
    act_bytes = tokens * cfg.d_model * 2 * 12 / chips
    t_memory = max(t_memory, act_bytes / hw.hbm_bw)

    # collectives: TP activation all-reduces (2/layer fwd, 2 bwd) over the
    # model axis + DP adapter-grad all-reduce (tiny — the tLoRA win).
    tp = min(chips, 16)
    bw = hw.dcn_bw if spans_nodes else hw.ici_bw
    L = cfg.num_layers
    ar_bytes = 4 * L * (tokens / max(chips // tp, 1)) * cfg.d_model * 2 \
        * 2 * (tp - 1) / tp
    lora_bytes = sum(lora_param_count(cfg, j.rank) for j in jobs) * 4
    dp = max(chips // tp, 1)
    ar_bytes += 2 * lora_bytes * (dp - 1) / dp
    n_colls = 4 * L * max(1, nano_batches)
    t_comm = ar_bytes / (tp * bw) + n_colls * hw.sync_latency * \
        (4.0 if spans_nodes else 1.0)
    if not kernel_fused:
        # unfused: per-adapter GEMM pairs serialize against comm (no
        # nano-overlap) — model as comm fully exposed.
        t_comm *= 2.0

    # kernel launches: fused = const per layer; unfused = + per adapter.
    launches = L * hw.kernels_per_layer * max(1, nano_batches)
    if not kernel_fused:
        launches += L * 4 * len(jobs) * max(1, nano_batches)
    t_overhead = launches * hw.launch_overhead + hw.step_overhead

    return StepCost(t_compute, t_compute_ideal, t_memory, t_comm,
                    t_overhead, overlap=kernel_fused)


def pipeline_bubble_fraction(stages: int, nanos: int,
                             skew: float = 0.0) -> float:
    """Idle fraction of a *stages*-deep pipeline schedule driving *nanos*
    microbatches: (P-1) warm-up/cool-down ticks out of N+P-1 total.

        bubble = 1 - N / ((N + P - 1) * (1 + skew))

    ``skew`` >= 0 inflates every tick to the SLOWEST stage's duration
    (per-nano imbalance: ragged job composition makes micro sizes and
    rank work uneven) — the critical path of a synchronous tick is its
    slowest stage, so skew converts straight into extra idle time on
    the others.  The multi-tenant claim is this formula's N: filling
    warm-up/cool-down slots with OTHER jobs' nanos makes N the GROUP
    total (one shared fill/drain), while single-job GPipe pays P-1
    bubble ticks PER JOB (core/nanobatch.pipeline_tick_counts)."""
    P, N = int(stages), int(nanos)
    if P <= 1 or N <= 0:
        return max(0.0, 1.0 - 1.0 / (1.0 + max(skew, 0.0)))
    return 1.0 - N / ((N + P - 1) * (1.0 + max(skew, 0.0)))


def pipeline_step_cost(cfg: ModelConfig, jobs: Sequence[LoRAJobSpec],
                       chips: int, *, stages: int,
                       hw: HardwareSpec = V5E,
                       nano_batches: int = 4,
                       spans_nodes: bool = False,
                       kernel_fused: bool = True,
                       ragged_kernels: bool = True,
                       skew: float = 0.0) -> StepCost:
    """Price one stage-partitioned step (tp_mode="pipeline").

    The scanned stack splits into *stages* contiguous sub-slices of
    ``chips/stages`` devices each; the group's nano slices become
    pipeline microbatches.  At steady state every stage computes
    concurrently on a different micro, so the machine-rate terms equal
    the all-chips fused step inflated by the bubble factor
    ``ticks/N = (N+P-1)/N``; on top ride the per-tick activation
    handoffs (one micro's boundary activations cross to the next
    stage's peer device over ICI) and a per-tick sync."""
    P = int(stages)
    assert chips >= 1 and P >= 1
    if P == 1:
        return group_step_cost(cfg, jobs, chips, hw=hw,
                               spans_nodes=spans_nodes,
                               kernel_fused=kernel_fused,
                               nano_batches=nano_batches,
                               ragged_kernels=ragged_kernels)
    assert chips % P == 0, (chips, P)
    N = max(int(nano_batches), P)      # micros must cover the depth
    base = group_step_cost(cfg, jobs, chips, hw=hw,
                           spans_nodes=spans_nodes,
                           kernel_fused=kernel_fused,
                           nano_batches=N,
                           ragged_kernels=ragged_kernels)
    ticks = N + P - 1
    f = 1.0 / (1.0 - pipeline_bubble_fraction(P, N, skew))
    D = chips // P
    tokens = sum(j.batch_size * j.seq_len for j in jobs)
    handoff = (tokens / N / D) * cfg.d_model * 2 / hw.ici_bw
    t_comm = base.t_comm * f + ticks * (handoff + hw.sync_latency)
    return StepCost(base.t_compute * f, base.t_compute_ideal,
                    base.t_memory * f, t_comm, base.t_overhead,
                    overlap=base.overlap)


def standalone_step_time(cfg: ModelConfig, job: LoRAJobSpec, *,
                         hw: HardwareSpec = V5E,
                         kernel_fused: bool = True,
                         ragged_kernels: bool = True) -> float:
    return group_step_cost(cfg, [job], max(job.gpus, 1), hw=hw,
                           kernel_fused=kernel_fused,
                           ragged_kernels=ragged_kernels).total


def group_throughput(cfg: ModelConfig, jobs: Sequence[LoRAJobSpec],
                     chips: int, *, hw: HardwareSpec = V5E,
                     spans_nodes: bool = False,
                     kernel_fused: bool = True,
                     ragged_kernels: bool = True) -> float:
    """Samples/sec of the fused group (the scheduler objective T̂(G))."""
    t = group_step_cost(cfg, jobs, chips, hw=hw, spans_nodes=spans_nodes,
                        kernel_fused=kernel_fused,
                        ragged_kernels=ragged_kernels).total
    return sum(j.batch_size for j in jobs) / t


def slowdowns(cfg: ModelConfig, jobs: Sequence[LoRAJobSpec], chips: int,
              *, hw: HardwareSpec = V5E, spans_nodes: bool = False,
              kernel_fused: bool = True,
              ragged_kernels: bool = True) -> Dict[str, float]:
    """Δ_j(G): per-job step-time inflation vs standalone execution."""
    t_g = group_step_cost(cfg, jobs, chips, hw=hw, spans_nodes=spans_nodes,
                          kernel_fused=kernel_fused,
                          ragged_kernels=ragged_kernels).total
    return {j.job_id: t_g / standalone_step_time(
                cfg, j, hw=hw, kernel_fused=kernel_fused,
                ragged_kernels=ragged_kernels)
            for j in jobs}


def residual_capacity(cfg: ModelConfig, job: LoRAJobSpec, *,
                      hw: HardwareSpec = V5E) -> float:
    """r_j in [0, 1): fraction of the job's allocation left idle when it
    runs alone — the complementarity signal of §3.4."""
    c = group_step_cost(cfg, [job], max(job.gpus, 1), hw=hw)
    return max(0.0, 1.0 - c.useful_fraction)


def min_chips(cfg: ModelConfig, *, hw: HardwareSpec = V5E) -> int:
    """Smallest chip count whose HBM holds the backbone shard at
    ``hw.backbone_bytes_per_param`` (2.0 bf16 / 1.0 int8)."""
    total, _ = param_counts(cfg)
    # +30% activations/fragmentation slack
    need = total * hw.backbone_bytes_per_param * 1.3
    c = 1
    while need / c > hw.hbm_capacity:
        c *= 2
    return c


# ----------------------------------------------------------- memory model
def group_memory_bytes(cfg: ModelConfig, jobs: Sequence[LoRAJobSpec],
                       chips: int, *, hw: HardwareSpec = V5E,
                       remat: bool = True, tp_mode: str = "tp",
                       stages: int = 1) -> float:
    """Per-chip HBM high-water mark of one fused group step.

    Three resident terms:

      * backbone shard at ``hw.backbone_bytes_per_param`` (the tentpole
        lever: int8 halves it);
      * per-job adapter state at PADDED rank — f32 master weights plus
        the two same-shaped AdamW moments (12 B/param), the only
        trainable (and therefore optimizer-bearing) parameters;
      * activation high-water under the group's remat flag.  With remat
        the fused step keeps one residual per layer boundary plus the
        live working set of the layer being recomputed (~12
        d_model-sized intermediates); without remat every layer's
        intermediates survive to the backward.

    ``tp_mode`` selects the residency model:

      * "tp" (default): every param term shards over *chips* — the
        ideal tensor-sharded residency the original gate priced;
      * "dp": the fully-manual data-parallel step replicates backbone,
        adapters and moments on EVERY chip — only activations shard.
        This is the mode that stops fitting first as models grow: the
        "DP alone cannot fit" configs pipeline mode exists to rescue;
      * "pipeline": like "dp" within each stage sub-slice, but each
        chip keeps only its stage's 1/*stages* slice of the scanned
        layer stack (backbone shard + every job's adapter/moment
        slices live with their stage — DESIGN.md §15); the embed/head
        ends stay replicated.

    This is the scheduler's explicit K-per-device feasibility gate
    (AdapterScheduler._feasible) — it replaces the old implicit
    max_group hard cap as the binding capacity constraint.
    """
    assert chips >= 1
    assert tp_mode in ("tp", "dp", "pipeline"), tp_mode
    total_p, _ = param_counts(cfg)
    dims = lora_dims_per_rank(cfg)
    adapter_params = sum(_padded_rank(j.rank) * dims for j in jobs)
    if tp_mode == "tp":
        backbone = total_p * hw.backbone_bytes_per_param / chips
        adapters = adapter_params * 12.0 / chips  # f32 + Adam m + Adam v
    else:
        P = max(int(stages), 1) if tp_mode == "pipeline" else 1
        embed = cfg.vocab_size * cfg.d_model \
            * (1 if cfg.tie_embeddings else 2)
        stack_frac = max(0.0, 1.0 - embed / max(total_p, 1))
        keep = (1.0 - stack_frac) + stack_frac / P
        backbone = total_p * keep * hw.backbone_bytes_per_param
        # adapters target the layer-stack projections: they (and their
        # moments) partition with their stage like the backbone shard
        adapters = adapter_params * 12.0 * keep

    tokens = sum(j.batch_size * j.seq_len for j in jobs)
    L = max(cfg.num_layers, 1)
    per_tok = cfg.d_model * 2                     # bf16 activations
    if remat:
        acts = tokens * per_tok * (L + 12) / chips
    else:
        acts = tokens * per_tok * L * 12 / chips
    return backbone + adapters + acts


def memory_feasible(cfg: ModelConfig, jobs: Sequence[LoRAJobSpec],
                    chips: int, *, hw: HardwareSpec = V5E,
                    remat: bool = True, headroom: float = 0.9,
                    tp_mode: str = "tp", stages: int = 1) -> bool:
    """True iff the group's per-chip high-water fits in HBM with
    *headroom* slack left for fragmentation/collective buffers."""
    return group_memory_bytes(cfg, jobs, chips, hw=hw, remat=remat,
                              tp_mode=tp_mode, stages=stages) \
        <= hw.hbm_capacity * headroom


def max_feasible_k(cfg: ModelConfig, job: LoRAJobSpec, chips: int, *,
                   hw: HardwareSpec = V5E, remat: bool = True,
                   headroom: float = 0.9, k_cap: int = 256,
                   tp_mode: str = "tp", stages: int = 1) -> int:
    """Largest K such that K clones of *job* fit on *chips* — the
    capacity headline BENCH_quant reports (int8 vs bf16)."""
    k = 0
    while k < k_cap:
        jobs = [dataclasses.replace(job, job_id=f"j{i}")
                for i in range(k + 1)]
        if not memory_feasible(cfg, jobs, chips, hw=hw, remat=remat,
                               headroom=headroom, tp_mode=tp_mode,
                               stages=stages):
            break
        k += 1
    return k


# ----------------------------------------------------- online calibration
@dataclass
class _CalBucket:
    """EWMA-weighted least-squares accumulators for one (model, chips)."""
    sw: float = 0.0      # sum of weights
    sx: float = 0.0      # sum of w * x          (x = analytic machine time)
    sy: float = 0.0      # sum of w * y          (y = measured step time)
    sxx: float = 0.0
    sxy: float = 0.0
    n: int = 0           # raw observation count


class OnlineCalibrator:
    """Fit effective hardware constants from measured `StepRecord`s.

    Closes the §3.4/§4.1 feedback loop: the analytic oracle prices a
    step with fixed `HardwareSpec` constants, but the machine the groups
    actually run on (a CPU host in tests, a real accelerator in prod)
    has different effective mfu, bandwidth efficiency and launch/step
    overheads.  Per (base model, chips, group size) bucket this
    maintains an exponentially-weighted least-squares fit

        measured  ≈  alpha * t_machine  +  beta

    where ``t_machine = StepCost.total - hw.step_overhead`` is the
    machine-rate part of the analytic prediction (compute/memory/
    collective roofline + kernel launches) and ``beta`` absorbs the
    per-step framework overhead.  ``alpha`` rescales every rate
    constant at once — mfu_cap, hbm_bw, ici/dcn bandwidth, launch and
    sync latencies all divide (or multiply) by it — so the calibrated
    `HardwareSpec` returned by :meth:`hw_for` reproduces the fit
    EXACTLY through the unchanged `group_step_cost` machinery:
    ``total(hw_cal) = alpha * (total(hw) - step_overhead) + beta``.

    Buckets include the group size K because a single (alpha, beta)
    cannot absorb MODEL error, only constant error: on hosts where the
    analytic step is floored by a token-independent term (tiny configs
    sit on the weight-streaming floor) t_machine barely moves with K
    while the true cost is token-dominated, and one shared fit would
    oscillate between compositions — measured exactly this way on
    XLA:CPU (DESIGN.md §9).  Per-K buckets are the online analogue of
    the paper's per-configuration micro-benchmarks.

    Buckets ALSO include the backbone storage dtype ("bf16" | "int8"):
    an int8 group runs a different machine program (fused dequant
    epilogue, half the weight streaming) with a different analytic
    regressor, so folding its measurements into the bf16 bucket for the
    same (model, chips, K) would contaminate both fits.  The regressor
    x is always priced with the dtype-matched base constants
    (``with_backbone_dtype``), keeping each fit's frame of reference
    self-consistent.

    EWMA weighting (``decay`` per observation) tracks drift — thermal
    throttling, host load, dataset-shape shifts; with at least
    ``min_obs`` observations and a well-spread x the two-parameter fit
    engages, otherwise a through-origin ratio fit (beta = 0) covers the
    degenerate all-identical-workload stream.  Until ``min_obs``
    observations arrive the bucket stays uncalibrated (base constants,
    or the same-K bucket with the nearest chip count) — never
    extrapolate from a single noisy point, and never across group
    sizes.
    """

    def __init__(self, hw: HardwareSpec = V5E, *, decay: float = 0.9,
                 min_obs: int = 2):
        assert 0.0 < decay <= 1.0
        self.hw = hw
        self.decay = decay
        self.min_obs = max(1, int(min_obs))
        # key: (model, chips, K, backbone_dtype, pipeline stages).
        # stages joins the key for the same reason dtype does: a
        # P-stage pipeline step is a different machine program (tick
        # loop + ring handoffs) with a different analytic regressor, so
        # its measurements must not contaminate the dense-step fit.
        self._buckets: Dict[Tuple[str, int, int, str, int],
                            _CalBucket] = {}
        self._hw_cache: Dict[Tuple[str, int, int, str, int],
                             HardwareSpec] = {}
        # measured regroup stalls (pause+migrate+compile+resume), EWMA
        # per base model — the transition-cost term the scheduler prices
        # payback horizons with.  One bucket per model (not per K): the
        # stall is dominated by the rebuilt group's compile, which
        # varies far more across models than across compositions.
        self._regroup: Dict[str, Tuple[float, int]] = {}

    # ------------------------------------------------------------- intake
    def machine_time(self, cfg: ModelConfig, jobs: Sequence[LoRAJobSpec],
                     chips: int, *, backbone_dtype: str = "bf16",
                     stages: int = 1, **kw) -> float:
        """The regressor x: analytic step time minus framework overhead,
        priced with the UNCALIBRATED base constants (repriced for the
        group's backbone storage dtype, and through the pipeline bubble
        model when the group runs stage-partitioned)."""
        hw = with_backbone_dtype(self.hw, backbone_dtype)
        if int(stages) > 1:
            cost = pipeline_step_cost(cfg, jobs, chips, stages=int(stages),
                                      hw=hw, **kw)
        else:
            cost = group_step_cost(cfg, jobs, chips, hw=hw, **kw)
        return cost.total - self.hw.step_overhead

    def observe(self, cfg: ModelConfig, jobs: Sequence[LoRAJobSpec],
                chips: int, measured: float, *,
                backbone_dtype: str = "bf16", stages: int = 1, **kw):
        """Fold one measured step time into its (model, chips, K,
        backbone dtype, stages) bucket."""
        assert measured > 0, measured
        x = self.machine_time(cfg, jobs, chips,
                              backbone_dtype=backbone_dtype,
                              stages=stages, **kw)
        key = (cfg.name, int(chips), len(jobs), backbone_dtype,
               int(stages))
        b = self._buckets.setdefault(key, _CalBucket())
        r = self.decay
        b.sw = b.sw * r + 1.0
        b.sx = b.sx * r + x
        b.sy = b.sy * r + measured
        b.sxx = b.sxx * r + x * x
        b.sxy = b.sxy * r + x * measured
        b.n += 1
        # invalidate the WHOLE spec cache, not just this key: hw_for
        # caches entries for never-observed keys too (base constants or
        # a nearest-bucket borrow), and those must re-derive once a new
        # observation could change what they borrow — stale entries
        # would freeze the scheduler's probe pricing at whatever it saw
        # before calibration engaged
        self._hw_cache.clear()

    # -------------------------------------------------------------- fits
    def fit(self, model: str, chips: int, k: int = 1,
            backbone_dtype: str = "bf16",
            stages: int = 1) -> Optional[Tuple[float, float]]:
        """(alpha, beta) for the bucket, or None while uncalibrated."""
        b = self._buckets.get((model, int(chips), int(k), backbone_dtype,
                               int(stages)))
        if b is None or b.n < self.min_obs or b.sw <= 0:
            return None
        mean_x = b.sx / b.sw
        var_x = max(b.sxx / b.sw - mean_x * mean_x, 0.0)
        alpha = beta = None
        # two-parameter fit only when x is WELL spread (>=3% relative
        # std): near-identical workloads cannot separate slope from
        # intercept, and a hairline spread would amplify measurement
        # noise into an arbitrary slope — distinct batch sizes move x
        # by >=12% on every registered config, so real composition
        # variation clears this easily
        if var_x > (3e-2 * max(mean_x, 1e-12)) ** 2:
            det = b.sw * b.sxx - b.sx * b.sx
            a = (b.sw * b.sxy - b.sx * b.sy) / det
            c = (b.sy - a * b.sx) / b.sw
            if a > 0 and c >= 0:
                alpha, beta = a, c
        if alpha is None:
            # through-origin ratio fit: all overhead folds into alpha
            if b.sxx <= 0:
                return None
            alpha, beta = b.sxy / b.sxx, 0.0
        return (alpha, beta) if alpha > 0 else None

    def _nearest_fit(self, model: str, chips: int, k: int,
                     backbone_dtype: str,
                     stages: int = 1) -> Optional[Tuple[float, float]]:
        """Fall back to the calibrated SAME-K SAME-DTYPE SAME-STAGES
        bucket with the nearest chip count — the scheduler probes chip
        counts it has never run, and effective constants vary slowly
        with scale.  Never borrow across group sizes, backbone dtypes,
        or pipeline depths: those are exactly the composition/program
        errors the bucket key exists to avoid."""
        best, best_d = None, float("inf")
        for (m, c, kb, dt, st), _ in self._buckets.items():
            if m != model or kb != k or dt != backbone_dtype \
                    or st != int(stages):
                continue
            f = self.fit(m, c, kb, dt, st)
            if f is None:
                continue
            d = abs(np.log(max(c, 1) / max(chips, 1)))
            if d < best_d:
                best, best_d = f, d
        return best

    # ------------------------------------------------------------ oracle
    def hw_for(self, model: str, chips: int, k: int = 1,
               backbone_dtype: str = "bf16",
               stages: int = 1) -> HardwareSpec:
        """Calibrated `HardwareSpec` for (model, chips, K, dtype,
        stages); the dtype-repriced base constants when the bucket (and
        every same-K same-dtype same-stages same-model neighbour) is
        still uncalibrated."""
        key = (model, int(chips), int(k), backbone_dtype, int(stages))
        hit = self._hw_cache.get(key)
        if hit is not None:
            return hit
        base = with_backbone_dtype(self.hw, backbone_dtype)
        f = self.fit(model, chips, k, backbone_dtype, stages) \
            or self._nearest_fit(model, chips, k, backbone_dtype, stages)
        if f is None:
            hw = base
        else:
            alpha, beta = f
            hw = dataclasses.replace(
                base,
                mfu_cap=base.mfu_cap / alpha,
                hbm_bw=base.hbm_bw / alpha,
                ici_bw=base.ici_bw / alpha,
                dcn_bw=base.dcn_bw / alpha,
                launch_overhead=base.launch_overhead * alpha,
                sync_latency=base.sync_latency * alpha,
                step_overhead=beta)
        self._hw_cache[key] = hw
        return hw

    def predict(self, cfg: ModelConfig, jobs: Sequence[LoRAJobSpec],
                chips: int, *, backbone_dtype: str = "bf16",
                stages: int = 1, **kw) -> float:
        """Calibrated step-time prediction (falls back to the base oracle
        while uncalibrated)."""
        hw = self.hw_for(cfg.name, chips, len(jobs), backbone_dtype,
                         stages)
        if int(stages) > 1:
            return pipeline_step_cost(cfg, jobs, chips,
                                      stages=int(stages), hw=hw,
                                      **kw).total
        return group_step_cost(cfg, jobs, chips, hw=hw, **kw).total

    # ------------------------------------------------- transition pricing
    def observe_regroup(self, model: str, stall_s: float):
        """Fold one measured regroup stall (pause-to-resume seconds for
        one rebuilt group) into the model's transition-cost estimate."""
        assert stall_s >= 0, stall_s
        mean, n = self._regroup.get(model, (0.0, 0))
        r = self.decay
        mean = stall_s if n == 0 else r * mean + (1 - r) * stall_s
        self._regroup[model] = (mean, n + 1)

    def regroup_cost(self, model: str) -> float:
        """Calibrated one-time cost of rebuilding a group for *model*
        (``hw.regroup_overhead`` until a stall has been measured)."""
        mean, n = self._regroup.get(model, (0.0, 0))
        return mean if n > 0 else self.hw.regroup_overhead

    # -------------------------------------------------------- persistence
    def save(self, path: str):
        """Persist the calibration tables (JSON) — step-time buckets,
        regroup stalls, and the base constants they regress against —
        so a fresh controller warm-starts with this machine's fits."""
        import json
        import os
        payload = {
            "decay": self.decay,
            "min_obs": self.min_obs,
            "hw": dataclasses.asdict(self.hw),
            "buckets": [
                {"model": m, "chips": c, "k": k, "dtype": dt,
                 "stages": st, "sw": b.sw, "sx": b.sx,
                 "sy": b.sy, "sxx": b.sxx, "sxy": b.sxy, "n": b.n}
                for (m, c, k, dt, st), b in self._buckets.items()],
            "regroup": {m: {"mean": mean, "n": n}
                        for m, (mean, n) in self._regroup.items()},
        }
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(payload, f, indent=1)

    @classmethod
    def load(cls, path: str) -> "OnlineCalibrator":
        """Rehydrate a calibrator saved with :meth:`save`.  The fits are
        bit-identical to the saved instance's (the accumulators round-
        trip as floats), and the restored base ``HardwareSpec`` keeps
        the fit's frame of reference intact."""
        import json
        with open(path) as f:
            d = json.load(f)
        cal = cls(HardwareSpec(**d["hw"]), decay=d["decay"],
                  min_obs=d["min_obs"])
        for b in d["buckets"]:
            key = (b["model"], int(b["chips"]), int(b["k"]),
                   b.get("dtype", "bf16"),   # pre-quant files: all bf16
                   int(b.get("stages", 1)))  # pre-pipeline files: dense
            cal._buckets[key] = \
                _CalBucket(sw=b["sw"], sx=b["sx"], sy=b["sy"],
                           sxx=b["sxx"], sxy=b["sxy"], n=int(b["n"]))
        for m, r in d.get("regroup", {}).items():
            cal._regroup[m] = (float(r["mean"]), int(r["n"]))
        return cal

    @property
    def calibrated(self) -> bool:
        return any(self.fit(m, c, k, dt, st) is not None
                   for m, c, k, dt, st in self._buckets)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for (m, c, k, dt, st), b in self._buckets.items():
            f = self.fit(m, c, k, dt, st)
            tag = f"{m}@{c}xK{k}:{dt}" + (f":P{st}" if st > 1 else "")
            out[tag] = {
                "observations": b.n,
                "alpha": f[0] if f else float("nan"),
                "beta": f[1] if f else float("nan"),
            }
        return out
