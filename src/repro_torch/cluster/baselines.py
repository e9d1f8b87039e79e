"""Grouping-policy baselines of the evaluation (paper §4.1): a copy of
``repro.cluster.baselines`` for the port, held to it by the tests.

  * megatron  — isolated jobs, no co-location (Megatron-LM trains each
    LoRA job independently on its own allocation).
  * mlora     — FIFO memory-cap batching: co-locate arrivals in order as
    long as device memory permits; no heterogeneity awareness, no
    slowdown constraint (Ye et al., 2025).
  * tlora              — full system (Algorithm 1 + fused kernel).
  * tlora_no_scheduler — SSM + fused kernel, but mLoRA's grouping policy.
  * tlora_no_kernel    — Algorithm 1 scheduling, unfused per-adapter
    kernels (prices the Fig. 7 ablation).
"""
from __future__ import annotations

from typing import Callable, Dict, List

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.jobs import JobRuntimeState
from repro_torch.core.scheduler import Group
from repro_torch.core import throughput as tp
from repro_torch.cluster.simulator import (ClusterConfig,
                                           ClusterSimulator, GroupPolicy,
                                           tlora_policy, _node_assigner)


def megatron_policy(jobs: List[JobRuntimeState], cc: ClusterConfig,
                    pressure: bool = False) -> List[Group]:
    return [Group([j], max(j.spec.gpus, 1)) for j in jobs]


def _act_mem_gb(cfg: ModelConfig, state: JobRuntimeState) -> float:
    """Activation + optimizer memory one job adds to a shared replica."""
    act = state.spec.batch_size * state.spec.seq_len * cfg.d_model \
        * cfg.num_layers * 2 * 2 / 1e9
    opt = 3 * 4 * tp.lora_param_count(cfg, state.spec.rank) / 1e9
    return act + opt


def mlora_policy(cfg_of: Callable[[str], ModelConfig],
                 mem_cap_gb: float = 16.0) -> GroupPolicy:
    """mLoRA-style FIFO batching: co-locate arrivals in order onto ONE
    shared model replica (chips = the largest member's allocation) as long
    as device memory permits — one weight copy + per-job activations.  No
    heterogeneity awareness, no slowdown bound (Ye et al., 2025)."""
    def policy(jobs: List[JobRuntimeState], cc: ClusterConfig,
               pressure: bool = False, max_group: int = 6) -> List[Group]:
        by_model: Dict[str, List[JobRuntimeState]] = {}
        for j in sorted(jobs, key=lambda s: s.spec.arrival_time):
            by_model.setdefault(j.spec.base_model, []).append(j)
        groups: List[Group] = []
        for model, js in by_model.items():
            cfg = cfg_of(model)
            total, _ = tp.param_counts(cfg)
            weights_gb = total * 2 / 1e9
            node_of = _node_assigner(js, cc)
            cur: List[JobRuntimeState] = []
            cur_chips = 0
            cur_mem = weights_gb
            for j in js:
                act = _act_mem_gb(cfg, j)
                chips = cur_chips + j.spec.gpus
                if cur and (cur_mem + act > mem_cap_gb * chips
                            or len(cur) >= max_group):
                    groups.append(_mk(cur, cur_chips, node_of))
                    cur, cur_chips, cur_mem = [], 0, weights_gb
                cur.append(j)
                cur_chips += j.spec.gpus
                cur_mem += act
            if cur:
                groups.append(_mk(cur, cur_chips, node_of))
        return groups
    return policy


def _mk(jobs: List[JobRuntimeState], chips: int, node_of) -> Group:
    nodes = {node_of(j.spec.job_id) for j in jobs}
    return Group(list(jobs), chips, spans_nodes=len(nodes) > 1)


def make_simulator(system: str, cluster: ClusterConfig) -> ClusterSimulator:
    """system ∈ {megatron, mlora, tlora, tlora_no_scheduler,
    tlora_no_kernel}."""
    def cfg_of(model: str) -> ModelConfig:
        cfg = get_config(model)
        return cfg.reduced() if cluster.reduced_models else cfg

    if system == "megatron":
        cc = ClusterConfig(**{**cluster.__dict__, "kernel_fused": True})
        return ClusterSimulator(cc, megatron_policy, cfg_of)
    if system == "mlora":
        # mLoRA batches but executes adapters unfused (simple heuristics)
        cc = ClusterConfig(**{**cluster.__dict__, "kernel_fused": False})
        return ClusterSimulator(cc, mlora_policy(cfg_of), cfg_of)
    if system == "tlora":
        cc = ClusterConfig(**{**cluster.__dict__, "kernel_fused": True})
        return ClusterSimulator(cc, tlora_policy(cfg_of, True), cfg_of)
    if system == "tlora_no_scheduler":
        cc = ClusterConfig(**{**cluster.__dict__, "kernel_fused": True})
        return ClusterSimulator(cc, mlora_policy(cfg_of), cfg_of)
    if system == "tlora_no_kernel":
        cc = ClusterConfig(**{**cluster.__dict__, "kernel_fused": False})
        return ClusterSimulator(cc, tlora_policy(cfg_of, False), cfg_of)
    raise ValueError(f"unknown system {system!r}")


SYSTEMS = ("megatron", "mlora", "tlora", "tlora_no_scheduler",
           "tlora_no_kernel")
