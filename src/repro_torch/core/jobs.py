"""LoRA job specifications and the scheduler's view of a running job
(port of ``repro.core.jobs``; framework-free)."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

DEFAULT_TARGETS = ("q", "k", "v", "o")   # per paper: attention projections


def tile_rows(batch_size: int, seq_len: int, block_t: int,
              shards: int = 1) -> int:
    """Tile-aligned (and shard-aligned) row count for one job's segment.

    The fused-kernel contract needs every job's token count to be a
    multiple of ``block_t``; under sharded execution the same holds per
    data shard, so the per-shard row count must itself be tile-aligned.
    Padding rows carry the owning job's adapter id and contribute exact
    zeros downstream.
    """
    assert shards >= 1
    if shards == 1 and batch_size * seq_len % block_t == 0:
        return batch_size
    # smallest per-shard row granule whose token count is tile-aligned
    lcm = block_t // math.gcd(block_t, seq_len)
    granule = lcm * shards
    return ((batch_size + granule - 1) // granule) * granule


@dataclass(frozen=True)
class LoRAJobSpec:
    """One LoRA fine-tuning job as submitted to the cluster."""
    job_id: str
    rank: int                              # r_i  (paper samples from {2,4,8,16})
    batch_size: int                        # per-job batch (paper: {1,2,4,8})
    seq_len: int = 512
    alpha: float = 16.0                    # LoRA scaling numerator
    target_modules: Tuple[str, ...] = DEFAULT_TARGETS
    base_model: str = "tinyllama-1.1b"
    # cluster attributes (fixed at submission, per paper A.1)
    gpus: int = 1
    steps_budget: int = 1000
    arrival_time: float = 0.0
    max_slowdown: float = 1.5              # Δ_j^max: bounded-slowdown constraint

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank


@dataclass
class JobRuntimeState:
    """Mutable scheduler-side view of a job (urgency, residuals, progress)."""
    spec: LoRAJobSpec
    steps_done: int = 0
    standalone_step_time: float = 0.0      # profiled isolated iteration time
    current_step_time: float = 0.0         # observed in current group
    queue_time: float = 0.0
    start_time: Optional[float] = None
    finish_time: Optional[float] = None

    @property
    def done(self) -> bool:
        return self.steps_done >= self.spec.steps_budget

    def slowdown(self) -> float:
        """Δ_j: observed step-time inflation vs standalone execution."""
        if self.standalone_step_time <= 0 or self.current_step_time <= 0:
            return 1.0
        return self.current_step_time / self.standalone_step_time

    def urgency(self) -> float:
        """u_j: proximity to violating the progress constraint (paper §3.4).

        >1 means the job is already past its bound; higher sorts earlier.
        """
        return self.slowdown() / max(self.spec.max_slowdown, 1e-9)
