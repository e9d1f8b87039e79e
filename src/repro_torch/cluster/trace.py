"""Workload traces: ACMETrace-style synthetic generator + CSV loader: a
copy of ``repro.cluster.trace`` for the port, held to it by the tests.
Job chip floors come from the throughput copy's default spec
(``_model_min_chips``), as in the reference.  ``executable=True`` names
``cluster/execution``, which comes with cluster control (ROADMAP queue
A, "Cluster control"); until then it raises ``ImportError``.

The paper replays ``trace_seren.csv`` from ACMETrace (Hu et al., NSDI'24)
and samples LoRA attributes on top (rank ∈ {2,4,8,16}, batch ∈ {1,2,4,8},
per §4.1).  The dataset is not shipped offline, so the default source is
a statistically matched generator reproducing the trace features the
evaluation depends on:

  * Poisson arrivals whose rate scales month-over-month (~1x, 2x, 4x
    concurrency in months 1-3 — Fig. 8b),
  * bursty clustering (arrivals arrive in small bursts),
  * log-normal step budgets / durations, GPU allocations in {1,2,4,8}.

``load_csv`` ingests the real ACMETrace file when available, mapping the
same columns, so results regenerate against the genuine trace.
"""
from __future__ import annotations

import csv
import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.jobs import LoRAJobSpec

RANKS = (2, 4, 8, 16)            # paper §4.1
BATCHES = (1, 2, 4, 8)
GPUS = (1, 2, 4, 8)
MONTH = 30 * 24 * 3600.0


@dataclass(frozen=True)
class TraceConfig:
    months: int = 1
    jobs_per_month: int = 2000
    month_rate_mult: Sequence[float] = (1.0, 2.0, 4.0)   # Fig. 8b
    burst_size_mean: float = 2.5
    seq_len: int = 512
    steps_mean: float = 5000.0
    steps_sigma: float = 0.8
    max_slowdown: float = 1.5
    # paper pairs Llama-3-8B / Qwen-3-8B; closest pool members:
    base_models: Sequence[str] = ("recurrentgemma-9b", "mamba2-2.7b")
    seed: int = 0


def _model_min_chips(model: str) -> int:
    from repro_torch.configs.registry import get_config
    from repro_torch.core.throughput import min_chips
    return min_chips(get_config(model))


class TraceValidationError(ValueError):
    """A trace is infeasible for the target pool/backend — raised at
    LOAD time with the offending jobs named, instead of failing deep
    inside mesh partitioning or backbone init hours into a replay."""


def validate_trace(jobs: Sequence[LoRAJobSpec], *,
                   pool_chips: Optional[int] = None,
                   executable: bool = False,
                   models: Optional[Sequence[str]] = None,
                   max_errors: int = 5) -> List[LoRAJobSpec]:
    """Fail fast on infeasible jobs.

    ``pool_chips`` rejects any job whose chip demand exceeds the pool;
    ``executable=True`` rejects base models outside
    ``cluster.execution.executable_models()`` (the live-controller
    backend); ``models`` supplies an explicit allowlist instead.  All
    checks are opt-in because analytic simulations (fig8b/fig9) legally
    replay models far larger than the executable registry."""
    allowed = None
    if models is not None:
        allowed = set(models)
    elif executable:
        from repro_torch.cluster.execution import executable_models
        allowed = set(executable_models())
    errs = []
    for j in jobs:
        if pool_chips is not None and j.gpus > pool_chips:
            errs.append(f"{j.job_id}: demands {j.gpus} chips but the "
                        f"pool has {pool_chips}")
        if allowed is not None and j.base_model not in allowed:
            errs.append(f"{j.job_id}: base model {j.base_model!r} not "
                        f"runnable here (allowed: {sorted(allowed)})")
        if len(errs) > max_errors:
            errs.append("...")
            break
    if errs:
        raise TraceValidationError(
            f"{len(errs)} infeasible trace job(s): " + "; ".join(errs))
    return list(jobs)


def generate(cfg: TraceConfig = TraceConfig(), *,
             pool_chips: Optional[int] = None,
             executable: bool = False) -> List[LoRAJobSpec]:
    rng = np.random.default_rng(cfg.seed)
    jobs: List[LoRAJobSpec] = []
    jid = 0
    for m in range(cfg.months):
        mult = cfg.month_rate_mult[m % len(cfg.month_rate_mult)]
        n = int(cfg.jobs_per_month * mult)
        t = m * MONTH
        while len([j for j in jobs if j.arrival_time >= m * MONTH]) < n:
            # bursts: geometric burst size at exponential burst gaps
            burst = 1 + rng.geometric(1.0 / cfg.burst_size_mean)
            gap = rng.exponential(MONTH / max(n / cfg.burst_size_mean, 1))
            t += gap
            if t >= (m + 1) * MONTH:
                break
            for _ in range(int(burst)):
                model = str(rng.choice(cfg.base_models))
                gpus = max(int(rng.choice(GPUS)), _model_min_chips(model))
                jobs.append(LoRAJobSpec(
                    job_id=f"job-{jid:05d}",
                    rank=int(rng.choice(RANKS)),
                    batch_size=int(rng.choice(BATCHES)),
                    seq_len=cfg.seq_len,
                    base_model=model,
                    gpus=gpus,
                    steps_budget=int(np.clip(
                        rng.lognormal(np.log(cfg.steps_mean),
                                      cfg.steps_sigma), 50, 100_000)),
                    arrival_time=float(t + rng.uniform(0, 60)),
                    max_slowdown=cfg.max_slowdown,
                ))
                jid += 1
    jobs.sort(key=lambda j: j.arrival_time)
    return validate_trace(jobs, pool_chips=pool_chips,
                          executable=executable)


def scale_arrivals(jobs: Sequence[LoRAJobSpec],
                   factor: float) -> List[LoRAJobSpec]:
    """Replay the same trace with arrivals `factor`x sooner (Fig. 9a)."""
    return [dataclasses.replace(j, arrival_time=j.arrival_time / factor)
            for j in jobs]


def month_slice(jobs: Sequence[LoRAJobSpec], month: int) -> List[LoRAJobSpec]:
    lo, hi = month * MONTH, (month + 1) * MONTH
    out = [dataclasses.replace(j, arrival_time=j.arrival_time - lo)
           for j in jobs if lo <= j.arrival_time < hi]
    return sorted(out, key=lambda j: j.arrival_time)


def load_csv(path: str, *, seed: int = 0,
             max_jobs: Optional[int] = None,
             pool_chips: Optional[int] = None,
             executable: bool = False) -> List[LoRAJobSpec]:
    """Load ACMETrace trace_seren.csv (submit_time, duration, gpu_num
    columns) and sample LoRA attributes per the paper's recipe.
    ``pool_chips``/``executable`` validate feasibility at load time
    (``validate_trace``)."""
    rng = np.random.default_rng(seed)
    jobs = []
    with open(path) as f:
        for i, row in enumerate(csv.DictReader(f)):
            if max_jobs and i >= max_jobs:
                break
            dur = float(row.get("duration", 3600.0))
            jobs.append(LoRAJobSpec(
                job_id=f"acme-{i:05d}",
                rank=int(rng.choice(RANKS)),
                batch_size=int(rng.choice(BATCHES)),
                gpus=max(1, min(8, int(float(row.get("gpu_num", 1))))),
                steps_budget=max(50, int(dur / 2.0)),
                arrival_time=float(row.get("submit_time", 0.0)),
            ))
    jobs.sort(key=lambda j: j.arrival_time)
    return validate_trace(jobs, pool_chips=pool_chips,
                          executable=executable)
