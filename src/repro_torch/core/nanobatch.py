"""Adaptive nano-batching: the AIMD controller of paper §3.3 (Eq. 2), a
port of ``repro.core.nanobatch``.

    N_{t+1} = N_t + alpha            if T_t <= T_{t-1} - tau
            = max(1, floor(beta N))  otherwise

The controller is host-side: it reads end-to-end step wall time and
emits the next N, snapped to the nearest legal value (divisors of the
fused row count, or an explicit ``legal`` list).  The runtime feeds it
once per chunk with the chunk's mean step time: N is constant within a
chunk, so the mean is a lower-variance sample of the quantity Eq. 2
reads.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from repro_torch.core.ssm import valid_nano_counts


@dataclass
class AIMDController:
    rows: int                       # fused batch rows (defines legal N)
    alpha: int = 4                  # additive step (paper default)
    beta: float = 0.5               # multiplicative backoff (paper default)
    tau_frac: float = 0.02          # stability margin, fraction of T
    n: int = 1                      # current nano-batch count
    max_n: Optional[int] = None
    # explicit legal-N override (e.g. divisors pre-filtered to the CUDA
    # kernels' token-tile rule), so AIMD never proposes a granulation
    # the kernels refuse
    legal: Optional[List[int]] = None

    _last_t: Optional[float] = field(default=None, repr=False)
    history: List[tuple] = field(default_factory=list, repr=False)

    def __post_init__(self):
        # `is not None`: an explicitly empty override fails here, not
        # later inside a step
        self._legal = (list(self.legal) if self.legal is not None
                       else valid_nano_counts(self.rows, self.max_n))
        assert self._legal, (self.rows, self.max_n, self.legal)
        self.n = self._snap(self.n)

    def _snap(self, n: int) -> int:
        return min(self._legal, key=lambda v: (abs(v - n), v))

    def update(self, step_time: float) -> int:
        """Feed the measured end-to-end batch time; returns next N."""
        prev = self._last_t
        if prev is None:
            # first observation: probe upward
            nxt = self._snap(self.n + self.alpha)
        else:
            tau = self.tau_frac * prev
            if step_time <= prev - tau:
                nxt = self._snap(self.n + self.alpha)      # additive increase
            elif step_time > prev + tau:
                nxt = self._snap(max(1, int(self.beta * self.n)))  # back off
            else:
                nxt = self.n                               # within noise band
        self.history.append((self.n, step_time))
        self._last_t = step_time
        self.n = nxt
        return nxt

    def converged(self, window: int = 4) -> bool:
        if len(self.history) < window:
            return False
        ns = [n for n, _ in self.history[-window:]]
        return len(set(ns)) == 1


def pipeline_tick_counts(nanos_per_job, stages: int):
    """(multi-job, per-job-GPipe) tick counts for one fused pipeline step
    over a *stages*-deep stage partition: the fused schedule fills and
    drains once per step, ``sum(N_j) + P - 1`` ticks; per-job GPipe pays
    the ramp once per job, ``sum(N_j + P - 1)``."""
    P = int(stages)
    ns = [int(n) for n in nanos_per_job]
    assert P >= 1 and all(n >= 1 for n in ns) and ns, (ns, P)
    multi = sum(ns) + P - 1
    gpipe = sum(n + P - 1 for n in ns)
    return multi, gpipe


def simulate_step_time(n: int, *, t_comp: float, t_comm: float,
                       launch_overhead: float = 2e-4) -> float:
    """Analytic Eq. 1 model used to exercise AIMD without hardware: per-
    nano compute and comm overlap except for the first nano's comm
    exposure, plus per-launch overhead.

        T(N) = max(T_comp, T_comm) + min(T_comp, T_comm)/N + c*N
    """
    bubble = min(t_comp, t_comm) / n
    return max(t_comp, t_comm) + bubble + launch_overhead * n


def optimal_nano(rows: int, *, t_comp: float, t_comm: float,
                 launch_overhead: float = 2e-4,
                 max_n: Optional[int] = None) -> int:
    legal = valid_nano_counts(rows, max_n)
    return min(legal, key=lambda n: simulate_step_time(
        n, t_comp=t_comp, t_comm=t_comm, launch_overhead=launch_overhead))
