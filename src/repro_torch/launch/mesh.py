"""The device arithmetic of the cluster controller's submesh partitioner
(port of the jax-free part of ``repro.launch.mesh``): how many devices
each group gets, and which pipeline depths a device slice takes.  The
meshes themselves wait for the multi-GPU slice (ROADMAP queue A)."""
from __future__ import annotations

import math
from typing import List, Sequence


def device_shares(weights: Sequence[float], n_devices: int) -> List[int]:
    """Device counts for per-group submeshes, honoring the scheduler's
    chip assignments (*weights*).

    Weighted max-min fill: every group gets at least one device, no
    group gets more than its assignment (cap = ceil(weight) — the
    scheduler already decided how many chips the group deserves; extra
    pool devices stay FREE for arrivals rather than over-sharding
    running groups), and while devices and headroom remain the next
    device goes to the group with the highest weight-per-allocated-
    device ratio.  Returns all-zeros when the pool cannot give every
    group a device (the controller falls back to time-multiplexed
    meshless execution).  Pure arithmetic — no jax.
    """
    k = len(weights)
    if k == 0:
        return []
    if n_devices < k:
        return [0] * k
    w = [max(float(x), 1e-9) for x in weights]
    caps = [max(1, int(math.ceil(x))) for x in w]
    shares = [1] * k
    left = min(n_devices, sum(caps)) - k
    while left > 0:
        best, best_r = -1, -1.0
        for i in range(k):
            if shares[i] >= caps[i]:
                continue
            r = w[i] / shares[i]
            if r > best_r:
                best, best_r = i, r
        if best < 0:
            break
        shares[best] += 1
        left -= 1
    assert sum(shares) <= n_devices
    assert all(1 <= s <= c for s, c in zip(shares, caps))
    return shares


def legal_stage_counts(n_devices: int) -> List[int]:
    """Stage counts that evenly tile an *n_devices* slice: its divisors."""
    return [p for p in range(1, n_devices + 1) if n_devices % p == 0]


def _check_stages(stages: int, n_devices: int, what: str) -> int:
    """Validate a pipeline depth against a device slice.

    Unlike the model-axis CLAMP in ``make_local_mesh`` (where a weaker
    degree is still the same program), silently lowering a pipeline
    depth would change which schedule the caller benchmarked/priced —
    so the partitioner REJECTS non-divisors, naming the legal choices.
    """
    stages = int(stages)
    if stages < 1:
        raise ValueError(f"stages must be >= 1, got {stages}")
    if n_devices % stages:
        raise ValueError(
            f"stages={stages} does not divide the {what} of {n_devices} "
            f"device(s); legal stage counts: {legal_stage_counts(n_devices)}")
    return stages
