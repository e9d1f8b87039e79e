"""Device meshes over ``torch.distributed`` (port of
``repro.launch.mesh``) and the device arithmetic of the cluster
controller's submesh partitioner.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks
of an initialized world, one rank a shard: ``init_mesh`` starts the
world on an explicit backend ("nccl" when every rank owns a GPU, "gloo"
on the CPU or when ranks share one GPU: NCCL refuses two ranks on one
device), ``make_local_mesh`` lays the world out as a ("data", "model")
mesh, and ``data_group`` gives the process group, shard count and shard
index the data-parallel step reduces over (every mesh axis folded into
rows, the reference's ``tp_mode="dp"``).  ``stage_mesh``,
``partition_mesh`` and ``make_production_mesh`` wait for pipeline mode
and the multi-device controller (ROADMAP A7b, A7e).
"""
from __future__ import annotations

import math
from datetime import timedelta
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
TIMEOUT_S = 300.0


def init_mesh(rank: int, world: int, init_method: str, backend: str, *,
              device_type: str = "cpu"):
    """Join the world as *rank* of *world* at *init_method* (``file://``
    or ``tcp://localhost:<port>``) on *backend*, then return
    ``make_local_mesh(device_type=device_type)``; a collective waits at
    most ``TIMEOUT_S`` for its peers.  The backend is never
    chosen here: "nccl" needs a GPU of its own for every rank (rank r
    takes ``cuda:r``) and is refused otherwise, naming "gloo" as the
    choice for ranks that share a device."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    kw = {}
    if backend == "nccl":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < world:
            raise RuntimeError(
                f"backend 'nccl' needs a GPU for each of {world} ranks, "
                f"this host has {n}: NCCL refuses two ranks on one "
                "device; ranks that share a GPU take 'gloo'")
        torch.cuda.set_device(rank)
        kw["device_id"] = torch.device("cuda", rank)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=TIMEOUT_S), **kw)
    return make_local_mesh(device_type=device_type)


def clamp_model(model: int, n: int) -> int:
    """The model-parallel degree a mesh of *n* ranks takes for a request
    of *model*: the largest divisor of n that is <= model (at least 1),
    so that a (n // model, model) mesh covers exactly all n ranks."""
    model = max(1, min(int(model), n))
    while n % model:
        model -= 1
    return model


def make_local_mesh(model: int = 1, device_type: str = "cpu"):
    """A ("data", "model") mesh over every rank of the initialized
    world, the model degree clamped to a divisor of the world size
    (``clamp_model``).  *device_type* names the devices the ranks
    compute on ("cuda" or "cpu"); gloo ranks sharing one GPU pass
    "cpu": the mesh only lays out ranks, and the runtime's ``device``
    places the tensors."""
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    m = clamp_model(model, n)
    return init_device_mesh(device_type, (n // m, m),
                            mesh_dim_names=("data", "model"))


def data_group(mesh) -> Tuple[object, int, int]:
    """(process group, shard count D, this rank's shard index) of the
    data-parallel step over *mesh*: every mesh axis folds into row
    sharding, shards ordered by the group's ranks.  A one-dimensional
    mesh reduces over its own group, a mesh over the whole world over
    the world; a multi-dimensional mesh over part of the world waits for
    the multi-device controller (ROADMAP A7e)."""
    ranks = mesh.mesh.flatten().tolist()
    if mesh.ndim == 1:
        group = mesh.get_group()
    elif ranks == list(range(dist.get_world_size())):
        group = dist.group.WORLD
    else:
        raise NotImplementedError(
            "a multi-dimensional mesh over part of the world is not "
            "ported yet (ROADMAP A7e: multi-GPU controller)")
    return group, len(ranks), dist.get_rank(group)


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
