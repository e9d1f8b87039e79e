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
rows, the reference's ``tp_mode="dp"``; with ``tp_mode="auto"`` the
"data" axis only), ``model_group`` the tensor-parallel "model" axis's.

The cluster controller's pool is the world's ranks (pool index i is
rank i).  ``partition_mesh`` carves it into disjoint 1-D submeshes, one
per group, over process groups that ``subgroup`` creates once per rank
tuple: ``torch.distributed.new_group`` is collective over the whole
world, so every rank, member or not, asks for every slice in the same
order, and a repartition back to a slice seen before reuses its
communicator.  ``control_group`` is a separate gloo group over the world
for the controller's own collectives (agreement on decisions, state
moves): gloo does not order two threads' calls on one group, and the
slices' groups belong to the groups' chunk pumps.

Pipeline mode (``tp_mode="pipeline"``) lays a slice of P·D ranks out as
a (stage, data) ``StageMesh`` (``stage_mesh``): stage s is the run of D
ranks ``[s·D, (s+1)·D)`` of the slice, as in the reference.  Its
process groups are one data group per stage (the shard-local kernels'
gathers and the denominators), one group per pair of neighbouring
stages at each data index (the activation and cotangent handoff), one
column group per data index (the stages' end-of-step reduction) and
one over the whole slice.  Like every group here they are made by every
rank of the world, in one fixed order (``_stage_group_keys``): over the
whole world ``stage_mesh`` makes them itself; a slice of a pool gets
them from ``partition_mesh(stages=)``, which every rank calls for every
slice.

``make_production_mesh`` is the reference's dry-run target, the (16, 16)
("data", "model") mesh or the (2, 16, 16) one with "pod", over a world
of 256 or 512 ranks; ``fake_world`` makes such a world in one process
on torch's "fake" backend (collectives return at once and move nothing),
for the dry run's analysis of one rank's step (``launch/dryrun``).
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from datetime import timedelta
from typing import Dict, List, Optional, Sequence, Tuple

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


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh over the initialized world: (16,
    16) ("data", "model") over 256 ranks, or (2, 16, 16) ("pod", "data",
    "model") over 512 (``src/repro/launch/mesh.py:15``)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise ValueError(f"the production mesh {shape} needs a world of "
                         f"{n} ranks, this one has {dist.get_world_size()}")
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


@contextlib.contextmanager
def fake_world(world: int, rank: int):
    """A world of *world* ranks seen from *rank*, in this process alone,
    on torch's "fake" backend (``FakeStore``: no peer, collectives
    return at once and move nothing), destroyed on exit.  A process that
    already has a process group is refused: the analysis must never run
    over a real group (or leave one behind)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: this process already has a process "
                           "group; a dry run takes a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def clamp_model(model: int, n: int) -> int:
    """The model-parallel degree a mesh of *n* ranks takes for a request
    of *model*: the largest divisor of n that is <= model (at least 1),
    so that a (n // model, model) mesh covers exactly all n ranks."""
    model = max(1, min(int(model), n))
    while n % model:
        model -= 1
    return model


def make_local_mesh(model: int = 1, device_type: str = "cpu",
                    stages: int = 1):
    """A ("data", "model") mesh over every rank of the initialized
    world, the model degree clamped to a divisor of the world size
    (``clamp_model``).  *device_type* names the devices the ranks
    compute on ("cuda" or "cpu"); gloo ranks sharing one GPU pass
    "cpu": the mesh only lays out ranks, and the runtime's ``device``
    places the tensors.

    ``stages`` is clamped the same way against the data slice n // m,
    as in the reference; more than one stage gives the (stage, data,
    model) ``StageMesh`` over the world (rank s·D·m + d·m + i is stage
    s, data index d, model index i).  As in the reference's pipeline
    step, whose ``shard_map`` names only "stage" and "data", a model
    rank is a replica of its (stage, data) rank: the same rows and the
    same whole stage weights."""
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    m = clamp_model(model, n)
    p = clamp_model(stages, n // m)
    if p > 1:
        return stage_mesh(list(range(n)), p, model=m)
    return init_device_mesh(device_type, (n // m, m),
                            mesh_dim_names=("data", "model"))


def data_group(mesh, axis: Optional[str] = None
               ) -> Tuple[object, int, int]:
    """(process group, shard count D, this rank's shard index) of the
    data-parallel rows over *mesh*.

    ``axis`` None (``tp_mode="dp"``): every mesh axis folds into row
    sharding, shards ordered by the group's ranks.  A one-dimensional
    mesh reduces over its own group, a mesh over the whole world over
    the world, a ``StageMesh`` over this rank's stage's data group.  A
    multi-dimensional DeviceMesh over part of the world is refused: its
    ranks' group would have to be created by every rank of the world,
    which the ranks outside it never reach here; the controller's
    slices are 1-D (``partition_mesh``).

    ``axis`` named (``tp_mode="auto"``): rows over that axis only, the
    group of this rank's column of it (the ranks that share its other
    coordinates: on a ("data", "model") mesh, its model index), which
    the DeviceMesh made for every rank when it was built.  A "pod" axis
    folds into "data", as the rules' batch axes fold them: the rows go
    over the flattened ("pod", "data") submesh, pod-major (every rank
    makes its group, in the same order)."""
    if isinstance(mesh, StageMesh):
        return mesh.data_group, mesh.data, mesh.shard
    if axis is not None and mesh.ndim > 1:
        names = mesh.mesh_dim_names
        if axis == "data" and "pod" in names:
            flat = mesh["pod", "data"]._flatten()
            return flat.get_group(), flat.size(), flat.get_local_rank()
        return (mesh.get_group(axis), mesh.size(names.index(axis)),
                mesh.get_local_rank(axis))
    ranks = mesh.mesh.flatten().tolist()
    if mesh.ndim == 1:
        group = mesh.get_group()
    elif ranks == list(range(dist.get_world_size())):
        group = dist.group.WORLD
    else:
        raise NotImplementedError(
            "a multi-dimensional mesh over part of the world has no group "
            "every rank created; carve 1-D slices with partition_mesh")
    return group, len(ranks), dist.get_rank(group)


def model_group(mesh) -> Tuple[object, int, int]:
    """(process group, model degree m, this rank's model index) of the
    tensor-parallel axis of *mesh* (``tp_mode="auto"``): the ranks that
    share this rank's data index.  A mesh without the axis (the
    controller's 1-D slices, a ``StageMesh``) has m = 1 and no group:
    "auto" then runs the data-parallel step over its data axis, as the
    reference's slices do."""
    if isinstance(mesh, StageMesh) or "model" not in (mesh.mesh_dim_names
                                                      or ()):
        return None, 1, 0
    return (mesh.get_group("model"),
            mesh.size(mesh.mesh_dim_names.index("model")),
            mesh.get_local_rank("model"))


# process groups by (ranks, backend, tag), for the world they were made in
_GROUPS: Dict[tuple, object] = {}
_GROUPS_WORLD: List[object] = [None]


def subgroup(ranks: Sequence[int], backend: Optional[str] = None,
             tag: str = ""):
    """The process group over *ranks* of the world (on *backend*, the
    world's by default), created on first use and cached by (ranks,
    backend, tag).  ``dist.new_group`` is collective over the whole
    world: every rank calls this for every group in the same order,
    member or not; a rank outside *ranks* gets the non-member sentinel.
    The cache is the world's: a new world starts an empty one."""
    if _GROUPS_WORLD[0] is not dist.group.WORLD:
        _GROUPS.clear()
        _GROUPS_WORLD[0] = dist.group.WORLD
    key = (tuple(int(r) for r in ranks), backend, tag)
    if key not in _GROUPS:
        _GROUPS[key] = dist.new_group(list(key[0]), backend=backend)
    return _GROUPS[key]


def control_group():
    """A gloo group over every rank of the world, for the controller's
    own collectives on its control thread (agreement, state moves); no
    chunk pump uses it."""
    return subgroup(range(dist.get_world_size()), backend="gloo",
                    tag="control")


def partition_mesh(sizes: Sequence[int], ranks: Optional[Sequence[int]] = None,
                   axis: str = "data", stages: int = 1,
                   device_type: str = "cpu") -> List:
    """Partition the pool of *ranks* (default: the world's) into disjoint
    1-D per-group submeshes.

    ``sizes[i]`` ranks (consecutive in pool order, so groups that keep
    their size keep their ranks across repartitions) become one
    ``(sizes[i],)`` mesh over *axis*, which ``data_group`` reduces over.
    Every rank calls this with the same arguments (``subgroup``): the
    returned list holds this rank's submesh where it is a member and
    None elsewhere.

    ``stages`` > 1 asserts that every slice can be carved into that many
    pipeline stages: a ValueError naming the legal divisors fires HERE,
    at partition time.  The returned submeshes stay 1-D (the runtime
    owns the (stage, data) reshape, ``stage_mesh``), but every rank
    makes each slice's stage groups here, so that the slice's own ranks
    can carve it later without the rest of the world.  *device_type*
    names the devices the ranks compute on, as in ``make_local_mesh``."""
    from torch.distributed.device_mesh import DeviceMesh
    ranks = list(range(dist.get_world_size())) if ranks is None \
        else [int(r) for r in ranks]
    assert all(s >= 1 for s in sizes), sizes
    assert sum(sizes) <= len(ranks), (sizes, len(ranks))
    for s in sizes:
        _check_stages(stages, int(s), "group slice")
    me = dist.get_rank()
    out, cur = [], 0
    for s in sizes:
        part = ranks[cur:cur + s]
        cur += s
        group = subgroup(part)
        if stages > 1:
            for key, tag in _stage_group_keys(part, stages):
                subgroup(key, tag=tag)
        out.append(DeviceMesh.from_group(
            group, device_type, mesh=torch.tensor(part),
            mesh_dim_names=(axis,)) if me in part else None)
    return out


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


# -------------------------------------------------------- pipeline mode
@dataclass(frozen=True)
class StageMesh:
    """A group's slice laid out as (stage, data) for pipeline mode, seen
    from one of its ranks: ``ranks[s][d]`` is the global rank of stage
    s, data index d.  The groups are this rank's: its stage's data group
    (D ranks), its column (the P stages at its data index, in stage
    order), the pairs it shares with the previous and the next stage at
    its data index (None at the ends) and the whole slice.

    With a model axis (``model`` > 1, the (stage, data, model) mesh of
    ``make_local_mesh(model=, stages=)``) the slice holds ``model``
    replicas of that (stage, data) grid: ``ranks`` and every group above
    are this rank's replica's (model index ``model_index``), so its
    handoffs and data groups stay within one model index;
    ``model_group`` is the ``model`` ranks at this rank's (stage,
    data)."""
    ranks: Tuple[Tuple[int, ...], ...]
    stage: int
    shard: int
    data_group: object
    column_group: object
    prev_group: object
    next_group: object
    slice_group: object
    axis: str = "data"
    stage_axis: str = "stage"
    model: int = 1
    model_index: int = 0
    model_group: object = None

    @property
    def stages(self) -> int:
        return len(self.ranks)

    @property
    def data(self) -> int:
        return len(self.ranks[0])

    @property
    def mesh_dim_names(self) -> Tuple[str, ...]:
        return ((self.stage_axis, self.axis) if self.model == 1
                else (self.stage_axis, self.axis, "model"))

    @property
    def mesh(self) -> torch.Tensor:
        """The global ranks: (stage, data), or (stage, data, model)."""
        grid = torch.tensor(self.ranks)
        if self.model == 1:
            return grid
        base = grid - self.model_index
        return base[..., None] + torch.arange(self.model)

    @property
    def shape(self) -> Dict[str, int]:
        out = {self.stage_axis: self.stages, self.axis: self.data}
        if self.model > 1:
            out["model"] = self.model
        return out

    def rank_of(self, stage: int, shard: Optional[int] = None) -> int:
        """The global rank at *stage* and data index *shard* (default:
        this rank's)."""
        return self.ranks[stage][self.shard if shard is None else shard]


def _stage_group_keys(ranks: Sequence[int], stages: int, model: int = 1
                      ) -> List[Tuple[Tuple[int, ...], str]]:
    """(ranks, tag) of every process group of a (stages, D) carve of
    *ranks*, in the one order every rank of the world makes them: the
    stages' data groups, the columns, the neighbouring pairs, the
    slice.  For P = 2 a pair is its column (the cache returns the same
    group).  With *model* > 1 the ranks are (stage, data, model): each
    model index's (stages, D) carve in index order, then the model
    groups of every (stage, data)."""
    ranks = [int(r) for r in ranks]
    if model > 1:
        keys = [k for i in range(model)
                for k in _stage_group_keys(ranks[i::model], stages)]
        return keys + [(tuple(ranks[j:j + model]), "model")
                       for j in range(0, len(ranks), model)]
    D = len(ranks) // stages
    grid = [ranks[s * D:(s + 1) * D] for s in range(stages)]
    keys = [(tuple(grid[s]), "") for s in range(stages)]
    keys += [(tuple(grid[s][d] for s in range(stages)), "stage")
             for d in range(D)]
    keys += [((grid[s][d], grid[s + 1][d]), "stage")
             for s in range(stages - 1) for d in range(D)]
    keys.append((tuple(ranks), ""))
    return keys


def stage_mesh(mesh_or_ranks, stages: int, axis: str = "data",
               stage_axis: str = "stage", model: int = 1) -> StageMesh:
    """Carve a group's slice (a 1-D mesh, a ``StageMesh`` or a list of
    ranks) into a (*stage_axis*, *axis*) ``StageMesh`` of *stages*
    stages: stage s is the s-th consecutive run of D = n / P ranks of
    the slice's order, so each stage's handoff peer is its neighbouring
    run (the reference's ``stage_mesh``).  A depth that does not divide
    the slice is refused with the legal divisors (``_check_stages``).
    *model* > 1: the slice's ranks are (stage, data, model), and this
    rank's mesh is its model index's (stage, data) replica
    (``StageMesh``).

    Over the whole world every rank calls this and the groups are made
    here; over part of the world the slice's ranks find them made by
    ``partition_mesh(stages=)``, and a carve that was not prepared so
    is refused (``dist.new_group`` would wait for the ranks outside)."""
    if isinstance(mesh_or_ranks, StageMesh):
        ranks = mesh_or_ranks.mesh.flatten().tolist()
        model = mesh_or_ranks.model
    elif isinstance(mesh_or_ranks, (list, tuple)):
        ranks = [int(r) for r in mesh_or_ranks]
    else:
        ranks = mesh_or_ranks.mesh.flatten().tolist()
    stages = _check_stages(stages, len(ranks) // model, "group submesh")
    keys = _stage_group_keys(ranks, stages, model)
    whole = sorted(ranks) == list(range(dist.get_world_size()))
    if not whole:
        if _GROUPS_WORLD[0] is not dist.group.WORLD or any(
                (k, None, tag) not in _GROUPS for k, tag in keys):
            raise RuntimeError(
                f"the stage groups of the slice {ranks} were not made by "
                f"every rank of the world: carve the pool with "
                f"partition_mesh(..., stages={stages})")
    groups = [subgroup(k, tag=tag) for k, tag in keys]
    me = dist.get_rank()
    mi = ranks.index(me) % model
    if model > 1:
        start = ranks.index(me) - mi
        model_group = subgroup(ranks[start:start + model], tag="model")
        ranks = ranks[mi::model]
        groups = [subgroup(k, tag=tag)
                  for k, tag in _stage_group_keys(ranks, stages)]
    else:
        model_group = None
    D = len(ranks) // stages
    grid = tuple(tuple(ranks[s * D:(s + 1) * D]) for s in range(stages))
    s_me = next(s for s in range(stages) if me in grid[s])
    d_me = grid[s_me].index(me)
    col = tuple(grid[s][d_me] for s in range(stages))
    prev_key = (grid[s_me - 1][d_me], me) if s_me > 0 else None
    next_key = (me, grid[s_me + 1][d_me]) if s_me < stages - 1 else None
    return StageMesh(
        ranks=grid, stage=s_me, shard=d_me, data_group=groups[s_me],
        column_group=subgroup(col, tag="stage"),
        prev_group=subgroup(prev_key, tag="stage") if prev_key else None,
        next_group=subgroup(next_key, tag="stage") if next_key else None,
        slice_group=groups[-1], axis=axis, stage_axis=stage_axis,
        model=model, model_index=mi, model_group=model_group)


def handoff(t: torch.Tensor, group, src: int) -> torch.Tensor:
    """One pipeline hop on the two-rank *group* of neighbouring stages:
    global rank *src* passes *t*, the other rank passes a buffer of the
    same shape and dtype and gets it back filled (both call this, in the
    same order).  It is a broadcast from *src*: gloo's point-to-point
    send and recv take host tensors only, so on a gloo group a CUDA
    tensor goes through host memory (the bytes, whatever the dtype);
    NCCL takes it where it is."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        mine = dist.get_rank() == src
        h = (t.detach().contiguous().to("cpu") if mine
             else torch.empty(t.shape, dtype=t.dtype))
        dist.broadcast(h.view(-1).view(torch.uint8), src=src, group=group)
        return t if mine else t.copy_(h)
    dist.broadcast(t.detach().contiguous().view(-1).view(torch.uint8) if
                   dist.get_rank() == src else t.view(-1).view(torch.uint8),
                   src=src, group=group)
    return t
