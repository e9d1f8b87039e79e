"""One rank's step analyzed on meta tensors: the counterpart of the
reference's ``launch/hlo_analysis.py``.

The reference compiles its steps with XLA on forced host devices and
parses the partitioned HLO text for dot FLOPs, bytes and collectives.
The port runs eagerly: there is no compiled module and no HLO to parse.
Instead the step itself runs, once, on ``meta`` tensors (shapes and
dtypes, no data and no memory: every op runs its shape function) inside
a fake world (``launch/mesh.fake_world``: the collectives return at
once), under one ``TorchDispatchMode`` that sees every aten and c10d op
the rank issues, in program order, and counts:

  * FLOPs, from ``torch.utils.flop_counter``'s formulas (those of
    ``FlopCounterMode``), and the share whose operands are float32 (the
    reference's ``flops_f32``: on the H100 an f32 GEMM does not run at
    the tensor cores' bf16 rate);
  * eager bytes: the tensor inputs and outputs of every op that makes a
    tensor and is not a view.  Each eager op reads its inputs from and
    writes its outputs to device memory, so this bounds the step's HBM
    traffic from above;
  * collective bytes and counts by kind ("all-reduce", "all-gather",
    "broadcast", ...), the operand bytes as the reference counts them,
    with the ranks of each op's group (``roofline`` prices a group inside
    one node and one that spans nodes apart);
  * peak bytes: what the step holds at its high-water mark.  Every
    storage an op creates is counted from its creation until it dies (a
    weak reference on the storage), rounded up to the caching
    allocator's 512-byte granule; the inputs (the rank's params,
    adapters, optimizer state, batch and caches) are counted throughout.

The meta tensors are not CUDA tensors, and ``card_path`` makes the step
take the card's branches all the same: under ``models/layers.
meta_as_card`` ``on_card`` answers True for a meta tensor (in this
thread only), so the row-parallel partials are bf16 GEMMs with f32
outputs (``mm_f32``) and every non-windowed attention's forward is the
flash kernel's.  The ctypes kernels cannot take meta tensors (they need
device pointers): the analysis runs ``impl="torch"`` (the eager route,
as the reference's dry run runs ``impl="xla"``), and the flash kernel B9
is stood in for: its outputs (out and lse) allocated as the kernel
allocates them and its dense FLOPs counted (QKᵀ and PV over every key,
what the reference's and the plain version's products count).
Everything else is the port's own code on the rank's shapes.

A host read inside a step (a ``.item()``, a tile map read back) fails on
meta tensors; the steps analyzed here make none: their tile maps and row
counts are static, built from the job specs on the host.  (Fake tensors,
``FakeTensorMode``, give the same counts in 3-4x the time.)
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# the caching allocator rounds every block up to this many bytes
ALLOC_GRANULE = 512

# c10d op name -> the reference's collective kind (another c10d op that
# moves tensors is counted under its own name)
_C10D_KINDS = {"allreduce_": "all-reduce", "_allgather_base_": "all-gather",
               "allgather_": "all-gather", "broadcast_": "broadcast"}


def _granule(n: int) -> int:
    return -(-n // ALLOC_GRANULE) * ALLOC_GRANULE


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclass
class StepReport:
    """What one rank's step did, counted on meta tensors (per rank, as
    the reference's HLO report is per device)."""
    flops: float = 0.0
    flops_f32: float = 0.0           # subset of flops on f32 operands
    eager_bytes: float = 0.0
    collective_bytes: Dict[str, float] = field(default_factory=dict)
    collective_counts: Dict[str, int] = field(default_factory=dict)
    # (kind, the group's global ranks) -> operand bytes
    collective_groups: Dict[Tuple[str, Tuple[int, ...]], float] = field(
        default_factory=dict)
    resident_bytes: int = 0          # the inputs' bytes (allocator granules)
    peak_bytes: int = 0              # inputs + the step's high-water mark
    ops: int = 0
    op_bytes: Dict[str, float] = field(default_factory=dict)  # by aten op

    @property
    def top_ops(self) -> List[Tuple[str, float]]:
        """(aten op, its eager bytes), most first."""
        return sorted(self.op_bytes.items(), key=lambda x: -x[1])

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def describe_collectives(self) -> str:
        return "; ".join(
            f"{k}: {self.collective_counts[k]}x "
            f"{self.collective_bytes[k] / 1e6:.1f}MB"
            for k in sorted(self.collective_bytes)) or "none"


def _group_ranks(args) -> Tuple[int, ...]:
    """The global ranks of the process group among a c10d op's args (a
    boxed ``ProcessGroup``: the op's first script object)."""
    for a in args:
        if isinstance(a, torch.ScriptObject):
            return tuple(dist.get_process_group_ranks(
                dist.ProcessGroup.unbox(a)))
    return ()


class _Counter(TorchDispatchMode):
    """Counts FLOPs, eager bytes, collectives and live storages of every
    op dispatched under it (see the module docstring)."""

    def __init__(self, report: StepReport):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.rep = report
        self.formulas = flop_registry
        self.live = 0
        self.seen: Dict[int, weakref.ref] = {}

    def add_flops(self, n: float, f32: bool) -> None:
        self.rep.flops += n
        if f32:
            self.rep.flops_f32 += n

    def _free(self, key: int, size: int):
        def cb(_):
            self.seen.pop(key, None)
            self.live -= size
        return cb

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self.seen and self.seen[key]() is st:
            return
        size = _granule(st.nbytes())
        self.seen[key] = weakref.ref(st, self._free(key, size))
        self.live += size
        self.rep.peak_bytes = max(self.rep.peak_bytes,
                                  self.rep.resident_bytes + self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        rep = self.rep
        rep.ops += 1
        packet = func._overloadpacket
        if packet in self.formulas:
            n = self.formulas[packet](*args, **kwargs, out_val=out)
            ins = _tensors(args)
            self.add_flops(n, bool(ins) and ins[0].dtype == torch.float32)
        if func.namespace == "c10d":
            name = func._schema.name.split("::")[-1]
            kind = _C10D_KINDS.get(name, name)
            # the operand: the input (a gather's shard, a reduction's
            # buffer), as the reference's HLO parse counts it
            ins = _tensors(args[1] if kind == "all-gather" else args[:1])
            b = sum(_nbytes(t) for t in ins)
            if b:
                rep.collective_bytes[kind] = \
                    rep.collective_bytes.get(kind, 0.0) + b
                rep.collective_counts[kind] = \
                    rep.collective_counts.get(kind, 0) + 1
                key = (kind, _group_ranks(args))
                rep.collective_groups[key] = \
                    rep.collective_groups.get(key, 0.0) + b
            return out
        outs = _tensors(out)
        if outs and not func.is_view:
            b = sum(_nbytes(t) for t in _tensors(args)) \
                + sum(_nbytes(t) for t in outs)
            rep.eager_bytes += b
            name = str(packet)
            rep.op_bytes[name] = rep.op_bytes.get(name, 0.0) + b
        for t in outs:
            self.track(t)
        return out


def card_path(counter: _Counter):
    """The card's branches on meta tensors (``layers.meta_as_card``)
    with the flash kernel (B9) stood in for: the wrapper's outputs
    allocated as the kernel's (out (BH, Sq, vd) in q's dtype, lse (BH,
    Sq) f32) and its dense FLOPs counted (2·BH·Sq·Skv·(hd + vd): every
    key's QKᵀ and PV, as the plain version and the reference count
    them)."""
    from repro_torch.models.layers import meta_as_card

    def flash_attention_fwd(q, k, v, *, causal=True, kv_groups=1):
        BH, Sq, hd = q.shape
        Skv, vd = k.shape[1], v.shape[-1]
        counter.add_flops(2.0 * BH * Sq * Skv * (hd + vd),
                          q.dtype == torch.float32)
        return (torch.empty((BH, Sq, vd), dtype=q.dtype, device=q.device),
                torch.empty((BH, Sq), dtype=torch.float32, device=q.device))
    return meta_as_card(flash_attention_fwd)


def analyze(step: Callable, inputs) -> Tuple[StepReport, object]:
    """Run ``step(*inputs)`` once on *inputs* (``meta`` tensors) and
    count it.  The inputs' bytes (allocator granules, each storage once)
    are the resident bytes; the peak adds every storage the step creates
    while it lives.  Returns (report, the step's output)."""
    rep = StepReport()
    counter = _Counter(rep)
    for t in _tensors(inputs):
        st = t.untyped_storage()
        if id(st) not in counter.seen:
            # counted once, here: a view of an input (a layer's slice of
            # a stacked weight) is no new storage
            counter.seen[id(st)] = weakref.ref(st)
            rep.resident_bytes += _granule(st.nbytes())
    rep.peak_bytes = rep.resident_bytes
    with card_path(counter), counter:
        out = step(*inputs)
    return rep, out
