"""Device-resident adapter pool for the fused multi-LoRA serving engine
(port of ``repro.serve.pool``).

  * the SOURCE OF TRUTH for every published adapter is a host-resident
    flat ``path -> un-padded slice`` dict (the ``slice_job`` format);
  * device residency is a CACHE over it: on first use an adapter's
    slices are padded to their own ``pad_rank`` width and copied to the
    device; an LRU policy bounds the number of device-resident adapters
    (a spill drops the device copy, the host copy remains);
  * ``acquire(names)`` assembles the ACTIVE SET into one packed ragged
    stack (``RankLayout`` segments concatenated along the rank axis),
    memoized on ``(name, version)`` tuples, so republishing one adapter
    invalidates only the stacks containing it.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.lora import RankLayout, pad_rank, rank_axis_is_last


class FusedAdapters(NamedTuple):
    """One acquired active set: packed stack + geometry for MultiLoRA."""
    names: Tuple[str, ...]
    versions: Tuple[int, ...]
    layout: RankLayout
    adapters: dict                    # packed ragged tree (model shape)
    ranks: torch.Tensor               # (K,) int32 true ranks
    scalings: torch.Tensor            # (K,) f32 alpha_k / r_k

    def index_of(self, name: str) -> int:
        return self.names.index(name)


@dataclass
class _Entry:
    name: str
    rank: int
    alpha: float
    version: int
    host: Dict[str, np.ndarray]       # flat path -> un-padded slice
    device: Optional[Dict[str, torch.Tensor]] = None   # padded to own r_pad
    last_used: int = 0


def _host_copy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32).numpy().copy()
    return np.array(v, dtype=np.float32)


def _unflatten(flat: Dict[str, torch.Tensor]) -> dict:
    """``segments/i/j/target/{A,B}`` paths -> {"segments": [...]} with the
    model's nesting (the list index is the segment number)."""
    segs: Dict[int, dict] = {}
    for path, leaf in flat.items():
        head, i, *rest = path.split("/")
        assert head == "segments" and rest, path
        node = segs.setdefault(int(i), {})
        for key in rest[:-1]:
            node = node.setdefault(key, {})
        node[rest[-1]] = leaf
    return {"segments": [segs[i] for i in range(len(segs))]}


@dataclass
class AdapterPool:
    """LRU-managed device pool of published adapters.

    ``capacity`` bounds DEVICE-resident adapters (host copies are the
    durable published state).  ``multiple`` is the rank padding granule
    of the serving ``RankLayout``."""
    cfg: ModelConfig
    capacity: int = 8
    multiple: int = 8
    device: str = "cuda"

    _entries: Dict[str, _Entry] = field(default_factory=dict)
    _packed: "OrderedDict[tuple, FusedAdapters]" = field(
        default_factory=OrderedDict)
    _packed_cap: int = 4
    _tick: int = 0
    stats: Dict[str, int] = field(default_factory=lambda: {
        "publishes": 0, "h2d_fetches": 0, "evictions": 0,
        "pack_builds": 0, "pack_hits": 0})

    # ----------------------------------------------------------- publish
    def publish(self, name: str, adapter: Dict[str, object], *,
                rank: int, alpha: float = 16.0) -> int:
        """Publish (or republish) an adapter; returns its new version.

        ``adapter``: flat path -> un-padded slice (numpy or tensor).  The
        slices are copied to host f32, never aliased."""
        host = {k: _host_copy(v) for k, v in adapter.items()}
        prev = self._entries.get(name)
        version = prev.version + 1 if prev is not None else 0
        self._tick += 1
        self._entries[name] = _Entry(name, int(rank), float(alpha), version,
                                     host, device=None,
                                     last_used=self._tick)
        for key in [k for k in self._packed if any(n == name for n, _ in k)]:
            del self._packed[key]
        self.stats["publishes"] += 1
        return version

    def publish_state(self, state) -> int:
        """Publish a ``JobTrainState`` (e.g. ``GroupRuntime.export``)."""
        return self.publish(state.spec.job_id, state.adapter,
                            rank=state.spec.rank, alpha=state.spec.alpha)

    def publish_group(self, specs: Sequence, adapters: dict,
                      layout: RankLayout) -> List[int]:
        """Publish every member of a packed fused stack (slices per job)."""
        from repro_torch.checkpoint.checkpoint import slice_job
        out = []
        for idx, spec in enumerate(specs):
            off, _ = layout.slice_of(idx)
            out.append(self.publish(spec.job_id,
                                    slice_job(adapters, off, spec.rank),
                                    rank=spec.rank, alpha=spec.alpha))
        return out

    # ------------------------------------------------------------ lookup
    def __contains__(self, name: str) -> bool:
        return name in self._entries

    @property
    def names(self) -> List[str]:
        return list(self._entries)

    def rank_of(self, name: str) -> int:
        return self._entries[name].rank

    def version_of(self, name: str) -> int:
        return self._entries[name].version

    def is_resident(self, name: str) -> bool:
        e = self._entries.get(name)
        return e is not None and e.device is not None

    def resident_names(self) -> List[str]:
        return [n for n, e in self._entries.items() if e.device is not None]

    # ------------------------------------------------------------- fetch
    def _fetch(self, name: str) -> _Entry:
        """Ensure *name* is device-resident (pad to its own r_pad, H2D)."""
        e = self._entries[name]
        if e.device is None:
            rp = pad_rank(e.rank, self.multiple)
            dev = {}
            for k, v in e.host.items():
                if rank_axis_is_last(k):
                    pad = [(0, 0)] * (v.ndim - 1) + [(0, rp - v.shape[-1])]
                else:
                    pad = ([(0, 0)] * (v.ndim - 2)
                           + [(0, rp - v.shape[-2]), (0, 0)])
                dev[k] = torch.from_numpy(np.pad(v, pad)).to(self.device)
            e.device = dev
            self.stats["h2d_fetches"] += 1
        self._tick += 1
        e.last_used = self._tick
        return e

    def prefetch(self, names: Sequence[str]) -> None:
        """Copy *names* to the device ahead of use."""
        for n in names:
            self._fetch(n)
        self._evict(keep=set(names))

    def _evict(self, keep: set) -> None:
        resident = [e for e in self._entries.values() if e.device is not None]
        excess = len(resident) - self.capacity
        if excess <= 0:
            return
        for e in sorted(resident, key=lambda e: e.last_used):
            if excess <= 0:
                break
            if e.name in keep:
                continue
            e.device = None            # LRU spill: host copy is the truth
            self.stats["evictions"] += 1
            excess -= 1

    # ----------------------------------------------------------- acquire
    def acquire(self, names: Sequence[str]) -> FusedAdapters:
        """Assemble the packed ragged stack for an active set: per-adapter
        device slices (each padded to its OWN width) concatenate along
        the rank axis in request order — a pure device concat."""
        names = tuple(names)
        assert names, "acquire needs at least one adapter"
        entries = [self._fetch(n) for n in names]
        self._evict(keep=set(names))
        key = tuple((e.name, e.version) for e in entries)
        hit = self._packed.get(key)
        if hit is not None:
            self._packed.move_to_end(key)
            self.stats["pack_hits"] += 1
            return hit

        layout = RankLayout(tuple(e.rank for e in entries),
                            multiple=self.multiple)
        flat = {k: torch.cat([e.device[k] for e in entries],
                             dim=-1 if rank_axis_is_last(k) else -2)
                for k in entries[0].device}
        fused = FusedAdapters(
            names=names,
            versions=tuple(e.version for e in entries),
            layout=layout,
            adapters=_unflatten(flat),
            ranks=torch.tensor([e.rank for e in entries], dtype=torch.int32,
                               device=self.device),
            scalings=torch.tensor([e.alpha / e.rank for e in entries],
                                  dtype=torch.float32, device=self.device))
        self._packed[key] = fused
        if len(self._packed) > self._packed_cap:
            self._packed.popitem(last=False)
        self.stats["pack_builds"] += 1
        return fused
