"""Rank-bucketed ragged multi-LoRA forward (port of the forward half of
``repro.kernels.ragged``).

``RaggedMeta`` is the static (batch layout, rank layout) geometry: one
adapter per token tile, segments contiguous, each adapter's padded rank
cut into rank tiles of width ``layout.multiple``.  ``ragged_lora_fwd``
computes the packed ragged LoRA forward over the active (token tile,
rank tile) pairs only:

    y[t] = Σ_{rank tiles rt of adapter(t)} mask(x_t · A[:, rt]) · B[rt, :]

in f32, unscaled (the caller scales and casts).  On a CUDA tensor it
launches the Hopper kernel ``csrc/ragged_lora.cu``; on a CPU tensor it
runs ``ragged_lora_fwd_plain``, the same function in plain PyTorch.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from functools import cached_property
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.lora import RankLayout
from repro_torch.kernels import build


@dataclass(frozen=True)
class RaggedMeta:
    """Static flattened grid metadata for one (batch layout, rank layout).

    ``tile_jobs`` maps each token tile to its adapter.  Hashable, so the
    device copy of the per-tile table is cached on it."""
    tile_jobs: Tuple[int, ...]
    ranks: Tuple[int, ...]
    r_pads: Tuple[int, ...]
    offsets: Tuple[int, ...]
    r_blk: int

    @classmethod
    def build(cls, tile_jobs: Sequence[int],
              layout: RankLayout) -> "RaggedMeta":
        return cls(tuple(int(t) for t in tile_jobs), layout.ranks,
                   layout.r_pads, layout.offsets, layout.multiple)

    @property
    def num_jobs(self) -> int:
        return len(self.ranks)

    @property
    def total_r(self) -> int:
        return sum(self.r_pads)

    def _rt_of(self, k: int) -> Tuple[int, int]:
        """(first global rank tile, rank-tile count) of job k."""
        return self.offsets[k] // self.r_blk, self.r_pads[k] // self.r_blk

    @cached_property
    def fwd_flat(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray]:
        """(tile, rtile, first, lanes) in (token tile, rank tile) order."""
        tile, rtile, first, lanes = [], [], [], []
        for t, k in enumerate(self.tile_jobs):
            rt0, n_rt = self._rt_of(k)
            for j in range(n_rt):
                tile.append(t)
                rtile.append(rt0 + j)
                first.append(1 if j == 0 else 0)
                lanes.append(int(np.clip(self.ranks[k] - j * self.r_blk,
                                         0, self.r_blk)))
        return (np.asarray(tile, np.int32), np.asarray(rtile, np.int32),
                np.asarray(first, np.int32), np.asarray(lanes, np.int32))

    @cached_property
    def wgrad_flat(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(tile, rtile, first) in (adapter, rank tile, token tile) order."""
        tiles_of = [[] for _ in range(self.num_jobs)]
        for t, k in enumerate(self.tile_jobs):
            tiles_of[k].append(t)
        tile, rtile, first = [], [], []
        for k in range(self.num_jobs):
            rt0, n_rt = self._rt_of(k)
            for j in range(n_rt):
                for i, t in enumerate(tiles_of[k]):
                    tile.append(t)
                    rtile.append(rt0 + j)
                    first.append(1 if i == 0 else 0)
        return (np.asarray(tile, np.int32), np.asarray(rtile, np.int32),
                np.asarray(first, np.int32))

    @cached_property
    def visited_rows(self) -> np.ndarray:
        """(total_r,) bool — packed rank rows owned by adapters with at
        least one token tile."""
        seen = np.zeros(self.num_jobs, bool)
        for k in self.tile_jobs:
            seen[k] = True
        return np.repeat(seen, np.asarray(self.r_pads, np.int64))

    @cached_property
    def tile_table(self) -> np.ndarray:
        """(n_tiles, 3) int32 per token tile: (first packed column, padded
        width, true rank) of its adapter — ``fwd_flat`` folded per tile,
        the table each CTA of the CUDA kernel reads."""
        _, rtile, first, lanes = self.fwd_flat
        starts = np.flatnonzero(first)
        n_rt = np.diff(np.append(starts, len(first)))
        return np.stack([rtile[starts] * self.r_blk, n_rt * self.r_blk,
                         np.add.reduceat(lanes, starts)],
                        axis=1).astype(np.int32)


@functools.lru_cache(maxsize=64)
def _device_table(meta: RaggedMeta, device: torch.device) -> torch.Tensor:
    """The per-tile table on *device*, copied once per (meta, device): a
    host-to-device copy per launch would sync the decode loop."""
    return torch.from_numpy(meta.tile_table).to(device)


def ragged_lora_fwd_plain(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                          meta: RaggedMeta, *, block_t: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: per adapter, its token tiles
    times its own padded segment; lanes >= the true rank are zeroed in
    f32 and xa is rounded to x.dtype before the second product."""
    T, d_in = x.shape
    d_out = B.shape[-1]
    n_tiles = T // block_t
    y = torch.empty((n_tiles, block_t, d_out), dtype=torch.float32,
                    device=x.device)
    xt = x.reshape(n_tiles, block_t, d_in)
    jobs = np.asarray(meta.tile_jobs)
    for k in np.unique(jobs):
        sel = torch.from_numpy(np.flatnonzero(jobs == k)).to(x.device)
        off, rp, r = meta.offsets[k], meta.r_pads[k], meta.ranks[k]
        xa = xt[sel].reshape(-1, d_in).float() @ A[:, off:off + rp].float()
        xa[:, r:] = 0.0
        yk = xa.to(x.dtype).float() @ B[off:off + rp].float()
        y[sel] = yk.reshape(len(sel), block_t, d_out)
    return y.reshape(T, d_out)


def _lib() -> ctypes.CDLL:
    lib = build.load("ragged_lora")
    fn = lib.ragged_lora_fwd_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def ragged_lora_fwd(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                    meta: RaggedMeta, *, block_t: int = 128) -> torch.Tensor:
    """x: (T, d_in), A: (d_in, R), B: (R, d_out) packed ragged.

    Returns (T, d_out) *unscaled* LoRA output in f32.  A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel or raises."""
    T, d_in = x.shape
    d_out = B.shape[-1]
    build.require(T % block_t == 0 and T // block_t == len(meta.tile_jobs),
                  f"T={T} is not {len(meta.tile_jobs)} tiles of {block_t}")
    build.require(A.shape == (d_in, meta.total_r)
                  and B.shape[0] == meta.total_r,
                  f"A {tuple(A.shape)} / B {tuple(B.shape)} do not match "
                  f"d_in={d_in}, R={meta.total_r}")
    if x.device.type == "cpu":
        return ragged_lora_fwd_plain(x, A, B, meta, block_t=block_t)
    build.require(x.device.type == "cuda", f"unsupported device {x.device}")
    for name, t in (("x", x), ("A", A), ("B", B)):
        build.require(t.device == x.device and t.dtype == torch.bfloat16
                      and t.is_contiguous(),
                      f"{name} must be a contiguous bf16 tensor on {x.device}")
    build.require(block_t % 16 == 0, f"block_t={block_t}: need a multiple "
                  "of 16 (one CTA's rows must share an adapter)")
    build.require(max(meta.r_pads) <= 256, "rank segments wider than 256 "
                  "lanes are not supported by the CUDA kernel")
    build.require_vectors((x, A, B), d_in, d_out, meta.r_blk)
    out = torch.empty((T, d_out), dtype=torch.float32, device=x.device)
    table = _device_table(meta, x.device)
    lib = _lib()
    groups = build.col_groups(T // 16, d_out, 128, x.device)
    err = lib.ragged_lora_fwd_launch(
        build.ptr(x), build.ptr(A), build.ptr(B), build.ptr(table),
        build.ptr(out), T, d_in, d_out, meta.total_r, block_t, groups,
        build.stream_ptr(x.device))
    build.check(lib, err, "ragged_lora_fwd")
    ragged_lora_fwd.launches += 1
    return out


ragged_lora_fwd.launches = 0
