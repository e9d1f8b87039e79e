"""Rank-bucketed ragged multi-LoRA kernels (port of
``repro.kernels.ragged``).

``RaggedMeta`` is the static (batch layout, rank layout) geometry: one
adapter per token tile, segments contiguous, each adapter's padded rank
cut into rank tiles of width ``layout.multiple``.  The five kernels work
over the active (token tile, rank tile) pairs only, seg(t) being the
packed segment of token t's adapter and mask() zeroing lanes >= its rank:

    ragged_lora_fwd    y[t]  = mask(x_t · A[:, seg(t)]) · B[seg(t)]     f32
    ragged_lora_dgrad  dx[t] = mask(dy_t · B[seg(t)]^T) · A[:, seg(t)]^T f32
    ragged_xa          xa[t, seg(t)]  = mask(x_t · A[:, seg(t)])        (T, R)
    ragged_dxa         dxa[t, seg(t)] = mask(dy_t · B[seg(t)]^T)        (T, R)
    ragged_wgrad       out[seg_k] = Σ_{t of adapter k} u[t, seg_k]^T · v_t
                       (summed in the grouped wgrad's order)

The masked intermediate is rounded to the input dtype before a second
product, as the TPU kernels do; xa and dxa are zero outside seg(t), and
wgrad rows of adapters that own no token tile are zero.  On a CUDA
tensor each wrapper launches its Hopper kernel (``csrc/ragged_lora.cu``
for the forward, ``csrc/ragged_bwd.cu`` for the other four; the first
four through the LoRA routine of ``csrc/lora_fwd.cuh``) and counts the
launch; on a CPU tensor it runs its ``*_plain`` version, the same
function in plain PyTorch.
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
from repro_torch.kernels.fused_lora import (WGRAD_CHUNK_TILES,
                                            lora_fwd_geometry,
                                            lora_packed_rows, wgrad_partial,
                                            wgrad_pieces)


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


@functools.lru_cache(maxsize=64)
def _device_wgrad_tables(meta: RaggedMeta, device: torch.device
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the wgrad kernel reads on *device*, copied once: the adapter
    of each token tile, and per adapter (first packed column, padded
    width)."""
    seg = np.stack([meta.offsets, meta.r_pads], axis=1).astype(np.int32)
    return (torch.tensor(meta.tile_jobs, dtype=torch.int32, device=device),
            torch.from_numpy(seg).to(device))


def _segments(meta: RaggedMeta, device, block_t: int):
    """(token rows of its tiles, segment offset, padded width, rank) for
    every adapter that owns at least one token tile."""
    jobs = np.asarray(meta.tile_jobs)
    for k in np.unique(jobs):
        tiles = np.flatnonzero(jobs == k)
        rows = (tiles[:, None] * block_t + np.arange(block_t)).reshape(-1)
        yield (torch.from_numpy(rows).to(device), meta.offsets[k],
               meta.r_pads[k], meta.ranks[k])


def ragged_lora_fwd_plain(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                          meta: RaggedMeta, *, block_t: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: per adapter, its token tiles
    times its own padded segment; lanes >= the true rank are zeroed in
    f32 and xa is rounded to x.dtype before the second product."""
    y = torch.empty((x.shape[0], B.shape[-1]), dtype=torch.float32,
                    device=x.device)
    for rows, off, rp, r in _segments(meta, x.device, block_t):
        xa = x[rows].float() @ A[:, off:off + rp].float()
        xa[:, r:] = 0.0
        y[rows] = xa.to(x.dtype).float() @ B[off:off + rp].float()
    return y


def ragged_lora_dgrad_plain(dy_s: torch.Tensor, A: torch.Tensor,
                            B: torch.Tensor, meta: RaggedMeta, *,
                            block_t: int) -> torch.Tensor:
    """Plain PyTorch version of the dgrad kernel: per adapter, dxa =
    dy_s · B_seg^T masked in f32 and rounded to dy_s.dtype, then
    dx = dxa · A_seg^T in f32."""
    dx = torch.empty((dy_s.shape[0], A.shape[0]), dtype=torch.float32,
                     device=dy_s.device)
    for rows, off, rp, r in _segments(meta, dy_s.device, block_t):
        dxa = dy_s[rows].float() @ B[off:off + rp].float().T
        dxa[:, r:] = 0.0
        dx[rows] = dxa.to(dy_s.dtype).float() @ A[:, off:off + rp].float().T
    return dx


def _packed_plain(x: torch.Tensor, W_seg, meta: RaggedMeta,
                  block_t: int) -> torch.Tensor:
    out = torch.zeros((x.shape[0], meta.total_r), dtype=x.dtype,
                      device=x.device)
    for rows, off, rp, r in _segments(meta, x.device, block_t):
        xa = x[rows].float() @ W_seg(off, rp).float()
        xa[:, r:] = 0.0
        out[rows, off:off + rp] = xa.to(x.dtype)
    return out


def ragged_xa_plain(x: torch.Tensor, A: torch.Tensor, meta: RaggedMeta, *,
                    block_t: int) -> torch.Tensor:
    """Plain PyTorch version of the xa kernel: (T, R) in x.dtype."""
    return _packed_plain(x, lambda off, rp: A[:, off:off + rp], meta,
                         block_t)


def ragged_dxa_plain(dy_s: torch.Tensor, B: torch.Tensor, meta: RaggedMeta,
                     *, block_t: int) -> torch.Tensor:
    """Plain PyTorch version of the dxa kernel: (T, R) in dy_s.dtype."""
    return _packed_plain(dy_s, lambda off, rp: B[off:off + rp].T, meta,
                         block_t)


def ragged_wgrad_plain(u: torch.Tensor, v: torch.Tensor, meta: RaggedMeta,
                       *, block_t: int) -> torch.Tensor:
    """Plain PyTorch version of the wgrad kernel: (R, d) f32, in the
    kernel's order (that of the grouped wgrad, ``wgrad_pieces``): one f32
    partial per piece of an adapter's tiles, added in tile order."""
    out = torch.zeros((meta.total_r, v.shape[-1]), dtype=torch.float32,
                      device=u.device)
    for t0, t1, k in wgrad_pieces(meta.tile_jobs):
        rows = slice(t0 * block_t, t1 * block_t)
        off, rp = meta.offsets[k], meta.r_pads[k]
        out[off:off + rp] += wgrad_partial(u[rows, off:off + rp], v[rows])
    return out


_ARGTYPES = {
    # (library, entry point): (pointer args, int args); a stream pointer
    # follows them all
    ("ragged_lora", "ragged_lora_fwd_launch"): (5, 8),
    ("ragged_bwd", "ragged_dgrad_launch"): (5, 8),
    ("ragged_bwd", "ragged_packed_launch"): (4, 7),
    ("ragged_bwd", "ragged_wgrad_launch"): (6, 7),
}


def _entry(lib_name: str, fn_name: str):
    lib = build.load(lib_name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        n_ptr, n_int = _ARGTYPES[(lib_name, fn_name)]
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib, fn


def _check_common(what: str, T: int, block_t: int, meta: RaggedMeta,
                  A_shape, B_shape, d_in: int) -> None:
    """Shape checks every wrapper makes on every device."""
    build.require(T % block_t == 0 and T // block_t == len(meta.tile_jobs),
                  f"{what}: T={T} is not {len(meta.tile_jobs)} tiles of "
                  f"{block_t}")
    build.require((A_shape is None or tuple(A_shape) == (d_in, meta.total_r))
                  and (B_shape is None or B_shape[0] == meta.total_r),
                  f"{what}: A {A_shape} / B {B_shape} do not match "
                  f"d_in={d_in}, R={meta.total_r}")


def check_kernel_operands(what: str, tensors, block_t: int,
                          meta: RaggedMeta, extents) -> None:
    """What the CUDA kernels take, checked before any build (raises
    ValueError otherwise): contiguous bf16 tensors, one adapter per CTA's
    rows (block_t a multiple of 16), segments of at most 256 lanes,
    packed rows of whole 16-byte units (R * 2 bytes, the tensor maps'
    row stride of A and of xa / dxa), 16-byte vectors (dims and the rank
    tile multiples of 8), all on one CUDA device."""
    for name, t in tensors:
        build.require(t.dtype == torch.bfloat16 and t.is_contiguous(),
                      f"{what}: {name} must be a contiguous bf16 tensor")
    build.require(block_t % 16 == 0, f"{what}: block_t={block_t}: need a "
                  "multiple of 16 (one CTA's rows must share an adapter)")
    build.require(max(meta.r_pads) <= 256, f"{what}: rank segments wider "
                  "than 256 lanes are not supported by the CUDA kernel")
    build.require(meta.total_r * 2 % 16 == 0, f"{what}: R={meta.total_r}: "
                  "packed rows of R * 2 bytes must be whole 16-byte units")
    build.require_vectors([t for _, t in tensors], *extents, meta.r_blk)
    dev = tensors[0][1].device
    build.require(dev.type == "cuda", f"{what}: unsupported device {dev}")
    build.require(all(t.device == dev for _, t in tensors),
                  f"{what}: every operand must be on {dev}")


def ragged_lora_fwd(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                    meta: RaggedMeta, *, block_t: int = 128) -> torch.Tensor:
    """x: (T, d_in), A: (d_in, R), B: (R, d_out) packed ragged.

    Returns (T, d_out) *unscaled* LoRA output in f32.  A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel or raises."""
    T, d_in = x.shape
    d_out = B.shape[-1]
    _check_common("ragged_lora_fwd", T, block_t, meta, A.shape, B.shape,
                  d_in)
    if x.device.type == "cpu":
        return ragged_lora_fwd_plain(x, A, B, meta, block_t=block_t)
    check_kernel_operands("ragged_lora_fwd", (("x", x), ("A", A), ("B", B)),
                          block_t, meta, (d_in, d_out))
    rows, splits = lora_fwd_geometry(T, d_out, block_t,
                                     build.sm_count(x.device))
    out = torch.empty((T, d_out), dtype=torch.float32, device=x.device)
    lib, fn = _entry("ragged_lora", "ragged_lora_fwd_launch")
    err = fn(build.ptr(x), build.ptr(A), build.ptr(B),
             build.ptr(_device_table(meta, x.device)), build.ptr(out), T,
             d_in, d_out, meta.total_r, max(meta.r_pads), block_t, rows,
             splits, build.stream_ptr(x.device))
    build.check(lib, err, "ragged_lora_fwd")
    build.count_launch(ragged_lora_fwd)
    return out


def ragged_lora_dgrad(dy_s: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                      meta: RaggedMeta, *, block_t: int = 128
                      ) -> torch.Tensor:
    """dy_s: (T, d_out) pre-scaled cotangent; A (d_in, R), B (R, d_out).
    Returns dx (T, d_in) f32 over the active rank tiles only."""
    T, d_out = dy_s.shape
    d_in = A.shape[0]
    _check_common("ragged_lora_dgrad", T, block_t, meta, A.shape, B.shape,
                  d_in)
    build.require(B.shape[-1] == d_out, f"B {tuple(B.shape)} vs dy_s "
                  f"{tuple(dy_s.shape)}")
    if dy_s.device.type == "cpu":
        return ragged_lora_dgrad_plain(dy_s, A, B, meta, block_t=block_t)
    check_kernel_operands("ragged_lora_dgrad",
                          (("dy_s", dy_s), ("A", A), ("B", B)), block_t,
                          meta, (d_in, d_out))
    rows, splits = lora_fwd_geometry(T, d_in, block_t,
                                     build.sm_count(dy_s.device))
    dx = torch.empty((T, d_in), dtype=torch.float32, device=dy_s.device)
    lib, fn = _entry("ragged_bwd", "ragged_dgrad_launch")
    err = fn(build.ptr(dy_s), build.ptr(A), build.ptr(B),
             build.ptr(_device_table(meta, dy_s.device)), build.ptr(dx), T,
             d_in, d_out, meta.total_r, max(meta.r_pads), block_t, rows,
             splits, build.stream_ptr(dy_s.device))
    build.check(lib, err, "ragged_lora_dgrad")
    build.count_launch(ragged_lora_dgrad)
    return dx


def _packed(what: str, x: torch.Tensor, w: torch.Tensor, meta: RaggedMeta,
            block_t: int, transposed: bool) -> torch.Tensor:
    T, d = x.shape
    check_kernel_operands(what, (("x", x), ("w", w)), block_t, meta, (d,))
    rows = lora_packed_rows(T, block_t, build.sm_count(x.device))
    out = torch.empty((T, meta.total_r), dtype=x.dtype, device=x.device)
    lib, fn = _entry("ragged_bwd", "ragged_packed_launch")
    err = fn(build.ptr(x), build.ptr(w),
             build.ptr(_device_table(meta, x.device)), build.ptr(out), T, d,
             meta.total_r, max(meta.r_pads), block_t, rows, int(transposed),
             build.stream_ptr(x.device))
    build.check(lib, err, what)
    return out


def ragged_xa(x: torch.Tensor, A: torch.Tensor, meta: RaggedMeta, *,
              block_t: int = 128) -> torch.Tensor:
    """Packed masked xa: (T, R) in x.dtype, xa[t, seg(t)] = mask(x_t ·
    A[:, seg(t)]), zero elsewhere.  Operand of dB's wgrad."""
    _check_common("ragged_xa", x.shape[0], block_t, meta, A.shape, None,
                  x.shape[1])
    if x.device.type == "cpu":
        return ragged_xa_plain(x, A, meta, block_t=block_t)
    out = _packed("ragged_xa", x, A, meta, block_t, transposed=False)
    build.count_launch(ragged_xa)
    return out


def ragged_dxa(dy_s: torch.Tensor, B: torch.Tensor, meta: RaggedMeta, *,
               block_t: int = 128) -> torch.Tensor:
    """Packed masked cotangent of xa: (T, R) in dy_s.dtype, dxa[t, seg(t)]
    = mask(dy_s_t · B[seg(t)]^T), zero elsewhere.  Operand of dA's
    wgrad."""
    _check_common("ragged_dxa", dy_s.shape[0], block_t, meta, None,
                  B.shape, 0)
    build.require(B.shape[-1] == dy_s.shape[1], f"B {tuple(B.shape)} vs "
                  f"dy_s {tuple(dy_s.shape)}")
    if dy_s.device.type == "cpu":
        return ragged_dxa_plain(dy_s, B, meta, block_t=block_t)
    out = _packed("ragged_dxa", dy_s, B, meta, block_t, transposed=True)
    build.count_launch(ragged_dxa)
    return out


def ragged_wgrad(u: torch.Tensor, v: torch.Tensor, meta: RaggedMeta, *,
                 block_t: int = 128) -> torch.Tensor:
    """u: (T, R) packed (xa or dxa), v: (T, d).  Returns (R, d) f32:
    dB directly (u = xa, v = dy_s) or dA transposed (u = dxa, v = x).
    Deterministic, in the grouped wgrad's order (``wgrad_pieces``): one
    wrapper call, two launches (partials, then their sum)."""
    T, R = u.shape
    d = v.shape[-1]
    _check_common("ragged_wgrad", T, block_t, meta, None, (R,), 0)
    build.require(v.shape[0] == T, f"u {tuple(u.shape)} vs v "
                  f"{tuple(v.shape)}")
    if u.device.type == "cpu":
        return ragged_wgrad_plain(u, v, meta, block_t=block_t)
    check_kernel_operands("ragged_wgrad", (("u", u), ("v", v)), block_t,
                          meta, (d,))
    build.require(meta.r_blk % 16 == 0, f"ragged_wgrad: rank tiles of "
                  f"{meta.r_blk} lanes; the CUDA kernel needs multiples of "
                  "16")
    out = torch.empty((R, d), dtype=torch.float32, device=u.device)
    max_w = max(meta.r_pads)
    # one partial slot per token tile, named by the piece's first tile
    work = torch.empty((T // block_t, max_w * d), dtype=torch.float32,
                       device=u.device)
    tile_jobs, seg = _device_wgrad_tables(meta, u.device)
    lib, fn = _entry("ragged_bwd", "ragged_wgrad_launch")
    err = fn(build.ptr(u), build.ptr(v), build.ptr(tile_jobs),
             build.ptr(seg), build.ptr(out), build.ptr(work), T, R, d,
             meta.num_jobs, max_w, block_t, WGRAD_CHUNK_TILES,
             build.stream_ptr(u.device))
    build.check(lib, err, "ragged_wgrad")
    build.count_launch(ragged_wgrad)
    return out


for _fn in (ragged_lora_fwd, ragged_lora_dgrad, ragged_xa, ragged_dxa,
            ragged_wgrad):
    _fn.launches = 0
del _fn
