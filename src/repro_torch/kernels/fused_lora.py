"""The masked max-rank multi-LoRA kernels and the quantized backbone's
dequant-matmul (port of ``repro.kernels.fused_lora``).

Stacked adapters A (K, d_in, r_pad) / B (K, r_pad, d_out), one adapter
per token tile (``tile_map``), lanes >= each adapter's true rank masked:

    fused_lora      xa = mask(x_tile · A[k]) rounded to x.dtype;
                    y_tile = xa · B[k]        (x.dtype, unscaled)
    grouped_matmul  y_t = x_t · W[k]          (x.dtype, f32 accumulation)
    grouped_wgrad   out[k] = Σ_{t of adapter k} x_t^T · g_t   (f32,
                    summed in the order of ``wgrad_pieces``)

The last two are the backward of the first (``kernels/ops._MaskedLoRA``).
The int8 frozen backbone's projection:

    dequant_matmul  y = (x · q) * scale       (x.dtype, f32 accumulation,
                    q int8 (d_in, d_out), scale f32 per output column)

whose backward is the same kernel on q^T with unit scales
(``kernels/ops._DequantMM``).  On a CUDA tensor each ``*_cuda`` wrapper
launches its Hopper kernel (``csrc/fused_lora.cu``, ``csrc/grouped.cu``,
``csrc/dequant.cu``) and counts the launch; on a CPU tensor it runs its
``*_plain`` version, the same function in plain PyTorch.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build


def _fit_block(n: int, cap: int) -> int:
    """Largest divisor of *n* that is <= cap (the TPU grid's tiles must
    divide the dim exactly; the CUDA kernels mask their own edges)."""
    b = max(1, min(cap, n))
    while n % b:
        b -= 1
    return b


def fused_lora_plain(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                     tile_map: torch.Tensor, ranks: torch.Tensor, *,
                     block_t: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, one batched product pair over
    the token tiles."""
    T, d_in = x.shape
    r_pad = A.shape[-1]
    n = T // block_t
    tm = tile_map.long()
    xa = torch.bmm(x.reshape(n, block_t, d_in).float(), A[tm].float())
    lane = torch.arange(r_pad, device=x.device)
    keep = lane[None, None, :] < ranks[tm].long()[:, None, None]
    xa = torch.where(keep, xa, 0.0).to(x.dtype)
    y = torch.bmm(xa.float(), B[tm].float())
    return y.reshape(T, -1).to(x.dtype)


def _lib() -> ctypes.CDLL:
    lib = build.load("fused_lora")
    fn = lib.fused_lora_fwd_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_long] * 4 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


# The launch geometry of the LoRA routine (csrc/lora_fwd.cuh: B1, B6, and
# B2 over dx's d_in columns): the token rows a CTA takes, picked as the
# grouped product's (the largest of these that divides block_t and still
# gives 90% of the SMs a CTA: 64 at T 8192, 16 at an N = 4 slice's 2048
# and at decode), and how many CTAs share one row block's output columns,
# more than one only where the row CTAs alone leave 10% of the SMs idle.
# Column blocks are LORA_FWD_COL_BLOCK wide.  Phase 1 alone (B3, B4)
# takes the same rows and no column split: each CTA writes whole packed
# rows.  It changes no result: each element is summed in one order
# whatever the tiling (chip_smoke.py checks it bit for bit).
LORA_FWD_ROWS = (64, 32, 16)
LORA_FWD_COL_BLOCK = 128


def _cta_rows(T: int, block_t: int, sms: int, choices) -> int:
    """The largest of *choices* dividing block_t whose row CTAs give 90%
    of the SMs one, else the smallest that divides block_t."""
    fits = [r for r in choices if block_t % r == 0]
    build.require(bool(fits), f"block_t={block_t}: need a multiple of 16 "
                  "(one CTA's rows must share an adapter)")
    return next((r for r in fits if 10 * (T // r) >= 9 * sms), fits[-1])


def lora_fwd_geometry(T: int, d_out: int, block_t: int,
                      sms: int) -> Tuple[int, int]:
    """(rows per CTA, column splits) of a LoRA forward on a card with
    *sms* multiprocessors."""
    rows = _cta_rows(T, block_t, sms, LORA_FWD_ROWS)
    row_ctas = T // rows
    if 10 * row_ctas >= 9 * sms:
        return rows, 1
    blocks = -(-d_out // LORA_FWD_COL_BLOCK)
    return rows, max(1, min(blocks, -(-sms // row_ctas)))


def lora_packed_rows(T: int, block_t: int, sms: int) -> int:
    """Rows per CTA of the routine's phase 1 alone (B3 ``ragged_xa``, B4
    ``ragged_dxa``) on a card with *sms* multiprocessors."""
    return _cta_rows(T, block_t, sms, LORA_FWD_ROWS)


def check_fused_lora_operands(x: torch.Tensor, A: torch.Tensor,
                              B: torch.Tensor, tile_map: torch.Tensor,
                              ranks: torch.Tensor, block_t: int) -> None:
    """What the Hopper kernel takes, checked before any build (raises
    ValueError otherwise): bf16 x contiguous, A and B with their last dim
    contiguous, int32 tile map and ranks, block_t a multiple of 16, r_pad
    at most 256, 16-byte vectors (dims and strides multiples of 8), all
    on one CUDA device."""
    d_in, d_out, r_pad = x.shape[1], B.shape[-1], A.shape[-1]
    build.require(x.dtype == torch.bfloat16 and x.is_contiguous(),
                  "x must be a contiguous bf16 tensor")
    for name, t in (("A", A), ("B", B)):
        build.require(t.dtype == torch.bfloat16 and t.stride(-1) == 1,
                      f"{name} must be bf16 with its last dim contiguous")
    for name, t in (("tile_map", tile_map), ("ranks", ranks)):
        build.require(t.dtype == torch.int32 and t.is_contiguous(),
                      f"{name} must be contiguous int32")
    build.require(block_t % 16 == 0, f"block_t={block_t}: need a multiple "
                  "of 16 (one CTA's rows must share an adapter)")
    build.require(r_pad <= 256, "r_pad > 256 is not supported by the kernel")
    build.require_vectors((x, A, B), d_in, d_out, r_pad, *A.stride()[:2],
                          *B.stride()[:2])
    build.require(x.device.type == "cuda", f"unsupported device {x.device}")
    build.require(all(t.device == x.device
                      for t in (A, B, tile_map, ranks)),
                  f"every operand must be on {x.device}")


def fused_lora_cuda(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                    tile_map: torch.Tensor, ranks: torch.Tensor, *,
                    block_t: int = 128) -> torch.Tensor:
    """x: (T, d_in), A: (K, d_in, r_pad), B: (K, r_pad, d_out), tile_map:
    (T // block_t,) adapter per token tile, ranks: (K,).

    Returns (T, d_out) *unscaled* LoRA output in x.dtype.  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or raises.
    A and B may be strided views as long as their last dim is contiguous.
    """
    T, d_in = x.shape
    K, _, r_pad = A.shape
    d_out = B.shape[-1]
    build.require(T % block_t == 0 and tile_map.shape == (T // block_t,),
                  f"T={T}, block_t={block_t}, tile_map {tuple(tile_map.shape)}")
    build.require(A.shape[1] == d_in and B.shape[:2] == (K, r_pad),
                  f"A {tuple(A.shape)} / B {tuple(B.shape)} do not match")
    if x.device.type == "cpu":
        return fused_lora_plain(x, A, B, tile_map, ranks, block_t=block_t)
    check_fused_lora_operands(x, A, B, tile_map, ranks, block_t)
    rows, splits = lora_fwd_geometry(T, d_out, block_t,
                                     build.sm_count(x.device))
    out = torch.empty((T, d_out), dtype=x.dtype, device=x.device)
    lib = _lib()
    err = lib.fused_lora_fwd_launch(
        build.ptr(x), build.ptr(A), build.ptr(B), build.ptr(tile_map),
        build.ptr(ranks), build.ptr(out), T, d_in, d_out, r_pad, K,
        A.stride(0), A.stride(1), B.stride(0), B.stride(1), block_t, rows,
        splits, build.stream_ptr(x.device))
    build.check(lib, err, "fused_lora_cuda")
    build.count_launch(fused_lora_cuda)
    return out


fused_lora_cuda.launches = 0


# ------------------------------------------------------------ grouped mm
def grouped_matmul_plain(x: torch.Tensor, W: torch.Tensor,
                         tile_map: torch.Tensor, *,
                         block_t: int) -> torch.Tensor:
    """Plain PyTorch version of the grouped product: one batched product
    over the token tiles, each against its adapter's W, in f32."""
    T, d_in = x.shape
    n = T // block_t
    y = torch.bmm(x.reshape(n, block_t, d_in).float(),
                  W[tile_map.long()].float())
    return y.reshape(T, -1).to(x.dtype)


def _layout(W: torch.Tensor) -> tuple:
    """(transposed, leading dim) of W's (rows, cols) matrices (its last
    two dims): as stored (last dim contiguous) or a transposed view
    (second-to-last dim contiguous)."""
    if W.stride(-1) == 1:
        return False, W.stride(-2)
    build.require(W.stride(-2) == 1, "W needs its last or its "
                  "second-to-last dim contiguous (strides "
                  f"{tuple(W.stride())})")
    return True, W.stride(-1)


# The grouped product's launch geometry (csrc/grouped.cu): the token rows
# a CTA takes, the largest of these that divides block_t (a CTA's rows
# must share an adapter) and, for the narrow output, still gives 90% of
# the SMs a CTA (on an H100: 64 rows at T 8192, 32 at an N = 2 slice's
# 4096, 16 at an N = 4 slice's 2048; chip_smoke.py times the three on the
# N = 2 slice).  It changes no result: every element is summed in one
# fixed order whatever the tiling, which chip_smoke.py checks bit for bit.
GROUPED_ROWS = (64, 32, 16)


def grouped_geometry(T: int, d_out: int, block_t: int,
                     sms: int) -> Tuple[bool, int]:
    """(narrow, rows per CTA) of a grouped product on a card with *sms*
    multiprocessors."""
    narrow = d_out <= 256      # the wide output takes the most rows
    return narrow, _cta_rows(T, block_t, sms if narrow else 0, GROUPED_ROWS)


def grouped_matmul_cuda(x: torch.Tensor, W: torch.Tensor,
                        tile_map: torch.Tensor, *,
                        block_t: int = 128) -> torch.Tensor:
    """x: (T, d_in), W: (K, d_in, d_out), tile_map: (T // block_t,) adapter
    per token tile.  Returns y (T, d_out) in x.dtype, y_t = x_t · W[k].

    W may be a strided view: its last dim contiguous, or its middle dim
    (the transposed B^T and A^T views of the masked VJP, read in place).
    One of d_in and d_out must be at most 256 (a LoRA rank width).  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises."""
    T, d_in = x.shape
    K, _, d_out = W.shape
    build.require(T % block_t == 0 and tile_map.shape == (T // block_t,),
                  f"T={T}, block_t={block_t}, tile_map {tuple(tile_map.shape)}")
    build.require(W.shape[1] == d_in, f"W {tuple(W.shape)} vs x "
                  f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, W, tile_map, block_t=block_t)
    build.require(x.device.type == "cuda", f"unsupported device {x.device}")
    build.require(x.dtype == torch.bfloat16 and x.is_contiguous(),
                  "x must be a contiguous bf16 tensor")
    build.require(W.device == x.device and W.dtype == torch.bfloat16,
                  f"W must be bf16 on {x.device}")
    build.require(tile_map.device == x.device
                  and tile_map.dtype == torch.int32
                  and tile_map.is_contiguous(),
                  f"tile_map must be contiguous int32 on {x.device}")
    build.require(block_t % 16 == 0, f"block_t={block_t}: need a multiple "
                  "of 16 (one CTA's rows must share an adapter)")
    build.require(d_out <= 256 or d_in <= 256, f"d_in={d_in}, d_out={d_out}: "
                  "the kernel needs one of them at most 256")
    trans, ld = _layout(W)
    build.require_vectors((x, W), d_in, d_out, W.stride(0), ld)
    narrow, rows = grouped_geometry(T, d_out, block_t,
                                    build.sm_count(x.device))
    out = torch.empty((T, d_out), dtype=x.dtype, device=x.device)
    lib = _grouped_lib()
    err = lib.grouped_matmul_launch(
        build.ptr(x), build.ptr(W), build.ptr(tile_map), build.ptr(out), T,
        d_in, d_out, W.stride(0), ld, int(trans), int(narrow), block_t,
        rows, build.stream_ptr(x.device))
    build.check(lib, err, "grouped_matmul_cuda")
    build.count_launch(grouped_matmul_cuda)
    return out


# --------------------------------------------------------- grouped wgrad
# The weight gradients' summation order (B8 here, B5 in kernels/ragged.py,
# their CUDA kernels through one routine of csrc/lora_tile.cuh): token
# tiles are cut into chunks of WGRAD_CHUNK_TILES tiles at absolute tile
# positions; each maximal run of one adapter's tiles inside one chunk (a
# piece) gets one f32 partial, and an adapter's partials are summed in
# tile order.  A constant of the design, not of the card.
WGRAD_CHUNK_TILES = 4


def wgrad_pieces(tile_map: Sequence[int],
                 chunk_tiles: int = WGRAD_CHUNK_TILES
                 ) -> List[Tuple[int, int, int]]:
    """(first tile, end tile, adapter) of every piece, in tile order."""
    pieces = []
    for t, k in enumerate(tile_map):
        if t % chunk_tiles == 0 or k != tile_map[t - 1]:
            pieces.append([t, t + 1, k])
        else:
            pieces[-1][1] = t + 1
    return [tuple(p) for p in pieces]


def wgrad_partial(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """One piece's f32 partial u^T·v, narrow operand first, as the kernel
    computes it (the plain B5 and B8 share it, so that they agree bit for
    bit on one layout)."""
    return u.float().contiguous().T @ v.float().contiguous()


def grouped_wgrad_plain(x: torch.Tensor, g: torch.Tensor,
                        tile_map: torch.Tensor, num_adapters: int, *,
                        block_t: int) -> torch.Tensor:
    """Plain PyTorch version of the grouped wgrad, in the kernel's order:
    one f32 partial per piece (``wgrad_pieces``), each adapter's partials
    added in tile order to zeros (adapters that own no tile stay zero)."""
    d_x, d_g = x.shape[1], g.shape[1]
    out = torch.zeros((num_adapters, d_x, d_g), dtype=torch.float32,
                      device=x.device)
    for t0, t1, k in wgrad_pieces(tile_map.tolist()):
        rows = slice(t0 * block_t, t1 * block_t)
        if d_x <= d_g:
            out[k] += wgrad_partial(x[rows], g[rows])
        else:
            out[k] += wgrad_partial(g[rows], x[rows]).T
    return out


def grouped_wgrad_cuda(x: torch.Tensor, g: torch.Tensor,
                       tile_map: torch.Tensor, num_adapters: int, *,
                       block_t: int = 128) -> torch.Tensor:
    """x: (T, d_x), g: (T, d_g), tile_map: (T // block_t,).  Returns
    (K, d_x, d_g) f32, out[k] = Σ_{t of adapter k} x_t^T · g_t: dA =
    wgrad(x, dxa), dB = wgrad(xa, dy_s).  The smaller of d_x and d_g (a
    rank width) must be a multiple of 16.  Deterministic: partials per
    piece (``wgrad_pieces``), summed in tile order by a second pass; one
    wrapper call, two launches."""
    T, d_x = x.shape
    d_g = g.shape[-1]
    build.require(T % block_t == 0 and tile_map.shape == (T // block_t,)
                  and g.shape[0] == T,
                  f"x {tuple(x.shape)}, g {tuple(g.shape)}, block_t="
                  f"{block_t}, tile_map {tuple(tile_map.shape)}")
    if x.device.type == "cpu":
        return grouped_wgrad_plain(x, g, tile_map, num_adapters,
                                   block_t=block_t)
    build.require(x.device.type == "cuda", f"unsupported device {x.device}")
    for name, t in (("x", x), ("g", g)):
        build.require(t.device == x.device and t.dtype == torch.bfloat16
                      and t.is_contiguous(),
                      f"{name} must be a contiguous bf16 tensor on {x.device}")
    build.require(tile_map.device == x.device
                  and tile_map.dtype == torch.int32
                  and tile_map.is_contiguous(),
                  f"tile_map must be contiguous int32 on {x.device}")
    build.require(block_t % 16 == 0, f"block_t={block_t}: need a multiple "
                  "of 16")
    build.require(min(d_x, d_g) % 16 == 0, f"d_x={d_x}, d_g={d_g}: the "
                  "narrow operand must be whole 16-lane tiles")
    build.require_vectors((x, g), d_x, d_g)
    out = torch.empty((num_adapters, d_x, d_g), dtype=torch.float32,
                      device=x.device)
    # one partial slot per token tile, named by the piece's first tile
    work = torch.empty((T // block_t, d_x * d_g), dtype=torch.float32,
                       device=x.device)
    lib = _grouped_lib()
    err = lib.grouped_wgrad_launch(
        build.ptr(x), build.ptr(g), build.ptr(tile_map), build.ptr(out),
        build.ptr(work), T, d_x, d_g, num_adapters, block_t,
        WGRAD_CHUNK_TILES, build.stream_ptr(x.device))
    build.check(lib, err, "grouped_wgrad_cuda")
    build.count_launch(grouped_wgrad_cuda)
    return out


def _grouped_lib() -> ctypes.CDLL:
    lib = build.load("grouped")
    mm, wg = lib.grouped_matmul_launch, lib.grouped_wgrad_launch
    if mm.argtypes is None:
        mm.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                       + [ctypes.c_long] * 2 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        mm.restype = ctypes.c_int
        wg.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        wg.restype = ctypes.c_int
    return lib


grouped_matmul_cuda.launches = 0
grouped_wgrad_cuda.launches = 0


# ------------------------------------------------------------ dequant mm
def dequant_matmul_plain(x: torch.Tensor, q: torch.Tensor,
                         scale: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version of the dequant-matmul: bf16 and int8 are
    exact in f32, so this is the reference's f32-accumulated dot, scaled
    per output column (``scale=None``: unit scales) and rounded once."""
    y = x.float() @ q.float()
    if scale is not None:
        y = y * scale.float()
    return y.to(x.dtype)


def dequant_matmul_cuda(x: torch.Tensor, q: torch.Tensor,
                        scale: Optional[torch.Tensor]) -> torch.Tensor:
    """x: (T, K), q: (K, N) int8, scale: (N,) f32 or None (unit scales).
    Returns (T, N) in x.dtype: ((x · q) * scale) accumulated in f32 and
    rounded once.

    q may be a transposed view of the stored (d_in, d_out) codes (the
    backward's q^T), read in place.  The kernel's output tile is one
    shape at every T (csrc/dequant.cu's kBM x kBN), so a row's output
    does not depend on T.  A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises."""
    build.require(x.ndim == 2 and q.ndim == 2 and x.shape[1] == q.shape[0],
                  f"x {tuple(x.shape)} and q {tuple(q.shape)} do not chain")
    T, K = x.shape
    N = q.shape[1]
    build.require(q.dtype == torch.int8, f"q must be int8, not {q.dtype}")
    build.require(scale is None or (scale.shape == (N,)
                                    and scale.dtype == torch.float32),
                  f"scale must be f32 of shape ({N},)")
    if x.device.type == "cpu":
        return dequant_matmul_plain(x, q, scale)
    build.require(x.device.type == "cuda", f"unsupported device {x.device}")
    build.require(x.dtype == torch.bfloat16 and x.is_contiguous(),
                  "x must be a contiguous bf16 tensor")
    build.require(q.device == x.device, f"q must be on {x.device}")
    build.require(scale is None or (scale.device == x.device
                                    and scale.is_contiguous()),
                  f"scale must be contiguous on {x.device}")
    build.require(T >= 1 and K % 16 == 0 and N % 16 == 0,
                  f"T={T}, K={K}, N={N}: the kernel needs rows and "
                  "K, N multiples of 16")
    trans, ld = _layout(q)
    build.require(all(t.data_ptr() % 16 == 0 for t in (x, q))
                  and ld % 16 == 0,
                  "x and q must be 16-byte aligned with a leading dim of "
                  f"q that is a multiple of 16 (got {ld})")
    out = torch.empty((T, N), dtype=x.dtype, device=x.device)
    lib = _dequant_lib()
    err = lib.dequant_matmul_launch(
        build.ptr(x), build.ptr(q),
        build.ptr(scale) if scale is not None else None, build.ptr(out), T,
        K, N, ld, int(trans), build.stream_ptr(x.device))
    build.check(lib, err, "dequant_matmul_cuda")
    build.count_launch(dequant_matmul_cuda)
    return out


def _dequant_lib() -> ctypes.CDLL:
    lib = build.load("dequant")
    fn = lib.dequant_matmul_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                       + [ctypes.c_long, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


dequant_matmul_cuda.launches = 0
