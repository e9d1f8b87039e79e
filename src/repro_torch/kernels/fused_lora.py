"""Masked max-rank multi-LoRA forward (port of the forward kernel of
``repro.kernels.fused_lora``).

Stacked adapters A (K, d_in, r_pad) / B (K, r_pad, d_out), one adapter
per token tile (``tile_map``), lanes >= each adapter's true rank masked:

    xa = mask(x_tile · A[k]) rounded to x.dtype;  y_tile = xa · B[k]

returned in x.dtype, unscaled.  On a CUDA tensor ``fused_lora_cuda``
launches the Hopper kernel ``csrc/fused_lora.cu``; on a CPU tensor it
runs ``fused_lora_plain``, the same function in plain PyTorch.
"""
from __future__ import annotations

import ctypes

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
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                       + [ctypes.c_long] * 4 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


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
    build.require(x.device.type == "cuda", f"unsupported device {x.device}")
    build.require(x.dtype == torch.bfloat16 and x.is_contiguous(),
                  "x must be a contiguous bf16 tensor")
    for name, t in (("A", A), ("B", B)):
        build.require(t.device == x.device and t.dtype == torch.bfloat16
                      and t.stride(-1) == 1,
                      f"{name} must be bf16 on {x.device}, last dim contiguous")
    for name, t in (("tile_map", tile_map), ("ranks", ranks)):
        build.require(t.device == x.device and t.dtype == torch.int32
                      and t.is_contiguous(),
                      f"{name} must be contiguous int32 on {x.device}")
    build.require(block_t % 16 == 0, f"block_t={block_t}: need a multiple "
                  "of 16 (one CTA's rows must share an adapter)")
    build.require(r_pad <= 256, "r_pad > 256 is not supported by the kernel")
    build.require_vectors((x, A, B), d_in, d_out, r_pad, *A.stride()[:2],
                          *B.stride()[:2])
    out = torch.empty((T, d_out), dtype=x.dtype, device=x.device)
    lib = _lib()
    groups = build.col_groups(T // 16, d_out, 128, x.device)
    err = lib.fused_lora_fwd_launch(
        build.ptr(x), build.ptr(A), build.ptr(B), build.ptr(tile_map),
        build.ptr(ranks), build.ptr(out), T, d_in, d_out, r_pad,
        A.stride(0), A.stride(1), B.stride(0), B.stride(1), block_t, groups,
        build.stream_ptr(x.device))
    build.check(lib, err, "fused_lora_cuda")
    fused_lora_cuda.launches += 1
    return out


fused_lora_cuda.launches = 0
