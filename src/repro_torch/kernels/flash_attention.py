"""Flash-attention forward (port of ``repro.kernels.flash_attention``).

Flat (batch*heads) layout: q (BH, Sq, hd), k (BH / kv_groups, Skv, hd),
v (BH / kv_groups, Skv, vd) with vd the value width (vd != hd for MLA,
as in the reference); query head bh reads kv head ``bh // kv_groups``
(GQA without a repeated copy; ``kv_groups=1`` is the reference's
signature).  Both return the
output and ``lse`` (BH, Sq) f32, each row's log-sum-exp of its scaled
scores — what ``_chunked_attention_fwd`` returns beside the output and
the training backward (``models/attention._Flash``) recomputes p from.
On a CUDA tensor ``flash_attention_fwd`` launches the Hopper kernel
``csrc/flash_attention.cu``; on a CPU tensor it runs
``flash_attention_ref``, the plain softmax oracle.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

NEG_BIG = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        kv_groups: int = 1
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch oracle: naive softmax attention in f32, v of any
    width.  Returns (out (BH, Sq, vd) in q.dtype, lse f32)."""
    if kv_groups > 1:
        k = k.repeat_interleave(kv_groups, dim=0)
        v = v.repeat_interleave(kv_groups, dim=0)
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bsd,btd->bst", q.float(), k.float()) * scale
    if causal:
        Sq, Skv = s.shape[-2:]
        mask = (torch.arange(Skv, device=q.device)[None, :]
                <= torch.arange(Sq, device=q.device)[:, None])
        s = torch.where(mask[None], s, NEG_BIG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bst,btd->bsd", p, v.float()).to(q.dtype)
    return out, torch.logsumexp(s, dim=-1)


# the (q/k head dim, v width) pairs the kernel is instantiated at:
# 64-byte rows (32), 128-byte rows (64), two 128-byte column parts (128),
# three for q/k with two for v (MLA's 192 / 128), and 80 in the 128-wide
# tile with its last 48 columns zero-filled in shared memory (hubert)
KERNEL_HEAD_DIMS = ((32, 32), (64, 64), (128, 128), (192, 128), (80, 80))


def check_kernel_operands(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> None:
    """What the Hopper kernel takes, checked before any build: q, k, v
    contiguous bf16 on one CUDA device, k as wide as q, a (head dim, v
    width) pair of ``KERNEL_HEAD_DIMS``, at least one query and one key
    row (raises ValueError otherwise)."""
    pair = (q.shape[-1], v.shape[-1])
    build.require(k.shape[-1] == q.shape[-1] and pair in KERNEL_HEAD_DIMS,
                  f"head dim {q.shape[-1]} (k {k.shape[-1]}, v "
                  f"{v.shape[-1]}): the kernel takes (hd, vd) "
                  f"{', '.join(map(str, KERNEL_HEAD_DIMS))}")
    build.require(q.shape[1] >= 1 and k.shape[1] >= 1,
                  f"empty attention: Sq={q.shape[1]}, Skv={k.shape[1]}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        build.require(t.dtype == torch.bfloat16 and t.is_contiguous(),
                      f"{name} must be a contiguous bf16 tensor")
    build.require(q.device.type == "cuda", f"unsupported device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        build.require(t.device == q.device and t.data_ptr() % 16 == 0,
                      f"{name} must be 16-byte aligned on {q.device}")


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        kv_groups: int = 1
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (BH, Sq, hd); k: (BH // kv_groups, Skv, hd); v: (BH //
    kv_groups, Skv, vd).  Returns (out (BH, Sq, vd) in q.dtype, lse (BH,
    Sq) f32); the scores never reach device memory."""
    BH, Sq, hd = q.shape
    Skv, vd = k.shape[1], v.shape[-1]
    build.require(k.shape[0] * kv_groups == BH
                  and v.shape[:2] == k.shape[:2] and k.shape[-1] == hd,
                  f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                  f"{tuple(v.shape)}, kv_groups={kv_groups}")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal,
                                   kv_groups=kv_groups)
    check_kernel_operands(q, k, v)
    o = torch.empty((BH, Sq, vd), dtype=q.dtype, device=q.device)
    lse = torch.empty((BH, Sq), dtype=torch.float32, device=q.device)
    lib = _lib()
    err = lib.flash_attention_fwd_launch(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(o),
        build.ptr(lse), BH, Sq, Skv,
        hd, vd, kv_groups, int(causal), hd ** -0.5,
        build.stream_ptr(q.device))
    build.check(lib, err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0
