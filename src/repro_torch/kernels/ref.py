"""Plain PyTorch oracles for the fused multi-LoRA kernels (port of
``repro.kernels.ref``).  The gather formulation is exact but builds
per-token adapter matrices, so it is only used at test scale."""
from __future__ import annotations

import torch


def rank_mask(xa: torch.Tensor, ids: torch.Tensor,
              ranks: torch.Tensor) -> torch.Tensor:
    """Zero lanes >= r_i for each token's adapter (rank-aware tiles)."""
    r_tok = ranks[ids]                                    # (T,)
    lane = torch.arange(xa.shape[-1], device=xa.device)[None, :]
    return xa * (lane < r_tok[:, None]).to(xa.dtype)


def fused_lora_ref(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                   ids: torch.Tensor, ranks: torch.Tensor,
                   scalings: torch.Tensor) -> torch.Tensor:
    """y_t = s[a(t)] * ((x_t @ A[a(t)]) @ B[a(t)]), rank-masked.

    x: (T, d_in); A: (K, d_in, r); B: (K, r, d_out); ids: (T,) int.
    The compact intermediate is held in x.dtype, as the kernels hold it.
    """
    ids = ids.long()
    a_tok = A[ids]                                        # (T, d_in, r)
    b_tok = B[ids]                                        # (T, r, d_out)
    xa = torch.einsum("td,tdr->tr", x.float(), a_tok.float())
    xa = rank_mask(xa, ids, ranks).to(x.dtype)
    y = torch.einsum("tr,tro->to", xa.float(), b_tok.float())
    y = y * scalings[ids][:, None]
    return y.to(x.dtype)


def grouped_matmul_ref(x: torch.Tensor, W: torch.Tensor,
                       ids: torch.Tensor) -> torch.Tensor:
    """y_t = x_t @ W[a(t)].  x: (T, d_in); W: (K, d_in, d_out)."""
    w_tok = W[ids.long()]
    y = torch.einsum("td,tdo->to", x.float(), w_tok.float())
    return y.to(x.dtype)


def grouped_wgrad_ref(x: torch.Tensor, g: torch.Tensor, ids: torch.Tensor,
                      num_adapters: int) -> torch.Tensor:
    """out[k] = Σ_{t: ids[t]=k} x_tᵀ g_t — oracle for the grouped wgrad.

    x: (T, d_in); g: (T, d_out); returns (K, d_in, d_out) f32.  The one-hot
    densification over K is what the kernel avoids; fine at test scale."""
    onehot = torch.nn.functional.one_hot(ids.long(), num_adapters).float()
    return torch.einsum("tk,td,to->kdo", onehot, x.float(), g.float())


def fused_lora_loop(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                    ids: torch.Tensor, ranks: torch.Tensor,
                    scalings: torch.Tensor) -> torch.Tensor:
    """The unfused baseline of the Fig. 7 ablation: one masked GEMM pair
    per adapter, K separate launches."""
    T, _ = x.shape
    K = A.shape[0]
    y = torch.zeros((T, B.shape[-1]), dtype=torch.float32, device=x.device)
    lane = torch.arange(A.shape[-1], device=x.device)[None, :]
    for k in range(K):
        sel = (ids == k).float()[:, None]
        xa = (x.float() * sel) @ A[k].float()
        xa = xa * (lane < ranks[k]).float()
        y = y + scalings[k] * (xa @ B[k].float()) * sel
    return y.to(x.dtype)
