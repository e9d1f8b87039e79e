"""Mamba-2 SSD (state-space duality) mixer, chunked scan (port of
``repro.models.ssd``) [arXiv:2405.21060].

Training and prefill use the SSD block decomposition: quadratic,
attention-like work inside length-``chunk`` blocks, plus a linear
recurrence over the chunk states (the reference's ``lax.scan``, here a
loop over the chunks).  Decode carries a (B, H, P, N) state: O(1) a
token.  Every einsum the reference runs with
``preferred_element_type=float32`` runs here on float32 copies of its
storage-dtype operands (the products are exact in f32, the sums are
f32), and the reference's bf16 storage of ``CBL``, ``xdt_w``, ``Cdec``
and the states is kept.

One departure, a repair: ``_segsum_decay`` masks the upper triangle
before ``exp`` (the reference masks after it, so at full width, where dt
sums past 88 over a chunk, ``exp`` overflows there and the VJP of the
mask gives 0 · inf = NaN; ROADMAP C7).  The forward values are the same.

LoRA targets: the in/out projections (``ssd_in`` / ``ssd_out``).  A
cache's state and conv tail are written IN PLACE (the reference returns
new arrays): the caller's layer-stacked cache is the one that decodes
next.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.lora import MultiLoRA, proj
from repro_torch.models.layers import (dense_init, dtype_of, grad_cast,
                                       rms_norm, softplus)

NGROUPS = 8   # B/C projection groups


class SSDCache(NamedTuple):
    state: torch.Tensor   # (L?, B, H, P, N) f32
    conv: torch.Tensor    # (L?, B, conv_w - 1, conv_dim): causal-conv tail

    @staticmethod
    def init(batch, cfg, layers: Optional[int] = None, device="cuda"):
        H, P, N = cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state
        conv_dim = cfg.ssm_d_inner + 2 * NGROUPS * N
        ls = (layers,) if layers is not None else ()
        return SSDCache(
            torch.zeros(ls + (batch, H, P, N), device=device),
            torch.zeros(ls + (batch, cfg.ssm_conv - 1, conv_dim),
                        dtype=dtype_of(cfg), device=device))


def ssd_init(cfg, dtype, *, generator: torch.Generator, device="cuda",
             layers: int = 1) -> dict:
    """The reference's distributions, stacked over *layers*: A = -1
    (A_log 0), D = 1, dt_bias 0, the conv weights N(0, 0.2^2)."""
    d, di, N, H = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_nheads
    conv_dim = di + 2 * NGROUPS * N
    d_in_proj = 2 * di + 2 * NGROUPS * N + H      # z, xBC, dt
    kw = dict(generator=generator, device=device, layers=layers)
    w_in = dense_init(d, d_in_proj, dtype, **kw)
    conv_w = (torch.randn((layers, cfg.ssm_conv, conv_dim),
                          generator=generator, device=device) * 0.2).to(dtype)
    return {"w_in": w_in, "conv_w": conv_w,
            "A_log": torch.zeros((layers, H), device=device),
            "D": torch.ones((layers, H), device=device),
            "dt_bias": torch.zeros((layers, H), device=device),
            "gate_norm": torch.zeros((layers, di), device=device),
            "w_out": dense_init(di, d, dtype, **kw)}


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv along seq. x: (B, S, C); w: (cw, C); tail:
    (B, cw-1, C), the previous inputs (decode continuity).  Products and
    sums in x's dtype, in the reference's order."""
    cw = w.shape[0]
    if tail is None:
        tail = x.new_zeros((x.shape[0], cw - 1, x.shape[2]))
    xp = torch.cat([tail.to(x.dtype), x], dim=1)
    S = x.shape[1]
    return sum(xp[:, i:i + S] * w[i].to(x.dtype)[None, None, :]
               for i in range(cw))


def _segsum_decay(dA_cs: torch.Tensor) -> torch.Tensor:
    """L[i, j] = exp(dA_cs[..., i] - dA_cs[..., j]) for i >= j else 0.
    dA_cs: (..., L). Returns (..., L, L).  The upper triangle is masked
    before ``exp``, so neither its value nor its gradient can overflow."""
    L = dA_cs.shape[-1]
    diff = dA_cs[..., :, None] - dA_cs[..., None, :]
    mask = torch.ones((L, L), dtype=torch.bool,
                      device=dA_cs.device).tril()
    return torch.where(mask, torch.exp(torch.where(mask, diff, 0.0)), 0.0)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. x: (B,S,H,P); dt: (B,S,H) f32; A: (H,) (negative);
    Bm/Cm: (B,S,H,N) (already head-broadcast). Returns (y in x's dtype,
    final state f32).  Raises ValueError unless chunk divides S."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if S % chunk:
        raise ValueError(f"ssd_scan: a sequence of {S} tokens is not whole "
                         f"chunks of {chunk}")
    nc = S // chunk
    r = lambda t: t.reshape(Bsz, nc, chunk, *t.shape[2:])
    xc, dtc, Bc, Cc = r(x), r(dt), r(Bm), r(Cm)
    f32 = torch.float32

    dA = dtc * A                                      # (B,nc,L,H)
    dA_cs = torch.cumsum(dA, dim=2)
    xdt = xc * dtc[..., None]                         # x·dt, f32

    # intra-chunk (quadratic in L), the decay/score products stored in
    # the storage dtype
    lp = x.dtype
    Lmat = _segsum_decay(dA_cs.transpose(2, 3))      # (B,nc,H,L,L)
    CB = torch.einsum("bclhn,bcshn->bchls", Cc.to(f32), Bc.to(f32))
    CBL = (CB * Lmat).to(lp)
    y_diag = torch.einsum("bchls,bcshp->bclhp", CBL.to(f32),
                          xdt.to(lp).to(f32))

    # chunk states: S_c = sum_s exp(dA_cs[L-1] - dA_cs[s]) B_s (x·dt)_s
    decay_out = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)
    xdt_w = (xdt * decay_out[..., None]).to(lp)
    states = torch.einsum("bcshn,bcshp->bchpn", Bc.to(f32), xdt_w.to(f32))

    # inter-chunk linear recurrence over the chunk states
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])      # (B,nc,H)
    s = (x.new_zeros((Bsz, H, P, N), dtype=f32) if init_state is None
         else init_state.to(f32))
    prev = []
    for c in range(nc):                              # the state before c
        prev.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)           # (B,nc,H,P,N)

    # inter-chunk output: y_off = C_s exp(dA_cs[s]) S_prev
    Cdec = (Cc.to(f32) * torch.exp(dA_cs)[..., None]).to(lp)
    y_off = torch.einsum("bclhn,bchpn->bclhp", Cdec.to(f32),
                         prev_states.to(lp).to(f32))
    y = grad_cast((y_diag + y_off).to(lp)).reshape(Bsz, S, H, P)
    return y, s


def ssd_block(cfg, params: dict, x: torch.Tensor, *,
              lora: Optional[MultiLoRA] = None,
              lora_ab: Optional[dict] = None,
              cache: Optional[SSDCache] = None,
              chunk: Optional[int] = None
              ) -> Tuple[torch.Tensor, Optional[SSDCache]]:
    """Full Mamba-2 mixer. x: (B, S, d) -> (y, cache).  With a cache: S =
    1 is one recurrent step, S > 1 a chunked prefill from the cached
    state; the cache is updated in place."""
    B, S, _ = x.shape
    di, N, H, P = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_nheads,
                   cfg.ssm_head_dim)
    la = lora_ab or {}
    zxbcdt = proj(x, params["w_in"], None, lora, la.get("ssd_in"))
    z, xBC, dt = torch.split(zxbcdt, [di, di + 2 * NGROUPS * N, H], dim=-1)
    dt = softplus(dt.float() + params["dt_bias"])

    new_conv = None
    if cache is not None:
        new_conv = torch.cat([cache.conv.to(xBC.dtype), xBC],
                             dim=1)[:, -(cfg.ssm_conv - 1):]
        xBC = _causal_conv(xBC, params["conv_w"], cache.conv)
    else:
        xBC = _causal_conv(xBC, params["conv_w"])
    xBC = F.silu(xBC.float()).to(x.dtype)
    xs, Bm, Cm = torch.split(xBC, [di, NGROUPS * N, NGROUPS * N], dim=-1)
    xs = xs.reshape(B, S, H, P)
    hpg = H // NGROUPS                     # broadcast groups to heads
    Bm = Bm.reshape(B, S, NGROUPS, N).repeat_interleave(hpg, dim=2)
    Cm = Cm.reshape(B, S, NGROUPS, N).repeat_interleave(hpg, dim=2)

    A = -torch.exp(params["A_log"])
    if cache is not None and S == 1:
        # ---- single-step decode
        dA = torch.exp(dt[:, 0] * A[None, :])                    # (B,H)
        upd = torch.einsum("bh,bhp,bhn->bhpn", dt[:, 0], xs[:, 0].float(),
                           Bm[:, 0].float())
        state = cache.state * dA[:, :, None, None] + upd
        y = torch.einsum("bhn,bhpn->bhp", Cm[:, 0].float(), state)[:, None]
    else:
        y, state = ssd_scan(xs, dt, A, Bm, Cm, min(chunk or cfg.ssm_chunk,
                                                   S),
                            init_state=(cache.state if cache is not None
                                        else None))
    if cache is not None:
        cache.state.copy_(state)
        cache.conv.copy_(new_conv)

    y = y.float() + params["D"][None, None, :, None] * xs.float()
    y = y.reshape(B, S, di).to(x.dtype)
    # gated RMSNorm (mamba2): norm(y * silu(z))
    y = y * F.silu(z.float()).to(x.dtype)
    y = rms_norm(y, params["gate_norm"], cfg.norm_eps)
    out = proj(y, params["w_out"], None, lora, la.get("ssd_out"))
    return out, cache
