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

Tensor parallelism (``tp``: ``models/layers.ModelAxis``): a model rank
runs its H/m heads.  ``w_in``'s columns are the concatenation [z, x, B,
C, dt], so the rank's block of it is taken segment by segment
(``tp_columns``): z and x by its heads, B and C by its groups (8/m, or
where m is a multiple of 8 the one group its m/8 replicas share), dt
whole; ``conv_w`` by the same x, B, C channels; ``A_log``, ``D``,
``dt_bias`` and ``gate_norm`` by heads; ``w_out`` by rows.  The
in-projection is column parallel (its LoRA delta whole on every rank,
cut to the rank's columns by ``ModelAxis.cut``), the conv, scan and
decode step local, the gated RMSNorm over the whole d_inner one f32
all-reduce of the rows' sums of squares, the out-projection row
parallel.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.lora import MultiLoRA, proj, row_proj
from repro_torch.models.layers import (dense_init, dtype_of, grad_cast,
                                       rms_norm, softplus)

NGROUPS = 8   # B/C projection groups


def tp_heads(H: int, size: int, index: int) -> Tuple[slice, slice]:
    """(heads, groups): model rank *index*'s heads (H/m, contiguous) and
    the B/C groups they read (8/m where m divides 8; where m is a
    multiple of 8, the one group the rank's heads lie in, shared by m/8
    ranks).  Any other m would split a head or a group: refused here,
    since the mixer then runs whole (``models/model.mixer_runs_whole``)."""
    if H % size or (NGROUPS % size and size % NGROUPS):
        raise ValueError(f"a model axis of {size} does not divide {H} SSD "
                         f"heads, or neither divides nor is a multiple of "
                         f"its {NGROUPS} groups: the mixer runs whole")
    hl = H // size
    heads = slice(index * hl, (index + 1) * hl)
    if NGROUPS % size == 0:
        gl = NGROUPS // size
        return heads, slice(index * gl, (index + 1) * gl)
    g = index // (size // NGROUPS)
    return heads, slice(g, g + 1)


def tp_columns(di: int, N: int, H: int, size: int,
               index: int) -> dict:
    """Model rank *index*'s columns (slices, side by side) of each SSD
    leaf cut over the model axis, by leaf name: ``w_in``'s [z, x, B, C,
    dt] segment by segment (dt whole), ``conv_w``'s [x, B, C] channels,
    and the per-head and per-channel vectors."""
    heads, groups = tp_heads(H, size, index)
    P = di // H
    ch = slice(heads.start * P, heads.stop * P)
    gb = slice(groups.start * N, groups.stop * N)
    sh = lambda sl, o: slice(sl.start + o, sl.stop + o)
    GN = NGROUPS * N
    return {"w_in": (ch, sh(ch, di), sh(gb, 2 * di), sh(gb, 2 * di + GN),
                     slice(2 * di + 2 * GN, 2 * di + 2 * GN + H)),
            "conv_w": (ch, sh(gb, di), sh(gb, di + GN)),
            "A_log": (heads,), "D": (heads,), "dt_bias": (heads,),
            "gate_norm": (ch,)}


def _widths(cfg, tp) -> Tuple[int, int]:
    """(heads, groups) a rank holds (the whole model's without *tp*)."""
    if tp is None:
        return cfg.ssm_nheads, NGROUPS
    heads, groups = tp_heads(cfg.ssm_nheads, tp.size, tp.index)
    return heads.stop - heads.start, groups.stop - groups.start


class SSDCache(NamedTuple):
    state: torch.Tensor   # (L?, B, H, P, N) f32
    conv: torch.Tensor    # (L?, B, conv_w - 1, conv_dim): causal-conv tail

    @staticmethod
    def init(batch, cfg, layers: Optional[int] = None, device="cuda",
             tp=None):
        """Zeroed state and conv tail; under *tp* the model rank's: its
        heads' state, its channels' tail (``tp_columns``)."""
        H, G = _widths(cfg, tp)
        P, N = cfg.ssm_head_dim, cfg.ssm_state
        conv_dim = H * P + 2 * G * N
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


def _sum_squares(xf: torch.Tensor) -> torch.Tensor:
    """The rows' sums of squares (..., 1), f32: a model rank's term of
    the gated norm's variance."""
    return (xf * xf).sum(dim=-1, keepdim=True)


def _gated_norm(y: torch.Tensor, gamma: torch.Tensor, eps: float, tp,
                width: int, row_block: Optional[int]) -> torch.Tensor:
    """``rms_norm`` of a rank's d_inner/m columns *y* over the whole
    d_inner (*width*): the ranks' f32 sums of squares summed over the
    axis (``ModelAxis.sum``; the cotangents of the sum summed back,
    ``enter``: each rank's columns read it)."""
    xf = y.float()
    var = tp.sum(tp.enter(_sum_squares(xf)), row_block=row_block) / width
    out = xf * torch.rsqrt(var + eps) * (1.0 + gamma.float())
    return out.to(y.dtype)


def ssd_block(cfg, params: dict, x: torch.Tensor, *,
              lora: Optional[MultiLoRA] = None,
              lora_ab: Optional[dict] = None,
              cache: Optional[SSDCache] = None,
              chunk: Optional[int] = None,
              row_block: Optional[int] = None, tp=None
              ) -> Tuple[torch.Tensor, Optional[SSDCache]]:
    """Full Mamba-2 mixer. x: (B, S, d) -> (y, cache).  With a cache: S =
    1 is one recurrent step, S > 1 a chunked prefill from the cached
    state; the cache is updated in place.  ``row_block``: rows per
    in/out product and per sum over the model axis (the serving
    decode); ``tp``: the model rank's heads (module docstring; its
    cache the rank's, ``SSDCache.init(tp=)``)."""
    B, S, _ = x.shape
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    H, G = _widths(cfg, tp)
    di = H * P
    la = lora_ab or {}
    rb = row_block
    if tp is None:
        zxbcdt = proj(x, params["w_in"], None, lora, la.get("ssd_in"), rb)
        dt = zxbcdt[..., -H:]
    else:
        zxbcdt = tp.column(x, params["w_in"], rb)
        if lora is not None and la.get("ssd_in") is not None:
            cols = tp_columns(cfg.ssm_d_inner, N, cfg.ssm_nheads, tp.size,
                              tp.index)["w_in"]
            d = tp.cut(lora.apply(x, la["ssd_in"]), cols)
            zxbcdt = zxbcdt + d.to(zxbcdt.dtype)
        heads, _ = tp_heads(cfg.ssm_nheads, tp.size, tp.index)
        dt = zxbcdt[..., zxbcdt.shape[-1] - cfg.ssm_nheads:][..., heads]
    z, xBC = torch.split(zxbcdt[..., :2 * di + 2 * G * N],
                         [di, di + 2 * G * N], dim=-1)
    dt = softplus(dt.float() + params["dt_bias"])

    new_conv = None
    if cache is not None:
        new_conv = torch.cat([cache.conv.to(xBC.dtype), xBC],
                             dim=1)[:, -(cfg.ssm_conv - 1):]
        xBC = _causal_conv(xBC, params["conv_w"], cache.conv)
    else:
        xBC = _causal_conv(xBC, params["conv_w"])
    xBC = F.silu(xBC.float()).to(x.dtype)
    xs, Bm, Cm = torch.split(xBC, [di, G * N, G * N], dim=-1)
    xs = xs.reshape(B, S, H, P)
    hpg = H // G                           # broadcast groups to heads
    Bm = Bm.reshape(B, S, G, N).repeat_interleave(hpg, dim=2)
    Cm = Cm.reshape(B, S, G, N).repeat_interleave(hpg, dim=2)

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
    if tp is None:
        y = rms_norm(y, params["gate_norm"], cfg.norm_eps)
        return proj(y, params["w_out"], None, lora, la.get("ssd_out"),
                    rb), cache
    y = _gated_norm(y, params["gate_norm"], cfg.norm_eps, tp,
                    cfg.ssm_d_inner, rb)
    return row_proj(tp, y, params["w_out"], lora, la.get("ssd_out"),
                    rb), cache
