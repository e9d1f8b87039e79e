"""Multi-adapter LoRA parameters and application (port of
``repro.core.lora``).

K heterogeneous adapters (ranks r_1..r_K) over one frozen backbone are
stored PACKED along the rank axis with per-adapter padding:

    A: (d_in, R)   R = Σ_k r_pad_k;  job k owns columns
                   [off_k, off_k + r_pad_k), zero beyond rank r_k
    B: (R, d_out)  same row segments

``MultiLoRA.apply(x, {"A", "B"})`` computes, per token t with adapter a(t),
``y_t = scaling[a] * ((x_t @ A[seg_a]) @ B[seg_a])`` without ever forming
A B^T.  Implementations: "ref" (gather oracle over a densified stack),
"loop" (one GEMM pair per adapter), "cuda" (the hand-written Hopper
kernels via kernels/ops.py; their plain PyTorch versions on CPU tensors)
and "torch" (the reference's "xla" path in plain PyTorch: segment-dense
batched products per rank bucket, or per stacked group for a uniform
layout, with the reference's hand-written backward; no kernel of this
repository runs).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.jobs import LoRAJobSpec


def pad_rank(r_max: int, multiple: int = 8) -> int:
    """Pad a rank to whole rank tiles of width *multiple*."""
    return max(multiple, ((r_max + multiple - 1) // multiple) * multiple)


def rank_axis_is_last(leaf_name: str) -> bool:
    """The packed-leaf axis convention: leaves named ``A`` carry the
    packed rank axis LAST (``(..., d, R)``), ``B`` leaves carry it
    second-to-last (``(..., R, d)``)."""
    return leaf_name.endswith("A")


@dataclass(frozen=True)
class RankLayout:
    """Packed ragged rank layout of one fused group (hashable, static).

    ``pads`` overrides the per-job padded widths (uniform historical
    padding); by default every job pads independently to
    ``pad_rank(rank, multiple)``, so a job's segment width never depends
    on who it is fused with.
    """
    ranks: Tuple[int, ...]
    multiple: int = 8
    pads: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        assert self.ranks, "layout needs at least one job"
        if self.pads is not None:
            assert len(self.pads) == len(self.ranks)
            for r, p in zip(self.ranks, self.pads):
                assert p >= r and p % self.multiple == 0, (r, p)

    @classmethod
    def for_jobs(cls, jobs: Sequence[LoRAJobSpec],
                 multiple: int = 8) -> "RankLayout":
        return cls(tuple(int(j.rank) for j in jobs), multiple)

    @classmethod
    def uniform(cls, ranks: Sequence[int], r_pad: int,
                multiple: Optional[int] = None) -> "RankLayout":
        """Every job padded to the same width (legacy max-rank padding)."""
        m = multiple or min(r_pad, 8)
        return cls(tuple(int(r) for r in ranks), m,
                   pads=tuple(r_pad for _ in ranks))

    @property
    def num_jobs(self) -> int:
        return len(self.ranks)

    @cached_property
    def r_pads(self) -> Tuple[int, ...]:
        if self.pads is not None:
            return self.pads
        return tuple(pad_rank(r, self.multiple) for r in self.ranks)

    @cached_property
    def is_uniform(self) -> bool:
        """True when every job pads to the same width: the packed
        (d, K*rp) pair is then a free reshape of the stacked (K, d, rp)
        layout, and the masked kernel family applies with no waste."""
        return len(set(self.r_pads)) == 1

    @cached_property
    def offsets(self) -> Tuple[int, ...]:
        out, off = [], 0
        for p in self.r_pads:
            out.append(off)
            off += p
        return tuple(out)

    @property
    def total(self) -> int:
        return sum(self.r_pads)

    @property
    def max_r_pad(self) -> int:
        return max(self.r_pads)

    def slice_of(self, k: int) -> Tuple[int, int]:
        """(column offset, padded width) of job *k*'s segment."""
        return self.offsets[k], self.r_pads[k]

    @cached_property
    def buckets(self) -> Tuple[Tuple[int, Tuple[int, ...]], ...]:
        """((r_pad, job indices), ...), buckets sorted descending."""
        by: Dict[int, List[int]] = {}
        for k, p in enumerate(self.r_pads):
            by.setdefault(p, []).append(k)
        return tuple((p, tuple(by[p])) for p in sorted(by, reverse=True))

    @cached_property
    def col_jobs(self) -> np.ndarray:
        """(total,) packed column -> owning job index."""
        return np.repeat(np.arange(self.num_jobs, dtype=np.int32),
                         np.asarray(self.r_pads, np.int64))

    @cached_property
    def active_cols(self) -> np.ndarray:
        """(total,) bool — lanes < the owning job's true rank."""
        lane = np.concatenate([np.arange(p) for p in self.r_pads])
        return lane < np.asarray(self.ranks)[self.col_jobs]


def init_adapter_pair(layout: RankLayout, d_in: int, d_out: int, *,
                      generator: torch.Generator, layers: int,
                      device="cuda") -> Dict[str, torch.Tensor]:
    """Standard LoRA init in the packed ragged layout, stacked over
    *layers*: A ~ N(0, 1/r_pad_k) with lanes >= rank zeroed, B = 0."""
    As, Bs = [], []
    for r, rp in zip(layout.ranks, layout.r_pads):
        a = torch.randn((layers, d_in, rp), generator=generator,
                        device=device) * (1.0 / rp) ** 0.5
        a[..., r:] = 0.0
        As.append(a)
        Bs.append(torch.zeros((layers, rp, d_out), device=device))
    return {"A": torch.cat(As, dim=-1), "B": torch.cat(Bs, dim=-2)}


def unpack_dense(A: torch.Tensor, B: torch.Tensor, layout: RankLayout,
                 r_pad: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed (..., d, R)/(..., R, d) -> stacked (..., K, d, rm)/(..., K,
    rm, d) at a uniform width (default: the layout max)."""
    rm = r_pad or layout.max_r_pad
    As, Bs = [], []
    for k in range(layout.num_jobs):
        off, rp = layout.slice_of(k)
        w = min(rp, rm)
        a = A[..., off:off + w]
        b = B[..., off:off + w, :]
        pad = rm - w
        if pad:
            a = torch.nn.functional.pad(a, (0, pad))
            b = torch.nn.functional.pad(b, (0, 0, 0, pad))
        As.append(a)
        Bs.append(b)
    return torch.stack(As, dim=-3), torch.stack(Bs, dim=-3)


@dataclass
class MultiLoRA:
    """Apply context for one fused group: token→adapter map + impl choice
    (the single-device forward subset of the reference's context)."""
    adapter_ids: torch.Tensor         # (B,) int32 per-sequence adapter index
    ranks: torch.Tensor               # (K,) int32
    scalings: torch.Tensor            # (K,) f32   alpha_i / r_i
    impl: str = "ref"                 # ref | loop | cuda | torch
    block_t: int = 128                # kernel token tile
    seg_rows: Optional[int] = None    # static max rows per adapter segment
    equal_segments: bool = False      # every adapter contributes seg_rows
    layout: Optional[RankLayout] = None
    rows_all: Optional[Tuple[int, ...]] = None   # static per-job rows of
    #                                   the full fused batch

    @property
    def num_adapters(self) -> int:
        return int(self.ranks.shape[0])

    def token_ids(self, batch: int, seq: int) -> torch.Tensor:
        """Per-token adapter ids for an (batch, seq) activation."""
        return self.adapter_ids.repeat_interleave(seq)

    def _slice_rows(self, bsz: int) -> Optional[Tuple[int, ...]]:
        """Per-job rows of the batch when it is the full fused batch
        (None otherwise: a contiguous sub-batch has no static tile map)."""
        if self.rows_all is None or bsz != sum(self.rows_all):
            return None
        return tuple(self.rows_all)

    def apply(self, x: torch.Tensor, ab: Dict[str, torch.Tensor]
              ) -> torch.Tensor:
        """x: (B, S, d_in) -> (B, S, d_out) LoRA delta (scaled)."""
        from repro_torch.kernels import ops
        A, B = ab["A"].to(x.dtype), ab["B"].to(x.dtype)
        bsz, seq, d_in = x.shape
        xf = x.reshape(bsz * seq, d_in)
        ids = self.token_ids(bsz, seq)
        # the "torch" impl's batched path: this batch is the full fused
        # batch and every adapter owns seg_rows of its rows
        eq = (self.equal_segments
              and self.seg_rows is not None
              and bsz == self.seg_rows * self.num_adapters)
        if (self.layout is not None and self.layout.is_uniform
                and self.impl in ("torch", "cuda")):
            # uniform padded widths: the packed (d, K*rp) pair reshapes
            # into the stacked (K, d, rp) contract of the MASKED family
            # (a strided view, no copy); lanes >= the true rank stay
            # masked via ``ranks``
            rp = self.layout.r_pads[0]
            K = self.layout.num_jobs
            A_st = A.reshape(d_in, K, rp).movedim(-2, -3)
            B_st = B.reshape(K, rp, B.shape[-1])
            out = ops.fused_lora(xf, A_st, B_st, ids, self.ranks,
                                 self.scalings, impl=self.impl,
                                 block_t=self.block_t, equal_segments=eq)
        elif self.layout is not None:
            out = ops.fused_lora_ragged(
                xf, A, B, ids, self.scalings, self.layout, impl=self.impl,
                block_t=self.block_t, equal_segments=eq,
                slice_rows=self._slice_rows(bsz), seq_len=seq,
                ranks=self.ranks)
        else:
            out = ops.fused_lora(xf, A, B, ids, self.ranks, self.scalings,
                                 impl=self.impl, block_t=self.block_t,
                                 equal_segments=eq)
        return out.reshape(bsz, seq, -1)


def proj(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
         lora: Optional[MultiLoRA] = None,
         ab: Optional[Dict[str, torch.Tensor]] = None,
         row_block: Optional[int] = None) -> torch.Tensor:
    """Frozen dense projection + optional fused multi-LoRA delta.

    ``w`` may be a quantized ``models/quant.QuantTensor``: ``qdot`` fuses
    the int8 dequant into the base matmul; the LoRA delta path is
    untouched (adapters stay high precision and take the gradient).
    ``row_block``: the base product's rows per product
    (``models/layers.dense``)."""
    from repro_torch.models.layers import dense   # lazy: models imports us
    y = dense(x, w, row_block)
    if b is not None:
        y = y + b.to(y.dtype)
    if lora is not None and ab is not None:
        y = y + lora.apply(x, ab).to(y.dtype)
    return y


# ---------------------------------------------------------------------
# Group-level parameter construction
# ---------------------------------------------------------------------
def merge_adapter_pair(pairs: Sequence[Dict[str, torch.Tensor]],
                       layout: Optional[RankLayout] = None
                       ) -> Dict[str, torch.Tensor]:
    """Pack per-job (d, r_i) pairs into one ragged (d, R) pair, each job
    re-padded to ITS OWN destination width ``layout.r_pads[k]``;
    shrinking drops lanes that must be zero."""
    widths = [int(p["A"].shape[-1]) for p in pairs]
    layout = layout or RankLayout(tuple(widths))
    assert layout.num_jobs == len(pairs)
    As, Bs = [], []
    for p, rp in zip(pairs, layout.r_pads):
        a, b = p["A"], p["B"]
        pad_a = rp - a.shape[-1]
        if pad_a < 0:    # source wider than destination: drop zero lanes
            a, b = a[:, :rp], b[:rp, :]
            pad_a = 0
        As.append(torch.nn.functional.pad(a, (0, pad_a)))
        Bs.append(torch.nn.functional.pad(b, (0, 0, 0, pad_a)))
    return {"A": torch.cat(As, dim=-1), "B": torch.cat(Bs, dim=0)}


def extract_adapter(ab: Dict[str, torch.Tensor], layout: RankLayout,
                    idx: int, rank: Optional[int] = None
                    ) -> Dict[str, torch.Tensor]:
    """Job *idx*'s un-padded adapter out of the packed pair."""
    off, _ = layout.slice_of(idx)
    r = rank or layout.ranks[idx]
    return {"A": ab["A"][..., :, off:off + r],
            "B": ab["B"][..., off:off + r, :]}
