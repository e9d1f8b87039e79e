"""Fused multi-LoRA serving engine: batched prefill + decode over one
frozen backbone with per-request adapter routing (port of
``repro.serve.engine``).

The batch layout is the reference's:

  * requests SORT BY ADAPTER into contiguous segments (the LoRA kernels'
    job-major contract) and each segment's row count pads to the kernel
    row granule — ``block_t`` rows for ``impl="cuda"`` (decode tokens
    arrive one per row, so rows ARE the token tile), 1 otherwise;
  * prompts RIGHT-pad to a ``block_t``-aligned width, so prefill at
    position 0 is exact and each request's first token reads
    ``logits[row, len_r - 1]``;
  * decode runs with PER-ROW positions (per-row KV scatter, rope and key
    masking), over key chunks of a fixed width, so a fused batch decodes
    exactly like each request solo.  On the card, where cuBLAS picks its
    summation order by row and batch count, the decode steps run their
    dense products and attention's chunk products on one row granule at
    a time (``row_blocks``), so that holds there bit for bit too;
  * the KV buffer pads to ``block_t`` past ``prompt_width + max_new``
    (and the caches round it up to whole decode-attention key chunks).

Prefill is ``decode_step`` at width S; the decode loop (the reference's
``lax.scan``) is a Python loop whose tokens stay on the device, with
one host copy per batch.  Per-request ``max_new_tokens`` and stop tokens
truncate each returned row.  It serves the token decoders whose mixers
keep position-indexed caches: GQA attention (the dense families, the MoE
qwen3-moe-30b-a3b) and MLA (deepseek-v2-lite-16b: latent caches, the
absorbed decode, whose products take the row blocks too and whose sums
run over fixed-width key chunks, as GQA decode's do).  A MoE FFN's
expert products group a row with whatever rows routed to the same
expert, so no row block reaches them: fused and solo decode the same
ids only as far as those products give a row the same bits in any group
(ROADMAP C9).  Recurrent
mixers, local attention (ring caches), the audio and VLM front ends and
non-causal configs are rejected at construction, as in the reference.  ``quantize="int8"``
quantizes the backbone once, at construction; every base projection then
runs the dequant-matmul kernel.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.lora import MultiLoRA
from repro_torch.models import model as M
from repro_torch.models import quant
from repro_torch.serve.pool import AdapterPool, FusedAdapters


def _align(n: int, m: int) -> int:
    """Round *n* up to a multiple of *m* (the tile_rows granule rule)."""
    return ((n + m - 1) // m) * m


@dataclass
class ServeRequest:
    """One inference request routed to a published adapter by name."""
    prompt: np.ndarray                # (len,) int32 token ids
    adapter: str                      # name in the AdapterPool
    max_new_tokens: int = 16
    stop_token: Optional[int] = None  # truncate at (and including) this id


@dataclass
class ServeResult:
    adapter: str
    prompt_len: int
    tokens: np.ndarray                # (n,) generated ids, n <= max_new_tokens


class _Batch(NamedTuple):
    """One fused batch laid out for the model (all tensors on device)."""
    fused: FusedAdapters
    rows: Tuple[int, ...]             # padded rows per adapter segment
    row_req: List[Optional[int]]      # request index per row (None = pad)
    tokens: torch.Tensor              # (B, S) right-padded prompts
    ids: torch.Tensor                 # (B,) adapter index per row
    lens: torch.Tensor                # (B,) prompt length per row
    buf: int                          # KV buffer width
    max_new: int


@dataclass
class ServeEngine:
    """Batched multi-adapter serving over one backbone + adapter pool."""
    cfg: ModelConfig
    params: dict
    pool: AdapterPool
    impl: str = "cuda"                # fused-LoRA kernel impl
    block_t: int = 16                 # token tile of the LoRA kernels
    greedy: bool = True
    # int8 frozen backbone (models/quant): halves the resident weight
    # bytes and the weight bytes every decode step streams.  None = keep
    # the params' dtype (an already-quantized tree passes through).
    quantize: Optional[str] = None
    # decode steps on the card run every dense and attention chunk
    # product one row granule (a solo request's rows) at a time; False
    # runs each whole, faster, and fused and solo may then part
    row_blocks: bool = True

    def __post_init__(self):
        cfg = self.cfg
        self.params = quant.quantize_params(self.params, self.quantize)
        if not cfg.causal:
            raise ValueError("serving needs a causal decoder config")
        if cfg.family in ("audio", "vlm"):
            raise ValueError(
                f"serving engine takes token prompts; family={cfg.family!r} "
                "frontends are not routable per-request")
        for seg in M.segment_plan(cfg):
            for spec in seg.specs:
                if spec.mixer not in ("attn", "mla"):
                    raise ValueError(
                        f"mixer {spec.mixer!r} keeps recurrent/ring state; "
                        "the fused serving engine needs position-indexed "
                        "caches (attn/mla)")
        if not self.greedy:
            raise NotImplementedError("only greedy decoding is implemented")

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device

    @property
    def _granule(self) -> int:
        """Rows per adapter segment: a solo request's row count."""
        return self.block_t if self.impl == "cuda" else 1

    @property
    def _row_block(self) -> Optional[int]:
        """Rows per product in the decode steps: the granule on the card
        (with ``row_blocks``), else None (whole products)."""
        return (self._granule if self.row_blocks
                and self.device.type == "cuda" else None)

    # ------------------------------------------------------------ layout
    def _batch(self, requests: Sequence[ServeRequest]) -> _Batch:
        assert requests, "serve needs at least one request"
        for r in requests:
            assert len(r.prompt) >= 1, "empty prompt"
            assert r.max_new_tokens >= 1, "max_new_tokens must be >= 1"
        names = tuple(sorted({r.adapter for r in requests}))
        fused = self.pool.acquire(names)

        # adapter-major row layout, segment rows padded to the granule
        granule = self._granule
        rows: List[int] = []
        row_req: List[Optional[int]] = []
        for n in names:
            idxs = [i for i, r in enumerate(requests) if r.adapter == n]
            n_rows = _align(len(idxs), granule)
            rows.append(n_rows)
            row_req.extend(idxs + [None] * (n_rows - len(idxs)))
        B = sum(rows)

        max_new = max(r.max_new_tokens for r in requests)
        S = _align(max(len(r.prompt) for r in requests), self.block_t)
        buf = _align(S + max_new, self.block_t)

        tokens = np.zeros((B, S), np.int32)
        lens = np.ones((B,), np.int32)
        ids = np.repeat(np.arange(len(rows), dtype=np.int32), rows)
        for row, ri in enumerate(row_req):
            if ri is None:
                continue                     # pad row: 1 zero token
            p = np.asarray(requests[ri].prompt, np.int32)
            tokens[row, :len(p)] = p         # RIGHT-pad
            lens[row] = len(p)
        dev = self.device
        return _Batch(fused, tuple(rows), row_req,
                      torch.from_numpy(tokens).to(dev),
                      torch.from_numpy(ids).to(dev),
                      torch.from_numpy(lens).to(dev), buf, max_new)

    def _lora(self, b: _Batch) -> MultiLoRA:
        return MultiLoRA(adapter_ids=b.ids, ranks=b.fused.ranks,
                         scalings=b.fused.scalings, impl=self.impl,
                         block_t=self.block_t, layout=b.fused.layout,
                         rows_all=b.rows)

    def _prefill(self, b: _Batch, lora: MultiLoRA):
        """Prefill at static position 0 (right padding makes column index
        == absolute position); returns (last-prompt logits (B, V), caches)."""
        B = b.tokens.shape[0]
        caches = M.init_caches(self.cfg, B, b.buf, device=self.device)
        logits, caches = M.decode_step(self.cfg, self.params,
                                       b.fused.adapters, lora, b.tokens, 0,
                                       caches)
        rows = torch.arange(B, device=self.device)
        return logits[rows, b.lens.long() - 1], caches

    def _generate(self, b: _Batch, n_steps: int):
        """Prefill, then *n_steps* greedy decode steps with per-row
        positions.  Returns (tokens (B, n_steps + 1) on the device, the
        logits (B, V) that chose the last of them)."""
        lora = self._lora(b)
        last, caches = self._prefill(b, lora)
        tok = last.argmax(dim=-1).to(torch.int32)
        pos = b.lens
        toks = [tok]
        for _ in range(n_steps):
            lg, caches = M.decode_step(self.cfg, self.params,
                                       b.fused.adapters, lora, tok[:, None],
                                       pos, caches, row_block=self._row_block)
            last = lg[:, 0]
            tok = last.argmax(dim=-1).to(torch.int32)
            pos = pos + 1
            toks.append(tok)
        return torch.stack(toks, dim=1), last

    # ------------------------------------------------------------- serve
    @torch.inference_mode()
    def serve(self, requests: Sequence[ServeRequest]) -> List[ServeResult]:
        """Run one fused batch; results come back in request order."""
        b = self._batch(requests)
        toks, _ = self._generate(b, b.max_new - 1)
        out = toks.cpu().numpy()                      # one host copy

        results: List[Optional[ServeResult]] = [None] * len(requests)
        for row, ri in enumerate(b.row_req):
            if ri is None:
                continue
            r = requests[ri]
            t = out[row, :r.max_new_tokens]           # per-request truncation
            if r.stop_token is not None:
                hit = np.nonzero(t == r.stop_token)[0]
                if hit.size:
                    t = t[:hit[0] + 1]
            results[ri] = ServeResult(adapter=r.adapter,
                                      prompt_len=len(r.prompt),
                                      tokens=np.array(t))
        return results  # type: ignore[return-value]

    @torch.inference_mode()
    def next_token_logits(self, requests: Sequence[ServeRequest],
                          steps: int = 0) -> torch.Tensor:
        """Each request's next-token logits after its prompt and *steps*
        greedy tokens, computed in the fused batch layout ``serve`` uses:
        (n_requests, vocab) in request order, on the device."""
        b = self._batch(requests)
        _, last = self._generate(b, steps)
        rows = [row for row, ri in sorted(
            ((row, ri) for row, ri in enumerate(b.row_req) if ri is not None),
            key=lambda t: t[1])]
        return last[torch.tensor(rows, device=self.device)]
