"""Data pipeline: per-job token streams + fused-group batch assembly
(port of ``repro.data.pipeline``, single device; numpy only, so the
same seed gives the reference's batches token for token).

tLoRA is lossless/throughput-oriented — data *content* affects no
reported metric (paper §4.1) — so the default source is a synthetic
stream whose sequence-length distribution matches GSM8K (~8.5k
grade-school problems, mean ≈ 190 tokens, right-skewed).  Sequences are
padded to the job's seq_len with a loss mask, as a fine-tuning loader
would.

``FusedBatcher`` lays out a group's batch the way the SSM and kernels
require: job-major concatenation (tokens of one adapter contiguous) and
each job's batch padded so its token count is a multiple of the kernel
tile.  With ``shards`` = D > 1 every job's rows pad further, so they
split evenly over the D data shards with per-shard tile alignment; the
batch stays in the solo job-major order, and ``shard_permutation`` gives
the shard-major order the sharded runtime stages from.

``frontend_inputs`` gives a batch of an audio or VLM config the stub
front-end inputs the reference's tests feed (tests/test_archs.py): the
batcher itself, like the reference's, emits tokens only.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.jobs import LoRAJobSpec, tile_rows

# GSM8K-like length model (log-normal, clipped) — mean ~190, p95 ~420.
_GSM8K_MU, _GSM8K_SIGMA = 5.1, 0.45


def sample_lengths(rng: np.random.Generator, n: int, max_len: int) -> np.ndarray:
    raw = rng.lognormal(_GSM8K_MU, _GSM8K_SIGMA, size=n)
    return np.clip(raw.astype(np.int64), 16, max_len)


@dataclass
class JobStream:
    """Infinite token stream for one LoRA job (synthetic GSM8K-like)."""
    spec: LoRAJobSpec
    vocab_size: int
    seed: int = 0

    def __post_init__(self):
        # crc32, not hash(): salted str hashing would change the stream
        # across interpreter runs with identical seeds
        self._rng = np.random.default_rng(
            zlib.crc32(f"{self.spec.job_id}/{self.seed}".encode()))

    def next_batch(self) -> Dict[str, np.ndarray]:
        """(batch_size, seq_len) tokens/labels + loss_mask."""
        B, S = self.spec.batch_size, self.spec.seq_len
        lens = sample_lengths(self._rng, B, S)
        toks = self._rng.integers(3, self.vocab_size, size=(B, S),
                                  dtype=np.int32)
        mask = (np.arange(S)[None, :] < lens[:, None])
        toks = np.where(mask, toks, 0)            # pad id 0
        return {"tokens": toks,
                "labels": toks,                    # causal LM: shift in loss
                "loss_mask": mask.astype(np.float32)}


class FusedBatcher:
    """Assemble a group's fused batch in SSM layout.

    Sequences are job-major; every job's sequence count is padded up so
    (count * seq_len) is a multiple of ``block_t`` — padding rows carry
    loss_mask 0 and keep the owning job's adapter id, so kernels see
    contiguous tile-aligned segments and the loss ignores them.
    """

    def __init__(self, jobs: Sequence[LoRAJobSpec], vocab_size: int,
                 block_t: int = 128, seed: int = 0,
                 streams: Optional[Sequence[JobStream]] = None,
                 shards: int = 1):
        assert len({j.seq_len for j in jobs}) == 1, \
            "group members must share seq_len (scheduler invariant)"
        self.jobs = list(jobs)
        self.seq_len = jobs[0].seq_len
        self.block_t = block_t
        # shards > 1: pad every job's rows to split evenly over the data
        # shards, tile-aligned per shard.  Padding rows draw nothing from
        # the stream, so a job consumes the same data whatever the mesh.
        self.shards = shards
        if streams is None:
            streams = [JobStream(j, vocab_size, seed) for j in jobs]
        else:
            # a job's live stream (rng position included) travels with it
            # between groups, so the data it sees does not depend on the
            # grouping (the lossless contract's data half)
            assert len(streams) == len(jobs)
        self.streams = list(streams)

    def _rows_for(self, job: LoRAJobSpec) -> int:
        return tile_rows(job.batch_size, self.seq_len, self.block_t,
                         shards=self.shards)

    def next_batch(self) -> Dict[str, np.ndarray]:
        toks, labels, masks, aids = [], [], [], []
        for k, (job, stream) in enumerate(zip(self.jobs, self.streams)):
            b = stream.next_batch()
            rows = self._rows_for(job)
            pad = rows - job.batch_size
            if pad:
                zt = np.zeros((pad, self.seq_len), np.int32)
                zm = np.zeros((pad, self.seq_len), np.float32)
                b = {"tokens": np.concatenate([b["tokens"], zt]),
                     "labels": np.concatenate([b["labels"], zt]),
                     "loss_mask": np.concatenate([b["loss_mask"], zm])}
            toks.append(b["tokens"]); labels.append(b["labels"])
            masks.append(b["loss_mask"])
            aids.append(np.full(rows, k, np.int32))
        return {"tokens": np.concatenate(toks),
                "labels": np.concatenate(labels),
                "loss_mask": np.concatenate(masks),
                "adapter_ids": np.concatenate(aids)}

    def next_batches(self, n: int) -> Dict[str, np.ndarray]:
        """Stack the next *n* fused batches along a leading chunk axis
        (the staged input of one chunk of steps)."""
        bs = [self.next_batch() for _ in range(n)]
        return {k: np.stack([b[k] for b in bs]) for k in bs[0]}

    @property
    def adapter_ids(self) -> np.ndarray:
        return np.concatenate([np.full(self._rows_for(j), k, np.int32)
                               for k, j in enumerate(self.jobs)])

    def total_rows(self) -> int:
        return int(sum(self._rows_for(j) for j in self.jobs))

    def rows_per_job(self) -> List[int]:
        return [self._rows_for(j) for j in self.jobs]


# ----------------------------------------------------------- shard layout
def shard_permutation(rows: Sequence[int], shards: int) -> np.ndarray:
    """Row permutation taking the solo job-major fused batch to the
    shard-major layout: ``perm[p]`` is the solo index of the row at
    shard-major position p.  Shard s holds, for every job j, its rows
    ``[s*rows_j/shards, (s+1)*rows_j/shards)`` concatenated job-major, so
    every shard is a tile-aligned mini fused batch with the same job
    composition and per-job segments of 1/shards the solo ones."""
    assert all(r % shards == 0 for r in rows), (rows, shards)
    offs = np.concatenate([[0], np.cumsum(rows)])
    out = []
    for s in range(shards):
        for j, r in enumerate(rows):
            rl = r // shards
            out.append(np.arange(offs[j] + s * rl, offs[j] + (s + 1) * rl))
    return np.concatenate(out).astype(np.int64)


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    """inv with inv[perm[p]] = p: a solo row index to its shard-major
    position."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=perm.dtype)
    return inv


def frontend_inputs(cfg, batch: Dict[str, np.ndarray],
                    rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """The front-end stub inputs for a batch of *cfg*'s family, drawn
    from *rng* as tests/test_archs.py draws them (leading axes kept, so a
    chunk's stacked batches take one draw): audio replaces the tokens by
    frames (..., S, frontend_dim) f32 ~ N(0, 1); a VLM batch gains
    patches (..., num_patches, frontend_dim) before its text; any other
    family's batch is returned as given."""
    if cfg.family == "audio":
        out = {k: v for k, v in batch.items() if k != "tokens"}
        out["frames"] = rng.standard_normal(
            batch["tokens"].shape + (cfg.frontend_dim,)).astype(np.float32)
        return out
    if cfg.family == "vlm":
        return dict(batch, patches=rng.standard_normal(
            batch["tokens"].shape[:-1] + (cfg.num_patches, cfg.frontend_dim)
        ).astype(np.float32))
    return batch
