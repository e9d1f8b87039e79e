"""Batched multi-adapter serving (prefill + decode) over one SSM (port of
``repro.train.serve``).

A thin wrapper over the serving subsystem (``repro_torch.serve``:
``AdapterPool`` + ``ServeEngine``), kept for the ``serve_batch(cfg, jobs,
reqs)`` entry point of the launcher's ``serve`` subcommand: adapter ids
index a job list, and without given weights the SSM draws them from a
seed (the port's own draws, not the reference's).  Prompts RIGHT-pad to
a tile-aligned width, so column index == absolute position; each row
decodes at its own position and truncates to its own
``max_new_tokens``.  Runs on the GPU unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.jobs import LoRAJobSpec
from repro_torch.core.ssm import SharedSuperModel
from repro_torch.serve import AdapterPool, ServeEngine, ServeRequest


@dataclass
class Request:
    prompt: np.ndarray           # (S,) int32
    adapter_id: int              # index into the job list
    max_new_tokens: int = 16


def pad_requests(reqs: Sequence[Request],
                 pad_to: int) -> Dict[str, np.ndarray]:
    """RIGHT-pad prompts to a shared tile-aligned width.

    Right padding keeps column index == absolute position, which is
    what makes fused prefill exact (the seed left-padded AND prefilled
    at pos 0, shifting every short prompt's rope/cache positions).
    Returns tokens (B, S), adapter_ids (B,), and per-request lens (B,).
    """
    S = max(len(r.prompt) for r in reqs)
    S = ((max(S, pad_to) + pad_to - 1) // pad_to) * pad_to
    toks = np.zeros((len(reqs), S), np.int32)
    lens = np.zeros((len(reqs),), np.int32)
    for i, r in enumerate(reqs):
        toks[i, :len(r.prompt)] = r.prompt
        lens[i] = len(r.prompt)
    return {"tokens": toks, "lens": lens,
            "adapter_ids": np.array([r.adapter_id for r in reqs], np.int32)}


def serve_batch(cfg: ModelConfig, jobs: Sequence[LoRAJobSpec],
                reqs: Sequence[Request], *, impl: str = "cuda",
                block_t: int = 16, params=None, adapters=None,
                seed: int = 0, greedy: bool = True,
                device="cuda") -> List[np.ndarray]:
    """Prefill + decode a batch of adapter-tagged requests on *device*.

    *params* / *adapters*: the backbone and the packed adapter tree of
    the SSM over *jobs* (``SharedSuperModel(cfg, jobs, block_t=).init``);
    drawn from *seed* on *device* when either is None.  Returns one array
    of generated token ids per request, each truncated to its own
    ``max_new_tokens``."""
    ssm = SharedSuperModel(cfg, list(jobs), impl=impl, block_t=block_t)
    if params is None or adapters is None:
        params, adapters = ssm.init(seed=seed, device=device)

    pool = AdapterPool(cfg, capacity=max(len(jobs), 1),
                       multiple=ssm.layout.multiple, device=device)
    pool.publish_group(list(jobs), adapters, ssm.layout)
    engine = ServeEngine(cfg, params, pool, impl=impl, block_t=block_t,
                         greedy=greedy)
    results = engine.serve([
        ServeRequest(prompt=np.asarray(r.prompt, np.int32),
                     adapter=jobs[r.adapter_id].job_id,
                     max_new_tokens=r.max_new_tokens)
        for r in reqs])
    return [r.tokens for r in results]
