"""End-to-end multi-LoRA training of one fused group (port of
``repro.train.train_loop``): data -> SSM train step -> AIMD nano-batch
adaptation -> per-job AdamW, through ``elastic.runtime.GroupRuntime``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

from repro_torch.configs.base import ModelConfig
from repro_torch.core.jobs import LoRAJobSpec
from repro_torch.elastic.runtime import GroupRuntime, TrainReport

__all__ = ["train_group", "TrainReport", "GroupRuntime"]


def train_group(cfg: ModelConfig, jobs: Sequence[LoRAJobSpec], *,
                steps: int = 20, lr: float = 1e-3, seed: int = 0,
                impl: str = "cuda", block_t: int = 128,
                adaptive_nano: bool = True, nano_batches: int = 1,
                remat: bool = True, quantize: Optional[str] = None,
                chunk_size: int = 4, params=None, adapters=None,
                log: Optional[Callable[[str], None]] = None,
                device="cuda") -> Dict:
    """Train a fused group for *steps* iterations on *device* (the GPU
    unless the caller asks for the CPU), in chunks of ``chunk_size``
    steps with one host read of the metrics per chunk; AIMD (on by
    default, as in the reference) picks the nano-batch count from each
    chunk's mean step time.  ``quantize="int8"`` trains over an int8
    backbone: the returned ``params`` is the quantized tree, the
    ``adapters`` are not quantized."""
    rt = GroupRuntime.from_specs(cfg, list(jobs), params=params,
                                 adapters=adapters, seed=seed,
                                 device=device, lr=lr, impl=impl,
                                 block_t=block_t, nano_batches=nano_batches,
                                 adaptive_nano=adaptive_nano, remat=remat,
                                 quantize=quantize, chunk_size=chunk_size)
    report = rt.run(steps, log=log)
    return {"ssm": rt.ssm, "params": rt.params, "adapters": rt.adapters,
            "opt_state": rt.opt_state, "report": report,
            "batcher": rt.batcher, "runtime": rt}
