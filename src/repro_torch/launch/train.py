"""CLI launcher of the port: multi-LoRA training of one fused group.

    python -m repro_torch.launch.train train --arch tinyllama-1.1b \
        --jobs 4 --steps 8

Runs on the GPU by default (``--device cpu`` for the kernels' plain
versions).  The defaults are the reference's: ranks {16, 8, 4, 2}, which
all pad to 16 (a uniform layout: the masked kernels), and AIMD nano-batch
adaptation on (``--no-aimd`` turns it off).  The reference's ``serve``
and ``simulate`` subcommands are not ported yet (ROADMAP queue A, item
15).
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.jobs import LoRAJobSpec

RANKS = (16, 8, 4, 2)


def cmd_train(args):
    from repro_torch.train.train_loop import train_group
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    jobs = [LoRAJobSpec(f"job-{i}", rank=RANKS[i % len(RANKS)],
                        batch_size=args.batch_size, seq_len=args.seq_len,
                        base_model=args.arch)
            for i in range(args.jobs)]
    out = train_group(cfg, jobs, steps=args.steps, lr=args.lr,
                      impl=args.impl, block_t=args.block_t,
                      chunk_size=args.chunk_size, seed=args.seed,
                      adaptive_nano=not args.no_aimd, device=args.device,
                      log=print)
    rep = out["report"]
    print(f"\nfinal loss {rep.losses[-1]:.4f}  "
          f"avg step {np.mean(rep.step_times[1:] or rep.step_times):.3f}s  "
          f"nano trajectory {rep.nano_history}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("train", help="train one fused group of LoRA jobs")
    t.add_argument("--arch", default="tinyllama-1.1b", choices=ARCH_IDS)
    t.add_argument("--reduced", action="store_true")
    t.add_argument("--jobs", type=int, default=4)
    t.add_argument("--steps", type=int, default=8)
    t.add_argument("--batch-size", type=int, default=4)
    t.add_argument("--seq-len", type=int, default=512)
    t.add_argument("--lr", type=float, default=1e-3)
    t.add_argument("--impl", default="cuda", choices=("cuda", "ref", "loop"))
    t.add_argument("--block-t", type=int, default=128)
    t.add_argument("--chunk-size", type=int, default=4)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--no-aimd", action="store_true")
    t.add_argument("--device", default="cuda")
    t.set_defaults(fn=cmd_train)
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
