"""CLI launcher of the port: multi-LoRA training / serving / cluster
simulation, the reference launcher's three subcommands.

    python -m repro_torch.launch.train train --arch tinyllama-1.1b \
        --jobs 4 --steps 8
    python -m repro_torch.launch.train serve --arch tinyllama-1.1b
    python -m repro_torch.launch.train simulate --system tlora --chips 128

``train`` and ``serve`` run on the GPU by default (``--device cpu`` for
the kernels' plain versions).  ``train``'s defaults are the reference's:
ranks {16, 8, 4, 2}, which all pad to 16 (a uniform layout: the masked
kernels), and AIMD nano-batch adaptation on (``--no-aimd`` turns it
off); ``--impl torch`` is the mirror of the reference's "xla".
``serve`` publishes four adapters of those ranks and decodes 12-token
prompts drawn from a seeded generator, at the kernels' token tile of 16.
``simulate`` replays a generated trace through the cluster simulator,
every system priced on the throughput model's default spec, with the
reference's flags and output.  Each subcommand's function returns what
it computed (``train_group``'s dict, the generated rows, the results by
system), and so does ``main``.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.jobs import LoRAJobSpec

RANKS = (16, 8, 4, 2)
IMPLS = ("cuda", "torch", "ref", "loop")


def _config(args):
    cfg = get_config(args.arch)
    return cfg.reduced() if args.reduced else cfg


def cmd_train(args):
    from repro_torch.train.train_loop import train_group
    cfg = _config(args)
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
    return out


def serve_workload(cfg, arch: str, requests: int, tokens: int):
    """The ``serve`` subcommand's adapters and requests, the reference's:
    one adapter of each of RANKS, 12-token prompts from
    ``np.random.default_rng(0)``, request i on adapter i % 4."""
    from repro_torch.train.serve import Request
    rng = np.random.default_rng(0)
    jobs = [LoRAJobSpec(f"adapter-{i}", rank=r, batch_size=1,
                        base_model=arch)
            for i, r in enumerate(RANKS)]
    reqs = [Request(prompt=rng.integers(1, cfg.vocab_size, size=12,
                                        dtype=np.int32),
                    adapter_id=i % len(jobs), max_new_tokens=tokens)
            for i in range(requests)]
    return jobs, reqs


def cmd_serve(args):
    from repro_torch.train.serve import serve_batch
    cfg = _config(args)
    jobs, reqs = serve_workload(cfg, args.arch, args.requests, args.tokens)
    out = serve_batch(cfg, jobs, reqs, impl=args.impl, block_t=args.block_t,
                      device=args.device)
    print(f"generated {len(out)} rows:")
    for i, row in enumerate(out):
        print(f"  req {i} [{jobs[i % len(jobs)].job_id}] {row.tolist()}")
    return out


def cmd_simulate(args):
    from repro_torch.cluster.baselines import SYSTEMS, make_simulator
    from repro_torch.cluster.metrics import compare, summarize
    from repro_torch.cluster.simulator import ClusterConfig
    from repro_torch.cluster.trace import TraceConfig, generate
    trace = generate(TraceConfig(months=1, jobs_per_month=args.jobs,
                                 seed=args.seed))
    systems = SYSTEMS if args.system == "all" else (args.system,)
    results = {}
    for s in systems:
        sim = make_simulator(s, ClusterConfig(total_chips=args.chips))
        results[s] = sim.run(trace)
        summary = {k: round(v, 4) for k, v in summarize(results[s]).items()}
        print(f"{s:20s} {json.dumps(summary)}")
    if len(results) > 1 and "mlora" in results:
        print("\nvs mLoRA:")
        for name, d in compare(results).items():
            print(f"  {name:20s} throughput x{d['throughput_x']:.2f} "
                  f"JCT x{d['jct_speedup_x']:.2f} "
                  f"util +{d['utilization_delta']*100:.1f}pp")
    return results


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
    t.add_argument("--impl", default="cuda", choices=IMPLS)
    t.add_argument("--block-t", type=int, default=128)
    t.add_argument("--chunk-size", type=int, default=4)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--no-aimd", action="store_true")
    t.add_argument("--device", default="cuda")
    t.set_defaults(fn=cmd_train)

    s = sub.add_parser("serve", help="serve requests over four adapters")
    s.add_argument("--arch", default="tinyllama-1.1b", choices=ARCH_IDS)
    s.add_argument("--reduced", action="store_true")
    s.add_argument("--requests", type=int, default=8)
    s.add_argument("--tokens", type=int, default=8)
    s.add_argument("--impl", default="cuda", choices=IMPLS)
    s.add_argument("--block-t", type=int, default=16)
    s.add_argument("--device", default="cuda")
    s.set_defaults(fn=cmd_serve)

    c = sub.add_parser("simulate", help="replay a generated cluster trace")
    c.add_argument("--system", default="all")
    c.add_argument("--chips", type=int, default=128)
    c.add_argument("--jobs", type=int, default=120)
    c.add_argument("--seed", type=int, default=0)
    c.set_defaults(fn=cmd_simulate)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
