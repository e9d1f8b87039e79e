#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package.  Phases, one JSON line
each on standard output:

  build   — nvcc builds every kernel library from ``src/repro_torch/
            kernels/csrc`` (one compiler per source, in parallel);
  kernels — each hand-written kernel against its plain PyTorch version on
            the card, at the shapes the serving and the training paths
            give it, with its device time from torch.profiler (``ms``;
            ``call_ms`` adds the launch overhead the device waits for),
            the plain version's device time, the least time the card
            could take (bound) and, where one PyTorch call computes the
            same function, that call's device time (``library_ms``, timed
            here only), flash at head dims 64, 32 and 128; then the
            bit-equality checks: the flash kernel's row invariance at
            each head dim (the first 48 rows at S = 192 against S = 48,
            64 heads inside BH 2048 against those heads alone), B5
            against B8 on one uniform layout (dB and dA), B7 against B3,
            B4 and B2 on one uniform layout (xa, dxa, dx), B7 at each
            row count a CTA can take (64, 32, 16) on one N = 2 slice,
            B10's rows 0-15 at T = 16, 64 and 8192 (forward and
            transposed), B6 against the B7 pair (narrow x·A[k], the rank
            mask, wide xa·B[k]) on the uniform train shape and the N = 4
            slice, bf16(B1) against B6 on one uniform layout (train and
            decode), B1 against B2 fed x, B^T and A^T (one order, two
            orientations of the LoRA routine), and rows 0-15 of B1 and
            B6, and of B2, B3 and B4, at T = 16, 64 and 8192 at every row
            count a CTA can take there; B10's host time per call; B6's
            lines carry the B7 pair's time (``pair_ms``), B1 and B6 on
            2048-token slices, and B2, B3 and B4 at the train shapes and
            on a 2048-token slice, are timed at 64, 32 and 16 rows a CTA
            (``ms_rows_*``); then the "torch" route (``_RaggedTorch``,
            ``_MaskedTorch``) against the kernels' Functions on the same
            inputs (``torch_route`` lines: forward and backward at the
            training shapes, forward at decode, each timed alone); and
            B1-B8 at the recurrent families' LoRA widths (2560 -> 12368
            and 5120 -> 2560 of mamba2-2.7b, 4096 -> 4096 and 4096 -> 256
            of recurrentgemma-9b) and the other families' (2048 -> 3072
            and 576 of MLA, 1280 -> 1280 of hubert) at the train shape,
            flash at (192, 128) causal and 80 non-causal beside SDPA;
  serve   — ``ServeEngine`` over full-width tinyllama-1.1b cut to
            SERVE_LAYERS layers, with seeded random weights: a mixed-rank adapter set (ragged kernel) and a
            uniform-width set (masked kernel), launch counts read around
            that run, fused-vs-solo logits, the C1 probe (request 1's
            decode steps fused and solo, op by op) and whole-sequence
            token ids of two requests per adapter, both asserted equal, tokens/s, peak device memory,
            and one profiled serve per set (device busy time against host
            wall time, the largest device kernels);
  train   — ``train_group`` over the same backbone: four LoRA jobs of
            ranks {8, 16, 32, 64} (a ragged layout) for 8 steps in chunks
            of 4 with remat, launch counts read around that run and
            checked per step, per-step per-job losses, step time,
            tokens/s, peak device memory; then one step's adapter
            gradients against the "loop" impl (autograd through one GEMM
            pair per adapter) and against the other kernel family (the
            densified masked route of a nano slice), one job's fused loss
            against its solo loss, and one profiled step;
  train_torch — the train cell through impl="torch" (the same adapters
            and batches): per-job losses within 0.02 of the "cuda" run,
            one step's adapter gradients within 0.05 of "cuda"'s, no LoRA
            kernel launched and the flash forward 44 times a step, the
            steady step beside the "cuda" one, peak device memory;
  train_uniform — the same as train for ranks {16, 8, 4, 2}, which all
            pad to 16: the masked kernels and their backward (grouped
            product and grouped wgrad), held against the ragged kernels
            on the same layout (the loop impl's gradients reported);
  train_uniform_torch — train_uniform through impl="torch" (the masked
            torch path), as train_torch;
  nano    — the mixed group at nano_batches 1 (ragged kernels) and 4
            (contiguous slices, densified, masked kernels) on the same
            batches, per-step per-job losses held together, exact launch
            counts at N = 4, the cost of densifying, one profiled N = 4
            step; then ``train_group`` with AIMD on, its N trajectory;
  pipeline — the mixed group twice from one state and one data seed,
            12 steps in chunks of 4: chunk after chunk (``dispatch_chunk``
            without a prefetch, then ``collect_chunk``) and ``run`` (the
            next chunk staged behind the running one); adapters, Adam
            moments and losses equal bit for bit, asserted; the
            synchronizing calls of one dispatch (and where they are
            made); each run's wall and steady step, two profiled chunks
            of each (device busy and idle share);
  elastic — a uniform group trains and checkpoints every member; two of
            its jobs move into a mixed group beside a fresh rank-64 job,
            then one of them trains alone; its losses against a control
            run of that job alone, its checkpoint against its export;
  quant   — the int8 backbone: quantized once (seconds, resident bytes
            bf16 against int8), then the ``train`` group on the same
            batches with every base projection through the dequant-matmul
            kernel (exact launches per step, per-job losses within 0.05
            relative of the bf16 run, one step's adapter gradients
            through the "cuda" against the "torch" dequant impl, step
            time, one profiled step), then ``ServeEngine(quantize=
            "int8")`` on the mixed set's requests (launches per decode
            step, fused-vs-solo prefill logits and first token ids,
            tokens/s, top-1 agreement with the bf16 engine, reported;
            one profiled serve);
  wide    — command-r-35b at full width (d_model 8192, head dim 128,
            vocab 256000) cut to 2 layers: ``train_group`` over the train
            group's ranks, exact launches per step (flash 2 a layer),
            finite per-job losses, peak device memory, one step's adapter
            gradients against the "loop" impl;
  recurrent — mamba2-2.7b at full width and depth (64 SSD layers) and
            recurrentgemma-9b at full width cut to 6 layers (RG-LRU,
            RG-LRU, local attention, twice): ``train_group`` over the
            train group's ranks for 4 steps, exact LoRA launches a step
            from the layer pattern (flash 0), finite losses, steady step
            beside the H100 spec's price, peak memory, one profiled step;
            then one step's gradients against "loop", fused against solo
            loss, and the serve steps (prefill 16 tokens into SSD and
            RG-LRU state and rings, decode 8) against the teacher-forced
            forward, each within the larger of its bar and twice what a
            2^-9 nudge of the adapters moves it (its floor, measured in
            the run); the same checks on mamba2-2.7b cut to 2 layers,
            where the bars are the larger;
  families — deepseek-v2-lite-16b (MLA + MoE) at full width and depth,
            qwen3-moe-30b-a3b cut to 8 layers, hubert-xlarge (audio
            encoder) at full depth, internvl2-26b (VLM) cut to 4
            layers: ``train_group`` over the train group for 4 steps
            (frames and patches drawn from the seed), exact launches a
            step from the layer pattern (B9 at (192, 128), 128 and 80),
            finite losses, the MoE aux, steady step, the H100 spec's
            price, one profiled step; gradients vs "loop", fused vs solo
            cross entropy and the decoders' serve steps (deepseek's MLA
            ring too), each within max(bar, 2 x floor); ``ServeEngine``
            on deepseek (prefill logits fused vs solo asserted, whole
            sequences compared and reported, ``c1_probe`` where they
            part) and its launcher ``train --no-aimd`` (masked); hubert's
            cached prefill (two adapters, four requests of 512 frames:
            logits vs the cacheless forward within 0.25, fused vs solo
            bit-equal, B1 once a LoRA projection, B9 once a layer);
  calibrate — ``OnlineCalibrator(H100)`` fed the steady steps of train,
            train_uniform, nano (N = 1 and 4) and quant: the fitted
            constants (mfu_cap, launch and step overheads) and each
            phase's predicted against measured step;
  simulate — the cluster simulator priced on the H100 spec (host
            arithmetic, a simulation): the reference launcher's default
            replay (five systems, 128 chips, 120 jobs, seed 0), each
            system's summary and its comparison against mLoRA, every job
            completed and a second run equal (asserted); then a month of
            tinyllama-1.1b jobs priced through that calibrator, with the
            count of fitted and base-spec lookups;
  engine  — an ``ElasticEngine`` priced with that calibrated spec: jobs of
            ranks 8, 16 and 64 arrive and are scheduled, train 4 steps; a
            rank-32 job arrives and the scheduler regroups; one move is
            forced; every job trains to its budget of 12 steps
            (asserted), a moved job against itself alone (losses within
            0.02, asserted); the regroup stalls and the calibrated
            regroup cost before and after;
  launch  — the launcher's entry points (``repro_torch.launch.train``):
            ``serve`` (8 requests, 16 new tokens: B6 and B9 launched, B1
            not, the ids equal ``ServeEngine.serve``'s on the same
            weights), the SSM's serve steps on a mixed layout (prefill 7
            tokens, decode the 8th: B1 and B9, the logits against the
            teacher-forced forward within 0.25), and ``train --impl
            torch --no-aimd`` for 4 steps at the launcher's defaults
            (finite losses, no LoRA kernel, 44 flash launches a step, the
            steady step beside train_uniform_torch's), exact launch
            counts asserted;
  cluster — ``ClusterController`` on full-width tinyllama-1.1b: (a) a
            masked and a ragged group under the sequential, roundrobin
            and threads modes (every pump on the device's default
            stream), adapters, Adam moments and losses bit-equal
            (asserted), each mode's wall, peak memory and idle share;
            (b) a job through the controller against the same job in a
            solo ``ElasticEngine``, bit-equal (asserted); (c) two solo
            pumps merged by an overlapped regroup while they step,
            beside a stop-the-world merge, each event's pause, migrate,
            warm and resume seconds; (d) ``TraceRunner`` over 7 trace
            jobs, fault-free and with a worker death in flight, a
            corrupt checkpoint and a stuck worker: no job lost, every
            fault recovered, steps lost within the checkpoint period,
            the corrupt checkpoint's job back at its admission-time init
            (asserted), measured JCTs, samples/s and recovery latencies;
            (e) ``ExecutionBackend(hw=H100)`` inside the simulator,
            predicted against measured steps; every part's launches held
            to the steps it dispatched;
  sharded — the train and train_uniform groups data-parallel through
            ``GroupRuntime(mesh=...)`` on tinyllama-1.1b at full width
            cut to 4 layers (SHARDED_LAYERS), 2 steps a run: (a) two gloo ranks spawned onto the one card
            (NCCL refuses two ranks on one device): the train group's
            exact gather mode, gather at N = 2 with the "rank_desc" nano
            order, and psum (ragged kernels), the uniform group's gather
            mode at N = 1 and N = 2 (masked kernels); (b) this process
            as a one-rank NCCL world, the gather mode.  Rank 0 trains
            the meshless run of each group with the same seeds first
            and holds each run against it (SHARDED_RUNS' bars: step 1's
            losses and adapter gradients for every run), and psum and
            N = 2 are rerun with half the batch planted out of the
            gradient, which the gradient limit must catch; every rank's
            launches are held to the layer pattern x N, every rank's
            losses must agree; walls, peak memory and rank 0's profiled
            step are recorded as ranks sharing one card, not as a
            multi-GPU number;
  cluster_sharded — the controller over four gloo ranks on cuda:0,
            tinyllama-1.1b at full width cut to 2 layers (CS_LAYERS):
            two groups on 2-rank slices, sequential vs threads, vs
            meshless, a repartition, a worker death and a lost slice;
  pipeline_mode — pipeline mode (``tp_mode="pipeline"``) on full-width,
            full-depth tinyllama-1.1b in 2 stages of 11 layers, gloo
            ranks on cuda:0: (a) two ranks, P = 2 x D = 1: the train
            group at N = 2 "rank_desc" and N = 4 (ragged kernels, B9),
            the uniform group at N = 2 (masked kernels); (b) four ranks,
            P = 2 x D = 2: the train group at N = 2; (c) eight ranks,
            the (stage 2, data 2, model 2) mesh: (b) on each model index,
            the replicas bit-equal to one another and to (b) at every
            (stage, data) position.  Each run's step 1
            against the meshless run (losses, adapter gradients at
            2^-6), a zeroed handoff that limit must catch, occupancy
            counters, launches a rank (its stage's layers x the pattern
            x N), every rank's losses and the resident backbone bytes
            (at least 40% below the meshless run's), all asserted;
            walls, rank 0's idle share and peak memory recorded as ranks
            sharing one card;
  tensor_parallel — tensor parallelism (``tp_mode="auto"``) and the MoE
            over every mesh, two gloo ranks on cuda:0: full-width
            tinyllama-1.1b cut to 2 layers at data 1 x model 2 (the train
            and uniform groups: B1-B8 on the split projections, B9 on
            H/2 heads), full-width qwen3-moe-30b-a3b cut to 2 layers at
            data 1 x model 2 (64 experts a rank, capacity and ragged),
            and qwen3-moe through "dp" (data 2) and "pipeline" (P = 2,
            4 layers).  Each run's step 1 against meshless (losses within
            0.02, adapter gradients at 2^-6), a row-parallel partial left
            out that the limit must catch, every rank's adapters equal,
            launches a rank and the resident backbone (at least 40%
            below meshless where it is split), all asserted; walls, rank
            0's idle share and peak memory recorded.  The other families
            at model 2 the same way (deepseek-v2-lite-16b at 2 layers,
            recurrentgemma-9b at 3, mamba2-2.7b, hubert-xlarge and
            internvl2-26b at 2), and the int8 backbone (tinyllama-1.1b
            and mamba2-2.7b at 2, B10's f32 partials), each with a
            planted fault on its new collective; smollm-360m at 2 layers,
            its 15 heads over 2 ranks: its attention whole on every rank
            (a zeroed whole attention on rank 1 planted);
  tp_serve — the serve steps over a model axis (``make_prefill_step(
            mesh=)``, ``make_serve_step(mesh=)``), eight gloo ranks on
            cuda:0: (a) full-width, full-depth tinyllama-1.1b at data 1 x
            model 2, the mixed adapter set {8, 16, 32, 64} (B1, B9):
            prefill 8 prompts of 16-200 tokens and 16 decode steps,
            against the meshless serve steps (prefill and teacher-forced
            decode logits within 0.25), fused vs solo ids equal under the
            mesh (the adapter of rank 64 served alone), the
            caches half the meshless bytes and the launches a rank,
            asserted; the greedy ids against meshless recorded; (b)
            tinyllama-1.1b cut to 2 layers at data 1 x model 8, each kv
            head held by 2 ranks: prefill and 4 decode steps, the same
            checks (fused vs solo: the adapters of ranks 8 and 64; caches
            a quarter; the sums over the axis in row blocks), one train step
            of the train group through GroupRuntime(tp_mode="auto")
            against meshless (step-1 gradients within max(2^-6, 2 x the
            2^-9 nudge's floor)) and a planted fault (each kv head's
            cotangent from one replica) that limit must catch; (c)
            qwen3-moe-30b-a3b cut to 2 layers at data 1 x model 2:
            prefill and 8 decode steps within 0.25 of the meshless serve
            forced onto the split's experts (a routing flip moves a row's
            logits O(1)), the flipped tokens at most twice the 2^-9
            nudge's, a planted fault (rank 1's experts left out) above
            0.25; (d)-(g) deepseek-v2-lite-16b, mamba2-2.7b,
            recurrentgemma-9b and internvl2-26b cut to 2-3 layers at
            data 1 x model 2, (a)'s checks (deepseek's routes forced as
            (c)'s); (h) smollm-360m at 4 layers, its attention and its
            caches whole on each rank.  The five multi-rank phases run
            their ranks in one pool of eight processes spawned once
            (``RankPool``).  Beside it, the dry run's prediction of
            (a)'s serve peak on rank 0, recorded;
  dryrun  — (after the serve phase) the dry run's analysis
            of one step of the train group through ``impl="torch"``
            (``launch/step_analysis``, meta tensors) against the same
            step on the card: resident bytes (params, adapters, Adam
            state) exactly equal, the predicted peak within 10% of
            ``max_memory_allocated()`` (less what the process held
            beside the step's inputs), asserted.

Then one line ``{"kernels": [...]}`` (B1-B8 with the "torch" route's time
beside their Function's and their times at the recurrent widths; the
run's seconds) and, last, ``{"ok": true, "device":
...}``.  Any failure raises and exits non-zero; without a CUDA device, or
without the rest of the repository beside it, it exits 2 and prints no
result.

    python3 chip_smoke.py --times ragged_lora_dgrad,ragged_xa [--src DIR]

builds and runs only the named wrappers' training cases (each against its
plain version, with its times), from ``DIR/repro_torch`` when given: the
same cases timed on two trees in one run of the card, for comparisons.

    python3 chip_smoke.py --families

runs only the ``families`` phase,

    python3 chip_smoke.py --cluster

only the ``cluster`` phase,

    python3 chip_smoke.py --sharded

only the ``sharded`` phase, and

    python3 chip_smoke.py --pipeline

only the ``pipeline_mode`` phase, and

    python3 chip_smoke.py --tensor-parallel

only the ``tensor_parallel`` phase,

    python3 chip_smoke.py --tp-serve

only the ``tp_serve`` phase, and

    python3 chip_smoke.py --dryrun

only the ``dryrun`` line.

    python3 chip_smoke.py --floors

runs only ``floors_sweep``: by depth (mamba2-2.7b at 1 to 64 layers,
recurrentgemma-9b at 3 and 6, tinyllama-1.1b at 22), how far a 2^-9
nudge of the adapters moves the logits and the "loop" gradients, beside
"cuda" and "torch" against "loop": the floors the recurrent phase's
checks are held to.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

START = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES = 3.35e12          # HBM3 bytes/s
PEAK_BF16 = 989e12            # bf16 tensor-core flop/s

BLOCK_T = 16                  # LoRA token tile (one WMMA M tile)
MULTIPLE = 16                 # rank padding granule (the bf16 MMA k-step)
MIXED = (8, 16, 32, 64)       # pads 16/16/32/64: non-uniform -> ragged route
UNIFORM = (16, 16, 12, 16)    # pads all 16: uniform -> masked route
N_REQ = 16                    # requests per active set
# the serve phase's depth: its serves are host-bound (the device is busy
# 0.5 s of a 6 s serve at 22 layers), and at full depth the phase took
# 192 s of the whole run's time limit
SERVE_LAYERS = 8
B_STD = 0.005                 # std of the random LoRA B (0 would make the
#                               delta vanish: standard LoRA init has B = 0)

# Tolerances, kernel vs plain version on the same inputs.  Both round at
# the same points; what differs is the f32 summation order (tensor-core
# tiles vs one large product), which can flip the bf16 rounding of an xa
# lane or of p by one ulp (2^-8 relative), and the bf16 output rounding
# itself (2^-9 relative).  Inputs are scaled so outputs are O(1).
ATOL, RTOL = 2e-2, 2e-2
# Training: four jobs, 4 sequences of 512 tokens each, 8192 tokens a step
TRAIN_RANKS = (8, 16, 32, 64)     # pads 16/16/32/64: ragged route
TRAIN_BATCH, TRAIN_SEQ = 4, 512
TRAIN_BLOCK_T = 128
TRAIN_STEPS, TRAIN_CHUNK = 8, 4
TRAIN_LR = 1e-3
# Kernel launches per training step on tinyllama (22 layers, LoRA on
# q/k/v/o: 88 projections).  remat recomputes each layer's forward in
# the backward, so the forward kernels run twice.
TRAIN_LAYERS = 22
TRAIN_LAUNCHES = {"ragged_lora_fwd": 176, "ragged_lora_dgrad": 88,
                  "ragged_xa": 88, "ragged_dxa": 88, "ragged_wgrad": 176,
                  "flash_attention_fwd": 44, "fused_lora_cuda": 0,
                  "grouped_matmul_cuda": 0, "grouped_wgrad_cuda": 0,
                  "dequant_matmul_cuda": 0}
# The masked route (uniform widths; contiguous nano slices): forward 2 x
# 88, backward 3 grouped products and 2 grouped wgrads per projection;
# nano_batches = N multiplies every count by N.
UNIFORM_RANKS = (16, 8, 4, 2)     # the reference launcher's default ranks
NANO_N = 4
MASKED_LAUNCHES = {"fused_lora_cuda": 176, "grouped_matmul_cuda": 264,
                   "grouped_wgrad_cuda": 176, "flash_attention_fwd": 44,
                   "ragged_lora_fwd": 0, "ragged_lora_dgrad": 0,
                   "ragged_xa": 0, "ragged_dxa": 0, "ragged_wgrad": 0,
                   "dequant_matmul_cuda": 0}
# The int8 backbone (quant phase): every base projection (7 a layer: q,
# k, v, o, gate, up, down; 154 in all) launches the dequant-matmul
# kernel.  A training step: 2 x 154 forward (remat) and 151 backward
# (dx): layer 0's q/k/v read the frozen embedding, so autograd asks no
# dx of them.  A serve: 154 per prefill and per decode step.
QUANT_PROJ = 154
QUANT_LAUNCHES = dict(TRAIN_LAUNCHES, dequant_matmul_cuda=2 * QUANT_PROJ
                      + QUANT_PROJ - 3)
# int8 against bf16 per-job losses, relative: the reference's own bar
# (tests/test_quant.py, test_train_group_quantized_loss_close)
QUANT_LOSS_RTOL = 0.05
# The head-dim-128 step (wide phase): command-r-35b at full width (d_model
# 8192, 64 heads, kv 8, hd 128, d_ff 22528, vocab 256000) cut to
# WIDE_LAYERS layers, the train group's ranks and batches.  Launches per
# step: TRAIN_LAUNCHES scaled from 22 layers to WIDE_LAYERS.
WIDE_ARCH, WIDE_LAYERS, WIDE_STEPS = "command-r-35b", 2, 2
AIMD_CHUNKS = 6                   # chunks of TRAIN_CHUNK steps under AIMD
ELASTIC_K = 4                     # steps per stage of the elastic phase
# cuda vs loop adapter gradients, same step: relative Frobenius error per
# leaf.  The loop impl keeps x·A in f32 where the kernels round it to
# bf16 (the reference's rounding point), and both run a bf16 backbone
# whose one-ulp flips (2^-8) carry through 22 layers of backward; a
# gradient that lost the LoRA path, or took another adapter's, is off
# by O(1).
GRAD_RTOL = 5e-2
# The same step's adapter gradients through the other kernel family on
# the same layout (ragged kernels for a uniform group, the densified
# masked route of a nano slice for a mixed group): both families round
# at the same points, sum each product in the same CTA routine and walk
# the tokens in the same order, so they agree bit for bit; 1e-6 leaves
# room for one reordered f32 sum in the backbone, nothing more.
ROUTE_RTOL = 1e-6
# Fused vs solo per-job loss (a mean CE of ~10 over ~1000 tokens): the
# solo group's one adapter takes the masked kernel and cuBLAS runs at
# another batch size, which may flip bf16 roundings of hidden states;
# the flips average out in the mean.
LOSS_ATOL = 2e-2
# Fused vs solo prefill logits: the base projections go through cuBLAS at
# another batch size M, which may pick another algorithm and flip bf16
# roundings of hidden states; flips compound over 22 layers.  Logits are
# O(1) bf16 values (ulp 2^-7 .. 2^-6 there): allow 0.25 absolute.
LOGIT_ATOL = 0.25


def emit(obj) -> None:
    if "phase" in obj:                  # seconds since the script began
        obj = dict(obj, elapsed_s=time.perf_counter() - START)
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def _device_us(prof) -> list:
    """(name, device µs, calls) of every device-side event of a profile
    (a CPU op's self device time would count its kernels twice), summed
    from the profiler's raw events: ``key_averages`` first builds every
    event's op tree, tens of seconds for a serve's ~140k kernels."""
    import torch
    rows = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            us, n = rows.get(e.name(), (0.0, 0))
            rows[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
    return [(k, us, n) for k, (us, n) in rows.items()]


def device_ms(fn, iters: int = 20) -> float:
    """Device time per call: the sum of the device work ``fn`` starts,
    from torch.profiler, without the gaps in which the device waits for
    the host to launch the next call.  Where three profiles in a row
    catch no device event (torch.profiler drops them now and then), the
    CUDA-event time per call instead, an upper bound, with a note on
    stderr."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):          # a profile that caught no device event
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(us for _, us, _ in _device_us(prof))
        if total > 0:
            break               # is read again; a time of 0 is no time
    if total <= 0:
        print(f"torch.profiler saw no device time for {fn}: CUDA events "
              "used", file=sys.stderr)
        return call_ms(fn, iters)
    return total / 1e3 / iters


def call_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Wall time per call between CUDA events over back-to-back calls:
    the device time plus whatever host launch overhead it cannot hide."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int = 459, warmup: int = 3) -> float:
    """Host time per call, in microseconds, over back-to-back calls
    issued without waiting for the device (459: B10's launches in one
    int8 training step)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def tensor_map_encode_us(dev, iters: int = 459):
    """Host time of the two ``cuTensorMapEncodeTiled`` calls a B10 launch
    makes (its x and q maps at T 64, 2048 -> 2048, as csrc/dequant.cu's
    make_map encodes them), called here through ctypes: microseconds a
    pair, an upper bound since ctypes adds its own cost.  None where the
    CUDA driver refuses (the reason goes to stderr)."""
    import ctypes
    import torch
    enc = ctypes.CDLL("libcuda.so.1").cuTensorMapEncodeTiled
    x = torch.zeros((64, 2048), dtype=torch.bfloat16, device=dev)
    q = torch.zeros((2048, 2048), dtype=torch.int8, device=dev)
    buf = ctypes.create_string_buffer(256)       # a map: 128 B, 64-aligned
    tm = ctypes.c_void_p(ctypes.addressof(buf) + (-ctypes.addressof(buf)
                                                  % 64))
    u64, u32 = ctypes.c_uint64, ctypes.c_uint32
    # (data type, address, rows, cols, row bytes, box rows, box cols,
    # swizzle): bf16 = 9 with the 128-byte swizzle = 3, uint8 = 0 unswizzled
    maps = [(9, x.data_ptr(), 64, 2048, 4096, 256, 64, 3),
            (0, q.data_ptr(), 2048, 2048, 2048, 64, 128, 0)]
    args = [(u32(t), u32(2), ctypes.c_void_p(p), (u64 * 2)(c, r),
             (u64 * 1)(ld), (u32 * 2)(bc, br), (u32 * 2)(1, 1), u32(0),
             u32(sw), u32(3), u32(0))
            for t, p, r, c, ld, br, bc, sw in maps]
    for a in args:
        err = enc(tm, *a)
        if err:
            print(f"cuTensorMapEncodeTiled refused: {err}", file=sys.stderr)
            return None
    t0 = time.perf_counter()
    for _ in range(iters):
        for a in args:
            enc(tm, *a)
    return (time.perf_counter() - t0) / iters * 1e6


def bound(nbytes: float, flops: float):
    t_b, t_f = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16 * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def compare(got, want) -> dict:
    """Kernel against plain version; a tuple of outputs compares each."""
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    abs_err, rel_err, ok = 0.0, 0.0, True
    for a, b in zip(got, want):
        g, w = a.float(), b.float()
        err = (g - w).abs()
        ok &= bool((err <= ATOL + RTOL * w.abs()).all())
        abs_err = max(abs_err, err.max().item())
        rel_err = max(rel_err,
                      (err / w.abs().clamp_min(1e-3)).max().item())
    return {"max_abs_err": abs_err, "max_rel_err": rel_err,
            "within_tol": ok}


def compare_scaled(got, want) -> dict:
    """``compare`` with each pair divided by the largest |value| of its
    plain side first: a tolerance relative to the tensor, for sums over
    thousands of tokens whose terms the two sides round differently."""
    scale = [b.float().abs().max().clamp_min(1e-30) for b in want]
    return compare(tuple(a.float() / c for a, c in zip(got, scale)),
                   tuple(b.float() / c for b, c in zip(want, scale)))


def make_requests(seed: int, names, vocab: int):
    import numpy as np
    from repro_torch.serve import ServeRequest
    rng = np.random.default_rng(seed)
    return [ServeRequest(
        prompt=rng.integers(1, vocab, size=int(rng.integers(16, 201)),
                            dtype=np.int32),
        adapter=names[i % len(names)],
        max_new_tokens=int(rng.integers(16, 33))) for i in range(N_REQ)]


def geometry(reqs):
    """(rows per adapter, prompt width S) of the engine's fused batch."""
    from repro_torch.serve.engine import _align
    names = sorted({r.adapter for r in reqs})
    rows = tuple(_align(sum(r.adapter == n for r in reqs), BLOCK_T)
                 for n in names)
    S = _align(max(len(r.prompt) for r in reqs), BLOCK_T)
    return rows, S


# ------------------------------------------------------------- kernels
def lora_operands(ranks, d_in, d_out, T, g, dev):
    """Packed (d_in, R)/(R, d_out) bf16 pair with dead lanes zero, and x."""
    import torch
    from repro_torch.core.lora import RankLayout
    lay = RankLayout(ranks, MULTIPLE)
    A = torch.randn((d_in, lay.total), generator=g, device=dev) / d_in ** 0.5
    B = torch.zeros((lay.total, d_out), device=dev)
    for k, (off, rp) in enumerate(zip(lay.offsets, lay.r_pads)):
        r = ranks[k]
        A[:, off + r:off + rp] = 0.0
        B[off:off + r] = torch.randn((r, d_out), generator=g,
                                     device=dev) / r ** 0.5
    x = torch.randn((T, d_in), generator=g, device=dev)
    bf = torch.bfloat16
    return lay, x.to(bf), A.to(bf), B.to(bf)


def flash_cost(BH, S, hd, groups, vd=None, causal=True):
    """(bytes, flops) of flash attention over S keys: q, k, v read once,
    out and lse written once; q·k and p·v over the causal triangle (or
    every pair), v and out *vd* wide (default hd)."""
    vd = vd or hd
    nbytes = ((BH * S * (hd + vd) + (BH // groups) * S * (hd + vd)) * 2
              + BH * S * 4)
    pairs = S * (S + 1) // 2 if causal else S * S
    return nbytes, 2 * BH * (hd + vd) * pairs


def sdpa_library(q, k, v, causal):
    """One ``scaled_dot_product_attention`` call on (BH, S, d) q, k, v
    (batch 1, BH heads), pinned to the first backend that takes the
    shapes, flash first: (callable, backend name), or (None, None)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
               SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        def fn(be=be):
            with sdpa_kernel([be]):
                return F.scaled_dot_product_attention(
                    q[None], k[None], v[None], is_causal=causal)
        try:
            fn()
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        return fn, be.name
    return None, None


def lora_cases(T, d_in, d_out, R, rt, ranks, x, A, B, dy):
    """(wrapper, operands, bytes, flops) of B1-B4 on T tokens whose token x
    true-rank products sum to *rt*, the adapters present of true *ranks*:
    each input read once (the segments' live lanes), each output written
    once."""
    ab = (d_in + d_out) * sum(ranks) * 2          # A and B segments, once
    return (("ragged_lora_fwd", (x, A, B), T * d_in * 2 + ab + T * d_out * 4,
             2 * rt * (d_in + d_out)),
            ("ragged_lora_dgrad", (dy, A, B),
             T * d_out * 2 + ab + T * d_in * 4, 2 * rt * (d_in + d_out)),
            ("ragged_xa", (x, A),
             T * d_in * 2 + d_in * sum(ranks) * 2 + T * R * 2,
             2 * rt * d_in),
            ("ragged_dxa", (dy, B),
             T * d_out * 2 + d_out * sum(ranks) * 2 + T * R * 2,
             2 * rt * d_out))


def train_kernel_cases(g, dev):
    """The training step's kernels at its shapes: T = 8192 tokens (4 jobs
    x 4 x 512), ranks {8, 16, 32, 64}, block_t 128; the q/o projections
    (2048 -> 2048) and the k/v ones (2048 -> 256); flash over 16 x 32
    heads of 512 tokens, 8 query heads per kv head."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import fused_lora as fl
    from repro_torch.kernels import ragged as rg
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_attention_ref)
    from repro_torch.kernels.ops import _tile_jobs_static
    rows = (TRAIN_BATCH,) * len(TRAIN_RANKS)
    T = sum(rows) * TRAIN_SEQ
    tile_jobs = _tile_jobs_static(rows, TRAIN_SEQ, TRAIN_BLOCK_T)
    toks = [tile_jobs.count(k) * TRAIN_BLOCK_T for k in range(len(rows))]
    rt = sum(t * r for t, r in zip(toks, TRAIN_RANKS))   # token x true rank
    bt = TRAIN_BLOCK_T
    d_in = 2048
    cases = []
    for d_out in (2048, 256):
        lay, x, A, B = lora_operands(TRAIN_RANKS, d_in, d_out, T, g, dev)
        meta = rg.RaggedMeta.build(tile_jobs, lay)
        R = lay.total
        dy = (torch.randn((T, d_out), generator=g, device=dev)
              ).to(torch.bfloat16)
        xa = rg.ragged_xa_plain(x, A, meta, block_t=bt)
        dxa = rg.ragged_dxa_plain(dy, B, meta, block_t=bt)
        shape = dict(T=T, d_in=d_in, d_out=d_out)
        for name, args, nbytes, flops in lora_cases(
                T, d_in, d_out, R, rt, TRAIN_RANKS, x, A, B, dy):
            run = functools.partial(getattr(rg, name), *args, meta,
                                    block_t=bt)
            cases.append((name, "train", shape, run,
                          functools.partial(getattr(rg, name + "_plain"),
                                            *args, meta, block_t=bt),
                          None, nbytes, flops,
                          {} if name == "ragged_lora_fwd" else
                          {f"ms_rows_{r}": fwd_rows(run, r)
                           for r in fl.LORA_FWD_ROWS}))
        if d_out == 2048:
            # B1-B4 on 2048 tokens (tiles 4-19: inside job 0 to job 1),
            # timed at each row count a CTA can take
            jobs = tile_jobs[4:20]
            sm = rg.RaggedMeta.build(jobs, lay)
            Ts = len(jobs) * bt
            rts = sum(jobs.count(k) * bt * r
                      for k, r in enumerate(TRAIN_RANKS))
            for name, args, nbytes, flops in lora_cases(
                    Ts, d_in, d_out, R, rts,
                    [r for k, r in enumerate(TRAIN_RANKS) if k in jobs],
                    x[:Ts].contiguous(), A, B, dy[:Ts].contiguous()):
                run = functools.partial(getattr(rg, name), *args, sm,
                                        block_t=bt)
                cases.append((
                    name, "train", dict(shape, T=Ts, slice="tiles 4-19"),
                    run, functools.partial(getattr(rg, name + "_plain"),
                                           *args, sm, block_t=bt),
                    None, nbytes, flops,
                    {f"ms_rows_{r}": fwd_rows(run, r)
                     for r in fl.LORA_FWD_ROWS}))
        # wgrad: dB = wgrad(xa, dy_s) (d = d_out), dA^T = wgrad(dxa, x)
        for operand, u, v in (("dB", xa, dy), ("dA", dxa, x)):
            d = v.shape[1]
            cases.append(("ragged_wgrad", "train",
                          dict(shape, operand=operand, d=d),
                          functools.partial(rg.ragged_wgrad, u, v, meta,
                                            block_t=bt),
                          functools.partial(rg.ragged_wgrad_plain, u, v,
                                            meta, block_t=bt),
                          None, rt * 2 + T * d * 2 + R * d * 4,
                          2 * rt * d))
    # flash at the three head dims the kernel takes: tinyllama (32 heads,
    # kv 4, hd 64) and its reduced config (4 heads, kv 2, hd 32) over the
    # step's 16 sequences; command-r-35b (64 heads, kv 8, hd 128) over 4
    for name, H, KV, hd, n_seq in (
            ("tinyllama-1.1b", 32, 4, 64, TRAIN_BATCH * len(TRAIN_RANKS)),
            ("tinyllama-1.1b-reduced", 4, 2, 32,
             TRAIN_BATCH * len(TRAIN_RANKS)),
            ("command-r-35b", 64, 8, 128, 4)):
        BH, S, G = n_seq * H, TRAIN_SEQ, H // KV
        q = torch.randn((BH, S, hd), generator=g,
                        device=dev).to(torch.bfloat16)
        k = torch.randn((BH // G, S, hd), generator=g,
                        device=dev).to(torch.bfloat16)
        v = torch.randn(k.shape, generator=g, device=dev).to(torch.bfloat16)
        kr, vr = (t.repeat_interleave(G, dim=0)[None] for t in (k, v))
        cases.append((
            "flash_attention_fwd", "train",
            dict(BH=BH, S=S, hd=hd, kv_groups=G, model=name),
            functools.partial(flash_attention_fwd, q, k, v, causal=True,
                              kv_groups=G),
            functools.partial(flash_attention_ref, q, k, v, causal=True,
                              kv_groups=G),
            functools.partial(F.scaled_dot_product_attention, q[None], kr,
                              vr, is_causal=True),
            *flash_cost(BH, S, hd, G)))
    # the other families' widths over the step's 16 sequences:
    # deepseek-v2-lite-16b's MLA (16 heads, q/k 192, v 128, causal) and
    # hubert-xlarge's encoder (16 heads of 80, MHA, not causal)
    for name, hd, vd, causal in (("deepseek-v2-lite-16b", 192, 128, True),
                                 ("hubert-xlarge", 80, 80, False)):
        BH, S = TRAIN_BATCH * len(TRAIN_RANKS) * 16, TRAIN_SEQ
        q, k = (torch.randn((BH, S, hd), generator=g, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        v = torch.randn((BH, S, vd), generator=g,
                        device=dev).to(torch.bfloat16)
        lib, backend = sdpa_library(q, k, v, causal)
        cases.append((
            "flash_attention_fwd", "train",
            dict(BH=BH, S=S, hd=hd, vd=vd, causal=causal, kv_groups=1,
                 model=name, sdpa_backend=backend),
            functools.partial(flash_attention_fwd, q, k, v, causal=causal),
            functools.partial(flash_attention_ref, q, k, v, causal=causal),
            lib, *flash_cost(BH, S, hd, 1, vd=vd, causal=causal)))
    return cases


# The recurrent families' LoRA widths: (d_in, d_out, model, targets)
REC_WIDTHS = ((2560, 12368, "mamba2-2.7b", "ssd_in"),
              (5120, 2560, "mamba2-2.7b", "ssd_out"),
              (4096, 4096, "recurrentgemma-9b", "rg_in, rg_gate, rg_out, q, o"),
              (4096, 256, "recurrentgemma-9b", "k, v"))
# ... and the other families' (kv_a's 576 columns end in half a box)
FAM_WIDTHS = ((2048, 3072, "deepseek-v2-lite-16b", "q"),
              (2048, 576, "deepseek-v2-lite-16b", "kv_a"),
              (1280, 1280, "hubert-xlarge", "q, k, v, o"))


def width_kernel_cases(g, dev, widths=REC_WIDTHS):
    """B1-B8 at the LoRA widths of *widths* (the recurrent families' by
    default), the train shape: T = 8192 tokens (4 jobs x 4 x 512),
    block_t 128.  B1-B5
    on the train group's ranks {8, 16, 32, 64} (the ragged route); B6,
    B7 (xa, dxa, dx) and B8 (dA, dB) at r_pad 16 over the uniform route's
    strided stacked views, ranks {16, 8, 4, 2}.  ssd_in's 12368 output
    columns end in a partial 128-column box of the LoRA routine."""
    import torch
    from repro_torch.kernels import fused_lora as fl
    from repro_torch.kernels import ragged as rg
    from repro_torch.kernels.ops import _tile_jobs_static
    rows = (TRAIN_BATCH,) * len(TRAIN_RANKS)
    K, bt, bf = len(TRAIN_RANKS), TRAIN_BLOCK_T, torch.bfloat16
    T = sum(rows) * TRAIN_SEQ
    tile_jobs = _tile_jobs_static(rows, TRAIN_SEQ, bt)
    toks = [tile_jobs.count(k) * bt for k in range(K)]
    rt = sum(t * r for t, r in zip(toks, TRAIN_RANKS))
    full = torch.tensor(tile_jobs, dtype=torch.int32, device=dev)
    rk = torch.tensor(UNIFORM_RANKS, dtype=torch.int32, device=dev)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=dev)
    cases = []
    for d_in, d_out, model, targets in widths:
        shape = dict(T=T, d_in=d_in, d_out=d_out, model=model,
                     targets=targets)
        lay, x, A, B = lora_operands(TRAIN_RANKS, d_in, d_out, T, g, dev)
        meta = rg.RaggedMeta.build(tile_jobs, lay)
        R = lay.total
        # dy_s·Bᵀ, the backward's bf16 intermediate, sums d_out products:
        # dy's std sqrt(2048 / d_out) gives it the magnitude it has at the
        # train cell's 2048-wide projections, where the tolerance was
        # set.  With unit dy, at 12368 columns it is 2.5x larger, and a
        # one-ulp flip of its rounding (the two sides sum in other
        # orders) moved B2's dx by up to 0.066 on an H100 where |dx| was
        # small (PERF.md); partial_box_bit_equal shows the kernels exact
        # on the partial box.
        dy = (rnd(T, d_out) * (2048 / d_out) ** 0.5).to(bf)
        for name, args, nbytes, flops in lora_cases(
                T, d_in, d_out, R, rt, TRAIN_RANKS, x, A, B, dy):
            cases.append((name, "train", shape,
                          functools.partial(getattr(rg, name), *args, meta,
                                            block_t=bt),
                          functools.partial(getattr(rg, name + "_plain"),
                                            *args, meta, block_t=bt),
                          None, nbytes, flops))
        xa = rg.ragged_xa_plain(x, A, meta, block_t=bt)
        dxa = rg.ragged_dxa_plain(dy, B, meta, block_t=bt)
        for operand, u, v in (("dB", xa, dy), ("dA", dxa, x)):
            d = v.shape[1]
            cases.append(("ragged_wgrad", "train",
                          dict(shape, operand=operand, d=d),
                          functools.partial(rg.ragged_wgrad, u, v, meta,
                                            block_t=bt),
                          functools.partial(rg.ragged_wgrad_plain, u, v,
                                            meta, block_t=bt),
                          None, rt * 2 + T * d * 2 + R * d * 4, 2 * rt * d))
        del xa, dxa
        # the masked family at r_pad 16
        rp = 16
        Au = (rnd(d_in, K * rp) / d_in ** 0.5).to(bf)
        Bu = (rnd(K * rp, d_out) / rp ** 0.5).to(bf)
        A_st = Au.reshape(d_in, K, rp).movedim(-2, -3)
        B_st = Bu.reshape(K, rp, d_out)
        xa_u = rnd(T, rp).to(bf)
        flops_b6 = sum(2 * t * r * (d_in + d_out)
                       for t, r in zip(toks, UNIFORM_RANKS))
        cases.append((
            "fused_lora_cuda", "train", dict(shape, op="y = mask(x . A) . B",
                                             r_pad=rp),
            functools.partial(fl.fused_lora_cuda, x, A_st, B_st, full, rk,
                              block_t=bt),
            functools.partial(fl.fused_lora_plain, x, A_st, B_st, full, rk,
                              block_t=bt),
            None, T * (d_in + d_out) * 2 + K * (d_in + d_out) * rp * 2,
            flops_b6))
        for op, a, W in (("xa = x . A", x, A_st),
                         ("dxa = dy_s . B^T", dy, B_st.transpose(1, 2)),
                         ("dx = dxa . A^T", xa_u, A_st.transpose(1, 2))):
            d, n = a.shape[1], W.shape[-1]
            cases.append((
                "grouped_matmul_cuda", "train",
                dict(shape, op=op, r_pad=rp, d=d, n=n),
                functools.partial(fl.grouped_matmul_cuda, a, W, full,
                                  block_t=bt),
                functools.partial(fl.grouped_matmul_plain, a, W, full,
                                  block_t=bt),
                grouped_library(a, W, full, K, wgrad=False),
                (T * d + K * d * n + T * n) * 2, 2 * T * d * n))
        for op, u, v in (("dA = x^T . dxa", x, xa_u),
                         ("dB = xa^T . dy_s", xa_u, dy)):
            d_x, d_g = u.shape[1], v.shape[1]
            cases.append((
                "grouped_wgrad_cuda", "train",
                dict(shape, op=op, r_pad=rp, d_x=d_x, d_g=d_g),
                functools.partial(fl.grouped_wgrad_cuda, u, v, full, K,
                                  block_t=bt),
                functools.partial(fl.grouped_wgrad_plain, u, v, full, K,
                                  block_t=bt),
                grouped_library(u, v, full, K, wgrad=True),
                T * (d_x + d_g) * 2 + K * d_x * d_g * 4, 2 * T * d_x * d_g))
    return cases


def grouped_library(x, W, tile_map, K, wgrad: bool):
    """One ``torch._grouped_mm`` call computing the same grouped product
    (per-adapter row groups from the sorted tile map) or grouped wgrad
    (groups along the contracted token axis), for timing only; None
    where this PyTorch has no such call or it refuses these operands
    (the reason goes to stderr)."""
    import torch
    if not hasattr(torch, "_grouped_mm"):
        return None
    counts = torch.bincount(tile_map.long(), minlength=K) * TRAIN_BLOCK_T
    offs = torch.cumsum(counts, 0).to(torch.int32)
    # the wgrad's f32 output where this PyTorch offers it, else bf16
    tries = ([lambda: torch._grouped_mm(x.t(), W, offs=offs,
                                        out_dtype=torch.float32),
              lambda: torch._grouped_mm(x.t(), W, offs=offs)] if wgrad
             else [lambda: torch._grouped_mm(x, W, offs=offs)])
    for fn in tries:
        try:
            fn()
            torch.cuda.synchronize()
            return fn
        except RuntimeError as e:
            print(f"torch._grouped_mm refused: {e}", file=sys.stderr)
    return None


def masked_kernel_cases(g, dev):
    """B6, B7 and B8 at the masked route's training shapes: T = 8192 tokens of
    4 jobs (16 token tiles of 128 each), r_pad 16 (a uniform group: the
    packed pair's strided stacked views) and 64 (a mixed group densified
    for a nano slice: contiguous stacks), the q/o projections (2048 ->
    2048) and the k/v ones (2048 -> 256); and one N = 4 slice (2048
    tokens) whose tile map starts inside adapter 1 and omits adapters 0
    and 3; and one N = 2 slice (4096 tokens, tiles 8-39: inside adapter 0
    to inside adapter 2), whose narrow products also time every row count
    a CTA can take (``ms_rows_64`` etc.)."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_lora as fl
    bt, K, d_in = TRAIN_BLOCK_T, 4, 2048
    T = K * TRAIN_BATCH * TRAIN_SEQ
    bf = torch.bfloat16
    full = torch.repeat_interleave(torch.arange(K, device=dev),
                                   T // bt // K).to(torch.int32)
    sl = torch.tensor([1] * 4 + [2] * 12, dtype=torch.int32, device=dev)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=dev)
    cases = []

    def add_mm(what, x, W, tm, rp, rows=()):
        T_, d, d_out = x.shape[0], x.shape[1], W.shape[-1]
        nbytes = (T_ * d + W.shape[0] * d * d_out + T_ * d_out) * 2
        run = lambda: fl.grouped_matmul_cuda(x, W, tm, block_t=bt)
        cases.append((
            "grouped_matmul_cuda", "train",
            dict(op=what, T=T_, d_in=d, d_out=d_out, r_pad=rp,
                 tiles=len(tm), strided=not W.is_contiguous(),
                 rows=fl.grouped_geometry(T_, d_out, bt,
                                         build.sm_count(x.device))[1]),
            run,
            lambda: fl.grouped_matmul_plain(x, W, tm, block_t=bt),
            grouped_library(x, W, tm, K, wgrad=False),
            nbytes, 2 * T_ * d * d_out,
            {f"ms_rows_{r}": grouped_rows(run, r) for r in rows}))

    def add_wg(what, x, y, tm, rp):
        T_, d_x, d_g = x.shape[0], x.shape[1], y.shape[1]
        nbytes = T_ * (d_x + d_g) * 2 + K * d_x * d_g * 4
        cases.append((
            "grouped_wgrad_cuda", "train",
            dict(op=what, T=T_, d_x=d_x, d_g=d_g, r_pad=rp, tiles=len(tm),
                 adapters_with_tiles=int(torch.unique(tm).numel())),
            lambda: fl.grouped_wgrad_cuda(x, y, tm, K, block_t=bt),
            lambda: fl.grouped_wgrad_plain(x, y, tm, K, block_t=bt),
            grouped_library(x, y, tm, K, wgrad=True),
            nbytes, 2 * T_ * d_x * d_g))

    def add_fwd(what, x, A, B, tm, rp, ranks, rows=()):
        T_, d_out = x.shape[0], B.shape[-1]
        rk = torch.tensor(ranks, dtype=torch.int32, device=dev)
        present = sorted(set(tm.tolist()))
        toks = [int((tm == k).sum()) * bt for k in range(K)]
        run = lambda: fl.fused_lora_cuda(x, A, B, tm, rk, block_t=bt)
        cases.append((
            "fused_lora_cuda", "train",
            dict(op=what, T=T_, d_in=d_in, d_out=d_out, r_pad=rp,
                 tiles=len(tm), strided=not A.is_contiguous(),
                 geometry=fl.lora_fwd_geometry(T_, d_out, bt,
                                               build.sm_count(x.device))),
            run,
            lambda: fl.fused_lora_plain(x, A, B, tm, rk, block_t=bt),
            None,
            T_ * (d_in + d_out) * 2 + sum((d_in + d_out) * rp * 2
                                          for _ in present),
            sum(2 * toks[k] * ranks[k] * (d_in + d_out) for k in range(K)),
            {"pair_ms": b7_pair(x, A, B, tm, rk, bt),
             **{f"ms_rows_{r}": fwd_rows(run, r) for r in rows}}))

    for rp in (16, 64):
        x = (rnd(T, d_in)).to(bf)
        xa = (rnd(T, rp)).to(bf)
        for d_out in (2048, 256):
            if rp == 16:        # the uniform route's strided views
                A = (rnd(d_in, K * rp) / d_in ** 0.5).to(bf)
                B = (rnd(K * rp, d_out) / rp ** 0.5).to(bf)
                A_st = A.reshape(d_in, K, rp).movedim(-2, -3)
                B_st = B.reshape(K, rp, d_out)
            else:               # unpack_dense's contiguous stacks
                A_st = (rnd(K, d_in, rp) / d_in ** 0.5).to(bf)
                B_st = (rnd(K, rp, d_out) / rp ** 0.5).to(bf)
            dy = rnd(T, d_out).to(bf)
            add_mm("dxa = dy_s . B^T", dy, B_st.transpose(1, 2), full, rp)
            add_wg("dB = xa^T . dy_s", xa, dy, full, rp)
            if d_out == 2048:   # d_in is 2048 for every projection
                ranks = UNIFORM_RANKS if rp == 16 else TRAIN_RANKS
                add_fwd("y = mask(x . A) . B", x, A_st, B_st, full, rp,
                        ranks)
                add_mm("xa = x . A", x, A_st, full, rp)
                add_mm("dx = dxa . A^T", xa, A_st.transpose(1, 2), full, rp)
                add_wg("dA = x^T . dxa", x, xa, full, rp)
                if rp == 64:    # one nano slice: mid-adapter, two absent
                    Ts = len(sl) * bt
                    add_fwd("y = mask(x . A) . B (slice)",
                            x[:Ts].contiguous(), A_st, B_st, sl, rp, ranks,
                            fl.LORA_FWD_ROWS)
                    add_mm("xa = x . A (slice)", x[:Ts].contiguous(), A_st,
                           sl, rp)
                    add_wg("dA = x^T . dxa (slice)", x[:Ts].contiguous(),
                           xa[:Ts].contiguous(), sl, rp)
                    # one N = 2 slice: B7's narrow products at 4096 rows
                    half = full[8:40].contiguous()
                    Th = len(half) * bt
                    add_mm("xa = x . A (N = 2 slice)", x[:Th].contiguous(),
                           A_st, half, rp, fl.GROUPED_ROWS)
                    add_mm("dxa = dy_s . B^T (N = 2 slice)",
                           dy[:Th].contiguous(), B_st.transpose(1, 2), half,
                           rp, fl.GROUPED_ROWS)
    return cases


def grouped_rows(fn, rows: int, knob: str = "GROUPED_ROWS"):
    """*fn* with the token rows per CTA forced to *rows*: B7's
    (``GROUPED_ROWS``) or the LoRA forward's, B1 and B6
    (``LORA_FWD_ROWS``), for timing the row counts against each other and
    for the bit-equality checks across them."""
    from repro_torch.kernels import fused_lora as fl

    def run():
        keep = getattr(fl, knob)
        setattr(fl, knob, (rows,))
        try:
            return fn()
        finally:
            setattr(fl, knob, keep)
    return run


def fwd_rows(fn, rows: int):
    """*fn* (B1 or B6) at *rows* token rows a CTA."""
    return grouped_rows(fn, rows, "LORA_FWD_ROWS")


def b7_pair(x, A, B, tile_map, ranks, block_t: int):
    """B6's function in two launches of B7 and a mask: xa = B7 narrow
    x·A[k], lanes >= rank[k] zeroed (the mask precomputed), y = B7 wide
    xa·B[k]: the same summation orders, so bit-equal to B6; B6's
    yardstick (``pair_ms``)."""
    import torch
    from repro_torch.kernels import fused_lora as fl
    r_pad = A.shape[-1]
    drop = (torch.arange(r_pad, device=x.device)[None]
            >= ranks[tile_map.long()][:, None]).repeat_interleave(block_t, 0)

    def run():
        xa = fl.grouped_matmul_cuda(x, A, tile_map, block_t=block_t)
        return fl.grouped_matmul_cuda(xa.masked_fill_(drop, 0.0), B,
                                      tile_map, block_t=block_t)
    return run


def dequant_library(x, q, scale, trans: bool):
    """One ``torch._weight_int8pack_mm`` call computing the same product
    from the same int8 codes (its int8 operand is (N, K): for the
    backward's q^T that is the stored codes themselves, for the forward a
    transposed copy made here, outside the timing), for timing only; None
    where this PyTorch has no such call or refuses these operands (the
    reason goes to stderr)."""
    import torch
    if not hasattr(torch, "_weight_int8pack_mm"):
        return None
    w = q.T if trans else q.T.contiguous()
    s = (scale if scale is not None else torch.ones(
        q.shape[1], device=x.device)).to(x.dtype)
    fn = lambda: torch._weight_int8pack_mm(x, w, s)
    try:
        fn()
        torch.cuda.synchronize()
        return fn
    except RuntimeError as e:
        print(f"torch._weight_int8pack_mm refused: {e}", file=sys.stderr)
        return None


# B10 at the other families' projection widths (ROADMAP A7), the train
# shape, forward and the backward's dx from q^T: (d_in, d_out, model,
# projection)
B10_WIDTHS = ((2560, 12368, "mamba2-2.7b", "ssd_in"),
              (5120, 2560, "mamba2-2.7b", "ssd_out"),
              (2048, 3072, "deepseek-v2-lite-16b", "q"),
              (2048, 576, "deepseek-v2-lite-16b", "kv_a"),
              (512, 4096, "deepseek-v2-lite-16b", "kv_b"))
# B10 at a model rank's widths under tensor parallelism (model 2, ROADMAP
# A8b), the train shape: (d_in, d_out, model, projection, dx, f32 out).
# A column block's forward rounds to bf16 and its dx is an f32 partial;
# a row block's forward is an f32 partial (the ranks sum the partials
# before the one rounding: the kernel's f32 epilogue).
B10_TP_WIDTHS = (
    (2048, 1024, "tinyllama-1.1b", "q (column)", False, False),
    (2048, 2816, "tinyllama-1.1b", "gate (column)", True, True),
    (1024, 2048, "tinyllama-1.1b", "o (row)", False, True),
    (2816, 2048, "tinyllama-1.1b", "down (row)", False, True),
    (2560, 6224, "mamba2-2.7b", "ssd_in (segments)", False, False),
    (2560, 6224, "mamba2-2.7b", "ssd_in (segments)", True, True),
    (2560, 2560, "mamba2-2.7b", "ssd_out (row)", False, True))


def dequant_kernel_cases(g, dev):
    """B10 at the int8 backbone's shapes: decode (64 rows) at 2048 ->
    5632 and 2048 -> 2048; training (8192 tokens) at 2048 -> 2048 (q, o),
    2048 -> 256 (k, v), 2048 -> 5632 (gate, up) and 5632 -> 2048 (down);
    and the backward's transposed read, dx (8192, 5632) = dys · q_down^T;
    then at B10_WIDTHS, forward and dx, without the library call (73-207
    ms a call at 8192 rows).  Besides the library call, each case times
    what the bf16 backbone pays for the same projection: cuBLAS on a
    bf16 copy of the weight."""
    import torch
    from repro_torch.kernels import fused_lora as fl
    from repro_torch.models.quant import quantize_array
    cases = []
    library = "torch._weight_int8pack_mm"
    shapes = [(step, T, d_in, d_out, trans, {}) for step, T, d_in, d_out,
              trans in (("decode", 64, 2048, 5632, False),
                        ("decode", 64, 2048, 2048, False),
                        ("train", 8192, 2048, 2048, False),
                        ("train", 8192, 2048, 256, False),
                        ("train", 8192, 2048, 5632, False),
                        ("train", 8192, 5632, 2048, False),
                        ("train", 8192, 5632, 2048, True))]
    shapes += [("train", 8192, d_in, d_out, trans,
                {"model": model, "projection": proj})
               for d_in, d_out, model, proj in B10_WIDTHS
               for trans in (False, True)]
    shapes += [("train", 8192, d_in, d_out, trans,
                {"model": model, "projection": proj, "model_axis": 2,
                 "out": "f32" if f32 else "bf16"})
               for d_in, d_out, model, proj, trans, f32 in B10_TP_WIDTHS]
    for step, T, d_in, d_out, trans, where in shapes:
        f32 = where.get("out") == "f32"
        qt = quantize_array(torch.randn((d_in, d_out), generator=g,
                                        device=dev) / d_in ** 0.5)
        if trans:       # dx = dys · q^T: unit scales, q read transposed
            x = torch.randn((T, d_out), generator=g, device=dev)
            x = (x * qt.scale).to(torch.bfloat16)
            q, scale, K, N = qt.q.T, None, d_out, d_in
        else:
            x = torch.randn((T, d_in), generator=g,
                            device=dev).to(torch.bfloat16)
            q, scale, K, N = qt.q, qt.scale, d_in, d_out
        wb = (q.float() * (scale if scale is not None else 1.0)
              ).to(torch.bfloat16)
        nbytes = T * K * 2 + K * N + (N * 4 if scale is not None else 0) \
            + T * N * (4 if f32 else 2)
        lib = None if where else dequant_library(x, q, scale, trans)
        cases.append((
            "dequant_matmul_cuda", step,
            dict(op="dx = dys . q^T" if trans else "y = (x . q) * scale",
                 T=T, d_in=K, d_out=N, **where),
            functools.partial(fl.dequant_matmul_cuda, x, q, scale,
                              out_f32=f32),
            functools.partial(fl.dequant_matmul_plain, x, q, scale,
                              out_f32=f32),
            lib, nbytes, 2 * T * K * N,
            {"library": library if lib else None,
             "cublas_bf16_ms": functools.partial(torch.matmul, x, wb)}))
    return cases


def kernels_phase(rows, S, dev):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_attention_ref)
    from repro_torch.kernels.fused_lora import (fused_lora_cuda,
                                                fused_lora_plain)
    from repro_torch.kernels.ops import _tile_jobs_static
    from repro_torch.kernels.ragged import (RaggedMeta, ragged_lora_fwd,
                                            ragged_lora_fwd_plain)
    g = torch.Generator(device=dev).manual_seed(1)
    d_in = 2048
    n_rows = sum(rows)
    cases = []
    for phase, seq in (("prefill", S), ("decode", 1)):
        T = n_rows * seq
        tile_jobs = _tile_jobs_static(rows, seq, BLOCK_T)
        for d_out in (2048, 256):
            # ---- kernel 1: ragged, mixed ranks
            lay, x, A, B = lora_operands(MIXED, d_in, d_out, T, g, dev)
            meta = RaggedMeta.build(tile_jobs, lay)
            run = functools.partial(ragged_lora_fwd, x, A, B, meta,
                                    block_t=BLOCK_T)
            plain = functools.partial(ragged_lora_fwd_plain, x, A, B, meta,
                                      block_t=BLOCK_T)
            toks = [tile_jobs.count(k) * BLOCK_T for k in range(len(MIXED))]
            nbytes = (T * d_in * 2 + T * d_out * 4 + sum(
                (d_in + d_out) * r * 2 for k, r in enumerate(MIXED)
                if toks[k]))
            flops = sum(2 * toks[k] * r * (d_in + d_out)
                        for k, r in enumerate(MIXED))
            cases.append(("ragged_lora_fwd", phase,
                          dict(T=T, d_in=d_in, d_out=d_out), run, plain,
                          None, nbytes, flops))
            # ---- kernel 2: masked, uniform widths (strided stacked view
            # of the packed pair, as MultiLoRA.apply passes it)
            lay, x, A, B = lora_operands(UNIFORM, d_in, d_out, T, g, dev)
            K, rp = lay.num_jobs, lay.r_pads[0]
            A_st = A.reshape(d_in, K, rp).movedim(-2, -3)
            B_st = B.reshape(K, rp, d_out)
            ids = torch.tensor(tile_jobs, dtype=torch.int32, device=dev)
            ranks = torch.tensor(UNIFORM, dtype=torch.int32, device=dev)
            run = functools.partial(fused_lora_cuda, x, A_st, B_st, ids,
                                    ranks, block_t=BLOCK_T)
            plain = functools.partial(fused_lora_plain, x, A_st, B_st, ids,
                                      ranks, block_t=BLOCK_T)
            nbytes = T * d_in * 2 + T * d_out * 2 + sum(
                (d_in + d_out) * r * 2 for r in UNIFORM)
            flops = sum(2 * tile_jobs.count(k) * BLOCK_T * r * (d_in + d_out)
                        for k, r in enumerate(UNIFORM))
            cases.append(("fused_lora_cuda", phase,
                          dict(T=T, d_in=d_in, d_out=d_out), run, plain,
                          None, nbytes, flops,
                          {"pair_ms": b7_pair(x, A_st, B_st, ids, ranks,
                                              BLOCK_T)}))
    # ---- kernel 3: flash, causal prefill over the first S positions
    H, KV, hd = 32, 4, 64
    BH = n_rows * H
    q = torch.randn((BH, S, hd), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((BH // (H // KV), S, hd), generator=g,
                    device=dev).to(torch.bfloat16)
    v = torch.randn(k.shape, generator=g, device=dev).to(torch.bfloat16)
    kr, vr = (t.repeat_interleave(H // KV, dim=0)[None] for t in (k, v))
    run = lambda: flash_attention_fwd(q, k, v, causal=True, kv_groups=H // KV)
    plain = lambda: flash_attention_ref(q, k, v, causal=True,
                                        kv_groups=H // KV)
    lib = lambda: F.scaled_dot_product_attention(q[None], kr, vr,
                                                 is_causal=True)
    cases.append(("flash_attention_fwd", "prefill",
                  dict(BH=BH, S=S, hd=hd, kv_groups=H // KV), run, plain,
                  lib, *flash_cost(BH, S, hd, H // KV)))
    cases += train_kernel_cases(g, dev)
    cases += masked_kernel_cases(g, dev)
    cases += dequant_kernel_cases(g, dev)
    cases += width_kernel_cases(g, dev)
    cases += width_kernel_cases(g, dev, FAM_WIDTHS)
    results = time_cases(cases)
    checks = {"flash_row_invariance": flash_invariance(dev),
              "flash_row_invariance_hd32": flash_invariance(dev, hd=32),
              "flash_row_invariance_hd128": flash_invariance(dev, hd=128),
              "flash_row_invariance_192_128": flash_invariance(
                  dev, hd=192, vd=128, G=1),
              "flash_row_invariance_hd80_noncausal": flash_invariance(
                  dev, hd=80, G=1, causal=False),
              "wgrad_b5_b8": wgrad_families_bit_equal(dev),
              "grouped_b7_vs_ragged": grouped_families_bit_equal(dev),
              "grouped_b7_rows": grouped_rows_bit_equal(dev),
              "b10_rows_16_64_8192": dequant_rows_bit_equal(dev),
              "fwd_b6_b7_pair": fwd_b6_b7_pair(dev),
              "fwd_b1_b6": fwd_b1_b6(dev),
              "fwd_b1_lora_rows": fwd_b1_lora_rows(dev),
              "fwd_rows_16_64_8192": fwd_rows_bit_equal(dev),
              "bwd_rows_16_64_8192": bwd_rows_bit_equal(dev),
              "partial_box_12368": partial_box_bit_equal(dev),
              "partial_box_576": partial_box_bit_equal(dev, 2048, 576, 640),
              "box_1280": partial_box_bit_equal(dev, 1280, 1280, 1408)}
    emit({"phase": "kernels", "bit_equal_checks": checks,
          "b10_tensor_map_encode_us": tensor_map_encode_us(dev)})
    failed = [f"{k}.{c}" for k, v in checks.items() for c, ok in v.items()
              if not ok]
    if failed:
        raise AssertionError(f"bit-equality checks failed: {failed}")
    return results


def time_cases(cases) -> list:
    """Each case against its plain version (raises where they disagree),
    with its times and bound, one ``kernels`` line each.  A case may end
    with a dict of further fields: a callable is timed like the library
    call (the key names it), any other value is copied."""
    import torch
    results = []
    for name, step, shape, run, plain, lib, nbytes, flops, *more in cases:
        got = run()
        torch.cuda.synchronize()         # surfaces a fault in the kernel
        res = compare(got, plain())
        bms, by = bound(nbytes, flops)
        res.update(name=name, step=step, shape=shape,
                   ms=device_ms(run), call_ms=call_ms(run),
                   plain_ms=device_ms(plain, iters=5),
                   library_ms=device_ms(lib) if lib else None,
                   bound_ms=bms, bound_by=by, bytes=nbytes, flops=flops)
        for key, val in (more[0] if more else {}).items():
            res[key] = device_ms(val) if callable(val) else val
        if shape.get("out") == "f32":
            res.update(f32_unrounded(got, plain()))
            res["within_tol"] &= res["unrounded"]
        if name == "dequant_matmul_cuda":   # tensor maps encoded per call
            res["host_us_per_call"] = host_us(run)
        emit({"phase": "kernels", **res})
        if not res["within_tol"]:
            raise AssertionError(f"{name} ({step}, {shape}) disagrees with "
                                 f"its plain version: {res}")
        results.append(res)
    return results


# B10's f32 epilogue writes the unrounded accumulator: its error from the
# f32 plain version is the summation order's, far below one bf16 rounding
# (2^-9 of a value).  The bar sits between the two.
F32_EPILOGUE_RTOL = 2.0 ** -14


def f32_unrounded(got, want) -> dict:
    """An f32 output against its plain version under the bar
    ``F32_EPILOGUE_RTOL`` * max |plain|, and the same bar read on the
    plain version rounded to bf16 and widened back, which it must miss
    (the bar tells the unrounded epilogue from a rounded one)."""
    import torch
    w = want.float()
    bar = F32_EPILOGUE_RTOL * w.abs().max().item()
    err = (got.float() - w).abs().max().item()
    rounded = (w.to(torch.bfloat16).float() - w).abs().max().item()
    return {"f32_bar": bar, "f32_err": err, "bf16_rounded_err": rounded,
            "unrounded": err <= bar < rounded}


# --------------------------------------------- invariance and equality
def flash_invariance(dev, hd: int = 64, vd: int = 0, G: int = 8,
                     causal: bool = True) -> dict:
    """The flash kernel's row invariance, bit for bit: a row's output and
    lse depend only on its own q and on its keys (up to the causal
    frontier), not on Sq, Skv or BH (what keeps fused and solo prefill
    logits equal).  Causal: the first 48 rows at S = 192 against S = 48;
    not causal: the first 48 query rows over all 192 keys against all
    192 rows.  And heads 512..575 of a BH 2048 launch against those 64
    heads alone (GQA *G*: 8 is the serving prefill's), at head dim
    ``hd`` and v width ``vd`` (default hd)."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    g = torch.Generator(device=dev).manual_seed(3)
    S, h0, vd = 192, 512, vd or hd
    rnd = lambda *s: torch.randn(s, generator=g, device=dev).to(
        torch.bfloat16)
    q, k, v = rnd(2048, S, hd), rnd(2048 // G, S, hd), rnd(2048 // G, S, vd)
    run = lambda q_, k_, v_: flash_attention_fwd(
        q_.contiguous(), k_.contiguous(), v_.contiguous(), causal=causal,
        kv_groups=G)
    o, lse = run(q, k, v)
    kv48 = 48 if causal else S
    o48, lse48 = run(q[:64, :48], k[:64 // G, :kv48], v[:64 // G, :kv48])
    o64, lse64 = run(q[h0:h0 + 64], k[h0 // G:(h0 + 64) // G],
                     v[h0 // G:(h0 + 64) // G])
    torch.cuda.synchronize()
    return {"rows_48_of_192_bit_equal": bool(
                torch.equal(o48, o[:64, :48])
                and torch.equal(lse48, lse[:64, :48])),
            "heads_64_of_2048_bit_equal": bool(
                torch.equal(o64, o[h0:h0 + 64])
                and torch.equal(lse64, lse[h0:h0 + 64]))}


def wgrad_families_bit_equal(dev) -> dict:
    """B5 (ragged_wgrad) against B8 (grouped_wgrad) on one uniform layout
    (ranks {16, 16, 12, 16}, 4 jobs x 2048 tokens, block_t 128, width
    2048): dB and dA bit for bit, the two kernels summing through the one
    routine of csrc/lora_tile.cuh in one order."""
    import torch
    from repro_torch.core.lora import RankLayout
    from repro_torch.kernels import fused_lora as fl
    from repro_torch.kernels import ragged as rg
    from repro_torch.kernels.ops import _tile_jobs_static
    g = torch.Generator(device=dev).manual_seed(4)
    lay = RankLayout(UNIFORM, MULTIPLE)
    K, rp, bt = len(UNIFORM), lay.r_pads[0], TRAIN_BLOCK_T
    tile_jobs = _tile_jobs_static((TRAIN_BATCH,) * K, TRAIN_SEQ, bt)
    meta = rg.RaggedMeta.build(tile_jobs, lay)
    T = len(tile_jobs) * bt
    tm = torch.tensor(tile_jobs, dtype=torch.int32, device=dev)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev).to(
        torch.bfloat16)
    x, dy, xa, dxa = rnd(T, 2048), rnd(T, 2048), rnd(T, rp), rnd(T, rp)
    ids = torch.repeat_interleave(tm.long(), bt)
    cols = (torch.as_tensor(lay.offsets, device=dev)[ids][:, None]
            + torch.arange(rp, device=dev))

    def packed(u):          # each token's lanes in its adapter's segment
        return torch.zeros((T, lay.total), dtype=u.dtype,
                           device=dev).scatter_(1, cols, u)

    dB8 = fl.grouped_wgrad_cuda(xa, dy, tm, K, block_t=bt)
    dB5 = rg.ragged_wgrad(packed(xa), dy, meta, block_t=bt)
    dA8 = fl.grouped_wgrad_cuda(x, dxa, tm, K, block_t=bt)
    dA5 = rg.ragged_wgrad(packed(dxa), x, meta, block_t=bt)
    torch.cuda.synchronize()
    return {"dB_bit_equal": bool(torch.equal(dB8, dB5.reshape(K, rp, -1))),
            "dA_bit_equal": bool(torch.equal(
                dA8, dA5.reshape(K, rp, -1).transpose(1, 2)))}


def grouped_families_bit_equal(dev) -> dict:
    """B7 (grouped product) against the ragged family on one uniform
    layout (4 adapters, every rank = r_pad 16, T 8192, d 2048, block_t
    128), bit for bit: B3's segment columns against B7 narrow's xa = x·A,
    B4's against B7 narrow's dxa = dy_s·B^T, and bf16(B2's f32 dx)
    against B7 wide(B7 narrow(dy_s, B^T), A^T) -- the orders of the LoRA
    routine's x·W1 and xa·W2 (csrc/lora_fwd.cuh)."""
    import torch
    from repro_torch.core.lora import RankLayout
    from repro_torch.kernels import fused_lora as fl
    from repro_torch.kernels import ragged as rg
    from repro_torch.kernels.ops import _tile_jobs_static
    g = torch.Generator(device=dev).manual_seed(5)
    K, rp, bt, d = 4, 16, TRAIN_BLOCK_T, 2048
    lay = RankLayout((rp,) * K, MULTIPLE)
    tile_jobs = _tile_jobs_static((TRAIN_BATCH,) * K, TRAIN_SEQ, bt)
    meta = rg.RaggedMeta.build(tile_jobs, lay)
    T = len(tile_jobs) * bt
    tm = torch.tensor(tile_jobs, dtype=torch.int32, device=dev)
    bf = torch.bfloat16
    x = torch.randn((T, d), generator=g, device=dev).to(bf)
    dy = torch.randn((T, d), generator=g, device=dev).to(bf)
    A = (torch.randn((d, lay.total), generator=g, device=dev)
         / d ** 0.5).to(bf)
    B = (torch.randn((lay.total, d), generator=g, device=dev)
         / rp ** 0.5).to(bf)
    A_st = A.reshape(d, K, rp).movedim(-2, -3)   # MultiLoRA.apply's views
    B_st = B.reshape(K, rp, d)
    xa7 = fl.grouped_matmul_cuda(x, A_st, tm, block_t=bt)
    dxa7 = fl.grouped_matmul_cuda(dy, B_st.transpose(1, 2), tm, block_t=bt)
    dx7 = fl.grouped_matmul_cuda(dxa7, A_st.transpose(1, 2), tm, block_t=bt)
    xa3 = rg.ragged_xa(x, A, meta, block_t=bt)
    dxa4 = rg.ragged_dxa(dy, B, meta, block_t=bt)
    dx2 = rg.ragged_lora_dgrad(dy, A, B, meta, block_t=bt)
    torch.cuda.synchronize()
    ids = torch.repeat_interleave(tm.long(), bt)
    cols = (torch.as_tensor(lay.offsets, device=dev)[ids][:, None]
            + torch.arange(rp, device=dev))
    return {"xa_b3_b7": bool(torch.equal(xa3.gather(1, cols), xa7)),
            "dxa_b4_b7": bool(torch.equal(dxa4.gather(1, cols), dxa7)),
            "dx_b2_b7": bool(torch.equal(dx2.to(bf), dx7))}


def grouped_rows_bit_equal(dev) -> dict:
    """B7 at every row count a CTA can take, bit for bit, on one N = 2
    slice (4096 tokens, tiles 8-39 of a 4-adapter step, r_pad 64,
    contiguous stacks, d 2048): the narrow xa = x·A and dxa = dy_s·B^T
    and the wide dx = dxa·A^T.  Which count the wrapper picks depends on
    T and the card, so it must not change a result."""
    import torch
    from repro_torch.kernels import fused_lora as fl
    g = torch.Generator(device=dev).manual_seed(7)
    K, rp, bt, d = 4, 64, TRAIN_BLOCK_T, 2048
    tm = torch.repeat_interleave(torch.arange(K, device=dev), 16)[8:40]
    tm = tm.to(torch.int32).contiguous()
    T = len(tm) * bt
    rnd = lambda *s_: torch.randn(s_, generator=g, device=dev).to(
        torch.bfloat16)
    x, dy, dxa = rnd(T, d), rnd(T, d), rnd(T, rp)
    A, B = rnd(K, d, rp) / d ** 0.5, rnd(K, rp, d) / rp ** 0.5
    out = {}
    for name, a, W in (("xa", x, A), ("dxa", dy, B.transpose(1, 2)),
                       ("dx", dxa, A.transpose(1, 2))):
        ys = [grouped_rows(lambda: fl.grouped_matmul_cuda(
            a, W, tm, block_t=bt), r)() for r in fl.GROUPED_ROWS]
        torch.cuda.synchronize()
        out[f"{name}_rows_" + "_".join(map(str, fl.GROUPED_ROWS))] = all(
            torch.equal(ys[0], y) for y in ys[1:])
    return out


def fwd_b6_b7_pair(dev) -> dict:
    """B6 against the B7 pair (narrow x·A[k], the rank mask, wide
    xa·B[k]), bit for bit: on the uniform train shape (ranks {16, 8, 4,
    2}, r_pad 16, the packed pair's strided stacked views, T 8192) and on
    the N = 4 slice (r_pad 64, contiguous stacks, tiles of adapters 1 and
    2 only, T 2048), d 2048."""
    import torch
    from repro_torch.kernels import fused_lora as fl
    g = torch.Generator(device=dev).manual_seed(8)
    K, bt, d = 4, TRAIN_BLOCK_T, 2048
    rnd = lambda *s_: torch.randn(s_, generator=g, device=dev).to(
        torch.bfloat16)
    full = torch.repeat_interleave(torch.arange(K, device=dev), 16)
    sl = torch.tensor([1] * 4 + [2] * 12, device=dev)
    A = rnd(d, K * 16) / d ** 0.5
    B = rnd(K * 16, d) / 4
    cases = {"uniform_r16": (A.reshape(d, K, 16).movedim(-2, -3),
                             B.reshape(K, 16, d), full, UNIFORM_RANKS),
             "slice_r64": (rnd(K, d, 64) / d ** 0.5, rnd(K, 64, d) / 8, sl,
                           TRAIN_RANKS)}
    out = {}
    for name, (A_st, B_st, tm, ranks) in cases.items():
        tm = tm.to(torch.int32).contiguous()
        rk = torch.tensor(ranks, dtype=torch.int32, device=dev)
        x = rnd(len(tm) * bt, d)
        y6 = fl.fused_lora_cuda(x, A_st, B_st, tm, rk, block_t=bt)
        y7 = b7_pair(x, A_st, B_st, tm, rk, bt)()
        torch.cuda.synchronize()
        out[name] = bool(torch.equal(y6, y7))
    return out


def fwd_b1_b6(dev) -> dict:
    """B1 against B6 on one uniform layout (ranks {16, 8, 4, 2}, all
    padded to 16; B6 on the packed pair's strided stacked views), bit for
    bit: bf16(B1's f32 y) == B6's y, at the train shape (T 8192, block_t
    128) and at decode (T 64, block_t 16), d 2048."""
    import torch
    from repro_torch.core.lora import RankLayout
    from repro_torch.kernels import fused_lora as fl
    from repro_torch.kernels import ragged as rg
    from repro_torch.kernels.ops import _tile_jobs_static
    g = torch.Generator(device=dev).manual_seed(9)
    lay = RankLayout(UNIFORM_RANKS, MULTIPLE)
    K, rp, d = lay.num_jobs, lay.r_pads[0], 2048
    rk = torch.tensor(UNIFORM_RANKS, dtype=torch.int32, device=dev)
    out = {}
    for name, rows, seq, bt in (("train", (TRAIN_BATCH,) * K, TRAIN_SEQ,
                                 TRAIN_BLOCK_T),
                                ("decode", (BLOCK_T,) * K, 1, BLOCK_T)):
        _, x, A, B = lora_operands(UNIFORM_RANKS, d, d, sum(rows) * seq, g,
                                   dev)
        tile_jobs = _tile_jobs_static(rows, seq, bt)
        tm = torch.tensor(tile_jobs, dtype=torch.int32, device=dev)
        y1 = rg.ragged_lora_fwd(x, A, B, rg.RaggedMeta.build(tile_jobs, lay),
                                block_t=bt)
        y6 = fl.fused_lora_cuda(x, A.reshape(d, K, rp).movedim(-2, -3),
                                B.reshape(K, rp, d), tm, rk, block_t=bt)
        torch.cuda.synchronize()
        out[name] = bool(torch.equal(y1.to(torch.bfloat16), y6))
    return out


def fwd_b1_lora_rows(dev) -> dict:
    """B1's f32 y against B2 (ragged_lora_dgrad) fed x for dy_s, B^T for
    A and A^T for B (contiguous copies), bit for bit: both compute
    mask(x·A_seg)·B_seg in the LoRA routine's one summation order (the
    order of the retired lora_rows, which the key still names), B1 in the
    routine's Forward orientation and B2 in its Backward one.  The train
    layout (ranks {8, 16, 32, 64}, T 8192) at 2048 -> 2048 and 2048 ->
    256, and the decode one (T 64, block_t 16)."""
    import torch
    from repro_torch.core.lora import RankLayout
    from repro_torch.kernels import ragged as rg
    from repro_torch.kernels.ops import _tile_jobs_static
    g = torch.Generator(device=dev).manual_seed(10)
    lay = RankLayout(TRAIN_RANKS, MULTIPLE)
    K = lay.num_jobs
    out = {}
    for name, rows, seq, bt, d_out in (
            ("train_2048", (TRAIN_BATCH,) * K, TRAIN_SEQ, TRAIN_BLOCK_T,
             2048),
            ("train_256", (TRAIN_BATCH,) * K, TRAIN_SEQ, TRAIN_BLOCK_T, 256),
            ("decode_2048", (BLOCK_T,) * K, 1, BLOCK_T, 2048)):
        _, x, A, B = lora_operands(TRAIN_RANKS, 2048, d_out, sum(rows) * seq,
                                   g, dev)
        meta = rg.RaggedMeta.build(_tile_jobs_static(rows, seq, bt), lay)
        y1 = rg.ragged_lora_fwd(x, A, B, meta, block_t=bt)
        y2 = rg.ragged_lora_dgrad(x, B.T.contiguous(), A.T.contiguous(),
                                  meta, block_t=bt)
        torch.cuda.synchronize()
        out[name] = bool(torch.equal(y1, y2))
    return out


def fwd_rows_bit_equal(dev) -> dict:
    """B1 and B6 row invariance, bit for bit: rows 0-15 of a T = 16
    (block_t 16), a T = 64 (block_t 64) and a T = 8192 (block_t 128)
    call, at every row count a CTA can take there (16; 64, 32, 16; 64,
    32, 16), so with and without column splits: a row's output must not
    depend on how many rows share the call (fused vs solo serving, decode
    vs training).  Ranks {8, 16, 32, 64}: B6 on contiguous stacks at
    r_pad 64, B1 on the packed ragged pair; d 2048."""
    import torch
    from repro_torch.core.lora import RankLayout
    from repro_torch.kernels import fused_lora as fl
    from repro_torch.kernels import ragged as rg
    g = torch.Generator(device=dev).manual_seed(11)
    d, K, rp = 2048, len(TRAIN_RANKS), 64
    rnd = lambda *s_: torch.randn(s_, generator=g, device=dev).to(
        torch.bfloat16)
    lay, x, A, B = lora_operands(TRAIN_RANKS, d, d, 8192, g, dev)
    A_st, B_st = rnd(K, d, rp) / d ** 0.5, rnd(K, rp, d) / 8
    rk = torch.tensor(TRAIN_RANKS, dtype=torch.int32, device=dev)
    b1, b6 = [], []
    for T, bt in ((16, 16), (64, 64), (8192, TRAIN_BLOCK_T)):
        jobs = [t * K * bt // T for t in range(T // bt)]   # job 0 first
        meta = rg.RaggedMeta.build(jobs, lay)
        tm = torch.tensor(jobs, dtype=torch.int32, device=dev)
        xs = x[:T].contiguous()
        for r in (r for r in fl.LORA_FWD_ROWS if bt % r == 0):
            b1.append(fwd_rows(lambda: rg.ragged_lora_fwd(
                xs, A, B, meta, block_t=bt), r)()[:16])
            b6.append(fwd_rows(lambda: fl.fused_lora_cuda(
                xs, A_st, B_st, tm, rk, block_t=bt), r)()[:16])
    torch.cuda.synchronize()
    return {f"{name}_rows_0_15_of_T_16_64_8192": all(
                torch.equal(ys[0], y) for y in ys[1:])
            for name, ys in (("b1", b1), ("b6", b6))}


def partial_box_bit_equal(dev, d_in: int = 2560, d: int = 12368,
                          d_pad: int = 12416) -> dict:
    """A width of *d* columns that ends in a partial 128-column box of
    the LoRA routine and in partial column blocks of the grouped product
    and the wgrads (ssd_in's 12368 of mamba2-2.7b; MLA's kv_a, 576 of
    deepseek-v2-lite-16b) or in whole ones (hubert's 1280): each kernel
    at *d* against the same kernel on its operands zero-padded to
    *d_pad* (97, 5, 11 whole boxes), bit for bit on the first *d*
    columns (the padded columns add exact zeros at the same points).
    B1 and B6 (output columns), B2, B4 and B7's dxa (contraction over
    the columns), B5 and B8's dB (output columns); 2048 tokens of the
    train group (block_t 128)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import fused_lora as fl
    from repro_torch.kernels import ragged as rg
    g = torch.Generator(device=dev).manual_seed(13)
    bt, K, rp = TRAIN_BLOCK_T, len(TRAIN_RANKS), 16
    T = 4 * K * bt
    jobs = [t // 4 for t in range(T // bt)]
    lay, x, A, B = lora_operands(TRAIN_RANKS, d_in, d, T, g, dev)
    meta = rg.RaggedMeta.build(jobs, lay)
    tm = torch.tensor(jobs, dtype=torch.int32, device=dev)
    rk = torch.tensor(UNIFORM_RANKS, dtype=torch.int32, device=dev)
    rnd = lambda *s_: torch.randn(s_, generator=g, device=dev)
    pad = lambda t: F.pad(t, (0, d_pad - d)).contiguous()
    dy = (rnd(T, d) * (2048 / d) ** 0.5).to(torch.bfloat16)
    xa = rg.ragged_xa_plain(x, A, meta, block_t=bt)
    A_st = (rnd(K, d_in, rp) / d_in ** 0.5).to(torch.bfloat16)
    B_st = (rnd(K, rp, d) / rp ** 0.5).to(torch.bfloat16)
    xa_u = rnd(T, rp).to(torch.bfloat16)
    pairs = {
        "b1": (lambda b: rg.ragged_lora_fwd(x, A, b, meta, block_t=bt),
               (B,)),
        "b2": (lambda y, b: rg.ragged_lora_dgrad(y, A, b, meta, block_t=bt),
               (dy, B)),
        "b4": (lambda y, b: rg.ragged_dxa(y, b, meta, block_t=bt), (dy, B)),
        "b5_dB": (lambda y: rg.ragged_wgrad(xa, y, meta, block_t=bt), (dy,)),
        "b6": (lambda b: fl.fused_lora_cuda(x, A_st, b, tm, rk, block_t=bt),
               (B_st,)),
        "b7_dxa": (lambda y, b: fl.grouped_matmul_cuda(
            y, b.transpose(1, 2), tm, block_t=bt), (dy, B_st)),
        "b8_dB": (lambda y: fl.grouped_wgrad_cuda(xa_u, y, tm, K,
                                                  block_t=bt), (dy,))}
    out = {}
    for name, (fn, args) in pairs.items():
        got = fn(*args)
        padded = fn(*(pad(a) for a in args))
        if padded.shape[-1] != got.shape[-1]:
            padded = padded[..., :d]
        out[f"{name}_{d}_eq_padded_{d_pad}"] = torch.equal(got, padded)
    torch.cuda.synchronize()
    return out


def bwd_rows_bit_equal(dev) -> dict:
    """B2, B3 and B4 row invariance, bit for bit: rows 0-15 of a T = 16
    (block_t 16), a T = 64 (block_t 64) and a T = 8192 (block_t 128)
    call, at every row count a CTA can take there (16; 64, 32, 16; 64,
    32, 16), so with and without B2's column splits: a row's gradient
    must not depend on how many rows share the call.  Ranks {8, 16, 32,
    64} on the packed ragged pair, 2048 -> 2048."""
    import torch
    from repro_torch.kernels import fused_lora as fl
    from repro_torch.kernels import ragged as rg
    g = torch.Generator(device=dev).manual_seed(12)
    d, K = 2048, len(TRAIN_RANKS)
    lay, x, A, B = lora_operands(TRAIN_RANKS, d, d, 8192, g, dev)
    dy = torch.randn((8192, d), generator=g, device=dev).to(torch.bfloat16)
    outs = {"b2": [], "b3": [], "b4": []}
    for T, bt in ((16, 16), (64, 64), (8192, TRAIN_BLOCK_T)):
        jobs = [t * K * bt // T for t in range(T // bt)]   # job 0 first
        meta = rg.RaggedMeta.build(jobs, lay)
        xs, dys = x[:T].contiguous(), dy[:T].contiguous()
        for r in (r for r in fl.LORA_FWD_ROWS if bt % r == 0):
            outs["b2"].append(fwd_rows(lambda: rg.ragged_lora_dgrad(
                dys, A, B, meta, block_t=bt), r)()[:16])
            outs["b3"].append(fwd_rows(lambda: rg.ragged_xa(
                xs, A, meta, block_t=bt), r)()[:16])
            outs["b4"].append(fwd_rows(lambda: rg.ragged_dxa(
                dys, B, meta, block_t=bt), r)()[:16])
    torch.cuda.synchronize()
    return {f"{name}_rows_0_15_of_T_16_64_8192": all(
                torch.equal(ys[0], y) for y in ys[1:])
            for name, ys in outs.items()}


def dequant_rows_bit_equal(dev) -> dict:
    """B10's row invariance, bit for bit: rows 0-15 of a T = 16, a T = 64
    and a T = 8192 call, forward (2048 -> 5632, scaled) and through the
    transposed codes (5632 -> 2048, dx = dys · q^T, unit scales): a row's
    output must not depend on how many rows share the call (fused vs
    solo serving, decode vs training)."""
    import torch
    from repro_torch.kernels import fused_lora as fl
    from repro_torch.models.quant import quantize_array
    g = torch.Generator(device=dev).manual_seed(6)
    qt = quantize_array(torch.randn((2048, 5632), generator=g, device=dev)
                        / 2048 ** 0.5)
    out = {}
    for name, q, scale in (("forward", qt.q, qt.scale),
                           ("transposed", qt.q.T, None)):
        x = torch.randn((8192, q.shape[0]), generator=g,
                        device=dev).to(torch.bfloat16)
        rows = [fl.dequant_matmul_cuda(x[:T].contiguous(), q, scale)[:16]
                for T in (16, 64, 8192)]
        torch.cuda.synchronize()
        out[name] = bool(torch.equal(rows[0], rows[1])
                         and torch.equal(rows[0], rows[2]))
    return out


def c1_probe(engine, reqs, request: int = 0, steps: int = 1,
             row_blocks: bool = True, prefill: bool = False) -> dict:
    """Where fused and solo decoding part (ROADMAP C1): the first *steps*
    decode steps of ``reqs[request]``, through the engine's own
    ``_generate``, in the fused batch of ``reqs`` and alone, op by op for
    its row -- each layer's input norm, q/k/v projections, decode
    attention, o projection, MLP norm, MLP and residual, then the final
    norm and the logits.  Returns the first op whose row differs (None
    when every op is bit-equal), its max abs diff and the number of ops
    compared; and, beside them, whether cuBLAS gives each 16-row block of
    a 64-row product the bits of a 16-row product (the LM head, layer 0's
    q, gate and down projections, decode attention's score product):
    where it does not, one product over the fused batch's rows would part
    from the solo one.
    ``row_blocks=False`` decodes without the engine's row blocks
    (``ServeEngine.row_blocks``), to show where the fused and solo paths
    part without them.  ``prefill=True`` walks the prefill instead (its
    row's first prompt-length positions of each op), and checks the
    same cuBLAS property at the prefill's rows for the first two layers'
    products (``prefill_gemms``: 12288 rows against their first 3072)."""
    import torch
    from repro_torch.models import attention as A
    from repro_torch.models import mla as MLA
    from repro_torch.models import model as M
    ops, state = [], {"layer": -1, "n": {}, "in_block": False, "step": 0,
                      "row": 0}
    names = {"rms_norm": ("ln1", "ln2"), "proj": ("q", "k", "v", "o"),
             "mla_proj": ("q", "kv_a", "o")}
    # (module, attribute, tag): MLA's projections and the MoE FFN too
    patched = [(M, "rms_norm", "rms_norm"), (A, "proj", "proj"),
               (MLA, "proj", "mla_proj"),
               (A, "decode_attention", "decode_attention"),
               (M, "swiglu", "swiglu"), (M, "moe_ffn", "moe_ffn"),
               (M, "apply_block", "apply_block"), (M, "_logits", "_logits")]
    saved = [getattr(mod, name) for mod, name, _ in patched]

    def wrap(name, fn):
        def rec(*args, **kw):
            decode = name == "apply_block" and \
                (args[5].shape[1] == 1) != prefill
            if decode:                      # x of apply_block(cfg, spec,
                state.update(layer=state["layer"] + 1, n={},  # p, ad,
                             in_block=True)                   # lora, x..)
            out = fn(*args, **kw)
            if decode:
                state["in_block"] = False
            t = out[0] if isinstance(out, tuple) else out
            if (t.shape[1] == 1) == prefill:    # the other pass
                return out
            tag = name
            if name in names:               # the k-th call of its kind
                per, k = names[name], state["n"].get(name, 0)
                tag = per[k % len(per)] if state["in_block"] else "ln_f"
                state["n"][name] = k + 1
            where = f"step{state['step']}."
            row = t[state["row"]]
            if prefill:                     # the prompt's positions
                row = row[:len(reqs[request].prompt)]
            ops.append((where + (f"L{state['layer']}.{tag}"
                                 if name != "_logits" else "logits"),
                        row.detach().clone()))
            if name == "_logits":           # the step's last op
                state.update(step=state["step"] + 1, layer=-1)
            return out
        return rec

    def run(rs, i):                         # rs[i] is the probed request
        b = engine._batch(rs)
        ops.clear()
        state.update(layer=-1, n={}, step=1, row=b.row_req.index(i))
        engine._generate(b, 0 if prefill else steps)
        return list(ops)

    try:
        for (mod, name, tag), fn in zip(patched, saved):
            setattr(mod, name, wrap(tag, fn))
        engine.row_blocks = row_blocks
        with torch.inference_mode():
            fused = run(reqs, request)
            solo = run([reqs[request]], 0)
    finally:
        engine.row_blocks = True
        for (mod, name, _), fn in zip(patched, saved):
            setattr(mod, name, fn)
    assert [n for n, _ in fused] == [n for n, _ in solo], "op order"
    first, diff = None, 0.0
    for (name, a), (_, b) in zip(fused, solo):
        if not torch.equal(a, b):
            first = name
            diff = (a.float() - b.float()).abs().max().item()
            break
    g = torch.Generator(device=engine.device).manual_seed(5)
    p0 = engine.params["segments"][0]["0"]
    head = engine.params["embed"].T if engine.cfg.tie_embeddings \
        else engine.params["head"]
    cublas = {}
    for what, w in (("head", head), ("wq", p0["attn"]["wq"]),
                    ("gate", p0["ffn"]["gate"]), ("down", p0["ffn"]["down"])):
        if not isinstance(w, torch.Tensor):      # an int8 leaf: no cuBLAS
            continue
        w = w[0] if w.ndim == 3 else w
        x = torch.randn((64, w.shape[0]), generator=g,
                        device=engine.device).to(w.dtype)
        full = x @ w
        cublas[what] = all(torch.equal(full[i:i + 16], x[i:i + 16] @ w)
                           for i in range(0, 64, 16))
    # decode attention's score product over 128 keys (f32 copies of bf16),
    # 64 rows in one batched product against the first 16 alone
    cfg = engine.cfg
    kv, grp = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
    qg = torch.randn((64, 1, kv, grp, cfg.head_dim), generator=g,
                     device=engine.device).bfloat16().float()
    kc = torch.randn((64, 128, kv, cfg.head_dim), generator=g,
                     device=engine.device).bfloat16().float()
    eq = "bsngd,bcnd->bngsc"
    cublas["attn_scores"] = torch.equal(torch.einsum(eq, qg, kc)[:16],
                                        torch.einsum(eq, qg[:16], kc[:16]))
    if cfg.num_experts and len(engine.params["segments"]) > 1:
        # the expert product: 16 rows of one expert alone against the
        # same rows at the head of a 64-row group of that expert
        w = engine.params["segments"][-1]["0"]["ffn"]["w_in"][0]
        x = torch.randn((64, w.shape[1]), generator=g,
                        device=engine.device).to(w.dtype)
        ends = lambda n: torch.full((w.shape[0],), n, dtype=torch.int32,
                                    device=engine.device)
        cublas["grouped_mm_16_of_64"] = torch.equal(
            torch._grouped_mm(x, w, offs=ends(64))[:16],
            torch._grouped_mm(x[:16].contiguous(), w, offs=ends(16)))
    prefill_gemms = {}
    if prefill:
        def two_d(tree, path=()):
            for k, v in tree.items():
                if isinstance(v, dict):
                    yield from two_d(v, path + (k,))
                elif isinstance(v, torch.Tensor) and v.ndim >= 2:
                    yield "/".join(path + (k,)), v
        layers = [("L0", engine.params["segments"][0]["0"])]
        if len(engine.params["segments"]) > 1:
            layers.append(("L1", M._tree_map(
                lambda v: v[0], engine.params["segments"][1]["0"])))
        for lname, tree in layers:
            for what, w in two_d(tree):
                if w.ndim != 2:             # expert slabs: _grouped_mm
                    continue
                x = torch.randn((12288, w.shape[0]), generator=g,
                                device=engine.device).to(w.dtype)
                prefill_gemms[f"{lname}/{what}"] = torch.equal(
                    (x @ w)[:3072], x[:3072] @ w)
    return {"request": request, "steps": 0 if prefill else steps,
            "prefill": prefill, "prefill_gemms": prefill_gemms,
            "row_blocks": row_blocks,
            "fused_rows": len(engine._batch(reqs).row_req),
            "ops_compared": len(fused), "first_differing_op": first,
            "first_diff_max_abs": diff,
            "cublas_16_row_blocks_bit_equal_at_64_rows": cublas}


# --------------------------------------------------------------- serve
def publish(pool, cfg, names, ranks, seed, dev):
    """Seeded adapters: the port's init (A random, B zero), then a random
    B so that every adapter changes the output."""
    import torch
    from repro_torch.checkpoint.checkpoint import slice_job
    from repro_torch.core.lora import RankLayout, rank_axis_is_last
    from repro_torch.models import model as M
    for i, (n, r) in enumerate(zip(names, ranks)):
        tree = M.init_adapters(cfg, [r], seed=seed + i, device=dev,
                               layout=RankLayout((r,), MULTIPLE))
        flat = slice_job(tree, 0, r)
        g = torch.Generator(device=dev).manual_seed(seed + 1000 + i)
        for key, t in flat.items():
            if not rank_axis_is_last(key):
                flat[key] = torch.randn(t.shape, generator=g,
                                        device=dev) * B_STD
        pool.publish(n, flat, rank=r)


def profile_run(fn) -> dict:
    """One run of ``fn`` under torch.profiler: device-busy time (the sum
    of the device kernels' own times) against host wall time, and the
    kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    # device activity only: the host ops' events would multiply the
    # profiler's own cost (minutes for a serve's ~100k launches)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    rows = _device_us(prof)
    if not rows:                       # the profiler saw no device time
        return {"wall_s": wall, "device_busy_s": None}
    busy_us = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    families = {}
    for k, us, n in rows:
        fam = _family(k)
        ms, calls = families.get(fam, (0.0, 0))
        families[fam] = (ms + us / 1e3, calls + n)
    return {"wall_s": wall, "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1 - busy_us / 1e6 / wall,
            "device_kernels": sum(r[2] for r in rows),
            "by_family": {f: {"device_ms": ms, "calls": n}
                          for f, (ms, n) in sorted(
                              families.items(), key=lambda kv: -kv[1][0])},
            "top": [{"name": k[:80], "device_ms": us / 1e3, "calls": n}
                    for k, us, n in rows[:12]]}


def _family(kernel_name: str) -> str:
    """The port's kernels by name (``wgrad_*``: the two passes B5 and B8
    share; B1, B6 and B2 by the orientation and segment type of their one
    template, B3 and B4 by the packed kernel's name); the MoE expert
    products (``torch._grouped_mm``, a CUTLASS grouped GEMM); f32 GEMMs
    (the plain attention backward's einsums run in f32), the other
    library GEMMs, and everything else."""
    if "GroupProblemShape" in kernel_name:      # torch._grouped_mm
        return "library_grouped_mm"
    for port in ("ragged_lora_fwd", "ragged_dgrad", "ragged_packed",
                 "wgrad_partials", "wgrad_reduce", "fused_lora_fwd",
                 "grouped_mm", "flash_fwd", "dequant_mm"):
        if port in kernel_name:
            return port
    if "lora_packed_kernel" in kernel_name:    # B3 and B4
        return "ragged_packed"
    if "lora_kernel" in kernel_name:           # B1, B6 and B2
        if "Backward" in kernel_name:
            return "ragged_dgrad"
        return ("ragged_lora_fwd" if "RaggedSeg" in kernel_name
                else "fused_lora_fwd")
    if "f32f32" in kernel_name:
        return "gemm_f32"
    if any(t in kernel_name for t in ("gemm", "nvjet", "xmma", "cutlass")):
        return "gemm_library"
    return "elementwise_copy_reduce"


def serve_phase(cfg, params, sets, dev):
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.fused_lora import fused_lora_cuda
    from repro_torch.kernels.ragged import ragged_lora_fwd
    from repro_torch.serve import AdapterPool, ServeEngine, ServeRequest

    t0 = time.perf_counter()
    pool = AdapterPool(cfg, capacity=8, multiple=MULTIPLE, device=dev)
    for si, (_, names, ranks, _) in enumerate(sets):
        publish(pool, cfg, names, ranks, seed=100 * (si + 1), dev=dev)
    engine = ServeEngine(cfg, params, pool, impl="cuda", block_t=BLOCK_T)
    # warm-up (cuBLAS handles, first launches): not timed, not counted
    engine.serve([ServeRequest(sets[0][3][0].prompt[:16], sets[0][1][0],
                               max_new_tokens=2)])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    wrappers = (ragged_lora_fwd, fused_lora_cuda, flash_attention_fwd)
    for w in wrappers:                   # the main path starts here
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    out = {}
    for set_name, names, ranks, reqs in sets:
        before = [w.launches for w in wrappers]
        t = time.perf_counter()
        res = engine.serve(reqs)
        secs = time.perf_counter() - t
        n_tok = sum(len(r.tokens) for r in res)
        out[set_name] = dict(
            results=res, seconds=secs, tokens=n_tok, tok_per_s=n_tok / secs,
            launches={w.__name__: w.launches - b
                      for w, b in zip(wrappers, before)})
    launches = {w.__name__: w.launches for w in wrappers}
    peak = torch.cuda.max_memory_allocated()
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"main path never launched {name}")

    # fused vs solo (outside the counted run): the prefill logits are
    # held to LOGIT_ATOL and the first decode step's are reported; the
    # C1 probe walks every decode step of request 1 op by op, and every
    # compared request's whole sequence must come out the same
    for set_name, names, ranks, reqs in sets:
        rec = out[set_name]
        diffs, flips = [], []
        for steps in (0, 1):
            fused_lg = engine.next_token_logits(reqs, steps).float()
            solo_lg = torch.cat([engine.next_token_logits([r], steps)
                                 for r in reqs]).float()
            if not bool(torch.isfinite(fused_lg).all()):
                raise AssertionError(f"{set_name}: non-finite logits")
            diffs.append((fused_lg - solo_lg).abs().max().item())
            flips.append(int((fused_lg.argmax(-1)
                              != solo_lg.argmax(-1)).sum()))
        probe = c1_probe(engine, reqs, request=1,
                         steps=reqs[1].max_new_tokens - 1)
        unblocked = c1_probe(engine, reqs, request=1, steps=1,
                             row_blocks=False)
        # whole sequences solo for two requests per adapter: 16 solo
        # serves a set took minutes of the run's time limit on slow hosts
        pairs = list(zip(reqs, rec["results"]))[:2 * len(names)]
        same = sum(int(f.tokens.tolist() ==
                       engine.serve([r])[0].tokens.tolist())
                   for r, f in pairs)
        emit({"phase": "serve", "set": set_name, "ranks": list(ranks),
              "requests": len(reqs), "rows": sum(geometry(reqs)[0]),
              "prompt_width": geometry(reqs)[1],
              "generated_tokens": rec["tokens"], "seconds": rec["seconds"],
              "tokens_per_s": rec["tok_per_s"], "launches": rec["launches"],
              "prefill_logits_max_abs_diff_fused_vs_solo": diffs[0],
              "logit_atol": LOGIT_ATOL,
              "decode1_logits_max_abs_diff_fused_vs_solo": diffs[1],
              "argmax_flips_prefill_decode1": flips,
              "c1_probe": probe, "c1_probe_without_row_blocks": unblocked,
              "token_ids_identical_share": same / len(pairs),
              "token_ids_compared": len(pairs)})
        if diffs[0] > LOGIT_ATOL:
            raise AssertionError(f"{set_name}: fused vs solo prefill logits "
                                 f"differ by {diffs[0]} (atol {LOGIT_ATOL})")
        if probe["first_differing_op"] is not None or same != len(pairs):
            raise AssertionError(
                f"{set_name}: fused and solo decoding part: {same} of "
                f"{len(pairs)} sequences equal; first decode step {probe}")
    prof = {set_name: profile_run(functools.partial(engine.serve, reqs))
            for set_name, _, _, reqs in sets}
    cost = {set_name: row_blocks_cost(engine, reqs, prof[set_name])
            for set_name, _, _, reqs in sets}
    emit({"phase": "serve", "model": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "setup_seconds": setup_s,
          "peak_device_memory_bytes": peak, "launches": launches,
          "profile": prof, "row_blocks_cost": cost, "card": card_line()})
    return launches


def row_blocks_cost(engine, reqs, prof_blocked: dict) -> dict:
    """What the decode steps' row blocks (``ServeEngine.row_blocks``)
    cost a serve of *reqs*: tokens per second with them and without,
    served alternately (on, off, on, off) in this run, untraced; and the
    device kernels and device-busy time of one serve each way, traced
    (*prof_blocked*: the phase's own profile, taken with them)."""
    import torch
    rates = {True: [], False: []}
    try:
        for on in (True, False, True, False):
            engine.row_blocks = on
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = engine.serve(reqs)
            secs = time.perf_counter() - t
            rates[on].append(sum(len(r.tokens) for r in res) / secs)
        engine.row_blocks = False
        whole = profile_run(functools.partial(engine.serve, reqs))
    finally:
        engine.row_blocks = True
    return {"tokens_per_s_row_blocks": rates[True],
            "tokens_per_s_whole": rates[False],
            "device_kernels_per_serve_row_blocks":
                prof_blocked.get("device_kernels"),
            "device_kernels_per_serve_whole": whole.get("device_kernels"),
            "device_busy_s_row_blocks": prof_blocked.get("device_busy_s"),
            "device_busy_s_whole": whole.get("device_busy_s")}


# --------------------------------------------------------------- train
def train_specs(ranks=TRAIN_RANKS, prefix="train"):
    from repro_torch.core.jobs import LoRAJobSpec
    return [LoRAJobSpec(f"{prefix}{i}-r{r}", rank=r, batch_size=TRAIN_BATCH,
                        seq_len=TRAIN_SEQ)
            for i, r in enumerate(ranks)]


def lora_wrappers():
    """Every kernel wrapper of the training path (the int8 backbone's
    included), with its counter."""
    from repro_torch.kernels import fused_lora as fl
    from repro_torch.kernels import ragged as rg
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    return (rg.ragged_lora_fwd, rg.ragged_lora_dgrad, rg.ragged_xa,
            rg.ragged_dxa, rg.ragged_wgrad, fl.fused_lora_cuda,
            fl.grouped_matmul_cuda, fl.grouped_wgrad_cuda,
            flash_attention_fwd, fl.dequant_matmul_cuda)


def counted(fn):
    """Run *fn* with every training-path counter set to 0 just before and
    read just after: (fn's result, {wrapper name: launches})."""
    import torch
    wrappers = lora_wrappers()
    torch.cuda.synchronize()
    for w in wrappers:
        w.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {w.__name__: w.launches for w in wrappers}


def train_adapters(cfg, ranks, layout, dev, seed=7):
    """The port's init (A random, lanes >= rank zero), then a random B so
    that every kernel of the step does real work from the first step."""
    import torch
    from repro_torch.core.lora import rank_axis_is_last
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import tree_map
    adapters = M.init_adapters(cfg, ranks, seed=seed, layout=layout,
                               device=dev)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    act = torch.as_tensor(layout.active_cols, device=dev)[:, None]
    return tree_map(
        lambda p, t: t if rank_axis_is_last(p[-1]) else
        torch.randn(t.shape, generator=g, device=dev) * B_STD * act,
        adapters)


def check_launches(phase, launches, steps, expect):
    per_step = {k: n / steps for k, n in launches.items()}
    if per_step != expect:
        raise AssertionError(f"{phase}: launches per training step "
                             f"{per_step}, expected {expect}")
    return per_step


def adapter_grads(cfg, params, specs, impl, adapters, batch,
                  other_route=False):
    """One step's adapter gradients through ``impl`` (the train step's
    loss: per-job denominators over the full batch, remat on).
    ``other_route`` sends "cuda" through the kernel family the layout does
    not take by itself: the ragged kernels for a uniform layout (its
    ``is_uniform`` overridden on a copy), the densified masked route of a
    nano slice (no static tile map) for a mixed one."""
    import dataclasses
    import torch
    from repro_torch.core.ssm import SharedSuperModel, _per_job_token_counts
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import tree_leaves, tree_map
    ssm = SharedSuperModel(cfg, specs, impl=impl, block_t=TRAIN_BLOCK_T)
    ad = tree_map(lambda _, t: t.detach().clone().requires_grad_(), adapters)
    denom = _per_job_token_counts(batch, len(specs), causal=cfg.causal)
    ctx = ssm.lora_ctx(batch["adapter_ids"])
    if other_route and ssm.layout.is_uniform:
        ctx.layout = dataclasses.replace(ssm.layout)
        ctx.layout.__dict__["is_uniform"] = False
    elif other_route:
        ctx.rows_all = None
    total, _ = M.loss_fn(cfg, params, ad, ctx, batch, remat=True,
                         per_job_denom=denom)
    return torch.autograd.grad(total, list(tree_leaves(ad)))


def fused_vs_solo_loss(cfg, params, specs, layout, adapters, batch,
                       k=0) -> dict:
    """Job *k*'s loss in the fused group against the job alone (its
    adapter segment and its rows), remat off."""
    import torch
    from repro_torch.core.lora import rank_axis_is_last
    from repro_torch.core.ssm import SharedSuperModel
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import tree_map
    with torch.no_grad():
        fused = SharedSuperModel(cfg, specs, impl="cuda",
                                 block_t=TRAIN_BLOCK_T)
        _, aux = M.loss_fn(cfg, params, adapters,
                           fused.lora_ctx(batch["adapter_ids"]), batch,
                           remat=False)
        solo = SharedSuperModel(cfg, [specs[k]], impl="cuda",
                                block_t=TRAIN_BLOCK_T)
        off, rp = layout.slice_of(k)
        solo_ad = tree_map(lambda p, t: t[..., off:off + rp]
                           if rank_axis_is_last(p[-1])
                           else t[..., off:off + rp, :], adapters)
        rows = batch["adapter_ids"] == k
        solo_b = {key: v[rows] for key, v in batch.items()}
        solo_b["adapter_ids"] = torch.zeros_like(solo_b["adapter_ids"])
        _, solo_aux = M.loss_fn(cfg, params, solo_ad,
                                solo.lora_ctx(solo_b["adapter_ids"]),
                                solo_b, remat=False)
    out = {"job": specs[k].job_id, "fused_loss": aux["per_job"][k].item(),
           "solo_loss": solo_aux["per_job"][0].item(), "atol": LOSS_ATOL,
           "fused_moe_aux": aux["aux"].item(),
           "solo_moe_aux": solo_aux["aux"].item()}
    out["abs_diff"] = abs(out["fused_loss"] - out["solo_loss"])
    return out


def train_phase(cfg, params, dev, *, phase="train", ranks=TRAIN_RANKS,
                expect=TRAIN_LAUNCHES, loop_rtol=GRAD_RTOL, measured=None):
    """``loop_rtol`` bounds the cuda-vs-loop gradient error where it is
    asserted (None: reported only; see the uniform phase in main).  The
    steady step goes into ``measured`` (the calibrate phase's input)."""
    import numpy as np
    import torch
    from repro_torch.core.ssm import SharedSuperModel
    from repro_torch.data.pipeline import FusedBatcher
    from repro_torch.train.train_loop import train_group

    specs = train_specs(ranks, prefix=phase)
    layout = SharedSuperModel(cfg, specs, block_t=TRAIN_BLOCK_T).layout
    assert layout.is_uniform == (expect is MASKED_LAUNCHES), layout.r_pads
    adapters = train_adapters(cfg, ranks, layout, dev)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, launches = counted(lambda: train_group(
        cfg, specs, steps=TRAIN_STEPS, lr=TRAIN_LR, seed=0, impl="cuda",
        block_t=TRAIN_BLOCK_T, chunk_size=TRAIN_CHUNK, remat=True,
        adaptive_nano=False, params=params, adapters=adapters, device=dev))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    per_step = check_launches(phase, launches, TRAIN_STEPS, expect)
    rep = out["report"]
    losses = np.stack(rep.per_job_losses)
    if losses.shape != (TRAIN_STEPS, len(specs)) or \
            not np.isfinite(losses).all():
        raise AssertionError(f"{phase}: per-job losses not finite: {losses}")

    # tokens trained: the same data streams replayed on the host
    replay = FusedBatcher(specs, cfg.vocab_size, block_t=TRAIN_BLOCK_T,
                          seed=0)
    batches = [replay.next_batch() for _ in range(TRAIN_STEPS)]
    real = int(sum(b["loss_mask"].sum() for b in batches))
    padded = int(sum(b["loss_mask"].size for b in batches))
    steady = float(np.mean(rep.step_times[TRAIN_CHUNK:]))

    # one step's gradients, cuda (the kernels) vs loop (autograd through
    # plain per-adapter GEMMs), on a fresh batch, outside the counted run
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             FusedBatcher(specs, cfg.vocab_size, block_t=TRAIN_BLOCK_T,
                          seed=1).next_batch().items()}
    g_cuda = adapter_grads(cfg, params, specs, "cuda", out["adapters"],
                           batch)
    g_loop = adapter_grads(cfg, params, specs, "loop", out["adapters"],
                           batch)
    g_other = adapter_grads(cfg, params, specs, "cuda", out["adapters"],
                            batch, other_route=True)
    rel = [((a.float() - b.float()).norm() / b.float().norm()).item()
           for a, b in zip(g_cuda, g_loop)]
    rel_route = [((a.float() - b.float()).norm() / b.float().norm()).item()
                 for a, b in zip(g_cuda, g_other)]
    grad_check = {"leaves": len(rel), "max_rel_fro_err": max(rel),
                  "mean_rel_fro_err": float(np.mean(rel)),
                  "rtol": loop_rtol,
                  "other_route": ("ragged" if layout.is_uniform
                                  else "masked, densified"),
                  "max_rel_fro_err_vs_other_route": max(rel_route),
                  "route_rtol": ROUTE_RTOL,
                  "max_abs_err": max((a.float() - b.float()).abs().max().item()
                                     for a, b in zip(g_cuda, g_loop)),
                  "max_abs_grad": max(b.abs().max().item() for b in g_loop)}

    fused_vs_solo = fused_vs_solo_loss(cfg, params, specs, layout,
                                       out["adapters"], batch)

    prof = profile_run(functools.partial(out["runtime"].run, 1))
    emit({"phase": phase, "model": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model,
          "jobs": [{"id": sp.job_id, "rank": sp.rank, "r_pad": rp_}
                   for sp, rp_ in zip(specs, layout.r_pads)],
          "batch_size": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
          "block_t": TRAIN_BLOCK_T, "steps": TRAIN_STEPS,
          "chunk_size": TRAIN_CHUNK, "remat": True,
          "per_step_per_job_loss": losses.tolist(),
          "step_times_s": rep.step_times, "wall_s": wall,
          "step_s_steady": steady,
          "tokens_real": real, "tokens_padded": padded,
          "tokens_per_s_real": real / wall,
          "tokens_per_s_padded": padded / wall,
          "tokens_per_s_real_steady": real / TRAIN_STEPS / steady,
          "tokens_per_s_padded_steady": padded / TRAIN_STEPS / steady,
          "peak_device_memory_bytes": peak,
          "launches": launches, "launches_per_step": per_step,
          "grad_check_cuda_vs_loop": grad_check,
          "fused_vs_solo_loss": fused_vs_solo,
          "profile_one_step": prof, "card": card_line()})
    if loop_rtol is not None and grad_check["max_rel_fro_err"] > loop_rtol:
        raise AssertionError(f"{phase}: cuda vs loop adapter gradients: "
                             f"{grad_check}")
    if grad_check["max_rel_fro_err_vs_other_route"] > ROUTE_RTOL:
        raise AssertionError(f"{phase}: the two kernel families' adapter "
                             f"gradients differ: {grad_check}")
    if fused_vs_solo["abs_diff"] > LOSS_ATOL:
        raise AssertionError(f"{phase}: fused vs solo loss: {fused_vs_solo}")
    if measured is not None:
        measured[phase] = dict(ranks=ranks, nano=1, dtype="bf16",
                               step_s=steady)
    return launches, losses, steady


def wide_phase(dev):
    """One group of the train phase's ranks {8, 16, 32, 64} through
    ``train_group`` on command-r-35b cut to WIDE_LAYERS layers at full
    width: flash at head dim 128, every LoRA kernel at d_model 8192,
    exact launches per step (flash: 2 a layer, remat) and finite
    per-job losses.  The batch is the train phase's (4 sequences of 512
    per job): 80 GB holds it.  Then one step's adapter gradients through
    the kernels against the "loop" impl, at GRAD_RTOL: what holds B1-B5
    to their plain versions at d_model 8192 (q/o 8192 -> 8192, k/v 8192
    -> 1024)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.ssm import SharedSuperModel
    from repro_torch.data.pipeline import FusedBatcher
    from repro_torch.models import model as M
    from repro_torch.train.train_loop import train_group
    cfg = dataclasses.replace(get_config(WIDE_ARCH), num_layers=WIDE_LAYERS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = M.init_model(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    specs = train_specs(TRAIN_RANKS, prefix="wide")
    layout = SharedSuperModel(cfg, specs, block_t=TRAIN_BLOCK_T).layout
    adapters = train_adapters(cfg, TRAIN_RANKS, layout, dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, launches = counted(lambda: train_group(
        cfg, specs, steps=WIDE_STEPS, lr=TRAIN_LR, seed=0, impl="cuda",
        block_t=TRAIN_BLOCK_T, chunk_size=WIDE_STEPS, remat=True,
        adaptive_nano=False, params=params, adapters=adapters, device=dev))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    expect = {k: n * WIDE_LAYERS // TRAIN_LAYERS
              for k, n in TRAIN_LAUNCHES.items()}
    per_step = check_launches("wide", launches, WIDE_STEPS, expect)
    report, trained = out["report"], out["adapters"]
    del out
    losses = np.stack(report.per_job_losses)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             FusedBatcher(specs, cfg.vocab_size, block_t=TRAIN_BLOCK_T,
                          seed=1).next_batch().items()}
    g_cuda = adapter_grads(cfg, params, specs, "cuda", trained, batch)
    g_loop = adapter_grads(cfg, params, specs, "loop", trained, batch)
    rel = [((a.float() - b.float()).norm() / b.float().norm()).item()
           for a, b in zip(g_cuda, g_loop)]
    grad_check = {"leaves": len(rel), "max_rel_fro_err": max(rel),
                  "mean_rel_fro_err": float(np.mean(rel)),
                  "rtol": GRAD_RTOL}
    del g_cuda, g_loop
    emit({"phase": "wide", "model": cfg.name, "layers": cfg.num_layers,
          "layers_cut_from": get_config(WIDE_ARCH).num_layers,
          "d_model": cfg.d_model, "heads": cfg.num_heads,
          "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
          "vocab": cfg.vocab_size,
          "jobs": [{"id": sp.job_id, "rank": sp.rank} for sp in specs],
          "batch_size": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
          "batch_cut": "none: the train phase's 4 x 512 per job fit",
          "steps": WIDE_STEPS, "init_seconds": init_s,
          "per_step_per_job_loss": losses.tolist(),
          "step_times_s": report.step_times, "wall_s": wall,
          "peak_device_memory_bytes": peak, "launches": launches,
          "launches_per_step": per_step,
          "grad_check_cuda_vs_loop": grad_check, "card": card_line()})
    if losses.shape != (WIDE_STEPS, len(specs)) or \
            not np.isfinite(losses).all():
        raise AssertionError(f"wide: per-job losses not finite: {losses}")
    if not grad_check["max_rel_fro_err"] <= GRAD_RTOL:
        raise AssertionError(f"wide: cuda vs loop adapter gradients: "
                             f"{grad_check}")
    del params, adapters, trained
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------ recurrent
# The recurrent families at full width: mamba2-2.7b (SSD, all 64 layers)
# and recurrentgemma-9b (RG-LRU + local attention, cut from 38 layers to
# 6: two whole cycles of its pattern, so that a local-attention layer is
# not the last one), the train cell's group and batches through
# ``train_group``, then the serve steps; and mamba2-2.7b cut to 2 layers,
# where the checks' own bars resolve what its 64 layers cannot (below).
# (arch, layers (None: all), train_group, the launcher's ``train --arch``)
REC_RUNS = (("mamba2-2.7b", None, True, True), ("mamba2-2.7b", 2, False,
                                                 False),
            ("recurrentgemma-9b", 6, True, False))
REC_LAUNCH_STEPS = 2
REC_ARCHS = ("mamba2-2.7b", "recurrentgemma-9b")
REC_STEPS, REC_CHUNK = 4, 2
REC_PROMPT, REC_DECODE = 16, 8
# What a check can resolve at depth.  Nudging every adapter entry by a
# relative 2^-9 (one bf16 rounding of the LoRA path: what the kernels
# round where the "loop" impl does not) moves a bf16 model's outputs
# more the deeper it is: on an H100, mamba2-2.7b's adapter gradients by
# 0.009 at 1 layer, 0.017 at 2, 0.06 at 8, 0.20 at 32 and 0.36 at 64,
# its logits by up to 0.05, 0.09, 0.32, 0.72 and 1.88 (``--floors``,
# PERF.md).
# So each check below is measured against the same quantity with the
# adapters nudged (its floor, in the same run) and asserted within the
# larger of its own bar and twice that floor; at 2 layers the own bar
# is the larger.
REC_NUDGE = 2.0 ** -9


def pattern_launches(cfg, masked: bool = False) -> dict:
    """Launches per training step, from the layer pattern: every LoRA
    target of every layer is one projection; remat runs a scanned
    segment's forward twice (an unrolled segment, as deepseek's dense
    head layer, once).  The ragged route (mixed ranks): B1 a forward,
    B2, B3 and B4 once and B5 twice (dA, dB) a backward; the masked
    route (uniform widths): B6 a forward, B7 three times and B8 twice a
    backward.  B9 once a forward for every globally attending layer
    ("attn", "mla"); windowed local layers never reach it (B9 has no
    window, as the TPU kernel has none)."""
    from repro_torch.models import model as M
    fwd = bwd = flash = 0
    for seg in M.segment_plan(cfg):
        passes = 2 if seg.scanned else 1
        n = seg.repeats * sum(len(s.lora_targets) for s in seg.specs)
        fwd += n * passes
        bwd += n
        flash += seg.repeats * passes * sum(s.mixer in ("attn", "mla")
                                            for s in seg.specs)
    zero = dict({w.__name__: 0 for w in lora_wrappers()},
                flash_attention_fwd=flash)
    if masked:
        return dict(zero, fused_lora_cuda=fwd, grouped_matmul_cuda=3 * bwd,
                    grouped_wgrad_cuda=2 * bwd)
    return dict(zero, ragged_lora_fwd=fwd, ragged_lora_dgrad=bwd,
                ragged_xa=bwd, ragged_dxa=bwd, ragged_wgrad=2 * bwd)


def nudged(adapters, dev, seed=5):
    """*adapters* with every entry scaled by 1 + REC_NUDGE * N(0, 1)."""
    import torch
    from repro_torch.optim.adamw import tree_map
    g = torch.Generator(device=dev).manual_seed(seed)
    return tree_map(lambda _, t: t * (1 + REC_NUDGE * torch.randn(
        t.shape, generator=g, device=dev)), adapters)


def against_floor(value, floor, bar) -> dict:
    limit = max(bar, 2 * floor)
    return {"value": value, "floor": floor, "bar": bar, "limit": limit,
            "ok": bool(value <= limit)}


def model_checks(cfg, params, specs, layout, adapters, dev,
                 rings=(False,)) -> dict:
    """One step's adapter gradients, "cuda" against "loop" (GRAD_RTOL);
    job 0's fused against its solo loss (LOSS_ATOL; the per-job cross
    entropy, the MoE aux beside it); and, for a decoder, the serve steps
    (``serve_steps_check``, once for each of *rings*); each against its
    floor (``against_floor``).  The batch carries the front-end stub
    inputs of an audio or VLM config (``frontend_inputs``)."""
    import numpy as np
    import torch
    from repro_torch.data.pipeline import FusedBatcher, frontend_inputs
    batch = frontend_inputs(cfg, FusedBatcher(
        specs, cfg.vocab_size, block_t=TRAIN_BLOCK_T, seed=1).next_batch(),
        np.random.default_rng(1))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    nudge = nudged(adapters, dev)

    def rel(a, b):
        return [((x.float() - y.float()).norm() / y.float().norm()).item()
                for x, y in zip(a, b)]

    g_loop = adapter_grads(cfg, params, specs, "loop", adapters, batch)
    err = rel(adapter_grads(cfg, params, specs, "cuda", adapters, batch),
              g_loop)
    floor = rel(adapter_grads(cfg, params, specs, "loop", nudge, batch),
                g_loop)
    del g_loop
    grads = dict(against_floor(max(err), max(floor), GRAD_RTOL),
                 leaves=len(err), mean_rel_fro_err=float(np.mean(err)))
    solo = fused_vs_solo_loss(cfg, params, specs, layout, adapters, batch)
    moved = fused_vs_solo_loss(cfg, params, specs, layout, nudge, batch)
    solo.update(against_floor(solo["abs_diff"],
                              abs(moved["fused_loss"] - solo["fused_loss"]),
                              LOSS_ATOL))
    del batch

    out = {"grads_cuda_vs_loop": grads, "fused_vs_solo_loss": solo}
    if cfg.supports_decode():
        for ring in rings:
            out["serve_steps_ring" if ring else "serve_steps"] = \
                serve_steps_check(cfg, params, dev, ring=ring)
    else:
        out["encoder_prefill"] = encoder_prefill_check(cfg, params, dev)
    return out


# an encoder's cached prefill: two adapters, ENC_ROWS requests each of
# ENC_FRAMES frames
ENC_RANKS, ENC_ROWS, ENC_FRAMES = (8, 64), 2, 512


def encoder_prefill_check(cfg, params, dev) -> dict:
    """An encoder's cached prefill (``make_prefill_step`` on hubert-
    xlarge): two adapters of ranks ENC_RANKS (the ragged route), ENC_ROWS
    requests each of ENC_FRAMES frames drawn from a seed; the last
    position's logits against the cacheless forward's (LOGIT_ATOL), the
    caches finite with every layer's keys written; each request
    prefilled alone, its adapter re-packed as a one-job group's, equal to
    its row of the fused prefill bit for bit (the dense products on one
    request's frames at a time); B1 once a LoRA projection and B9 once a
    layer in the fused prefill."""
    import dataclasses
    import torch
    from repro_torch.configs.base import InputShape
    from repro_torch.core.jobs import LoRAJobSpec
    from repro_torch.core.ssm import SharedSuperModel
    from repro_torch.models import model as M
    specs = [LoRAJobSpec(f"enc{i}-r{r}", rank=r, batch_size=ENC_ROWS,
                         seq_len=ENC_FRAMES) for i, r in enumerate(ENC_RANKS)]
    ssm = SharedSuperModel(cfg, specs, impl="cuda", block_t=BLOCK_T)
    ad = train_adapters(cfg, ENC_RANKS, ssm.layout, dev)
    B = ENC_ROWS * len(specs)
    g = torch.Generator(device=dev).manual_seed(13)
    frames = (torch.randn((B, ENC_FRAMES, cfg.frontend_dim), generator=g,
                          device=dev) * 0.02).to(torch.bfloat16)
    ids = torch.arange(len(specs), device=dev,
                       dtype=torch.int32).repeat_interleave(ENC_ROWS)
    shape = InputShape("encoder", ENC_FRAMES, B, "prefill")
    prefill = ssm.make_prefill_step(shape)
    batch = {"frames": frames, "adapter_ids": ids}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (logits, caches), launches = counted(
        lambda: prefill(params, ad, batch, row_block=ENC_FRAMES))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    logits = logits[:, 0].float()
    with torch.no_grad():
        plain = M.forward(cfg, params, ad, ssm.lora_ctx(ids),
                          {"frames": frames})[0][:, -1].float()
    diff = (logits - plain).abs().max().item()
    kv = [c for seg in caches for c in seg.values()]
    written = all(bool(t[..., :ENC_FRAMES, :, :].abs().amax(
        dim=(-1, -2, -3)).gt(0).all()) for c in kv for t in c)
    finite = bool(torch.isfinite(logits).all()) and all(
        bool(torch.isfinite(t).all()) for c in kv for t in c)
    del caches, kv
    solo_diff = 0.0
    for k, r in enumerate(ENC_RANKS):
        one = SharedSuperModel(cfg, [LoRAJobSpec(
            f"enc-solo-r{r}", rank=r, batch_size=1, seq_len=ENC_FRAMES)],
            impl="cuda", block_t=BLOCK_T)
        step = one.make_prefill_step(dataclasses.replace(shape,
                                                         global_batch=1))
        sad = tps_solo_adapters(ad, ssm.layout, k)
        for i in range(k * ENC_ROWS, (k + 1) * ENC_ROWS):
            lg, _ = step(params, sad, {
                "frames": frames[i:i + 1],
                "adapter_ids": torch.zeros(1, dtype=torch.int32,
                                           device=dev)},
                row_block=ENC_FRAMES)
            solo_diff = max(solo_diff, (lg[0, 0].float()
                                        - logits[i]).abs().max().item())
    n_proj = sum(len(s.lora_targets) for s in M.layer_specs(cfg))
    want = dict({w.__name__: 0 for w in lora_wrappers()},
                ragged_lora_fwd=n_proj,
                flash_attention_fwd=sum(s.mixer in ("attn", "mla")
                                        for s in M.layer_specs(cfg)))
    return {"ranks": list(ENC_RANKS), "requests": B, "frames": ENC_FRAMES,
            "logits_max_abs_diff_vs_cacheless": diff,
            "logit_atol": LOGIT_ATOL,
            "fused_vs_solo_max_abs_diff": solo_diff,
            "caches_written": written, "finite": finite, "wall_s": wall,
            "launches": launches, "launches_expected": want,
            "ok": bool(diff <= LOGIT_ATOL and solo_diff == 0.0 and written
                       and finite)}


def serve_steps_check(cfg, params, dev, ring: bool = False) -> dict:
    """The serve steps on ranks {8, 16, 32, 64}, STEPS_ROWS rows a job:
    prefill REC_PROMPT tokens into the caches (KV, MLA latent, SSD and
    RG-LRU state, the local layers' rings; with *ring* every attention
    cache a ring), decode REC_DECODE, against the teacher-forced forward
    (LOGIT_ATOL, against its floor: ``against_floor``), with B1 launched
    once a projection a pass and B9 once a globally attending layer in
    the prefill."""
    import torch
    from repro_torch.configs.base import InputShape
    from repro_torch.core.jobs import LoRAJobSpec
    from repro_torch.core.ssm import SharedSuperModel
    from repro_torch.models import model as M
    sspecs = [LoRAJobSpec(f"steps{i}-r{r}", rank=r, batch_size=STEPS_ROWS,
                          seq_len=BLOCK_T) for i, r in enumerate(MIXED)]
    ssm = SharedSuperModel(cfg, sspecs, impl="cuda", block_t=BLOCK_T)
    sad = train_adapters(cfg, MIXED, ssm.layout, dev)
    B = STEPS_ROWS * len(sspecs)
    g = torch.Generator(device=dev).manual_seed(11)
    toks = torch.randint(1, cfg.vocab_size, (B, REC_PROMPT + REC_DECODE),
                         generator=g, device=dev, dtype=torch.int32)
    ids = torch.arange(len(sspecs), device=dev,
                       dtype=torch.int32).repeat_interleave(STEPS_ROWS)
    shape = InputShape("recurrent", REC_PROMPT + REC_DECODE, B, "decode")
    prefill = ssm.make_prefill_step(shape, ring=ring)
    step = ssm.make_serve_step(ring=ring)

    def serve():
        lp, caches = prefill(params, sad, {"tokens": toks[:, :REC_PROMPT],
                                           "adapter_ids": ids})
        outs = [lp[:, 0].float()]
        for pos in range(REC_PROMPT, REC_PROMPT + REC_DECODE):
            ld, _ = step(params, sad, caches, {
                "tokens": toks[:, pos:pos + 1], "adapter_ids": ids}, pos)
            outs.append(ld[:, 0].float())
        return torch.stack(outs, dim=1)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, launches = counted(serve)
    serve_s = time.perf_counter() - t0
    with torch.no_grad():
        ctx = ssm.lora_ctx(ids)
        tf = M.forward(cfg, params, sad, ctx,
                       {"tokens": toks})[0][:, REC_PROMPT - 1:].float()
        d_pos = (got - tf).abs().amax(dim=(0, 2))
        moved = (M.forward(cfg, params, nudged(sad, dev), ctx,
                           {"tokens": toks})[0][:, REC_PROMPT - 1:].float()
                 - tf).abs()
        finite = bool(torch.isfinite(got).all())
        serve_chk = dict(
            against_floor(d_pos.max().item(), moved.amax().item(),
                          LOGIT_ATOL),
            max_abs_diff_vs_forward_by_pos=d_pos.tolist(),
            mean_abs_diff_vs_forward=(got - tf).abs().mean().item(),
            floor_mean=moved.mean().item(), finite=finite)
    del tf, got, moved, sad
    n_proj = sum(len(s.lora_targets) for s in M.layer_specs(cfg))
    want = dict({w.__name__: 0 for w in lora_wrappers()},
                ragged_lora_fwd=n_proj * (1 + REC_DECODE),
                flash_attention_fwd=sum(s.mixer in ("attn", "mla")
                                        for s in M.layer_specs(cfg)))
    serve_chk.update(ring=ring, rows=B, ranks=list(MIXED), prompt=REC_PROMPT,
                     decode=REC_DECODE, wall_s=serve_s, launches=launches,
                     launches_expected=want)
    return serve_chk


def mixer_costs(cfg, params, dev, iters: int = 5) -> dict:
    """What the recurrent mixers cost a training step: device time per
    call (``device_ms``) of one layer's scan alone (``ssd_scan`` over
    chunks of ``cfg.ssm_chunk``, or ``_lru_scan``) and of its whole block
    without LoRA (``ssd_block``, ``rglru_block``), forward and forward +
    backward, at the train shape (TRAIN_BATCH x 4 sequences of TRAIN_SEQ
    tokens), on layer 0's weights; and the step's share of each,
    layers x (2 forwards (remat) + 1 forward-and-backward) against the
    steady step (the caller's)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models import rglru as G
    from repro_torch.models import ssd as S
    Bsz = TRAIN_BATCH * len(TRAIN_RANKS)
    g = torch.Generator(device=dev).manual_seed(3)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=dev)
    bf = torch.bfloat16
    kinds = [s.mixer for s in M.layer_specs(cfg)]
    seg = params["segments"][0]
    out = {}
    x = (rnd(Bsz, TRAIN_SEQ, cfg.d_model)).to(bf)
    for j, spec in enumerate(M.segment_plan(cfg)[0].specs):
        if spec.mixer not in ("ssd", "rglru") or spec.mixer in out:
            continue
        p = M._tree_map(lambda v: v[0], seg[str(j)])
        if spec.mixer == "ssd":
            H, P, N = cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state
            ins = [rnd(Bsz, TRAIN_SEQ, H, P).to(bf),
                   torch.nn.functional.softplus(rnd(Bsz, TRAIN_SEQ, H)),
                   -torch.ones(H, device=dev),
                   rnd(Bsz, TRAIN_SEQ, H, N).to(bf),
                   rnd(Bsz, TRAIN_SEQ, H, N).to(bf)]
            scan = lambda *a: S.ssd_scan(*a, cfg.ssm_chunk)[0]
            block = lambda xx: S.ssd_block(cfg, p["ssd"], xx)[0]
        else:
            W = cfg.lru_width
            ins = [torch.rand(Bsz, TRAIN_SEQ, W, generator=g, device=dev),
                   rnd(Bsz, TRAIN_SEQ, W)]
            scan = G._lru_scan
            block = lambda xx: G.rglru_block(cfg, p["rg"], xx)[0]

        def fwd_bwd(fn, args):
            args = [a.detach().requires_grad_(a.is_floating_point())
                    for a in args]
            y = fn(*args)
            torch.autograd.grad(y.float().sum(), [a for a in args
                                                  if a.requires_grad])

        with torch.no_grad():
            f_scan = device_ms(lambda: scan(*ins), iters)
            f_block = device_ms(lambda: block(x), iters)
        n = kinds.count(spec.mixer)
        fb_scan = device_ms(lambda: fwd_bwd(scan, ins), iters)
        fb_block = device_ms(lambda: fwd_bwd(block, [x]), iters)
        out[spec.mixer] = {
            "layers": n, "scan_fwd_ms": f_scan, "scan_fwd_bwd_ms": fb_scan,
            "block_fwd_ms": f_block, "block_fwd_bwd_ms": fb_block,
            "scan_ms_a_step": n * (f_scan + fb_scan),
            "block_ms_a_step": n * (f_block + fb_block)}
    return out


# (arch, layers) of the depth sweep (``--floors``)
FLOOR_SWEEP = tuple(("mamba2-2.7b", n) for n in (1, 2, 4, 8, 16, 32, 64)) \
    + (("recurrentgemma-9b", 3), ("recurrentgemma-9b", 6),
       ("tinyllama-1.1b", 22))


def floors_sweep(dev) -> None:
    """How far a REC_NUDGE of every adapter entry moves a bf16 model, by
    depth, at full width, one line each: the teacher-forced logits (max
    and mean |change|), the "loop" impl's adapter gradients (relative
    Frobenius change, the largest leaf), and beside it "cuda" and "torch"
    against "loop" and "cuda" against "torch", with the cuda-vs-loop
    error's smallest and largest layer; the train group and batch of
    ``model_checks``, fresh adapters."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.ssm import SharedSuperModel
    from repro_torch.data.pipeline import FusedBatcher
    from repro_torch.models import model as M

    def rel(a, b):
        return max(((x.float() - y.float()).norm()
                    / y.float().norm()).item() for x, y in zip(a, b))

    def by_layer(a, b):
        errs = [((x.float() - y.float()).flatten(1).norm(dim=1)
                 / y.float().flatten(1).norm(dim=1))
                for x, y in zip(a, b) if x.ndim == 3 and x.shape[0] > 1]
        if not errs:
            return None
        e = torch.stack(errs)
        return [e.min().item(), e.max().item()]

    for arch, layers in FLOOR_SWEEP:
        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        params = M.init_model(cfg, seed=0, device=dev)
        specs = train_specs(TRAIN_RANKS, prefix="floor")
        ssm = SharedSuperModel(cfg, specs, impl="cuda",
                               block_t=TRAIN_BLOCK_T)
        adapters = train_adapters(cfg, TRAIN_RANKS, ssm.layout, dev)
        nudge = nudged(adapters, dev)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in
                 FusedBatcher(specs, cfg.vocab_size, block_t=TRAIN_BLOCK_T,
                              seed=1).next_batch().items()}
        with torch.no_grad():
            ctx = ssm.lora_ctx(batch["adapter_ids"])
            tok = {"tokens": batch["tokens"]}
            moved = (M.forward(cfg, params, nudge, ctx, tok)[0].float()
                     - M.forward(cfg, params, adapters, ctx, tok)[0].float()
                     ).abs()
            logits = {"max": moved.max().item(), "mean": moved.mean().item()}
            del moved
        g = {impl: adapter_grads(cfg, params, specs, impl, adapters, batch)
             for impl in ("loop", "cuda", "torch")}
        g_n = adapter_grads(cfg, params, specs, "loop", nudge, batch)
        emit({"floors": {"model": cfg.name, "layers": layers,
                         "logits_moved_by_nudge": logits,
                         "grads_moved_by_nudge": rel(g_n, g["loop"]),
                         "cuda_vs_loop": rel(g["cuda"], g["loop"]),
                         "torch_vs_loop": rel(g["torch"], g["loop"]),
                         "cuda_vs_torch": rel(g["cuda"], g["torch"]),
                         "cuda_vs_loop_layer_range": by_layer(g["cuda"],
                                                              g["loop"])},
              "card": card_line()})
        del params, adapters, nudge, g, g_n
        torch.cuda.empty_cache()


def recurrent_phase(dev):
    """Each of REC_RUNS at full width: ``train_group`` over the train
    cell's ranks {8, 16, 32, 64} and batches (4 x 512 tokens a job,
    block_t 128, remat) for REC_STEPS steps in chunks of REC_CHUNK, exact
    launches a step (``pattern_launches``), finite per-job losses,
    steady step, tokens/s, peak memory, one profiled step and what its
    recurrent mixers cost of it (``mixer_costs``); the H100 spec's price
    of the same step (``core/throughput.group_step_cost``, reported
    only); then ``model_checks`` on the trained adapters (on fresh
    ones where the run does not train); for mamba2-2.7b, the launcher's
    ``train --arch mamba2-2.7b --no-aimd`` at its defaults (ranks {16, 8,
    4, 2}, which all pad to 16: the masked kernels B6-B8) for
    REC_LAUNCH_STEPS steps, exact launches a step, finite losses."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import throughput as tp
    from repro_torch.core.ssm import SharedSuperModel
    from repro_torch.data.pipeline import FusedBatcher
    from repro_torch.models import model as M
    from repro_torch.train.train_loop import train_group
    total = {w.__name__: 0 for w in lora_wrappers()}
    from repro_torch.launch import train as launcher
    for arch, layers, train, launch in REC_RUNS:
        full = get_config(arch)
        cfg = dataclasses.replace(full, num_layers=layers or full.num_layers)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = M.init_model(cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        specs = train_specs(TRAIN_RANKS, prefix=arch.split("-")[0])
        layout = SharedSuperModel(cfg, specs, block_t=TRAIN_BLOCK_T).layout
        adapters = train_adapters(cfg, TRAIN_RANKS, layout, dev)
        line = {"phase": "recurrent", "model": cfg.name,
                "family": cfg.family, "layers": cfg.num_layers,
                "layers_cut_from": full.num_layers, "d_model": cfg.d_model,
                "vocab": cfg.vocab_size,
                "pattern": [s.mixer for s in M.layer_specs(cfg)[:3]],
                "init_seconds": init_s,
                "jobs": [{"id": sp.job_id, "rank": sp.rank, "r_pad": rp}
                         for sp, rp in zip(specs, layout.r_pads)]}
        launches = {k: 0 for k in total}
        if train:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out, launches = counted(lambda: train_group(
                cfg, specs, steps=REC_STEPS, lr=TRAIN_LR, seed=0,
                impl="cuda", block_t=TRAIN_BLOCK_T, chunk_size=REC_CHUNK,
                remat=True, adaptive_nano=False, params=params,
                adapters=adapters, device=dev))
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            expect = pattern_launches(cfg)
            per_step = check_launches(arch, launches, REC_STEPS, expect)
            rep, adapters = out["report"], out["adapters"]
            losses = np.stack(rep.per_job_losses)
            steady = float(np.mean(rep.step_times[REC_CHUNK:]))
            replay = FusedBatcher(specs, cfg.vocab_size,
                                  block_t=TRAIN_BLOCK_T, seed=0)
            masks = [replay.next_batch()["loss_mask"]
                     for _ in range(REC_STEPS)]
            real = sum(int(m.sum()) for m in masks) / REC_STEPS
            price = tp.group_step_cost(cfg, specs, 1, hw=tp.H100,
                                       nano_batches=1).total
            line.update(
                batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                block_t=TRAIN_BLOCK_T, steps=REC_STEPS,
                chunk_size=REC_CHUNK, remat=True,
                per_step_per_job_loss=losses.tolist(),
                step_times_s=rep.step_times, wall_s=wall,
                step_s_steady=steady, h100_spec_step_s=price,
                measured_over_h100_spec=steady / price,
                tokens_per_s_real_steady=real / steady,
                tokens_per_s_padded_steady=masks[0].size / steady,
                peak_device_memory_bytes=peak, launches=launches,
                launches_per_step=per_step,
                profile_one_step=profile_run(
                    functools.partial(out["runtime"].run, 1)))
            del out
            costs = mixer_costs(cfg, params, dev)
            for c in costs.values():
                c["scan_share_of_step"] = c["scan_ms_a_step"] / 1e3 / steady
                c["block_share_of_step"] = (c["block_ms_a_step"] / 1e3
                                            / steady)
            line["mixer_costs"] = costs
            if losses.shape != (REC_STEPS, len(specs)) or \
                    not np.isfinite(losses).all():
                raise AssertionError(f"recurrent {cfg.name}: per-job "
                                     f"losses not finite: {losses}")
        checks = model_checks(cfg, params, specs, layout, adapters, dev)
        line.update(checks, card=card_line())
        if launch:
            del params, adapters
            torch.cuda.empty_cache()
            argv = ["train", "--arch", arch, "--steps", str(REC_LAUNCH_STEPS),
                    "--chunk-size", str(REC_LAUNCH_STEPS), "--no-aimd"]
            lout, l_launches = counted(lambda: launcher.main(argv))
            l_losses = np.stack(lout["report"].per_job_losses)
            l_expect = pattern_launches(cfg, masked=True)
            line["launcher_train"] = {
                "argv": argv, "ranks": [j.rank for j in lout["ssm"].jobs],
                "r_pads": list(lout["ssm"].layout.r_pads),
                "per_step_per_job_loss": l_losses.tolist(),
                "step_times_s": lout["report"].step_times,
                "launches_per_step": check_launches(
                    f"recurrent {arch} launcher", l_launches,
                    REC_LAUNCH_STEPS, l_expect)}
            params = adapters = lout = None
            if not np.isfinite(l_losses).all():
                raise AssertionError(f"recurrent {arch} launcher: losses "
                                     f"{l_losses}")
            for k in total:
                total[k] += l_launches[k]
        emit(line)
        serve = checks["serve_steps"]
        failed = [k for k, v in checks.items() if not v["ok"]]
        if failed:
            raise AssertionError(f"recurrent {cfg.name}: {failed}: "
                                 f"{checks}")
        if serve["launches"] != serve["launches_expected"] or \
                not serve["finite"]:
            raise AssertionError(f"recurrent {cfg.name} serve steps: "
                                 f"{serve}")
        for k in total:
            total[k] += launches[k] + serve["launches"][k]
        del params, adapters
        torch.cuda.empty_cache()
    return total


# ------------------------------------------------------------ families
# (arch, layers or None for the full depth): deepseek-v2-lite-16b at its
# full 27 layers (31.4 GB of bf16 weights, 28.8 of them expert slabs);
# qwen3-moe-30b-a3b cut 48 -> 8 (the full 61 GB and the f32 logits of
# its 151936 vocab leave no room to train on 80 GB); hubert-xlarge at its
# full 48; internvl2-26b cut 48 -> 4 (d_model 6144: 4 layers keep the
# phase short)
FAM_RUNS = (("deepseek-v2-lite-16b", None), ("qwen3-moe-30b-a3b", 8),
            ("hubert-xlarge", None), ("internvl2-26b", 4))
FAM_ARCHS = tuple(a for a, _ in FAM_RUNS)
FAM_ENGINE = "deepseek-v2-lite-16b"    # ServeEngine and the launcher
FAM_STEPS, FAM_CHUNK, FAM_LAUNCH_STEPS = 4, 2, 2


def family_engine(cfg, params, dev) -> dict:
    """``ServeEngine.serve`` on *cfg* with 4 adapters of ranks {8, 16, 32,
    64} and the serve cell's 16 prompts: launches and tokens/s; fused
    against solo prefill logits (asserted within LOGIT_ATOL); two
    requests per adapter decoded whole, fused against solo (asserted:
    the MoE expert products group a row with whatever rows routed to
    its experts, and ``expert_mm_probe`` holds them row invariant), and
    where they part, the first differing decode step and op
    (``c1_probe``)."""
    import torch
    from repro_torch.serve import AdapterPool, ServeEngine, ServeRequest
    names = [f"fam{i}-r{r}" for i, r in enumerate(TRAIN_RANKS)]
    pool = AdapterPool(cfg, capacity=8, multiple=MULTIPLE, device=dev)
    publish(pool, cfg, names, TRAIN_RANKS, seed=300, dev=dev)
    engine = ServeEngine(cfg, params, pool, impl="cuda", block_t=BLOCK_T)
    reqs = make_requests(0, names, cfg.vocab_size)
    engine.serve([ServeRequest(reqs[0].prompt[:16], names[0],
                               max_new_tokens=2)])       # warm-up
    t0 = time.perf_counter()
    res, launches = counted(lambda: engine.serve(reqs))
    secs = time.perf_counter() - t0
    n_tok = sum(len(r.tokens) for r in res)
    fused_lg = engine.next_token_logits(reqs, 0).float()
    solo_lg = torch.cat([engine.next_token_logits([r], 0)
                         for r in reqs]).float()
    by_req = (fused_lg - solo_lg).abs().amax(dim=-1)
    prefill_diff = by_req.max().item()
    pairs = list(zip(reqs, res))[:2 * len(names)]
    same = [f.tokens.tolist() == engine.serve([r])[0].tokens.tolist()
            for r, f in pairs]
    out = {"adapters": names, "requests": len(reqs),
           "rows": sum(geometry(reqs)[0]), "prompt_width": geometry(reqs)[1],
           "generated_tokens": n_tok, "seconds": secs,
           "tokens_per_s": n_tok / secs, "launches": launches,
           "prefill_logits_max_abs_diff_fused_vs_solo": prefill_diff,
           "prefill_logits_diff_by_request": by_req.tolist(),
           "prefill_argmax_flips": int((fused_lg.argmax(-1)
                                        != solo_lg.argmax(-1)).sum()),
           "logit_atol": LOGIT_ATOL,
           "token_ids_identical_share": sum(same) / len(same),
           "token_ids_compared": len(same),
           "finite": bool(torch.isfinite(fused_lg).all())}
    if prefill_diff > 0:
        out["c1_probe_prefill"] = c1_probe(
            engine, reqs, request=int(by_req.argmax()), prefill=True)
    if not all(same):
        i = same.index(False)
        out["c1_probe_first_differing_request"] = c1_probe(
            engine, reqs, request=i, steps=reqs[i].max_new_tokens - 1)
    # the expert products are row invariant (expert_mm_probe, asserted
    # beside this line), so fused and solo decode the same ids
    out["ok"] = bool(prefill_diff <= LOGIT_ATOL and out["finite"]
                     and all(same)
                     and all(launches[n] for n in ("ragged_lora_fwd",
                                                   "flash_attention_fwd")))
    del engine, pool
    return out



# C9's probe: each expert's first rows alone against the same rows inside
# larger groups (rows per expert: small vs big), the two serving products
# and the backward's transposed one, at the engine model's widths
EXPERT_PROBE_ROWS = ((1, 16), (1, 256), (3, 256), (16, 256))


def expert_mm_probe(cfg, dev, seed=11) -> dict:
    """Whether ``models/moe._ExpertMM``'s products (``torch._grouped_mm``
    on bf16) are row invariant on the card, as ``c1_probe`` asks of the
    dense products: for each (small, big) of EXPERT_PROBE_ROWS, every
    expert's first *small* rows are multiplied alone (every expert's
    segment *small* rows) and inside segments of *big* rows, and the
    same rows compared bit for bit; also one expert alone with every
    other segment empty.  Products: x·w_in (d -> 2 f), h·w_out (f -> d)
    and dy·w_inᵀ (the backward's, through the transposed view)."""
    import torch
    E, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    g = torch.Generator(device=dev).manual_seed(seed)
    w_in = (torch.randn((E, d, 2 * f), generator=g, device=dev)
            / d ** 0.5).to(torch.bfloat16)
    w_out = (torch.randn((E, f, d), generator=g, device=dev)
             / f ** 0.5).to(torch.bfloat16)
    prods = {"x.w_in": (w_in, d), "h.w_out": (w_out, f),
             "dy.w_in^T": (w_in.transpose(-1, -2), 2 * f)}

    def offs(rows):
        return torch.cumsum(torch.as_tensor(rows, device=dev), 0).to(
            torch.int32)
    cases = []
    for name, (w, k) in prods.items():
        for small, big in EXPERT_PROBE_ROWS:
            xb = torch.randn((E * big, k), generator=g,
                             device=dev).to(torch.bfloat16)
            yb = torch._grouped_mm(xb, w, offs=offs([big] * E))
            pick = torch.cat([torch.arange(e * big, e * big + small,
                                           device=dev) for e in range(E)])
            ys = torch._grouped_mm(xb[pick].contiguous(), w,
                                   offs=offs([small] * E))
            diff = (ys.float() - yb[pick].float()).abs()
            rows = diff.amax(-1) > 0
            # one expert alone: the others' segments empty
            e = E // 2
            alone = torch._grouped_mm(
                xb[e * big:e * big + small].contiguous(), w,
                offs=offs([0] * e + [small] + [0] * (E - e - 1)))
            d_alone = (alone.float() - yb[e * big:e * big + small].float()
                       ).abs().max().item()
            cases.append({"product": name, "rows_small": small,
                          "rows_big": big, "rows_compared": int(pick.numel()),
                          "rows_differing": int(rows.sum().item()),
                          "max_abs_diff": diff.max().item(),
                          "one_expert_alone_max_abs_diff": d_alone})
    torch.cuda.synchronize()
    return {"model": cfg.name, "experts": E, "d_model": d, "moe_d_ff": f,
            "dtype": "bfloat16", "cases": cases,
            "row_invariant": all(c["rows_differing"] == 0
                                 and c["one_expert_alone_max_abs_diff"] == 0
                                 for c in cases)}


def families_phase(dev):
    """Each of FAM_RUNS at full width: ``train_group`` over the train
    cell's ranks {8, 16, 32, 64} and batches (4 x 512 tokens a job,
    block_t 128, remat; hubert's audio frames and internvl2's 256 patches
    drawn from the seed, ``data.pipeline.frontend_inputs``) for FAM_STEPS
    steps in chunks of FAM_CHUNK: exact launches a step
    (``pattern_launches``: B9 at (192, 128) for deepseek's MLA, 128 for
    qwen3-moe and internvl2, 80 non-causal for hubert), finite per-job
    losses, the MoE aux, steady step, tokens/s, peak memory, one
    profiled step, the H100 spec's price; then ``model_checks`` on the
    trained adapters (gradients against "loop"; fused against solo
    cross entropy; the decoders' serve steps, deepseek's through the MLA
    ring too; the encoder's cached prefill, ``encoder_prefill_check``);
    for FAM_ENGINE, ``family_engine`` and the launcher's
    ``train --arch ... --no-aimd`` at its defaults (ranks {16, 8, 4, 2}:
    the masked kernels B6-B8) for FAM_LAUNCH_STEPS steps, exact
    launches."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import throughput as tp
    from repro_torch.core.ssm import SharedSuperModel
    from repro_torch.data.pipeline import FusedBatcher
    from repro_torch.launch import train as launcher
    from repro_torch.models import model as M
    from repro_torch.train.train_loop import train_group
    total = {w.__name__: 0 for w in lora_wrappers()}
    failed = []                  # checks that failed, raised at the end
    for arch, layers in FAM_RUNS:
        t_run = time.perf_counter()
        full = get_config(arch)
        cfg = dataclasses.replace(full, num_layers=layers or full.num_layers)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = M.init_model(cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        specs = train_specs(TRAIN_RANKS, prefix=arch.split("-")[0])
        layout = SharedSuperModel(cfg, specs, block_t=TRAIN_BLOCK_T).layout
        adapters = train_adapters(cfg, TRAIN_RANKS, layout, dev)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out, launches = counted(lambda: train_group(
            cfg, specs, steps=FAM_STEPS, lr=TRAIN_LR, seed=0, impl="cuda",
            block_t=TRAIN_BLOCK_T, chunk_size=FAM_CHUNK, remat=True,
            adaptive_nano=False, params=params, adapters=adapters,
            device=dev))
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        per_step = check_launches(f"families {arch}", launches, FAM_STEPS,
                                  pattern_launches(cfg))
        rep, adapters = out["report"], out["adapters"]
        losses = np.stack(rep.per_job_losses)
        steady = float(np.mean(rep.step_times[FAM_CHUNK:]))
        replay = FusedBatcher(specs, cfg.vocab_size, block_t=TRAIN_BLOCK_T,
                              seed=0)
        masks = [replay.next_batch()["loss_mask"] for _ in range(FAM_STEPS)]
        real = sum(int(m.sum()) for m in masks) / FAM_STEPS
        # the rows the backbone runs: a VLM sequence is its patches and
        # its text
        seq = TRAIN_SEQ + (cfg.num_patches if cfg.family == "vlm" else 0)
        price = tp.group_step_cost(cfg, specs, 1, hw=tp.H100,
                                   nano_batches=1).total
        line = {"phase": "families", "model": cfg.name,
                "family": cfg.family, "layers": cfg.num_layers,
                "layers_cut_from": full.num_layers, "d_model": cfg.d_model,
                "vocab": cfg.vocab_size, "causal": cfg.causal,
                "segments": [[s.mixer + "/" + s.ffn for s in seg.specs]
                             + [seg.repeats] for seg in M.segment_plan(cfg)],
                "init_seconds": init_s,
                "jobs": [{"id": sp.job_id, "rank": sp.rank, "r_pad": rp}
                         for sp, rp in zip(specs, layout.r_pads)],
                "batch_size": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
                "rows_per_sequence": seq, "block_t": TRAIN_BLOCK_T,
                "steps": FAM_STEPS, "chunk_size": FAM_CHUNK, "remat": True,
                "per_step_per_job_loss": losses.tolist(),
                "moe_aux_last_chunk": rep.last_metrics["aux"].tolist(),
                "step_times_s": rep.step_times, "wall_s": wall,
                "step_s_steady": steady, "h100_spec_step_s": price,
                "measured_over_h100_spec": steady / price,
                "tokens_per_s_real_steady": real / steady,
                "tokens_per_s_padded_steady": masks[0].shape[0] * seq
                / steady,
                "peak_device_memory_bytes": peak, "launches": launches,
                "launches_per_step": per_step,
                "profile_one_step": profile_run(
                    functools.partial(out["runtime"].run, 1))}
        del out
        if losses.shape != (FAM_STEPS, len(specs)) or \
                not np.isfinite(losses).all():
            raise AssertionError(f"families {cfg.name}: per-job losses "
                                 f"not finite: {losses}")
        rings = (False, True) if cfg.use_mla else (False,)
        checks = model_checks(cfg, params, specs, layout, adapters, dev,
                              rings=rings)
        line.update(checks, card=card_line(),
                    run_seconds=time.perf_counter() - t_run)
        emit(line)
        failed += [f"{cfg.name}.{k}" for k, v in checks.items()
                   if not v["ok"]]
        for key in ("serve_steps", "serve_steps_ring", "encoder_prefill"):
            serve = checks.get(key)
            if serve is None:
                continue
            if serve["launches"] != serve["launches_expected"] or \
                    not serve["finite"]:
                failed.append(f"{cfg.name}.{key}.launches")
            for k in total:
                total[k] += serve["launches"][k]
        for k in total:
            total[k] += launches[k]
        if arch == FAM_ENGINE:
            del adapters
            probe = expert_mm_probe(cfg, dev)
            engine = family_engine(cfg, params, dev)
            emit({"phase": "families", "model": cfg.name,
                  "expert_mm_probe": probe, "engine": engine,
                  "card": card_line()})
            if not probe["row_invariant"]:
                failed.append(f"{cfg.name}.expert_mm_row_invariance")
            if not engine["ok"]:
                failed.append(f"{cfg.name}.engine")
            del params
            params = adapters = None
            torch.cuda.empty_cache()
            argv = ["train", "--arch", arch, "--steps", str(FAM_LAUNCH_STEPS),
                    "--chunk-size", str(FAM_LAUNCH_STEPS), "--no-aimd"]
            lout, l_launches = counted(lambda: launcher.main(argv))
            l_losses = np.stack(lout["report"].per_job_losses)
            emit({"phase": "families", "model": cfg.name,
                  "launcher_train": {
                      "argv": argv,
                      "ranks": [j.rank for j in lout["ssm"].jobs],
                      "r_pads": list(lout["ssm"].layout.r_pads),
                      "per_step_per_job_loss": l_losses.tolist(),
                      "step_times_s": lout["report"].step_times,
                      "launches_per_step": {k: n / FAM_LAUNCH_STEPS
                                            for k, n in l_launches.items()}},
                  "card": card_line()})
            lout = None
            check_launches(f"families {arch} launcher", l_launches,
                           FAM_LAUNCH_STEPS, pattern_launches(cfg, masked=True))
            if not np.isfinite(l_losses).all():
                raise AssertionError(f"families {arch} launcher: losses "
                                     f"{l_losses}")
            for k in total:
                total[k] += l_launches[k] + engine["launches"][k]
        params = adapters = None
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"families: checks failed: {failed}")
    return total


def tree_bytes(tree) -> int:
    """Resident bytes of a parameter tree (a QuantTensor: codes and
    scales)."""
    from repro_torch.models.quant import QuantTensor, leaves
    return sum(t.numel() * t.element_size()
               for leaf in leaves(tree)
               for t in ((leaf.q, leaf.scale) if isinstance(leaf, QuantTensor)
                         else (leaf,)))


def quant_phase(cfg, params, sets, bf16_losses, bf16_step, dev,
                measured=None):
    """The int8 backbone: quantize once; train the ``train`` group on the
    same batches (launches per step, losses against the bf16 run, the
    steady step against the bf16 run's ``bf16_step`` of this call, one
    step's gradients through the "cuda" and the "torch" dequant impls);
    serve the mixed adapter set with the same requests (launches per
    decode step, fused against solo, agreement with the bf16 engine)."""
    import numpy as np
    import torch
    from repro_torch.core.ssm import SharedSuperModel
    from repro_torch.data.pipeline import FusedBatcher
    from repro_torch.models import quant
    from repro_torch.serve import AdapterPool, ServeEngine
    from repro_torch.train.train_loop import train_group

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qparams = quant.quantize_params(params, "int8")
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    resident = {"bf16": tree_bytes(params), "int8": tree_bytes(qparams)}

    # ---- training: the train phase's group, adapters and batches
    specs = train_specs(TRAIN_RANKS)
    layout = SharedSuperModel(cfg, specs, block_t=TRAIN_BLOCK_T).layout
    adapters = train_adapters(cfg, TRAIN_RANKS, layout, dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, launches = counted(lambda: train_group(
        cfg, specs, steps=TRAIN_STEPS, lr=TRAIN_LR, seed=0, impl="cuda",
        block_t=TRAIN_BLOCK_T, chunk_size=TRAIN_CHUNK, remat=True,
        adaptive_nano=False, params=qparams, adapters=adapters,
        quantize="int8", device=dev))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    per_step = check_launches("quant", launches, TRAIN_STEPS, QUANT_LAUNCHES)
    rep = out["report"]
    losses = np.stack(rep.per_job_losses)
    if losses.shape != bf16_losses.shape or not np.isfinite(losses).all():
        raise AssertionError(f"quant: per-job losses {losses}")
    loss_rel = float(np.max(np.abs(losses - bf16_losses)
                            / np.abs(bf16_losses)))
    if not quant.is_quantized(out["params"]) or \
            quant.is_quantized(out["adapters"]):
        raise AssertionError("quant: the backbone must be int8 and the "
                             "adapters not")
    steady = float(np.mean(rep.step_times[TRAIN_CHUNK:]))
    if measured is not None:
        measured["quant"] = dict(ranks=TRAIN_RANKS, nano=1, dtype="int8",
                                 step_s=steady)
    padded = TRAIN_STEPS * len(specs) * TRAIN_BATCH * TRAIN_SEQ

    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             FusedBatcher(specs, cfg.vocab_size, block_t=TRAIN_BLOCK_T,
                          seed=1).next_batch().items()}
    grads = {}
    try:
        for impl in ("cuda", "torch"):
            quant.set_dequant_impl(impl)
            grads[impl] = adapter_grads(cfg, qparams, specs, "cuda",
                                        out["adapters"], batch)
    finally:
        quant.set_dequant_impl("cuda")
    rel = [((a.float() - b.float()).norm() / b.float().norm()).item()
           for a, b in zip(grads["cuda"], grads["torch"])]
    prof = profile_run(functools.partial(out["runtime"].run, 1))

    # ---- serving: the mixed set, the serve phase's adapters and requests
    set_name, names, ranks, reqs = sets[0]
    pool = AdapterPool(cfg, capacity=8, multiple=MULTIPLE, device=dev)
    publish(pool, cfg, names, ranks, seed=100, dev=dev)
    engine = ServeEngine(cfg, qparams, pool, impl="cuda", block_t=BLOCK_T,
                         quantize="int8")
    dense = ServeEngine(cfg, params, pool, impl="cuda", block_t=BLOCK_T)
    engine.serve(reqs[:1])               # warm-up: not timed, not counted
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, serve_launches = counted(lambda: engine.serve(reqs))
    secs = time.perf_counter() - t0
    serve_peak = torch.cuda.max_memory_allocated()
    max_new = max(r.max_new_tokens for r in reqs)   # prefill + decodes
    if serve_launches["dequant_matmul_cuda"] != QUANT_PROJ * max_new:
        raise AssertionError(
            f"quant: {serve_launches['dequant_matmul_cuda']} dequant "
            f"launches for a prefill and {max_new - 1} decode steps, "
            f"expected {QUANT_PROJ} each")
    n_tok = sum(len(r.tokens) for r in res)
    fused_lg = engine.next_token_logits(reqs, 0).float()
    solo_lg = torch.cat([engine.next_token_logits([r], 0)
                         for r in reqs]).float()
    if not bool(torch.isfinite(fused_lg).all()):
        raise AssertionError("quant: non-finite logits")
    logit_diff = (fused_lg - solo_lg).abs().max().item()
    # each request's first token is the argmax of its prefill logits:
    # held fused vs solo (whole sequences are held in the serve phase; no
    # solo serves here, they cost a minute on slow hosts)
    flips = int((fused_lg.argmax(-1) != solo_lg.argmax(-1)).sum())
    first = torch.tensor([r.tokens[0] for r in res], device=dev)
    if not bool((first == fused_lg.argmax(-1)).all()):
        raise AssertionError("quant: served first tokens are not the "
                             "argmax of the prefill logits")
    dense_lg = dense.next_token_logits(reqs, 0).float()
    dense_res = dense.serve(reqs)
    top1 = float((dense_lg.argmax(-1) == fused_lg.argmax(-1)
                  ).float().mean())
    tok_agree = float(np.mean([a == b for d, q_ in zip(dense_res, res)
                               for a, b in zip(d.tokens.tolist(),
                                               q_.tokens.tolist())]))
    serve_prof = profile_run(functools.partial(engine.serve, reqs))
    emit({"phase": "quant", "model": cfg.name, "layers": cfg.num_layers,
          "quantize_seconds": quant_s, "resident_backbone_bytes": resident,
          "train": {
              "jobs": [{"id": sp.job_id, "rank": sp.rank} for sp in specs],
              "steps": TRAIN_STEPS, "chunk_size": TRAIN_CHUNK,
              "per_step_per_job_loss": losses.tolist(),
              "max_rel_loss_diff_vs_bf16": loss_rel,
              "loss_rtol": QUANT_LOSS_RTOL,
              "step_times_s": rep.step_times, "wall_s": wall,
              "step_s_steady": steady,
              "step_ratio_int8_vs_bf16": steady / bf16_step,
              "tokens_per_s_padded_steady": padded / TRAIN_STEPS / steady,
              "peak_device_memory_bytes": peak, "launches": launches,
              "launches_per_step": per_step,
              "grad_check_cuda_vs_torch": {
                  "leaves": len(rel), "max_rel_fro_err": max(rel),
                  "mean_rel_fro_err": float(np.mean(rel)),
                  "rtol": GRAD_RTOL},
              "profile_one_step": prof},
          "serve": {
              "set": set_name, "requests": len(reqs),
              "generated_tokens": n_tok, "seconds": secs,
              "tokens_per_s": n_tok / secs, "launches": serve_launches,
              "decode_steps": max_new - 1,
              "peak_device_memory_bytes": serve_peak,
              "prefill_logits_max_abs_diff_fused_vs_solo": logit_diff,
              "logit_atol": LOGIT_ATOL,
              "first_token_flips_fused_vs_solo": flips,
              "top1_agreement_int8_vs_bf16_prefill": top1,
              "token_agreement_int8_vs_bf16": tok_agree,
              "profile": serve_prof},
          "card": card_line()})
    if loss_rel > QUANT_LOSS_RTOL:
        raise AssertionError(f"quant: int8 vs bf16 losses differ by "
                             f"{loss_rel} relative")
    if max(rel) > GRAD_RTOL:
        raise AssertionError(f"quant: cuda vs torch dequant adapter "
                             f"gradients differ by {max(rel)}")
    if logit_diff > LOGIT_ATOL:
        raise AssertionError(f"quant: fused vs solo prefill logits differ "
                             f"by {logit_diff} (atol {LOGIT_ATOL})")
    if flips:
        raise AssertionError(f"quant: fused vs solo first token ids differ "
                             f"for {flips} requests")
    return {k: launches[k] + serve_launches[k] for k in launches}


def unpack_dense_cost(cfg, layout, dev):
    """Device time of the densify-and-copy (``unpack_dense``) that every
    LoRA application of a nano slice pays on a mixed group, per training
    step: 22 layers x (q, o at 2048 -> 2048, k, v at 2048 -> 256) x 2
    (remat) x N, forward only (its backward adds the matching copies)."""
    import torch
    from repro_torch.core.lora import unpack_dense
    per_layer = 0.0
    shapes = {}
    for d_out, n in ((2048, 2), (256, 2)):
        A = torch.zeros((2048, layout.total), dtype=torch.bfloat16,
                        device=dev)
        B = torch.zeros((layout.total, d_out), dtype=torch.bfloat16,
                        device=dev)
        ms = device_ms(lambda: unpack_dense(A, B, layout))
        shapes[f"2048x{d_out}"] = ms
        per_layer += n * ms
    return {"ms_per_call": shapes,
            "ms_per_step": per_layer * cfg.num_layers * 2 * NANO_N}


def nano_phase(cfg, params, dev, measured=None):
    """The mixed group at N = 1 and N = 4 on the same batches, then AIMD;
    the steady steps at N = 1 and 4 go into ``measured``."""
    import numpy as np
    import torch
    from repro_torch.core.ssm import SharedSuperModel
    from repro_torch.train.train_loop import train_group

    specs = train_specs(TRAIN_RANKS, prefix="nano")
    layout = SharedSuperModel(cfg, specs, block_t=TRAIN_BLOCK_T).layout
    adapters = train_adapters(cfg, TRAIN_RANKS, layout, dev)
    kw = dict(steps=TRAIN_STEPS, lr=TRAIN_LR, seed=0, impl="cuda",
              block_t=TRAIN_BLOCK_T, chunk_size=TRAIN_CHUNK, remat=True,
              adaptive_nano=False, params=params, adapters=adapters,
              device=dev)
    runs, launches = {}, {}
    for n in (1, NANO_N):
        torch.cuda.reset_peak_memory_stats()
        runs[n], launches[n] = counted(
            lambda: train_group(cfg, specs, nano_batches=n, **kw))
        runs[n]["peak"] = torch.cuda.max_memory_allocated()
    expect = {k: v * NANO_N for k, v in MASKED_LAUNCHES.items()}
    per_step = check_launches("nano", launches[NANO_N], TRAIN_STEPS, expect)
    losses = {n: np.stack(runs[n]["report"].per_job_losses) for n in runs}
    diff = float(np.abs(losses[1] - losses[NANO_N]).max())
    steady = {n: float(np.mean(runs[n]["report"].step_times[TRAIN_CHUNK:]))
              for n in runs}
    prof = profile_run(functools.partial(runs[NANO_N]["runtime"].run, 1))
    for n in runs:
        if measured is not None:
            measured[f"nano_n{n}"] = dict(ranks=TRAIN_RANKS, nano=n,
                                          dtype="bf16", step_s=steady[n])

    # AIMD: train_group's default, fed each chunk's mean step time
    aimd_steps = AIMD_CHUNKS * TRAIN_CHUNK
    out, aimd_launches = counted(lambda: train_group(
        cfg, specs, **dict(kw, steps=aimd_steps, adaptive_nano=True)))
    rt = out["runtime"]
    legal = rt.aimd._legal
    hist = out["report"].nano_history
    chunks = [{"n": hist[i], "step_s": out["report"].step_times[i]}
              for i in range(0, aimd_steps, TRAIN_CHUNK)]
    emit({"phase": "nano", "model": cfg.name,
          "jobs": [{"id": sp.job_id, "rank": sp.rank, "r_pad": rp_}
                   for sp, rp_ in zip(specs, layout.r_pads)],
          "steps": TRAIN_STEPS, "nano_batches": [1, NANO_N],
          "per_step_per_job_loss": {n: losses[n].tolist() for n in runs},
          "max_abs_loss_diff_n1_vs_n4": diff, "atol": LOSS_ATOL,
          "step_s_steady": steady,
          "step_times_s": {n: runs[n]["report"].step_times for n in runs},
          "peak_device_memory_bytes": {n: runs[n]["peak"] for n in runs},
          "launches": {n: launches[n] for n in runs},
          "launches_per_step_n4": per_step,
          "unpack_dense": unpack_dense_cost(cfg, layout, dev),
          "profile_one_step_n4": prof,
          "aimd": {"legal": legal, "chunks": chunks, "nano_history": hist,
                   "controller_history": rt.aimd.history,
                   "launches": aimd_launches},
          "card": card_line()})
    if diff > LOSS_ATOL:
        raise AssertionError(f"nano: N=1 vs N={NANO_N} per-job losses differ "
                             f"by {diff}")
    if not set(hist) <= set(legal) or len(hist) != aimd_steps:
        raise AssertionError(f"nano: AIMD trajectory {hist} leaves the "
                             f"legal set {legal}")
    return {k: launches[1][k] + launches[NANO_N][k] + aimd_launches[k]
            for k in launches[1]}


def elastic_phase(cfg, params, dev, tmp):
    """Uniform group -> (two of its jobs + a fresh rank-64 job) mixed
    group -> one job alone, against a control run of that job alone."""
    import numpy as np
    import torch
    from repro_torch.core.jobs import LoRAJobSpec
    from repro_torch.core.ssm import SharedSuperModel
    from repro_torch.elastic.migrate import JobTrainState
    from repro_torch.elastic.runtime import GroupRuntime

    k = ELASTIC_K
    specs = train_specs(UNIFORM_RANKS, prefix="elastic")
    layout = SharedSuperModel(cfg, specs, block_t=TRAIN_BLOCK_T).layout
    kw = dict(lr=TRAIN_LR, impl="cuda", block_t=TRAIN_BLOCK_T,
              chunk_size=TRAIN_CHUNK, remat=True, device=dev)
    uniform = GroupRuntime.from_specs(
        cfg, specs, params=params, adapters=train_adapters(
            cfg, UNIFORM_RANKS, layout, dev), checkpoint_dir=tmp,
        checkpoint_every=1, **kw)
    j16, j8 = specs[0].job_id, specs[1].job_id
    start = uniform.export(j16)            # the control run starts here
    new = LoRAJobSpec("elastic-new-r64", rank=64, batch_size=TRAIN_BATCH,
                      seq_len=TRAIN_SEQ)

    def elastic_path():
        uniform.run(k)
        moved = [uniform.export(j16), uniform.export(j8),
                 JobTrainState.fresh(new, cfg, 11)]
        mixed = GroupRuntime.from_states(cfg, params, moved, **kw)
        mixed.run(k)
        alone = GroupRuntime.from_states(cfg, params, [mixed.export(j16)],
                                         **kw)
        alone.run(k)
        return moved, mixed, alone

    t0 = time.perf_counter()
    (moved, mixed, alone), launches = counted(elastic_path)
    wall = time.perf_counter() - t0
    control = GroupRuntime.from_states(cfg, params, [start], **kw)
    control.run(3 * k)
    got = [float(l[0]) for rt in (uniform, mixed, alone)
           for l in rt.report.per_job_losses]
    want = [float(l[0]) for l in control.report.per_job_losses]
    diff = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    final, ctl = alone.export(j16), control.export(j16)
    # the checkpoint written after the uniform group's run against the
    # export taken when the job moved
    restored = JobTrainState.from_checkpoint(
        os.path.join(tmp, f"{j16}.npz"), specs[0], cfg)
    same_bits = all(torch.equal(restored.adapter[key], moved[0].adapter[key])
                    and torch.equal(restored.mu[key], moved[0].mu[key])
                    and torch.equal(restored.nu[key], moved[0].nu[key])
                    for key in moved[0].adapter)
    emit({"phase": "elastic", "model": cfg.name,
          "stages": [{"group": [s.job_id for s in g.specs],
                      "r_pads": list(g.ssm.layout.r_pads),
                      "route": ("masked" if g.ssm.layout.is_uniform
                                else "ragged"), "steps": k}
                     for g in (uniform, mixed, alone)],
          "job": j16, "losses_elastic": got, "losses_control": want,
          "max_abs_loss_diff": diff, "atol": LOSS_ATOL,
          "opt_step": [final.opt_step, ctl.opt_step],
          "steps_done": [final.steps_done, ctl.steps_done],
          "checkpoint_equals_export": same_bits,
          "checkpoint_steps": restored.steps_done, "wall_s": wall,
          "launches": launches, "card": card_line()})
    if diff > LOSS_ATOL:
        raise AssertionError(f"elastic: migrated vs control losses differ "
                             f"by {diff}")
    if final.opt_step != ctl.opt_step or final.opt_step != 3 * k:
        raise AssertionError(f"elastic: Adam steps {final.opt_step} vs "
                             f"{ctl.opt_step}")
    if not same_bits or restored.opt_step != k:
        raise AssertionError("elastic: the checkpoint does not restore the "
                             "exported state")
    return launches


# ------------------------------------------------ the "torch" route
class _Ctx:
    """A stand-in for autograd's context: a Function's forward and
    backward called directly, so that each is timed alone."""

    def save_for_backward(self, *tensors):
        self.saved_tensors = tensors


def torch_route_cases(rows, dev) -> list:
    """The "torch" route (``_RaggedTorch``, ``_MaskedTorch``: the
    reference's "xla" path in plain PyTorch) against the kernels'
    Functions (``_RaggedLoRA``: B1 forward, B2-B5 backward;
    ``_MaskedLoRA``: B6 forward, B7 and B8 backward) on the same inputs:
    the training shapes (T 8192, 2048 -> 2048 and 2048 -> 256; the train
    and train_uniform groups, equal segments) and the serving decode
    (forward only, the one-hot fallback: a serving context has no segment
    rows).  Outputs compared at the kernel tolerance, y and dx, dA, dB
    each divided by its largest |value| first (``compare_scaled``): the
    routes round at other points, as the reference's "pallas" and "xla"
    do (the masked kernel rounds the unscaled product to bf16 and scales
    it after, the torch route scales in f32; the kernels round dy_s and
    dxa to bf16, the torch route keeps them f32), and with alpha / r up
    to 8, or a wgrad summing 8192 tokens, one ulp of an intermediate is
    many of a small output element; y's elementwise comparison is
    recorded beside (``fwd_elementwise``).  Each forward and backward
    timed alone, device ms from torch.profiler."""
    import torch
    from repro_torch.kernels.ops import (_MaskedLoRA, _MaskedTorch,
                                         _RaggedLoRA, _RaggedTorch,
                                         _tile_jobs_static)
    from repro_torch.kernels.ragged import RaggedMeta
    g = torch.Generator(device=dev).manual_seed(2)
    d_in = 2048
    shapes = [("train", (TRAIN_BATCH,) * len(TRAIN_RANKS), TRAIN_SEQ,
               TRAIN_BLOCK_T, d_out) for d_out in (2048, 256)]
    shapes.append(("decode", rows, 1, BLOCK_T, 2048))
    results = []
    for step, rws, seq, bt, d_out in shapes:
        T = sum(rws) * seq
        tile_jobs = _tile_jobs_static(rws, seq, bt)
        ids = torch.tensor(tile_jobs, dtype=torch.int32,
                           device=dev).repeat_interleave(bt)
        # the serving context carries no segment rows: decode takes the
        # one-hot fallback, as a serve through impl="torch" would
        equal = step == "train" and len(set(rws)) == 1
        for route, ranks in (
                ("ragged", TRAIN_RANKS if step == "train" else MIXED),
                ("masked", UNIFORM_RANKS if step == "train" else UNIFORM)):
            lay, x, A, B = lora_operands(ranks, d_in, d_out, T, g, dev)
            scal = torch.tensor([16.0 / r for r in ranks], device=dev)
            dy = torch.randn((T, d_out), generator=g,
                             device=dev).to(torch.bfloat16)
            if route == "ragged":
                meta = RaggedMeta.build(tile_jobs, lay)
                fns = (_RaggedLoRA, (x, A, B, ids, scal, meta, bt),
                       _RaggedTorch, (x, A, B, ids, scal, lay, equal))
            else:
                K, rp = lay.num_jobs, lay.r_pads[0]
                A_st = A.reshape(d_in, K, rp).movedim(-2, -3)
                B_st = B.reshape(K, rp, d_out)
                rk = torch.tensor(ranks, dtype=torch.int32, device=dev)
                fns = (_MaskedLoRA, (x, A_st, B_st, ids, rk, scal, bt),
                       _MaskedTorch, (x, A_st, B_st, ids, rk, scal, equal))
            kfn, kargs, tfn, targs = fns
            kctx, tctx = _Ctx(), _Ctx()
            y_k = kfn.forward(kctx, *kargs)
            y_t = tfn.forward(tctx, *targs)
            torch.cuda.synchronize()
            res = {"name": "torch_route", "route": route, "step": step,
                   "shape": dict(T=T, d_in=d_in, d_out=d_out,
                                 equal_segments=equal),
                   "fwd": compare_scaled((y_t,), (y_k,)),
                   "fwd_elementwise": compare(y_t, y_k),
                   "fwd_ms": device_ms(lambda: kfn.forward(_Ctx(), *kargs)),
                   "torch_fwd_ms": device_ms(
                       lambda: tfn.forward(_Ctx(), *targs))}
            if step == "train":
                g_k = kfn.backward(kctx, dy)[:3]
                g_t = tfn.backward(tctx, dy)[:3]
                torch.cuda.synchronize()
                res.update(bwd=compare_scaled(g_t, g_k),
                           bwd_ms=device_ms(lambda: kfn.backward(kctx, dy)),
                           torch_bwd_ms=device_ms(
                               lambda: tfn.backward(tctx, dy)))
            emit({"phase": "kernels", **res})
            for part in ("fwd", "bwd"):
                if part in res and not res[part]["within_tol"]:
                    raise AssertionError(
                        f"torch route ({route}, {step}, d_out {d_out}) "
                        f"{part} disagrees with the kernels: {res}")
            results.append(res)
    return results


# Launches per step through impl="torch": no LoRA kernel, the flash
# forward as in every training step
TORCH_LAUNCHES = {k: (v if k == "flash_attention_fwd" else 0)
                  for k, v in TRAIN_LAUNCHES.items()}


def torch_phase(cfg, params, dev, *, phase, ranks, cuda_losses, cuda_step,
                measured, held_steps=TRAIN_STEPS):
    """The ``phase`` cell (train or train_uniform: the same job ids, so the
    same data streams, and the same adapters) through impl="torch": per-job
    losses against the "cuda" run of this call (the first ``held_steps``
    steps asserted within LOSS_ATOL, every step reported), one step's
    adapter gradients "torch" against "cuda", no LoRA kernel launched, the
    flash forward 44 times a step; the steady step beside the "cuda"
    one."""
    import numpy as np
    import torch
    from repro_torch.core.ssm import SharedSuperModel
    from repro_torch.data.pipeline import FusedBatcher
    from repro_torch.train.train_loop import train_group

    name = phase + "_torch"
    specs = train_specs(ranks, prefix=phase)
    layout = SharedSuperModel(cfg, specs, block_t=TRAIN_BLOCK_T).layout
    adapters = train_adapters(cfg, ranks, layout, dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, launches = counted(lambda: train_group(
        cfg, specs, steps=TRAIN_STEPS, lr=TRAIN_LR, seed=0, impl="torch",
        block_t=TRAIN_BLOCK_T, chunk_size=TRAIN_CHUNK, remat=True,
        adaptive_nano=False, params=params, adapters=adapters, device=dev))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    per_step = check_launches(name, launches, TRAIN_STEPS, TORCH_LAUNCHES)
    rep = out["report"]
    losses = np.stack(rep.per_job_losses)
    per_step_diff = np.abs(losses - cuda_losses).max(axis=1)
    diff = float(per_step_diff[:held_steps].max())
    steady = float(np.mean(rep.step_times[TRAIN_CHUNK:]))
    measured[name] = dict(ranks=ranks, nano=1, dtype="bf16", step_s=steady)

    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             FusedBatcher(specs, cfg.vocab_size, block_t=TRAIN_BLOCK_T,
                          seed=1).next_batch().items()}
    g_torch = adapter_grads(cfg, params, specs, "torch", out["adapters"],
                            batch)
    g_cuda = adapter_grads(cfg, params, specs, "cuda", out["adapters"],
                           batch)
    rel = [((a.float() - b.float()).norm() / b.float().norm()).item()
           for a, b in zip(g_torch, g_cuda)]
    prof = profile_run(functools.partial(out["runtime"].run, 1))
    emit({"phase": name, "model": cfg.name, "layers": cfg.num_layers,
          "route": "masked" if layout.is_uniform else "ragged",
          "jobs": [{"id": sp.job_id, "rank": sp.rank, "r_pad": rp_}
                   for sp, rp_ in zip(specs, layout.r_pads)],
          "steps": TRAIN_STEPS, "chunk_size": TRAIN_CHUNK,
          "per_step_per_job_loss": losses.tolist(),
          "max_abs_loss_diff_vs_cuda": diff, "atol": LOSS_ATOL,
          "held_steps": held_steps,
          "max_abs_loss_diff_vs_cuda_per_step": per_step_diff.tolist(),
          "step_times_s": rep.step_times, "wall_s": wall,
          "step_s_steady": steady, "step_s_steady_cuda": cuda_step,
          "step_ratio_torch_vs_cuda": steady / cuda_step,
          "peak_device_memory_bytes": peak,
          "launches": launches, "launches_per_step": per_step,
          "grad_check_torch_vs_cuda": {
              "leaves": len(rel), "max_rel_fro_err": max(rel),
              "mean_rel_fro_err": float(np.mean(rel)), "rtol": GRAD_RTOL},
          "profile_one_step": prof, "card": card_line()})
    if diff > LOSS_ATOL:
        raise AssertionError(f"{name}: torch vs cuda per-job losses differ "
                             f"by {diff}")
    if max(rel) > GRAD_RTOL:
        raise AssertionError(f"{name}: torch vs cuda adapter gradients "
                             f"differ by {max(rel)}")
    return launches


# The kernels' Function each wrapper runs in, and the part of it
TORCH_ROUTE_OF = {"ragged_lora_fwd": ("ragged", "fwd"),
                  "ragged_lora_dgrad": ("ragged", "bwd"),
                  "ragged_xa": ("ragged", "bwd"),
                  "ragged_dxa": ("ragged", "bwd"),
                  "ragged_wgrad": ("ragged", "bwd"),
                  "fused_lora_cuda": ("masked", "fwd"),
                  "grouped_matmul_cuda": ("masked", "bwd"),
                  "grouped_wgrad_cuda": ("masked", "bwd")}


# ---------------------------------------------------------- pipeline
PIPE_STEPS = 12                   # steps of each run of the pipeline phase


def _same_state(a, b) -> dict:
    """Bit-equality of two runtimes' adapters, Adam moments, Adam steps
    and per-job losses."""
    import numpy as np
    import torch
    from repro_torch.optim.adamw import tree_leaves
    same = lambda x, y: all(torch.equal(p, q) for p, q in
                            zip(tree_leaves(x), tree_leaves(y)))
    return {"adapters": same(a.adapters, b.adapters),
            "adam_mu": same(a.opt_state.mu, b.opt_state.mu),
            "adam_nu": same(a.opt_state.nu, b.opt_state.nu),
            "adam_step": torch.equal(a.opt_state.step, b.opt_state.step),
            "per_job_loss": bool(np.array_equal(
                np.stack(a.report.per_job_losses),
                np.stack(b.report.per_job_losses)))}


def sync_calls(fn):
    """(fn's result, the synchronizing CUDA calls it made): each warning
    of ``torch.cuda.set_sync_debug_mode("warn")``, named by the Python
    stack that made the call (its innermost frames, "file:line func").
    The mode switch's own warning is the instrument's, not fn's: counted,
    it names ``set_sync_debug_mode`` itself as its site."""
    import traceback
    import warnings
    import torch
    sites = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            stack = [f for f in traceback.extract_stack()[:-1]
                     if not f.filename.endswith("warnings.py")]
            if stack[-1].name == "set_sync_debug_mode":
                return
            sites.append(" <- ".join(
                f"{os.path.relpath(f.filename, ROOT) if f.filename.startswith(ROOT) else os.path.basename(f.filename)}"
                f":{f.lineno} {f.name}" for f in reversed(stack[-6:])))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sites


def pipeline_phase(cfg, params, dev):
    """The mixed group from one initial state and one data seed, PIPE_STEPS
    steps in chunks of TRAIN_CHUNK, twice: sequential (each chunk
    dispatched without a prefetch, then collected) and pipelined
    (``run``: each chunk dispatched with the next one staged behind it).
    Adapters, Adam moments and per-job losses must be equal bit for bit;
    the synchronizing calls inside one dispatch are counted; each run's
    wall and steady step, and two profiled chunks of each."""
    import numpy as np
    import torch
    from repro_torch.core.ssm import SharedSuperModel
    from repro_torch.elastic.runtime import GroupRuntime

    specs = train_specs(TRAIN_RANKS, prefix="pipe")
    layout = SharedSuperModel(cfg, specs, block_t=TRAIN_BLOCK_T).layout
    adapters = train_adapters(cfg, TRAIN_RANKS, layout, dev)
    kw = dict(lr=TRAIN_LR, impl="cuda", block_t=TRAIN_BLOCK_T,
              chunk_size=TRAIN_CHUNK, remat=True, seed=0, device=dev)
    seq = GroupRuntime.from_specs(cfg, specs, params=params,
                                  adapters=adapters, **kw)
    piped = GroupRuntime.from_specs(cfg, specs, params=params,
                                    adapters=adapters, **kw)
    warm_s = {"sequential": seq.warm([TRAIN_CHUNK]),
              "pipelined": piped.warm([TRAIN_CHUNK])}

    def sequential():
        for _ in range(PIPE_STEPS // TRAIN_CHUNK):
            seq.collect_chunk(seq.dispatch_chunk(TRAIN_CHUNK, prefetch=0))

    walls = {}
    t0 = time.perf_counter()
    _, launches_seq = counted(sequential)
    walls["sequential"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, launches_piped = counted(lambda: piped.run(PIPE_STEPS))
    walls["pipelined"] = time.perf_counter() - t0
    equal = _same_state(seq, piped)
    steady = {k: float(np.mean(rt.report.step_times[TRAIN_CHUNK:]))
              for k, rt in (("sequential", seq), ("pipelined", piped))}

    # the synchronizing calls of one dispatch (with its prefetch)
    pending, syncs = sync_calls(
        lambda: seq.dispatch_chunk(TRAIN_CHUNK, prefetch=TRAIN_CHUNK))
    seq.collect_chunk(pending)
    seq.discard_staged()
    prof = {"sequential": profile_run(lambda: [
                seq.collect_chunk(seq.dispatch_chunk(TRAIN_CHUNK))
                for _ in range(2)]),
            "pipelined": profile_run(lambda: piped.run(2 * TRAIN_CHUNK))}
    emit({"phase": "pipeline", "model": cfg.name,
          "jobs": [{"id": sp.job_id, "rank": sp.rank} for sp in specs],
          "steps": PIPE_STEPS, "chunk_size": TRAIN_CHUNK,
          "bit_equal_sequential_vs_pipelined": equal,
          "warm_s": warm_s, "wall_s": walls,
          "wall_per_step_s": {k: v / PIPE_STEPS for k, v in walls.items()},
          "step_s_steady": steady,
          "sync_calls_in_one_dispatch": len(syncs),
          "sync_call_sites": sorted(set(syncs)),
          "profile_two_chunks": {
              k: {f: p.get(f) for f in ("wall_s", "device_busy_s",
                                        "device_idle_share",
                                        "device_kernels")}
              for k, p in prof.items()},
          "launches": {"sequential": launches_seq,
                       "pipelined": launches_piped},
          "card": card_line()})
    if not all(equal.values()):
        raise AssertionError(f"pipeline: sequential and pipelined runs "
                             f"differ: {equal}")
    for name, lc in (("sequential", launches_seq),
                     ("pipelined", launches_piped)):
        check_launches(f"pipeline {name}", lc, PIPE_STEPS, TRAIN_LAUNCHES)
    return {k: launches_seq[k] + launches_piped[k] for k in launches_seq}


# --------------------------------------------------------- calibrate
def calibrate_phase(cfg, measured):
    """``OnlineCalibrator(H100)`` fed the steady step times this run
    measured (train, train_uniform, nano at N = 1 and 4, quant): the
    fitted constants per bucket (K = 4 jobs, bf16 or int8 backbone) and
    each phase's predicted against measured step.  ``min_obs`` = 1: the
    int8 bucket has one measurement (the ratio fit through it).  Returns
    the bf16 K = 4 spec and the calibrator."""
    from repro_torch.core import throughput as tp
    from repro_torch.core.jobs import LoRAJobSpec

    def jobs(ranks):
        return [LoRAJobSpec(f"cal{i}", rank=r, batch_size=TRAIN_BATCH,
                            seq_len=TRAIN_SEQ) for i, r in enumerate(ranks)]

    fed = {k: v for k, v in measured.items()
           if k in ("train", "train_uniform", "nano_n1", "nano_n4", "quant")}
    cal = tp.OnlineCalibrator(tp.H100, min_obs=1)
    before = {k: tp.group_step_cost(cfg, jobs(m["ranks"]), 1, hw=tp.H100,
                                    nano_batches=m["nano"]).total
              for k, m in fed.items()}
    for m in fed.values():
        cal.observe(cfg, jobs(m["ranks"]), 1, m["step_s"],
                    backbone_dtype=m["dtype"], nano_batches=m["nano"])
    fits = {}
    for dtype in ("bf16", "int8"):
        hw = cal.hw_for(cfg.name, 1, 4, dtype)
        fits[dtype] = {"alpha_beta": cal.fit(cfg.name, 1, 4, dtype),
                       "mfu_cap": hw.mfu_cap, "hbm_bw": hw.hbm_bw,
                       "launch_overhead": hw.launch_overhead,
                       "step_overhead": hw.step_overhead}
    rows = {k: {"measured_s": m["step_s"], "predicted_h100_s": before[k],
                "predicted_calibrated_s": cal.predict(
                    cfg, jobs(m["ranks"]), 1, backbone_dtype=m["dtype"],
                    nano_batches=m["nano"]),
                "nano_batches": m["nano"], "backbone": m["dtype"]}
            for k, m in fed.items()}
    emit({"phase": "calibrate", "model": cfg.name, "base": "H100",
          "fits": fits, "steps": rows, "summary": cal.summary(),
          "card": card_line()})
    if len(fed) < 5 or cal.fit(cfg.name, 1, 4, "bf16") is None:
        raise AssertionError(f"calibrate: no fit from {sorted(fed)}")
    return cal.hw_for(cfg.name, 1, 4, "bf16"), cal


# ------------------------------------------------------------ engine
ENGINE_RANKS, ENGINE_LATE = (8, 16, 64), 32    # the three, then the fourth
ENGINE_BUDGET = 12                             # steps a job trains


def engine_phase(cfg, params, dev, hw):
    """An ``ElasticEngine`` priced with the calibrated H100 spec: three
    jobs arrive and are scheduled, train TRAIN_CHUNK steps; a fourth
    arrives and the scheduler regroups (its stall and the jobs it moved
    recorded); one move forced with ``set_grouping``, so that migration
    runs on the card whatever the scheduler chose (its stall recorded;
    both fed to ``observe_regroup``); then every job trains until it
    retires at its budget.  A job that moved is held to the same job
    trained alone for as many steps."""
    import copy
    import numpy as np
    import torch
    from repro_torch.core import throughput as tp
    from repro_torch.core.jobs import LoRAJobSpec
    from repro_torch.core.scheduler import AdapterScheduler, SchedulerConfig
    from repro_torch.elastic import ElasticEngine
    from repro_torch.elastic.runtime import GroupRuntime

    cal = tp.OnlineCalibrator(hw)
    eng = ElasticEngine(cfg, params=params, scheduler=AdapterScheduler(
        cfg, SchedulerConfig(hw=hw), calibrator=cal), impl="cuda",
        block_t=TRAIN_BLOCK_T, lr=TRAIN_LR, chunk_size=TRAIN_CHUNK,
        remat=True, seed=0, device=dev)

    def spec(i, r):
        return LoRAJobSpec(f"eng{i}-r{r}", rank=r, batch_size=TRAIN_BATCH,
                           seq_len=TRAIN_SEQ, steps_budget=ENGINE_BUDGET,
                           max_slowdown=2.0)

    fresh, losses = {}, {}

    def add(s):
        fresh[s.job_id] = copy.deepcopy(eng.add_job(s))
        losses[s.job_id] = []

    def run(steps):
        for gkey, rep in eng.run(steps).items():
            for i, jid in enumerate(gkey):
                losses[jid].extend(float(l[i])
                                   for l in rep.per_job_losses[-steps:])

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        for rt in eng._runtimes.values():    # pause-to-resume: ready to run
            rt.warm()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def homes():
        return {j: g for g in eng.current_grouping() for j in g}

    cost_before = cal.regroup_cost(cfg.name)
    counts = {}
    for i, r in enumerate(ENGINE_RANKS):
        add(spec(i, r))
    first = eng.reschedule()
    _, counts["first"] = counted(lambda: run(TRAIN_CHUNK))
    late = spec(len(ENGINE_RANKS), ENGINE_LATE)
    add(late)
    was = homes()
    second, stall_sched = timed(eng.reschedule)
    moved_sched = sorted(j for j, g in homes().items()
                         if j in was and g != was[j])
    # force a move: one group of all four, or split it when that is what
    # the scheduler chose
    ids = [s for s in fresh]
    target = ([tuple(ids[:2]), tuple(ids[2:])]
              if any(len(g) == len(ids) for g in eng.current_grouping())
              else [tuple(ids)])
    was = homes()
    diff, stall_forced = timed(lambda: eng.set_grouping(target))
    moved_forced = sorted(j for j, g in homes().items() if g != was[j])
    for s in (stall_sched, stall_forced):
        cal.observe_regroup(cfg.name, s)
    rounds = 0
    while eng.job_ids:
        _, counts[f"round{rounds}"] = counted(lambda: run(TRAIN_CHUNK))
        rounds += 1
        if rounds > ENGINE_BUDGET:
            raise AssertionError("engine: jobs never retired")
    done = {j: st.steps_done for j, st in eng.finished.items()}
    # a moved job against itself alone, from its arrival state
    job = moved_forced[0]
    alone = GroupRuntime.from_states(cfg, params, [fresh[job]],
                                     impl="cuda", block_t=TRAIN_BLOCK_T,
                                     lr=TRAIN_LR, chunk_size=TRAIN_CHUNK,
                                     remat=True, seed=0, device=dev)
    alone.run(ENGINE_BUDGET)
    want = [float(l[0]) for l in alone.report.per_job_losses]
    diff_alone = float(np.abs(np.asarray(losses[job])
                              - np.asarray(want)).max())
    launches = {k: sum(c[k] for c in counts.values())
                for k in counts["first"]}
    emit({"phase": "engine", "model": cfg.name, "hw": "H100, calibrated",
          "jobs": {j: {"rank": st.spec.rank, "budget": st.spec.steps_budget,
                       "steps_done": st.steps_done}
                   for j, st in eng.finished.items()},
          "grouping_first": first, "grouping_after_arrival": second,
          "moved_by_scheduler": moved_sched,
          "regroup_stall_s_scheduler": stall_sched,
          "forced_grouping": target, "forced_diff": diff,
          "moved_forced": moved_forced,
          "regroup_stall_s_forced": stall_forced,
          "regroup_events": eng.regroup_events,
          "regroup_cost_s": {"before": cost_before,
                             "after": cal.regroup_cost(cfg.name)},
          "moved_job": job, "losses_moved": losses[job],
          "losses_alone": want, "max_abs_loss_diff_vs_alone": diff_alone,
          "atol": LOSS_ATOL, "rounds_after_regroup": rounds,
          "launches": launches, "card": card_line()})
    if done != {j: ENGINE_BUDGET for j in fresh}:
        raise AssertionError(f"engine: steps done {done}, budget "
                             f"{ENGINE_BUDGET}")
    if diff_alone > LOSS_ATOL:
        raise AssertionError(f"engine: moved job {job} vs alone: "
                             f"{diff_alone}")
    return launches


# ------------------------------------------------------------ launch
LAUNCH_SERVE_REQUESTS, LAUNCH_SERVE_TOKENS = 8, 16
STEPS_ROWS, STEPS_PROMPT = 16, 7   # rows a job (one 16-token tile at
#                                    decode), prompt tokens before decode
LAUNCH_TRAIN_STEPS, LAUNCH_TRAIN_CHUNK = 4, 2


def launch_phase(cfg, params, dev, measured):
    """The launcher's entry points (``repro_torch.launch.train.main`` and
    the functions it calls) on full-width tinyllama-1.1b:

      (a) ``serve`` (8 requests, 16 new tokens; ranks 16/8/4/2, which
          all pad to 16: the masked forward): a prefill and 15 decode
          steps, B6 88 times each, B9 22 times at prefill, B1 never;
          the ids against ``ServeEngine.serve`` over the same seeded
          weights, pool and requests, asserted equal;
      (b) the serve steps on a mixed layout {8, 16, 32, 64} (the ragged
          forward), 16 rows a job: ``make_prefill_step`` over 7 tokens,
          ``make_serve_step`` for the 8th; both held to the teacher-forced
          ``forward`` within LOGIT_ATOL; B1 88 times a pass, B9 22 times
          at prefill;
      (c) ``train --impl torch --no-aimd`` at the launcher's defaults (4
          jobs, 4 x 512 tokens, ranks 16/8/4/2) for 4 steps in chunks of
          2: finite losses, no LoRA kernel, 44 flash launches a step; the
          steady step beside ``train_uniform_torch``'s (the same layout
          and batches through ``train_group``)."""
    import numpy as np
    import torch
    from repro_torch.configs.base import InputShape
    from repro_torch.core.jobs import LoRAJobSpec
    from repro_torch.core.ssm import SharedSuperModel
    from repro_torch.launch import train as launcher
    from repro_torch.models import model as M
    from repro_torch.serve import AdapterPool, ServeEngine, ServeRequest

    zero = {w.__name__: 0 for w in lora_wrappers()}
    counts = {}
    # (a) serve, then the same requests through the engine
    t0 = time.perf_counter()
    rows, counts["serve"] = counted(lambda: launcher.main(
        ["serve", "--requests", str(LAUNCH_SERVE_REQUESTS), "--tokens",
         str(LAUNCH_SERVE_TOKENS)]))
    serve_wall = time.perf_counter() - t0
    jobs, reqs = launcher.serve_workload(cfg, cfg.name, LAUNCH_SERVE_REQUESTS,
                                         LAUNCH_SERVE_TOKENS)
    ssm = SharedSuperModel(cfg, jobs, impl="cuda", block_t=BLOCK_T)
    p_serve, a_serve = ssm.init(seed=0, device=dev)
    pool = AdapterPool(cfg, capacity=len(jobs), multiple=ssm.layout.multiple,
                       device=dev)
    pool.publish_group(jobs, a_serve, ssm.layout)
    engine = ServeEngine(cfg, p_serve, pool, impl="cuda", block_t=BLOCK_T)
    sreqs = [ServeRequest(prompt=r.prompt, adapter=jobs[r.adapter_id].job_id,
                          max_new_tokens=r.max_new_tokens) for r in reqs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.serve(sreqs)
    engine_s = time.perf_counter() - t0
    same = [a.tolist() == b.tokens.tolist() for a, b in zip(rows, res)]
    del p_serve, a_serve, pool, engine
    per_pass = 4 * cfg.num_layers          # LoRA on q, k, v, o
    want_serve = dict(zero, fused_lora_cuda=per_pass * LAUNCH_SERVE_TOKENS,
                      flash_attention_fwd=cfg.num_layers)

    # (b) the serve steps on a mixed layout
    specs = [LoRAJobSpec(f"steps{i}-r{r}", rank=r, batch_size=STEPS_ROWS,
                         seq_len=BLOCK_T) for i, r in enumerate(MIXED)]
    ssm = SharedSuperModel(cfg, specs, impl="cuda", block_t=BLOCK_T)
    adapters = train_adapters(cfg, MIXED, ssm.layout, dev)
    B = STEPS_ROWS * len(specs)
    g = torch.Generator(device=dev).manual_seed(11)
    toks = torch.randint(1, cfg.vocab_size, (B, STEPS_PROMPT + 1),
                         generator=g, device=dev, dtype=torch.int32)
    ids = torch.arange(len(specs), device=dev,
                       dtype=torch.int32).repeat_interleave(STEPS_ROWS)
    shape = InputShape("launch", 2 * BLOCK_T, B, "decode")
    prefill = ssm.make_prefill_step(shape)
    step = ssm.make_serve_step()

    def steps():
        lp, caches = prefill(params, adapters, {
            "tokens": toks[:, :STEPS_PROMPT], "adapter_ids": ids})
        ld, _ = step(params, adapters, caches, {
            "tokens": toks[:, STEPS_PROMPT:], "adapter_ids": ids},
            STEPS_PROMPT)
        return lp[:, 0].float(), ld[:, 0].float()

    (lp, ld), counts["serve_steps"] = counted(steps)
    with torch.no_grad():
        tf = M.forward(cfg, params, adapters, ssm.lora_ctx(ids),
                       {"tokens": toks})[0].float()
    d_prefill = (lp - tf[:, STEPS_PROMPT - 1]).abs().max().item()
    d_decode = (ld - tf[:, STEPS_PROMPT]).abs().max().item()
    finite = bool(torch.isfinite(ld).all() and torch.isfinite(lp).all())
    want_steps = dict(zero, ragged_lora_fwd=2 * per_pass,
                      flash_attention_fwd=cfg.num_layers)
    del adapters, tf

    # (c) train --impl torch at the launcher's defaults
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, counts["train_torch"] = counted(lambda: launcher.main(
        ["train", "--impl", "torch", "--steps", str(LAUNCH_TRAIN_STEPS),
         "--chunk-size", str(LAUNCH_TRAIN_CHUNK), "--no-aimd"]))
    train_wall = time.perf_counter() - t0
    rep = out["report"]
    per_step = {k: n / LAUNCH_TRAIN_STEPS
                for k, n in counts["train_torch"].items()}
    losses = np.stack(rep.per_job_losses)
    steady = float(np.mean(rep.step_times[LAUNCH_TRAIN_CHUNK:]))
    ref_step = measured.get("train_uniform_torch", {}).get("step_s")
    train_jobs = [{"id": sp.job_id, "rank": sp.rank, "batch": sp.batch_size,
                   "seq_len": sp.seq_len} for sp in out["ssm"].jobs]
    peak = torch.cuda.max_memory_allocated()
    del out

    emit({"phase": "launch", "model": cfg.name, "layers": cfg.num_layers,
          "serve": {"argv": ["serve", "--requests",
                             str(LAUNCH_SERVE_REQUESTS), "--tokens",
                             str(LAUNCH_SERVE_TOKENS)],
                    "rows": [r.tolist() for r in rows],
                    "main_wall_s": serve_wall, "engine_serve_s": engine_s,
                    "tokens_per_s": sum(len(r) for r in rows) / engine_s,
                    "ids_equal_engine": sum(same), "requests": len(same),
                    "launches": counts["serve"],
                    "launches_expected": want_serve},
          "serve_steps": {"ranks": list(MIXED),
                          "r_pads": list(ssm.layout.r_pads),
                          "rows": B, "prompt": STEPS_PROMPT,
                          "prefill_max_abs_diff_vs_forward": d_prefill,
                          "decode_max_abs_diff_vs_forward": d_decode,
                          "logit_atol": LOGIT_ATOL, "finite": finite,
                          "launches": counts["serve_steps"],
                          "launches_expected": want_steps},
          "train_torch": {"argv_extra": ["--impl", "torch", "--steps",
                                         str(LAUNCH_TRAIN_STEPS),
                                         "--chunk-size",
                                         str(LAUNCH_TRAIN_CHUNK),
                                         "--no-aimd"],
                          "jobs": train_jobs,
                          "per_step_per_job_loss": losses.tolist(),
                          "step_times_s": rep.step_times,
                          "step_s_steady": steady,
                          "step_s_steady_train_uniform_torch": ref_step,
                          "wall_s": train_wall,
                          "peak_device_memory_bytes": peak,
                          "launches_per_step": per_step},
          "card": card_line()})
    if counts["serve"] != want_serve:
        raise AssertionError(f"launch serve: launches {counts['serve']}, "
                             f"expected {want_serve}")
    if not all(same) or len(same) != LAUNCH_SERVE_REQUESTS:
        raise AssertionError(f"launch serve: serve_batch and "
                             f"ServeEngine.serve part: {same}")
    if counts["serve_steps"] != want_steps:
        raise AssertionError(f"launch serve steps: launches "
                             f"{counts['serve_steps']}, expected "
                             f"{want_steps}")
    if not finite or max(d_prefill, d_decode) > LOGIT_ATOL:
        raise AssertionError(f"launch serve steps vs forward: prefill "
                             f"{d_prefill}, decode {d_decode}")
    check_launches("launch train_torch", counts["train_torch"],
                   LAUNCH_TRAIN_STEPS, TORCH_LAUNCHES)
    if not np.isfinite(losses).all():
        raise AssertionError("launch train_torch: non-finite losses")
    return {k: sum(c[k] for c in counts.values()) for k in zero}


# ---------------------------------------------------------- simulate
def simulate_phase(cfg, cal):
    """The cluster simulator on the H100 spec, host arithmetic only:

      (a) the reference launcher's default replay (all five systems, 128
          chips, a 120-job month, seed 0) under ``ClusterConfig(hw=H100)``:
          each system's summary and its comparison against mLoRA, run
          twice; every job completes and the two runs agree, asserted;
      (b) a 120-job month of ``tinyllama-1.1b`` jobs alone, priced through
          the calibrator the calibrate phase fitted (its ``hw`` is H100,
          so the simulator's frame check admits it): the same lines, and
          how many ``hw_for`` lookups returned a fitted spec and how many
          the base spec (groups of K != 4 have no fit); beside it the
          same trace on the H100 spec alone.

    Every number is a simulation priced by the throughput model, not a
    measurement."""
    from repro_torch.cluster.baselines import SYSTEMS, make_simulator
    from repro_torch.cluster.metrics import compare, summarize
    from repro_torch.cluster.simulator import ClusterConfig
    from repro_torch.cluster.trace import TraceConfig, generate
    from repro_torch.core import throughput as tp

    def replay(trace, calibrator=None):
        t0 = time.perf_counter()
        res = {}
        for s in SYSTEMS:
            sim = make_simulator(s, ClusterConfig(total_chips=128,
                                                  hw=tp.H100))
            if calibrator is not None:
                sim.calibrator = calibrator
            res[s] = sim.run(trace)
        wall = time.perf_counter() - t0
        vs = {n: {k: d[k] for k in ("throughput_x", "jct_speedup_x",
                                    "utilization_delta")}
              for n, d in compare(res).items()}
        return {s: summarize(r) for s, r in res.items()}, vs, wall

    trace = generate(TraceConfig(months=1, jobs_per_month=120, seed=0))
    summ, vs, wall = replay(trace)
    summ2, vs2, _ = replay(trace)
    models = sorted({j.base_model for j in trace})

    looked = {"fitted": 0, "base": 0}
    hw_for = cal.hw_for
    base = tp.with_backbone_dtype(cal.hw, "bf16")

    def counting(*a, **k):
        hw = hw_for(*a, **k)
        looked["base" if hw == base else "fitted"] += 1
        return hw

    tiny = generate(TraceConfig(months=1, jobs_per_month=120, seed=0,
                                base_models=(cfg.name,)))
    summ_u, vs_u, _ = replay(tiny)
    cal.hw_for = counting
    try:
        summ_t, vs_t, wall_t = replay(tiny, calibrator=cal)
    finally:
        del cal.hw_for
    emit({"phase": "simulate", "hw": "H100 (simulated, not measured)",
          "default": {"jobs": len(trace), "chips": 128, "seed": 0,
                      "models": models, "summaries": summ, "vs_mlora": vs,
                      "rerun_equal": summ2 == summ and vs2 == vs,
                      "wall_s": wall},
          "tinyllama_calibrated": {
              "jobs": len(tiny), "chips": 128, "seed": 0,
              "fit_bf16_k4": cal.fit(cfg.name, 1, 4, "bf16"),
              "summaries": summ_t, "vs_mlora": vs_t,
              "hw_for_lookups": looked, "wall_s": wall_t,
              "uncalibrated": {"summaries": summ_u, "vs_mlora": vs_u}},
          "card": card_line()})
    for name, s in (("default", summ), ("tinyllama", summ_t)):
        short = {k: v["completion_rate"] for k, v in s.items()
                 if v["completion_rate"] != 1.0}
        if short:
            raise AssertionError(f"simulate {name}: jobs left undone {short}")
    if summ2 != summ or vs2 != vs:
        raise AssertionError("simulate: two runs of one replay differ")
    if not looked["fitted"]:
        raise AssertionError(f"simulate: no calibrated price {looked}")


# ------------------------------------------------------------- cluster
# Cluster control on the one card.  Two groups of the train cell's jobs:
# ranks 8 and 16 (both pad to 16: a uniform layout, the masked kernels)
# and ranks 32 and 64 (a mixed layout, the ragged kernels).
CLUSTER_GROUPS = ((8, 16), (32, 64))
CLUSTER_MODES = ("sequential", "roundrobin", "threads")
CLUSTER_STEPS = 4                 # timed steps of each mode (one chunk)
# the overlapped regroup: chunks of REGROUP_CHUNK steps toward a run
# target the two pumps are still short of when the merged group is
# installed (preparing it took 9.4 s beside two 22-layer pumps in
# chunks of 4, while they stepped on to a target of 16)
REGROUP_CHUNK, REGROUP_TARGET = 2, 16
# the trace harness: tinyllama jobs of ranks from the train cell's set,
# budgets of 12-24 steps, arriving over TRACE_WINDOW_S of wall time;
# chunks of TRACE_CHUNK steps, a checkpoint every TRACE_CKPT_EVERY
# chunks.  The harness's groups are singletons (the scheduler merges
# only under queue pressure), and a 22-layer step costs ~0.45 s of host
# time whatever its tokens, taken by turns under the GIL: 7 such jobs
# took 142 s a run and tripped the heartbeat four times without a fault
# (PERF.md §6).  So the trace runs tinyllama at full width cut to
# TRACE_LAYERS layers (it was 6: two of them paid for the tp_serve phase
# and the dryrun line inside the whole run's time).
TRACE_JOBS, TRACE_WINDOW_S, TRACE_LAYERS = 6, 10.0, 4
TRACE_CHUNK, TRACE_CKPT_EVERY = 2, 2
# heartbeat: past a healthy chunk with every other pump taking the host
# by turns, and its checkpoint write
TRACE_STUCK_AFTER = 10.0
TRACE_MAX_WALL_S = 240.0
SIM_MAX_TIME = 240.0              # simulated seconds of the backend's run


def cluster_controller(cfg, dev, **kw):
    from repro_torch.cluster.controller import ClusterController
    kw.setdefault("chunk_size", TRAIN_CHUNK)
    return ClusterController(lambda m: cfg, impl="cuda",
                             block_t=TRAIN_BLOCK_T, lr=TRAIN_LR, remat=True,
                             seed=0, device=dev, **kw)


def cluster_spec(jid, rank, budget=10_000, **kw):
    from repro_torch.core.jobs import LoRAJobSpec
    return LoRAJobSpec(jid, rank=rank, batch_size=TRAIN_BATCH,
                       seq_len=TRAIN_SEQ, steps_budget=budget,
                       max_slowdown=2.0, **kw)


class chunk_tally:
    """Within the block, every dispatched chunk's steps by route: a
    uniform layout's steps launch ``MASKED_LAUNCHES``, a mixed one's
    ``TRAIN_LAUNCHES``, scaled from 22 layers to *layers* (every launch
    of a chunk is made at dispatch, so a chunk whose collect a fault
    prevents still counts)."""

    def __init__(self, layers: int = TRAIN_LAYERS):
        self.layers = layers

    def __enter__(self):
        import threading
        from repro_torch.elastic.runtime import GroupRuntime
        self.steps = {"masked": 0, "ragged": 0}
        self._orig = orig = GroupRuntime.dispatch_chunk
        tally, lock = self.steps, threading.Lock()

        def dispatch_chunk(rt, length=None, **kw):
            route = "masked" if rt.ssm.layout.is_uniform else "ragged"
            with lock:                    # the pumps dispatch in threads
                tally[route] += int(length or rt.chunk_size)
            return orig(rt, length, **kw)
        GroupRuntime.dispatch_chunk = dispatch_chunk
        return self

    def __exit__(self, *exc):
        from repro_torch.elastic.runtime import GroupRuntime
        GroupRuntime.dispatch_chunk = self._orig

    def expect(self) -> dict:
        return {k: (self.steps["masked"] * MASKED_LAUNCHES[k]
                    + self.steps["ragged"] * TRAIN_LAUNCHES[k])
                * self.layers // TRAIN_LAYERS for k in TRAIN_LAUNCHES}


def check_cluster_launches(part, launches, tally):
    want = tally.expect()
    if launches != want:
        raise AssertionError(f"cluster {part}: launches {launches}, "
                             f"expected {want} for steps {tally.steps}")


def cluster_modes(cfg, dev) -> tuple:
    """(a) The two groups under each concurrency mode, from the same
    seeds: half a chunk to warm up, CLUSTER_STEPS steps timed, one step
    under the profiler (whose post-processing takes seconds per 10,000
    kernels); adapters, Adam moments and per-job losses bit-equal across
    the modes (asserted); each mode's wall and peak memory over the
    timed steps, and its device idle share over the profiled step."""
    import numpy as np
    import torch
    out, rts, launches = {}, {}, {}
    groups = [tuple(f"c{r}" for r in g) for g in CLUSTER_GROUPS]
    for mode in CLUSTER_MODES:
        ctl = cluster_controller(cfg, dev, concurrency=mode)
        for g, ranks in zip(groups, CLUSTER_GROUPS):
            for jid, r in zip(g, ranks):
                ctl.submit(cluster_spec(jid, r))
        ctl.apply_grouping(groups)
        warm = {"+".join(g): ctl._slots[g].runtime(g).warm([TRAIN_CHUNK])
                for g in groups}
        with chunk_tally() as tally:
            _, lc_warm = counted(lambda: ctl.run(TRAIN_CHUNK // 2))
        check_cluster_launches(f"modes {mode} warm-up", lc_warm, tally)
        torch.cuda.reset_peak_memory_stats()
        with chunk_tally() as tally:
            t0 = time.perf_counter()
            _, lc = counted(lambda: ctl.run(CLUSTER_STEPS))
            wall = time.perf_counter() - t0
        check_cluster_launches(f"modes {mode}", lc, tally)
        peak = torch.cuda.max_memory_allocated()
        prof = profile_run(lambda: ctl.run(1))
        rts[mode] = {g: ctl._slots[g].runtime(g) for g in groups}
        launches[mode] = {k: lc[k] + lc_warm[k] for k in lc}
        timed = {"+".join(g): float(np.mean(
            rt.report.step_times[TRAIN_CHUNK // 2:
                                 TRAIN_CHUNK // 2 + CLUSTER_STEPS]))
            for g, rt in rts[mode].items()}
        out[mode] = {"wall_s": wall, "wall_per_step_s": wall / CLUSTER_STEPS,
                     "warm_s": warm, "step_s_by_group": timed,
                     "peak_device_memory_bytes": peak,
                     "profile_one_step": {
                         k: prof.get(k) for k in ("wall_s", "device_busy_s",
                                                  "device_idle_share",
                                                  "device_kernels")},
                     "routes": {"+".join(g): "masked" if rt.ssm.layout
                                .is_uniform else "ragged"
                                for g, rt in rts[mode].items()}}
        del ctl
    equal = {mode: {"+".join(g): _same_state(rts["sequential"][g], rt)
                    for g, rt in rts[mode].items()}
             for mode in CLUSTER_MODES[1:]}
    seq = out["sequential"]["wall_s"]
    for mode in CLUSTER_MODES:
        out[mode]["wall_vs_sequential"] = out[mode]["wall_s"] / seq
    total = {k: sum(lc[k] for lc in launches.values())
             for k in launches["sequential"]}
    return out, equal, total


def cluster_solo(cfg, dev) -> tuple:
    """(b) One job through the controller against the same job in a solo
    ``ElasticEngine`` (each draws its own backbone and adapters from the
    seed): adapters, Adam moments and per-step losses bit-equal."""
    import numpy as np
    import torch
    from repro_torch.elastic import ElasticEngine
    spec = cluster_spec("solo-r16", 16)

    def both():
        ctl = cluster_controller(cfg, dev)
        ctl.submit(spec)
        rt_c = ctl.ensure_group((spec.job_id,))
        rt_c.run(CLUSTER_STEPS)
        eng = ElasticEngine(cfg, impl="cuda", block_t=TRAIN_BLOCK_T,
                            lr=TRAIN_LR, chunk_size=TRAIN_CHUNK,
                            remat=True, seed=0, device=dev)
        eng.add_job(spec)
        rt_e = eng.ensure_group((spec.job_id,))
        rt_e.run(CLUSTER_STEPS)
        return (ctl.job_state(spec.job_id), eng.job_state(spec.job_id),
                rt_c, rt_e)

    with chunk_tally() as tally:
        (a, b, rt_c, rt_e), lc = counted(both)
    check_cluster_launches("solo", lc, tally)
    same = {part: all(torch.equal(getattr(a, part)[k], getattr(b, part)[k])
                      for k in getattr(a, part))
            for part in ("adapter", "mu", "nu")}
    same["opt_step"] = a.opt_step == b.opt_step == CLUSTER_STEPS
    same["per_job_loss"] = bool(np.array_equal(
        np.stack(rt_c.report.per_job_losses),
        np.stack(rt_e.report.per_job_losses)))
    return {"job": spec.job_id, "steps": CLUSTER_STEPS,
            "bit_equal": same}, lc


def cluster_regroup(cfg, dev) -> tuple:
    """(c) Two solo pumps run toward REGROUP_TARGET steps in chunks of
    REGROUP_CHUNK; the merged
    group is prepared while they step, then installed (overlapped); the
    same groups merged stop-the-world on a second controller.  Asserted:
    the pumps advanced during the prepare, the event is overlapped with no
    warm in its stall window, and every job reaches the target."""
    out = {}
    ids = ("rg8", "rg64")

    def both():
        for mode in ("overlapped", "stop_the_world"):
            ctl = cluster_controller(cfg, dev, chunk_size=REGROUP_CHUNK)
            ctl.submit(cluster_spec(ids[0], 8))
            ctl.submit(cluster_spec(ids[1], 64))
            ctl.apply_grouping([(ids[0],), (ids[1],)])
            ctl.begin(REGROUP_TARGET)
            while min(ctl.steps_done(j) for j in ids) < REGROUP_CHUNK:
                time.sleep(0.01)            # both pumps past their first
            before = {j: ctl.steps_done(j) for j in ids}
            prepared, prewarm_s = 0, None
            if mode == "overlapped":
                t0 = time.perf_counter()
                prepared = ctl.prewarm([ids])
                prewarm_s = time.perf_counter() - t0
            after = {j: ctl.steps_done(j) for j in ids}
            ctl.apply_grouping([ids], overlap=mode == "overlapped")
            ev = ctl.regroup_log[-1]
            ctl.finish()
            out[mode] = {
                **ev.summary(), "fence_steps": dict(ev.fence_steps),
                "steps_before_prewarm": before,
                "steps_after_prewarm": after, "prepared": prepared,
                "prewarm_s": prewarm_s,
                "steps_done": {j: ctl.steps_done(j) for j in ids},
                "regroup_events": ctl.regroup_events}

    with chunk_tally() as tally:
        _, lc = counted(both)
    check_cluster_launches("regroup", lc, tally)
    ov = out["overlapped"]
    checks = {
        "mode_overlapped": ov["mode"] == "overlapped",
        "no_warm_in_window": ov["compile_s"] == 0.0,
        "assembled_off_window": ov["assemble_s"] > 0.0,
        "pumps_stepped_during_prepare": all(
            ov["steps_after_prewarm"][j] > ov["steps_before_prewarm"][j]
            for j in ids),
        "fence_mid_run": all(0 < s < REGROUP_TARGET
                             for s in ov["fence_steps"].values()),
        "reached_target": all(
            out[m]["steps_done"][j] >= REGROUP_TARGET
            for m in out for j in ids),
        "stop_the_world": out["stop_the_world"]["mode"] == "stop_the_world"}
    return out, checks, lc


def trace_jobs():
    """TRACE_JOBS jobs of the synthetic trace (its arrival order and
    spacing), given the train cell's shapes, ranks from {8, 16, 32, 64}
    and budgets of 12-24 steps drawn from seed 7."""
    import dataclasses
    import numpy as np
    from repro_torch.cluster.trace import TraceConfig, generate
    raw = generate(TraceConfig(months=1, jobs_per_month=8 * TRACE_JOBS,
                               base_models=("tinyllama-1.1b",),
                               seed=7))[:TRACE_JOBS]
    rng = np.random.default_rng(7)
    return [dataclasses.replace(
        j, rank=int(rng.choice(TRAIN_RANKS)), batch_size=TRAIN_BATCH,
        seq_len=TRAIN_SEQ, gpus=1, steps_budget=int(rng.integers(12, 25)),
        max_slowdown=2.0) for j in raw]


def cluster_trace(cfg, dev, tmp) -> tuple:
    """(d) ``TraceRunner`` over the trace jobs on the live controller
    (*cfg* cut to TRACE_LAYERS layers), fault-free, then with a worker
    death in flight, a corrupt checkpoint and a stuck worker.  Asserted: no job lost, every fault recovered,
    steps lost at most the checkpoint period for every job restored from
    a checkpoint, and the corrupt checkpoint's job restarted from exactly
    its admission-time init."""
    import dataclasses
    import torch
    from repro_torch.cluster.faults import FaultPlan, FaultSpec
    from repro_torch.cluster.harness import TraceRunner
    cfg = dataclasses.replace(cfg, num_layers=min(TRACE_LAYERS,
                                                  cfg.num_layers))
    jobs = trace_jobs()
    by_budget = sorted(jobs, key=lambda j: -j.steps_budget)
    period = TRACE_CHUNK * TRACE_CKPT_EVERY
    out, fresh_checks = {}, []

    def restore_checked(ctl):
        """``_restore_state`` with a check of every fresh restart against
        the job's admission-time init, drawn anew."""
        restore = ctl._restore_state

        def wrapped(jid, spec, rec):
            st = restore(jid, spec, rec)
            if jid in rec.restarted_fresh:
                want = ctl._fresh_state(spec)
                fresh_checks.append({"job": jid, "equal": all(
                    torch.equal(getattr(st, p)[k], getattr(want, p)[k])
                    for p in ("adapter", "mu", "nu") for k in want.adapter)
                    and st.opt_step == st.steps_done == 0})
            return st
        return wrapped

    def runs():
        for name in ("fault_free", "faults"):
            plan = None if name == "fault_free" else FaultPlan([
                FaultSpec("worker_death", job_id=by_budget[0].job_id,
                          at_step=2, phase="inflight"),
                FaultSpec("corrupt_checkpoint", job_id=by_budget[1].job_id,
                          at_step=4),
                FaultSpec("stuck_worker", job_id=by_budget[2].job_id,
                          at_step=2, stuck_s=120.0)], seed=7)
            ckpt = os.path.join(tmp, "cluster_" + name)
            shutil.rmtree(ckpt, ignore_errors=True)
            os.makedirs(ckpt)
            ctl = cluster_controller(
                cfg, dev, concurrency="threads", chunk_size=TRACE_CHUNK,
                checkpoint_dir=ckpt, checkpoint_every=TRACE_CKPT_EVERY,
                fault_plan=plan, backoff_base_s=0.2,
                stuck_after=TRACE_STUCK_AFTER, startup_grace_s=120.0)
            ctl._restore_state = restore_checked(ctl)
            res = TraceRunner(ctl, jobs, arrival_window_s=TRACE_WINDOW_S,
                              max_wall_s=TRACE_MAX_WALL_S).run()
            s = res.summary()
            s["jct_per_job_s"] = {j: lg.jct_s for j, lg in res.logs.items()}
            s["steps_per_job"] = {j: ctl.steps_done(j) for j in res.logs}
            s["regroups"] = len(ctl.regroup_log)
            s["regroup_stats"] = ctl.regroup_stats()
            if plan is not None:
                s["faults_fired"] = len(plan.fired)
                s["faults_planned"] = len(plan.faults)
            out[name] = s

    with chunk_tally(cfg.num_layers) as tally:
        _, lc = counted(runs)
    check_cluster_launches("trace", lc, tally)
    f = out["faults"]
    fresh = [j for rec in f["failures"] for j in rec["restarted_fresh"]]
    checks = {
        "no_job_lost": all(out[n]["lost_jobs"] == 0
                           and out[n]["completed"] == len(jobs)
                           and not out[n]["timed_out"] for n in out),
        "fault_free_has_no_failures": not out["fault_free"]["failures"],
        "every_fault_fired": f["faults_fired"] == f["faults_planned"] == 3,
        "every_fault_recovered": f["recovery"]["faults"]
        == f["recovery"]["recovered"] >= 3,
        "steps_lost_within_period": all(
            n <= period for rec in f["failures"]
            for j, n in rec["steps_lost"].items()
            if j in rec["restored_from_checkpoint"]),
        "fresh_restart_is_the_corrupt_checkpoint_job":
            fresh == [by_budget[1].job_id],
        "fresh_restart_equals_admission_init": bool(fresh_checks)
        and all(c["equal"] for c in fresh_checks),
        "budgets_reached": all(
            out[n]["steps_per_job"][j.job_id] == j.steps_budget
            for n in out for j in jobs)}
    info = {"layers": cfg.num_layers,
            "jobs": [{"id": j.job_id, "rank": j.rank,
                      "budget": j.steps_budget} for j in jobs],
            "checkpoint_period_steps": period, "chunk_size": TRACE_CHUNK,
            "checkpoint_every": TRACE_CKPT_EVERY,
            "stuck_after_s": TRACE_STUCK_AFTER,
            "arrival_window_s": TRACE_WINDOW_S,
            "fresh_restarts": fresh_checks}
    return out, checks, info, lc


def cluster_execution(cfg, dev, sim_cfg_of=None) -> tuple:
    """(e) ``ExecutionBackend(hw=H100, impl="cuda")`` inside the cluster
    simulator (``reduced_models=False``: the full-width config) on a
    three-job tinyllama trace: the executed groupings, every horizon's
    predicted (H100 spec) against measured step, and the uncalibrated
    and calibrated errors.  Asserted: a fused multi-job group executed."""
    from repro_torch.cluster.execution import ExecutionBackend
    from repro_torch.cluster.simulator import (ClusterConfig,
                                               ClusterSimulator,
                                               tlora_policy)
    from repro_torch.core import throughput as tp
    trace = [cluster_spec("x0-r8", 8, 20_000),
             cluster_spec("x1-r64", 64, 20_000),
             cluster_spec("x2-r16", 16, 4_000, arrival_time=40.0)]

    def simulate():
        be = ExecutionBackend(hw=tp.H100, impl="cuda", block_t=TRAIN_BLOCK_T,
                              lr=TRAIN_LR, steps_per_measure=2, device=dev)
        cc = ClusterConfig(total_chips=8, horizon=30.0, concurrency_cap=4,
                           reduced_models=False, hw=tp.H100)
        sim = ClusterSimulator(cc, None, cfg_of=sim_cfg_of, execution=be)
        sim.policy = tlora_policy(sim._cfg_of)
        t0 = time.perf_counter()
        res = sim.run(trace, max_time=SIM_MAX_TIME)
        return be, res, time.perf_counter() - t0

    with chunk_tally() as tally:
        (be, res, wall), lc = counted(simulate)
    check_cluster_launches("execution", lc, tally)
    out = {"summary": be.summary(), "wall_s": wall,
           "config": be.controller._cfg(trace[0].base_model).name,
           "records": [{"t": r.t, "jobs": list(r.job_ids), "chips": r.chips,
                        "predicted_s": r.predicted, "measured_s": r.measured,
                        "predicted_cal_s": r.predicted_cal,
                        "error": r.error, "error_cal": r.error_cal}
                       for r in res.step_records],
           "regroup_events": res.regroup_events}
    checks = {"observed": bool(res.step_records),
              "fused_group_executed": any(len(r.job_ids) > 1
                                          for r in res.step_records)}
    return out, checks, lc


def cluster_phase(cfg, dev, tmp, sim_cfg_of=None):
    """Cluster control on the one card (``cluster/controller``, its chunk
    pumps, faults, the trace harness and the execution backend), on
    full-width tinyllama-1.1b with the "cuda" impl, block_t 128 and
    remat: (a) the three concurrency modes, (b) controller against the
    solo engine, (c) the overlapped regroup under live pumps beside a
    stop-the-world one, (d) the trace harness fault-free and under
    injected faults, (e) the execution-backed simulator.  Every part's
    kernel launches are held to its dispatched steps (a mixed layout's
    TRAIN_LAUNCHES, a uniform one's MASKED_LAUNCHES a step); returns the
    phase's totals."""
    t0 = time.perf_counter()
    part_s = {}

    def part(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        part_s[name] = time.perf_counter() - t
        return out

    modes, equal, lc_a = part("modes", cluster_modes, cfg, dev)
    solo, lc_b = part("solo", cluster_solo, cfg, dev)
    regroup, regroup_checks, lc_c = part("regroup", cluster_regroup, cfg, dev)
    trace, trace_checks, trace_info, lc_d = part("trace", cluster_trace, cfg,
                                                 dev, tmp)
    execution, exec_checks, lc_e = part("execution", cluster_execution, cfg,
                                        dev, sim_cfg_of)
    launches = {k: sum(lc[k] for lc in (lc_a, lc_b, lc_c, lc_d, lc_e))
                for k in lc_a}
    emit({"phase": "cluster", "model": cfg.name, "layers": cfg.num_layers,
          "stream": "every pump on the device's default stream",
          "modes": {"groups": [list(g) for g in CLUSTER_GROUPS],
                    "steps": CLUSTER_STEPS, "by_mode": modes,
                    "bit_equal_vs_sequential": equal},
          "controller_vs_solo_engine": solo,
          "regroup": {"target": REGROUP_TARGET, "by_mode": regroup,
                      "checks": regroup_checks},
          "trace": {**trace_info, "runs": trace, "checks": trace_checks},
          "execution": {**execution, "checks": exec_checks},
          "launches": launches, "seconds": time.perf_counter() - t0,
          "part_seconds": part_s, "card": card_line()})
    if not all(all(same.values()) for e in equal.values()
               for same in e.values()):
        raise AssertionError(f"cluster: modes differ from sequential: "
                             f"{equal}")
    if not all(solo["bit_equal"].values()):
        raise AssertionError(f"cluster: controller vs solo engine: {solo}")
    for name, checks in (("regroup", regroup_checks),
                         ("trace", trace_checks),
                         ("execution", exec_checks)):
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"cluster {name}: {failed}")
    return launches


# ----------------------------------------------------------- sharded
SHARDED_D = 2                  # gloo ranks sharing cuda:0
SHARDED_STEPS = 2              # steps a run, one at a time
# tinyllama-1.1b at full width cut to 4 of its 22 layers (cut first to 11
# to pay for the pipeline_mode phase, then to 6 for tp_serve and the
# dryrun line, then to 4 for tp_serve's fused vs solo check at model 8,
# inside the whole run's time; no check depends on the depth, launches
# follow it through ``pattern_launches``)
SHARDED_LAYERS = 4
SHARDED_GROUPS = {"train": TRAIN_RANKS,      # mixed ranks: ragged route
                  "uniform": UNIFORM_RANKS}  # uniform widths: masked route
SHARDED_RUNS = (               # (name, group, GroupRuntime options)
    ("gather", "train", {}),
    ("gather_n2_rank_desc", "train",
     {"nano_batches": 2, "nano_order": "rank_desc"}),
    ("psum", "train", {"grad_sync": "psum"}),
    ("uniform_gather", "uniform", {}),
    ("uniform_gather_n2", "uniform", {"nano_batches": 2}))
# Each run against the meshless run of the same group and seeds, on rank
# 0.  Every run: step 1's per-job losses at the CPU tests' bars
# (tests/torch_sharded_common.py: 1e-4 relative and absolute); step 1's
# adapter gradients, read as Adam's first moments after step 1 ((1 - b1)
# x the gradient, the same factor on both sides), within SHARD_GRAD_RTOL
# relative Frobenius difference for every leaf and job; Adam steps and
# steps done exactly.  Gather at N = 1 computes every adapter gradient
# as one device does (the same full-shape wgrads over the same rows) and
# is held to the CPU tests' bars over both steps as well: losses as
# above; adapters and Adam moments within 2.5e-2 and within 1e-5 for
# over 85% of the coordinates.  psum and N = 2 sum partial gradients
# (two ranks', two slices'), each rounded to bf16 where the Function
# returns it (the reference's rounding point), so their gradients carry
# a 2^-9 rounding of each partial: SHARD_GRAD_RTOL = 2^-6 sits 4x above
# the 2^-8 floor that leaves, while a step whose gradient misses half
# the batch or takes a wrong wgrad reads O(1) (the planted runs below
# show it).  Adam's second step turns those roundings into lr-sized
# moves of near-cancelling coordinates, so their step-2 losses are held
# as N = 1 vs N = 4 is (LOSS_ATOL) and their state is reported.
SHARD_LOSS_TOL, SHARD_STATE_ATOL, SHARD_BULK = 1e-4, 2.5e-2, 0.85
SHARD_GRAD_RTOL = 2.0 ** -6
# The check of the gradient limit itself: these runs are repeated for
# one step with rank 1's rows dropped from the gradient (its loss
# multiplied by 0: its forward, collectives and per-job losses stay),
# the fault of a step that leaves out half the batch; each must read
# above SHARD_GRAD_RTOL, or the phase fails.
SHARDED_PLANTED = ("psum", "gather_n2_rank_desc")


def _state_diff(a, b) -> dict:
    """Largest |a - b| over two trees' leaves and the smallest share of a
    leaf's coordinates within 1e-5 of the other tree's."""
    from repro_torch.optim.adamw import tree_leaves
    worst, bulk = 0.0, 1.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        d = (x.float() - y.float()).abs()
        worst = max(worst, d.max().item())
        bulk = min(bulk, (d < 1e-5).float().mean().item())
    return {"max_abs_diff": worst, "min_share_within_1e-5": bulk}


def _grad_rel(mu, mu_ref, layout) -> float:
    """The largest relative Frobenius difference of *mu* from *mu_ref*
    (step 1's Adam first moments) over every leaf and every job's packed
    columns."""
    import torch
    from repro_torch.core.lora import rank_axis_is_last
    from repro_torch.optim.adamw import tree_map
    rel = []

    def one(path, a, b):
        ax = a.dim() - 1 if rank_axis_is_last(path[-1]) else a.dim() - 2
        for k in range(layout.num_jobs):
            off, r = layout.slice_of(k)
            x, y = (t.narrow(ax, off, r).float() for t in (a, b))
            rel.append((x - y).norm() / y.norm().clamp_min(1e-30))
        return a
    tree_map(one, mu, mu_ref)
    return torch.stack(rel).max().item()


def vs_meshless(rt, mu1, solo, exact: bool) -> dict:
    """A sharded runtime against the meshless one (*solo*: its runtime
    and first moments after step 1) after the same steps; *mu1*: the
    sharded run's first moments after step 1.  Held at the bars of
    SHARDED_RUNS' comment (*exact*: also the CPU tests' over both
    steps)."""
    import numpy as np
    import torch
    solo_rt, solo_mu1 = solo
    got = np.stack(rt.report.per_job_losses)
    want = np.stack(solo_rt.report.per_job_losses)
    close = lambda a, b: bool(np.allclose(a, b, rtol=SHARD_LOSS_TOL,
                                          atol=SHARD_LOSS_TOL))
    out = {"bars": "cpu tests" if exact else
           "step 1 and gradients; step 2's losses within LOSS_ATOL",
           "loss_abs_diff_per_step": np.abs(got - want).max(1).tolist(),
           "step1_loss_ok": close(got[0], want[0]),
           "loss_ok": (close(got, want) if exact else
                       bool(np.abs(got - want).max() <= LOSS_ATOL)),
           "step1_grad_rel": _grad_rel(mu1, solo_mu1, rt.ssm.layout),
           "adam_step_equal": torch.equal(rt.opt_state.step,
                                          solo_rt.opt_state.step),
           "steps_done_equal": rt.steps_done == solo_rt.steps_done}
    out["grad_ok"] = out["step1_grad_rel"] <= SHARD_GRAD_RTOL
    ok = [out[k] for k in ("step1_loss_ok", "loss_ok", "grad_ok",
                           "adam_step_equal", "steps_done_equal")]
    for part, x, y in (("adapters", rt.adapters, solo_rt.adapters),
                       ("adam_mu", rt.opt_state.mu, solo_rt.opt_state.mu),
                       ("adam_nu", rt.opt_state.nu, solo_rt.opt_state.nu)):
        d = _state_diff(x, y)
        if exact:
            d["ok"] = (d["max_abs_diff"] <= SHARD_STATE_ATOL
                       and d["min_share_within_1e-5"] > SHARD_BULK)
            ok.append(d["ok"])
        out[part] = d
    out["ok"] = all(ok)
    return out


def _first_moments(rt):
    from repro_torch.optim.adamw import tree_map
    return tree_map(lambda _, t: t.detach().clone(), rt.opt_state.mu)


def planted_half_batch(rank, make_rt, solo) -> dict:
    """One step of a fresh runtime from *make_rt* with rank 1's rows
    dropped from the gradient (its loss x 0), read as vs_meshless reads
    step 1's gradients; every rank takes the step (the collectives must
    pair)."""
    from repro_torch.models import model as M
    loss_fn = M.loss_fn

    def dropped(*a, **kw):
        total, aux = loss_fn(*a, **kw)
        return total * 0.0, aux
    rt = make_rt()
    rt.warm([1])
    if rank == 1:
        M.loss_fn = dropped
    try:
        rt.run(1)
    finally:
        M.loss_fn = loss_fn
    if solo is None:
        return {}
    rel = _grad_rel(_first_moments(rt), solo[1], rt.ssm.layout)
    return {"step1_grad_rel": rel, "caught": rel > SHARD_GRAD_RTOL}


def sharded_runs(rank, mesh, cfg, params, dev, runs) -> dict:
    """One rank's part of the sharded phase: trains each of *runs* for
    SHARDED_STEPS steps through ``GroupRuntime(mesh=...)`` from the
    seeds every rank shares, its launch counts read around the run and
    held to the layer pattern x N.  Rank 0 first trains the meshless run
    of each group with the same seeds and holds every sharded run
    against it; on more than one rank, the SHARDED_PLANTED runs are
    repeated with a planted fault that the gradient limit must catch.
    The first run's second step is profiled on rank 0 (every rank takes
    it as a step of its own: the collectives must pair).  Raises on a
    failed check, after emitting what it measured."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core.ssm import SharedSuperModel
    from repro_torch.elastic.runtime import GroupRuntime
    kw = dict(lr=TRAIN_LR, impl="cuda", block_t=TRAIN_BLOCK_T,
              chunk_size=SHARDED_STEPS, remat=True, seed=0, device=dev)
    groups, solos = {}, {}
    for g in {grp for _, grp, _ in runs}:
        specs = train_specs(SHARDED_GROUPS[g], prefix=f"shard-{g}")
        layout = SharedSuperModel(cfg, specs, block_t=TRAIN_BLOCK_T).layout
        groups[g] = (specs, train_adapters(cfg, SHARDED_GROUPS[g], layout,
                                           dev))
        # every rank trains it (rank 0 holds the runs against it): a
        # spawned process's first steps on the card are slow (PERF.md
        # §7), and are taken here at once on every rank
        solo = GroupRuntime.from_specs(cfg, specs, params=params,
                                       adapters=groups[g][1], **kw)
        solo.run(1)
        mu1 = _first_moments(solo)
        solo.run(SHARDED_STEPS - 1)
        solos[g] = (solo, mu1)
    dist.barrier()
    out = {"rank": rank, "world": dist.get_world_size(),
           "backend": dist.get_backend(), "runs": {}}
    failed = []
    for i, (name, grp, opts) in enumerate(runs):
        specs, adapters = groups[grp]

        def make_rt():
            return GroupRuntime.from_specs(cfg, specs, params=params,
                                           adapters=adapters, mesh=mesh,
                                           **dict(kw, **opts))
        rt = make_rt()
        rt.warm([1])
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        prof, mu1 = {}, {}

        def steps():
            rt.run(1)
            if rank == 0:
                mu1["mu"] = _first_moments(rt)
            for k in range(1, SHARDED_STEPS):
                if i == 0 and rank == 0 and k == SHARDED_STEPS - 1:
                    prof["one_step"] = profile_run(lambda: rt.run(1))
                else:
                    rt.run(1)
        t0 = time.perf_counter()
        _, launches = counted(steps)
        wall = time.perf_counter() - t0
        losses = np.stack(rt.report.per_job_losses)
        expect = pattern_launches(cfg, masked=grp == "uniform")
        res = {"group": grp, "ranks": list(SHARDED_GROUPS[grp]),
               "options": opts, "data_shards": rt.data_shards,
               "nano": rt.n, "per_step_per_job_loss": losses.tolist(),
               "step_times_s": rt.report.step_times, "wall_s": wall,
               "peak_device_memory_bytes": torch.cuda.max_memory_allocated(),
               "launches": launches,
               "expected_launches_per_step": {
                   k: v * rt.n for k, v in expect.items()}}
        if prof:
            res["profile_last_step"] = prof["one_step"]
        if rank == 0:
            res["vs_meshless"] = vs_meshless(
                rt, mu1["mu"], solos[grp],
                exact=rt.n == 1 and rt.grad_sync == "gather")
            if not res["vs_meshless"]["ok"]:
                failed.append(name)
        del rt
        if name in SHARDED_PLANTED and dist.get_world_size() > 1:
            res["planted_half_batch"] = planted_half_batch(
                rank, make_rt, solos.get(grp))
            if rank == 0 and not res["planted_half_batch"]["caught"]:
                failed.append(f"{name} (planted fault not caught)")
        out["runs"][name] = res
        check_launches(f"sharded {name} rank {rank}", launches,
                       SHARDED_STEPS, res["expected_launches_per_step"])
        if not np.isfinite(losses).all():
            raise AssertionError(f"sharded {name}: losses {losses}")
        torch.cuda.empty_cache()
    if failed:
        emit({"phase": "sharded_rank_failed", **out})
        raise AssertionError(f"sharded runs {failed} fail their checks: "
                             + json.dumps({n: out["runs"][n.split()[0]].get(
                                 "vs_meshless") for n in failed}))
    return out


# ------------------------------------------------- the ranks' processes
# The multi-rank phases (sharded, cluster_sharded, pipeline_mode,
# tensor_parallel, tp_serve) run their gloo ranks in one pool of
# processes spawned once (ROADMAP A7): a fresh process pays its start,
# torch's import, its CUDA context and its first steps' lazy loads, ~20 s
# a phase; a pool process pays them once.  Each phase still joins a
# world of its own size on the pool's first processes (its rank
# function calls ``init_mesh`` and destroys the group at its end), the
# others wait for the next phase.
_POOL = [None]


def _rank_worker(index, tasks, done):
    """A pool process: runs each task ``(fn, args)`` as ``fn(index,
    *args)`` and reports (index, None) or (index, its traceback); after
    a failure it ends (its peers may be stuck in a collective: the pool
    is torn down)."""
    import gc
    import traceback
    import torch
    import torch.distributed as dist
    while True:
        task = tasks.get()
        if task is None:
            return
        fn, args = task
        try:
            fn(index, *args)
        except BaseException:
            done.put((index, traceback.format_exc()))
            return
        if dist.is_initialized():
            dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
        done.put((index, None))


class RankPool:
    """*n* spawned processes that run the multi-rank phases' rank
    functions in turn (``run``)."""

    def __init__(self, n: int):
        import torch.multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.tasks = [ctx.Queue() for _ in range(n)]
        self.done = ctx.Queue()
        self.procs = [ctx.Process(target=_rank_worker, daemon=True,
                                  args=(i, self.tasks[i], self.done))
                      for i in range(n)]
        for proc in self.procs:
            proc.start()

    def run(self, fn, args, nprocs: int) -> None:
        """``fn(rank, *args)`` on the first *nprocs* processes, joined;
        raises (and tears the pool down) if one raised or died."""
        import queue
        if nprocs > len(self.procs):
            raise ValueError(f"{nprocs} ranks from a pool of "
                             f"{len(self.procs)}")
        for i in range(nprocs):
            self.tasks[i].put((fn, args))
        waiting, errors = set(range(nprocs)), []
        while waiting:
            try:
                i, err = self.done.get(timeout=5.0)
            except queue.Empty:
                dead = [i for i in waiting if not self.procs[i].is_alive()]
                if dead:
                    errors.append(f"rank {dead[0]} died")
                    break
                continue
            waiting.discard(i)
            if err is not None:
                errors.append(f"rank {i} raised:\n{err}")
                break
        if errors:
            self.close()
            raise RuntimeError(f"{fn.__name__}: {errors[0]}")

    def close(self) -> None:
        for proc in self.procs:
            if proc.is_alive():
                proc.terminate()
        for proc in self.procs:
            proc.join(10)
        if _POOL[0] is self:
            _POOL[0] = None


@contextlib.contextmanager
def rank_pool(n: int):
    """Within: the multi-rank phases run their ranks in one pool of *n*
    processes (``run_ranks``); closed on the way out."""
    _POOL[0] = RankPool(n)
    try:
        yield
    finally:
        if _POOL[0] is not None:
            for q in _POOL[0].tasks:
                q.put(None)
            _POOL[0].close()


def run_ranks(fn, args, nprocs: int) -> None:
    """``fn(rank, *args)`` for ranks 0 .. nprocs - 1 in the open pool's
    processes (``rank_pool``), or in a pool of their own."""
    if _POOL[0] is not None:
        _POOL[0].run(fn, args, nprocs)
        return
    with rank_pool(nprocs):
        _POOL[0].run(fn, args, nprocs)


def sharded_cfg(cfg):
    """*cfg* (tinyllama-1.1b) at full width, cut to SHARDED_LAYERS."""
    import dataclasses
    return dataclasses.replace(cfg, num_layers=SHARDED_LAYERS)


def sharded_rank(rank, world, init_method, src, out_path):
    """A spawned gloo rank of the sharded phase's case (a): joins the
    world, builds tinyllama-1.1b (``sharded_cfg``) from seed 0 on the one
    card and runs ``sharded_runs``; writes its results to *out_path* %
    rank.  Anything that fails raises, and the parent fails with it."""
    sys.path.insert(0, src)
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_mesh
    from repro_torch.models import model as M
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mesh = init_mesh(rank, world, init_method, "gloo")
    cfg = sharded_cfg(get_config("tinyllama-1.1b"))
    out = sharded_runs(rank, mesh, cfg, M.init_model(cfg, seed=0,
                                                      device=dev),
                       dev, SHARDED_RUNS)
    with open(out_path % rank, "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def sharded_phase(src, cfg, dev):
    """Case (a): SHARDED_D gloo ranks spawned onto cuda:0 run
    SHARDED_RUNS; case (b): this process joins a one-rank NCCL world
    (NCCL's init and collectives on the card) and runs the gather mode;
    both on *cfg* cut to SHARDED_LAYERS, its weights drawn from seed 0.
    Ranks sharing one card measure no multi-GPU scaling: their walls
    include each other's kernels and the gloo copies through the host.
    Returns the launches of every rank of both cases, summed."""
    import gc
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_mesh
    from repro_torch.models import model as M
    cfg = sharded_cfg(cfg)
    # hand the earlier phases' cached blocks back to the card: the ranks
    # are other processes and allocate beside this one
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="sharded-", dir=os.path.join(ROOT,
                                                               "build"))
    cases = {}
    t0 = time.perf_counter()
    out_path = os.path.join(tmp, "%d.json")
    run_ranks(sharded_rank, (
        SHARDED_D, f"file://{os.path.join(tmp, 'gloo')}", src, out_path),
        SHARDED_D)
    ranks = []
    for r in range(SHARDED_D):
        with open(out_path % r) as f:
            ranks.append(json.load(f))
    cases["gloo_shared_card"] = {"seconds": time.perf_counter() - t0,
                                 "ranks": ranks}
    t0 = time.perf_counter()
    mesh = init_mesh(0, 1, f"file://{os.path.join(tmp, 'nccl')}", "nccl",
                     device_type="cuda")
    try:
        one = sharded_runs(0, mesh, cfg, M.init_model(cfg, seed=0,
                                                      device=dev),
                           dev, SHARDED_RUNS[:1])
    finally:
        dist.destroy_process_group()
    cases["nccl_one_rank"] = {"seconds": time.perf_counter() - t0,
                              "ranks": [one]}
    shutil.rmtree(tmp, ignore_errors=True)
    launches = {}
    for case, c in cases.items():
        for res in c["ranks"]:
            for run in res["runs"].values():
                for k, v in run["launches"].items():
                    launches[k] = launches.get(k, 0) + v
        # every rank holds the same replicated trajectory
        for name in c["ranks"][0]["runs"]:
            first = c["ranks"][0]["runs"][name]["per_step_per_job_loss"]
            for res in c["ranks"][1:]:
                if res["runs"][name]["per_step_per_job_loss"] != first:
                    raise AssertionError(f"sharded {case} {name}: ranks "
                                         "report different losses")
    emit({"phase": "sharded", "model": cfg.name,
          "layers": cfg.num_layers, "steps_a_run": SHARDED_STEPS,
          "groups": {g: [{"rank": r, "batch_size": TRAIN_BATCH,
                          "seq_len": TRAIN_SEQ} for r in ranks]
                     for g, ranks in SHARDED_GROUPS.items()},
          "block_t": TRAIN_BLOCK_T, "step1_grad_rtol": SHARD_GRAD_RTOL,
          "note": "ranks share one H100: no time here is a multi-GPU "
                  "number",
          "cases": cases, "launches": launches, "card": card_line()})
    return launches



# ------------------------------------------------------ cluster_sharded
# The multi-device controller: CLUSTER_GROUPS at TRAIN_BATCH x TRAIN_SEQ
# on two 2-rank slices of CS_RANKS gloo ranks spawned onto cuda:0 (NCCL
# refuses two ranks on one device), full-width tinyllama-1.1b cut to
# CS_LAYERS of its 22 layers, "cuda", block_t 128, remat, every rank
# building the same controller (cluster/controller's SPMD design).  Steps
# are few: a gloo gather step moves x and dy through host memory (the
# sharded phase: 5.36 s a step on two ranks), so each part runs one or
# two.  The depth was cut (to 11, for the pipeline_mode phase; then to
# 4, for tp_serve and the dryrun line; then to 2, for tp_serve's fused vs
# solo check at model 8) inside the whole run's time;
# no check depends on it (launches are scaled to the depth by
# ``chunk_tally``).
CS_RANKS = 4
CS_LAYERS = 2
CS_STEPS = 2             # (a)/(b): threads and sequential, one chunk
CS_STAGE = 1             # (c): steps of each repartition stage
CS_DEATH = (2, 3)        # (d): worker_death at step 2 in flight, budget 3
CS_LOSS = (1, 2)         # (e): submesh_loss at step 1, budget 2


def _cs_decisions(ctl) -> dict:
    """What every rank of the pool must agree on (times excluded)."""
    return {"devices": sorted([list(g), list(d)]
                              for g, d in ctl.group_devices().items()),
            "regroups": [[ev.mode, ev.groups_built, ev.groups_dissolved,
                          sorted(ev.fence_steps.items())]
                         for ev in ctl.regroup_log],
            "failures": [[r.kind, list(r.gkey), sorted(r.steps_lost.items()),
                          sorted(r.restored_from_checkpoint),
                          sorted(r.restarted_fresh),
                          list(r.quarantined_devices)]
                         for r in ctl.failure_log],
            "quarantined": sorted(ctl.quarantined),
            "finished": sorted(ctl.finished)}


def _cs_mine(ctl):
    """This rank's group of *ctl* and its runtime (None, None if the rank
    runs none)."""
    for g, slot in ctl._slots.items():
        if slot.engine is not None:
            return g, slot.runtime(g)
    return None, None


def _cs_job_diff(a, b) -> dict:
    """Two JobTrainStates at the CPU tests' bars: the largest |a - b| of
    adapter and Adam moments, the smallest share within 1e-5, and the
    Adam step and step count."""
    worst, bulk = 0.0, 1.0
    for part in ("adapter", "mu", "nu"):
        x, y = getattr(a, part), getattr(b, part)
        for k in x:
            d = (x[k].float() - y[k].float()).abs()
            worst = max(worst, d.max().item())
            bulk = min(bulk, (d < 1e-5).float().mean().item())
    return {"max_abs_diff": worst, "min_share_within_1e-5": bulk,
            "opt_step": [a.opt_step, b.opt_step],
            "steps_done": [a.steps_done, b.steps_done],
            "ok": bool(worst <= SHARD_STATE_ATOL and bulk > SHARD_BULK
                       and a.opt_step == b.opt_step
                       and a.steps_done == b.steps_done)}


def _cs_losses(ctl, gkey, job):
    """Per-step losses of *job* in group *gkey*, its first rank's."""
    rt = ctl._slots[gkey].runtime(gkey)
    mine = [float(l[gkey.index(job)]) for l in rt.report.per_job_losses] \
        if rt is not None else None
    return ctl.first_rank_value(gkey, mine)


def cluster_sharded_runs(rank, cfg, dev, ckpt_dir) -> dict:
    """One rank's part of the cluster_sharded phase.  Every rank builds
    each controller and calls the same methods in the same order:
    (a) CLUSTER_GROUPS on two 2-rank slices, sequential and threads,
    CS_STEPS steps each, bit-equal; (b) the same groups through the
    meshless controller (``partition=False``: every rank runs both
    groups whole), each slice's group within the CPU tests' bars of it;
    (c) a repartition 2+2 -> 4 -> 2+2, CS_STAGE steps a stage, against
    the threads run carried on to the same step (no repartition): every
    job at the CPU bars, steps and Adam steps exact; (d) a worker death
    in flight in the mixed group, replay-exact, no job lost; (e) a lost
    submesh, its ranks never used again.  Every rank's launches held to
    its dispatched steps.  Raises on a failed check, after emitting."""
    import numpy as np
    import torch
    from repro_torch.cluster.faults import FaultPlan, FaultSpec
    from repro_torch.models import model as M
    params = M.init_model(cfg, seed=0, device=dev)
    groups = [tuple(f"s{r}" for r in g) for g in CLUSTER_GROUPS]
    jobs = [j for g in groups for j in g]
    rank_of = {f"s{r}": r for g in CLUSTER_GROUPS for r in g}
    ga, gb = groups               # gb: the mixed (ragged) group

    def make(conc, budget=10_000, chunk=CS_STEPS, **kw):
        ctl = cluster_controller(cfg, dev, concurrency=conc,
                                 chunk_size=chunk, **kw)
        ctl._backbones[cfg.name] = params       # one backbone a rank
        for j in jobs:
            ctl.submit(cluster_spec(j, rank_of[j], budget))
        return ctl

    out = {"rank": rank, "decisions": {}}
    checks, walls = {}, {}
    # a spawned process's first steps on the card are slow (PERF.md §7):
    # every rank takes one meshless step of its slice's group first, at
    # once, outside the timed and counted parts
    from repro_torch.core.ssm import SharedSuperModel
    from repro_torch.elastic.runtime import GroupRuntime
    warm = [cluster_spec(f"warm{r}", r) for r in CLUSTER_GROUPS[rank // 2]]
    layout = SharedSuperModel(cfg, warm, block_t=TRAIN_BLOCK_T).layout
    GroupRuntime.from_specs(
        cfg, warm, params=params,
        adapters=train_adapters(cfg, [s.rank for s in warm], layout, dev),
        impl="cuda", block_t=TRAIN_BLOCK_T, lr=TRAIN_LR, remat=True,
        chunk_size=1, seed=0, device=dev).run(1)
    torch.cuda.reset_peak_memory_stats()

    def body():
        # (a) sequential and threads on two 2-rank slices
        runs = {}
        for conc in ("sequential", "threads"):
            ctl = make(conc)
            ctl.apply_grouping(groups, chips=[2, 2])
            g, rt = _cs_mine(ctl)
            rt.warm([CS_STEPS])
            ctl._barrier()
            t0 = time.perf_counter()
            ctl.run(CS_STEPS)
            walls[conc] = time.perf_counter() - t0
            runs[conc] = ctl
            out["decisions"][conc] = _cs_decisions(ctl)
        g, rt_s = _cs_mine(runs["sequential"])
        _, rt_t = _cs_mine(runs["threads"])
        out["group"], out["data_shards"] = list(g), rt_t.data_shards
        eq = _same_state(rt_s, rt_t)
        out["threads_vs_sequential_bit_equal"] = eq
        checks["threads_equal_sequential"] = all(eq.values())
        del runs["sequential"]
        # (b) the meshless controller on the same grouping
        ml = make("sequential", partition=False)
        ml.apply_grouping(groups, chips=[2, 2])
        t0 = time.perf_counter()
        ml.run(CS_STEPS)
        walls["meshless"] = time.perf_counter() - t0
        rt_m = ml._slots[g].runtime(g)
        got = np.stack(rt_t.report.per_job_losses)
        want = np.stack(rt_m.report.per_job_losses)
        vs = {"loss_max_abs_diff": float(np.abs(got - want).max()),
              "loss_ok": bool(np.allclose(got, want, rtol=SHARD_LOSS_TOL,
                                          atol=SHARD_LOSS_TOL)),
              "adam_step_equal": torch.equal(rt_t.opt_state.step,
                                             rt_m.opt_state.step)}
        for part, x, y in (("adapters", rt_t.adapters, rt_m.adapters),
                           ("adam_mu", rt_t.opt_state.mu, rt_m.opt_state.mu),
                           ("adam_nu", rt_t.opt_state.nu,
                            rt_m.opt_state.nu)):
            d = _state_diff(x, y)
            d["ok"] = (d["max_abs_diff"] <= SHARD_STATE_ATOL
                       and d["min_share_within_1e-5"] > SHARD_BULK)
            vs[part] = d
        out["partitioned_vs_meshless"] = vs
        checks["partitioned_vs_meshless"] = (
            vs["loss_ok"] and vs["adam_step_equal"]
            and all(vs[p]["ok"] for p in ("adapters", "adam_mu",
                                          "adam_nu")))
        del ml, rt_m
        # (c) repartition 2+2 -> 4 -> 2+2 against no repartition
        T = runs["threads"]
        rp = make("sequential", chunk=CS_STAGE)
        rp.apply_grouping(groups, chips=[2, 2])
        rp.run(CS_STAGE)
        losses = {j: list(_cs_losses(rp, gk, j)) for gk in groups
                  for j in gk}
        merged = ga + gb
        rp.apply_grouping([merged], chips=[4])
        merged_shards = rp.ensure_group(merged).data_shards
        t0 = time.perf_counter()
        rp.run(CS_STAGE)
        walls["merged_stage"] = time.perf_counter() - t0
        for j in jobs:
            losses[j] += _cs_losses(rp, merged, j)
        rp.apply_grouping(groups, chips=[2, 2])
        rp.run(CS_STAGE)
        for gk in groups:
            for j in gk:
                losses[j] += _cs_losses(rp, gk, j)
        extra = 3 * CS_STAGE - CS_STEPS
        prof = profile_run(lambda: T.run(extra)) if rank == 0 else None
        if rank != 0:
            T.run(extra)
        ref = {j: _cs_losses(T, gk, j) for gk in groups for j in gk}
        rep = {"merged_data_shards": merged_shards,
               "loss_max_abs_diff": max(
                   float(np.abs(np.subtract(losses[j], ref[j])).max())
                   for j in jobs),
               "losses": losses, "no_repartition_losses": ref,
               "regroup_events": rp.regroup_events,
               "jobs": {j: _cs_job_diff(rp.job_state(j), T.job_state(j))
                        for j in jobs}}
        rep["loss_ok"] = all(np.allclose(losses[j], ref[j],
                                         rtol=SHARD_LOSS_TOL,
                                         atol=SHARD_LOSS_TOL) for j in jobs)
        out["repartition"] = rep
        out["decisions"]["repartition"] = _cs_decisions(rp)
        checks["repartition"] = (rep["loss_ok"] and merged_shards == 4
                                 and rep["regroup_events"] >= 2
                                 and all(v["ok"]
                                         for v in rep["jobs"].values()))
        if prof is not None:
            out["profile_threads_step_rank0"] = prof
        del rp
        # (d) a worker death in flight in the mixed group
        at, budget = CS_DEATH
        plan = FaultPlan([FaultSpec("worker_death", job_id=gb[0],
                                    at_step=at, phase="inflight")])
        dd = os.path.join(ckpt_dir, "death")
        os.makedirs(dd, exist_ok=True)
        fc = make("threads", budget=budget, chunk=1, checkpoint_dir=dd,
                  checkpoint_every=1, fault_plan=plan, backoff_base_s=0.0,
                  stuck_after=None)
        fc.apply_grouping(groups, chips=[2, 2])
        t0 = time.perf_counter()
        fc.begin(until_budget=True)
        recs = []
        while not recs:
            recs += fc.supervise(reschedule=False)
            time.sleep(0.05)
        rec = recs[0]
        ckpt_step = min(fc._parked[j].steps_done for j in gb)
        fc.apply_grouping(groups, chips=[2, 2])
        while not all(fc._gather(all(w.done.is_set()
                                     for w in fc._workers.values()))):
            time.sleep(0.05)
        g_d, rt_d = _cs_mine(fc)
        post = np.stack(rt_d.report.per_job_losses)
        want = np.stack(rt_t.report.per_job_losses)
        ok_d = (bool(np.array_equal(post, want)) if g_d == ga else
                bool(np.allclose(post, want[ckpt_step:budget],
                                 rtol=SHARD_LOSS_TOL, atol=SHARD_LOSS_TOL)))
        fc.reap_completed()
        walls["worker_death"] = time.perf_counter() - t0
        steps = {j: fc.steps_done(j) for j in jobs}
        out["worker_death"] = {
            "kind": rec.kind, "gkey": list(rec.gkey),
            "restored_from_checkpoint": sorted(rec.restored_from_checkpoint),
            "steps_lost": rec.steps_lost, "checkpoint_step": ckpt_step,
            "replay_ok": ok_d, "finished": sorted(fc.finished),
            "steps": steps, "detect_latency_s": rec.detect_latency_s}
        out["decisions"]["worker_death"] = _cs_decisions(fc)
        checks["worker_death"] = (
            rec.kind == "worker_death" and tuple(rec.gkey) == gb and ok_d
            and sorted(rec.restored_from_checkpoint) == sorted(gb)
            and sorted(fc.finished) == sorted(jobs)
            and all(v == budget for v in steps.values()))
        del fc, T, rt_t, rt_s
        # (e) a lost submesh
        at, budget = CS_LOSS
        plan = FaultPlan([FaultSpec("submesh_loss", job_id=gb[0],
                                    at_step=at)])
        dl = os.path.join(ckpt_dir, "loss")
        os.makedirs(dl, exist_ok=True)
        lc = make("threads", budget=budget, chunk=1, checkpoint_dir=dl,
                  checkpoint_every=1, fault_plan=plan, backoff_base_s=0.0,
                  stuck_after=None)
        lc.apply_grouping(groups, chips=[2, 2])
        lost = set(lc.group_devices()[gb])
        t0 = time.perf_counter()
        lc.begin(until_budget=True)
        recs = []
        while not recs:
            recs += lc.supervise(reschedule=False)
            time.sleep(0.05)
        lc.apply_grouping(groups, chips=[2, 2])
        used_after = {i for d in lc.group_devices().values() for i in d}
        while not all(lc._gather(all(w.done.is_set()
                                     for w in lc._workers.values()))):
            time.sleep(0.05)
        lc.reap_completed()
        walls["submesh_loss"] = time.perf_counter() - t0
        steps = {j: lc.steps_done(j) for j in jobs}
        out["submesh_loss"] = {
            "kind": recs[0].kind, "lost_ranks": sorted(lost),
            "quarantined": sorted(lc.quarantined),
            "ranks_used_after": sorted(used_after),
            "finished": sorted(lc.finished), "steps": steps}
        out["decisions"]["submesh_loss"] = _cs_decisions(lc)
        checks["submesh_loss"] = (
            recs[0].kind == "submesh_loss" and lc.quarantined == lost
            and not used_after & lost
            and sorted(lc.finished) == sorted(jobs)
            and all(v == budget for v in steps.values()))
        del lc

    with chunk_tally(cfg.num_layers) as tally:
        _, launches = counted(body)
    out.update(walls_s=walls, checks=checks, launches=launches,
               dispatched_steps=dict(tally.steps),
               peak_device_memory_bytes=torch.cuda.max_memory_allocated())
    try:
        check_cluster_launches(f"cluster_sharded rank {rank}", launches,
                               tally)
        checks["launches"] = True
    except AssertionError as e:
        out["launch_error"] = str(e)
        checks["launches"] = False
    return out


def cluster_sharded_rank(rank, world, init_method, src, out_path, ckpt):
    """A spawned gloo rank of the cluster_sharded phase: joins the world
    on cuda:0 and runs ``cluster_sharded_runs``; writes its results to
    *out_path* % rank, then raises if a check failed."""
    sys.path.insert(0, src)
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_mesh
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    init_mesh(rank, world, init_method, "gloo")
    out = cluster_sharded_runs(rank, cs_cfg(get_config("tinyllama-1.1b")),
                               dev, ckpt)
    with open(out_path % rank, "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    failed = [k for k, ok in out["checks"].items() if not ok]
    if failed:
        raise AssertionError(f"cluster_sharded rank {rank}: {failed}")


def cs_cfg(cfg):
    """*cfg* (tinyllama-1.1b) at full width, cut to CS_LAYERS layers."""
    import dataclasses
    return dataclasses.replace(cfg, num_layers=CS_LAYERS)


def cluster_sharded_phase(src, cfg):
    """CS_RANKS gloo ranks spawned onto cuda:0 run the multi-device
    controller (``cluster_sharded_runs``) on *cfg* cut to CS_LAYERS; the
    parent holds every rank's decisions equal and emits the walls, rank
    0's idle share over one threads step, every rank's peak memory and
    launches.  The ranks share one H100, so no time here is a multi-GPU
    number.  Returns the launches of every rank, summed."""
    import gc
    cfg = cs_cfg(cfg)
    import tempfile
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="cluster-sharded-",
                           dir=os.path.join(ROOT, "build"))
    out_path = os.path.join(tmp, "%d.json")
    t0 = time.perf_counter()
    err = None
    try:
        run_ranks(cluster_sharded_rank, (
            CS_RANKS, f"file://{os.path.join(tmp, 'gloo')}", src, out_path,
            tmp), CS_RANKS)
    except Exception as e:            # emit what the ranks wrote first
        err = e
    ranks = []
    for r in range(CS_RANKS):
        if os.path.exists(out_path % r):
            with open(out_path % r) as f:
                ranks.append(json.load(f))
    seconds = time.perf_counter() - t0
    shutil.rmtree(tmp, ignore_errors=True)
    if len(ranks) < CS_RANKS:
        emit({"phase": "cluster_sharded_failed", "ranks_written":
              [r["rank"] for r in ranks], "by_rank": ranks})
        raise AssertionError(f"cluster_sharded: {len(ranks)} of {CS_RANKS} "
                             "ranks finished") from err
    same = all(r["decisions"] == ranks[0]["decisions"] for r in ranks[1:])
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    r0 = ranks[0]
    emit({"phase": "cluster_sharded", "model": cfg.name,
          "layers": cfg.num_layers, "ranks": CS_RANKS,
          "groups": [[{"rank": r, "batch_size": TRAIN_BATCH,
                       "seq_len": TRAIN_SEQ} for r in g]
                     for g in CLUSTER_GROUPS],
          "block_t": TRAIN_BLOCK_T, "steps": {"modes": CS_STEPS,
                                              "stage": CS_STAGE,
                                              "worker_death": CS_DEATH,
                                              "submesh_loss": CS_LOSS},
          "note": "the ranks share one H100: no time here is a multi-GPU "
                  "number",
          "seconds": seconds, "decisions_equal_on_every_rank": same,
          "decisions": r0["decisions"],
          "walls_s_by_rank": [r["walls_s"] for r in ranks],
          "rank0_idle_share_threads_step": r0.get(
              "profile_threads_step_rank0", {}).get("device_idle_share"),
          "profile_threads_step_rank0": r0.get("profile_threads_step_rank0"),
          "peak_device_memory_bytes_by_rank": [
              r["peak_device_memory_bytes"] for r in ranks],
          "by_rank": [{k: r[k] for k in (
              "rank", "group", "data_shards", "checks", "launches",
              "dispatched_steps", "threads_vs_sequential_bit_equal",
              "partitioned_vs_meshless", "worker_death", "submesh_loss")}
              for r in ranks],
          "repartition_rank0": {k: v for k, v in r0["repartition"].items()
                                if k not in ("losses",
                                             "no_repartition_losses")},
          "launches": launches, "card": card_line()})
    if not same:
        raise AssertionError("cluster_sharded: the ranks' decisions differ")
    if err is not None:
        raise err
    return launches


# -------------------------------------------------------- pipeline_mode
# Pipeline mode (tp_mode="pipeline"): full-width, full-depth
# tinyllama-1.1b cut into P = 2 stages of 11 layers, the train cell's
# jobs (4 x 512 tokens a job), PP_STEPS steps a run, "cuda", block_t 128,
# remat, gloo ranks spawned onto cuda:0.  (a) Two ranks, P = 2 x D = 1;
# (b) four, P = 2 x D = 2; (c) all eight, the (stage 2, data 2, model 2)
# mesh of ``make_local_mesh(model=2, stages=2)`` (ROADMAP A8d): each
# model index a replica of (b)'s pipeline, the replicas' adapters, Adam
# moments and losses bit-equal to one another and to (b)'s, each rank's
# resident backbone (b)'s.  Each run against the meshless run of its
# group with the same seeds (rank 0 trains it first, one step): step 1's
# per-job losses at SHARD_LOSS_TOL and step 1's adapter gradients (Adam's
# first moments, assembled whole over the stages) within SHARD_GRAD_RTOL
# per leaf and job, as the sharded phase reads them: a micro is a nano
# slice, whose gradients are summed from bf16 partials.  PP_PLANTED is
# rerun for one step with stage 1 zeroing micro 0's handoff, which must
# read above that limit.  Occupancy, launches a rank (its stage's 11
# layers x the pattern x N), every rank's losses and each rank's resident
# backbone bytes (PP_RESIDENT_CUT below the meshless run's) are asserted.
PP_RANKS = 8
PP_STAGES = 2
PP_STEPS = 2
PP_RUNS = (                    # (name, group, ranks, GroupRuntime options)
    ("gather_n2_rank_desc", "train", 2,
     {"nano_batches": 2, "nano_order": "rank_desc"}),
    ("gather_n4", "train", 2, {"nano_batches": 4}),
    ("uniform_gather_n2", "uniform", 2, {"nano_batches": 2}),
    ("gather_n2_d2", "train", 4, {"nano_batches": 2}),
    ("gather_n2_d2_m2", "train", 8, {"nano_batches": 2}))
PP_REPLICA_OF = {"gather_n2_d2_m2": "gather_n2_d2"}    # (c) and (b)
PP_WARM = 4                    # ranks that take the meshless steps
PP_PLANTED = "gather_n2_rank_desc"
PP_RESIDENT_CUT = 0.40


def _zero_first_receive():
    """A stand-in for ``launch/mesh.handoff`` that zeroes the first
    tensor this rank receives (stage 1: micro 0's activation)."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_mod
    real, seen = mesh_mod.handoff, [0]

    def handoff(t, group, src):
        out = real(t, group, src)
        if src != dist.get_rank():
            seen[0] += 1
            if seen[0] == 1:
                out.zero_()
        return out
    return real, handoff


def pipeline_mode_runs(rank, cfg, dev) -> dict:
    """One rank's part of the pipeline_mode phase: PP_RUNS through
    ``GroupRuntime(tp_mode="pipeline")`` from the seeds every rank
    shares, each held to the bars of the block comment above; rank 0's
    second step of the first run profiled.  Raises on a failed check,
    after returning what it measured to the caller's file."""
    import dataclasses
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core.ssm import SharedSuperModel
    from repro_torch.elastic.runtime import GroupRuntime
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import model as M
    params = M.init_model(cfg, seed=0, device=dev)
    kw = dict(lr=TRAIN_LR, impl="cuda", block_t=TRAIN_BLOCK_T, chunk_size=1,
              remat=True, seed=0, device=dev, tp_mode="pipeline",
              pipeline_stages=PP_STAGES)
    stage_cfg = dataclasses.replace(cfg,
                                    num_layers=cfg.num_layers // PP_STAGES)
    groups, solos = {}, {}
    for g in SHARDED_GROUPS:
        specs = train_specs(SHARDED_GROUPS[g], prefix=f"pipe-{g}")
        layout = SharedSuperModel(cfg, specs, block_t=TRAIN_BLOCK_T).layout
        groups[g] = (specs, train_adapters(cfg, SHARDED_GROUPS[g], layout,
                                           dev))
        # the first PP_WARM ranks take the meshless step (rank 0 holds
        # the runs against it): a spawned process's first step on the
        # card costs 13-16 s (PERF.md §7), paid here at once instead of
        # once a fresh rank in the timed runs; eight full-depth meshless
        # steps at once do not fit on one card
        if rank >= PP_WARM:
            continue
        solo = GroupRuntime.from_specs(
            cfg, specs, params=params, adapters=groups[g][1],
            **{k: v for k, v in kw.items()
               if k not in ("tp_mode", "pipeline_stages")})
        solo.run(1)
        solos[g] = (np.stack(solo.report.per_job_losses)[0],
                    _first_moments(solo), tree_bytes(solo.params))
        del solo
    torch.cuda.empty_cache()
    meshes = {2: mesh_mod.partition_mesh([2], stages=PP_STAGES)[0],
              4: mesh_mod.partition_mesh([4], stages=PP_STAGES)[0],
              8: mesh_mod.make_local_mesh(model=2, stages=PP_STAGES)}
    dist.barrier()
    out = {"rank": rank, "runs": {}}
    failed = []
    for i, (name, grp, n_ranks, opts) in enumerate(PP_RUNS):
        mesh = meshes[n_ranks]
        if mesh is None:              # not on this run's slice
            dist.barrier()
            continue
        specs, adapters = groups[grp]

        def make_rt():
            return GroupRuntime.from_specs(cfg, specs, params=params,
                                           adapters=adapters, mesh=mesh,
                                           **dict(kw, **opts))
        rt = make_rt()
        rt.warm([1])
        torch.cuda.reset_peak_memory_stats()
        for g in rt._sync_groups:
            dist.barrier(group=g)
        prof, mu1 = {}, {}

        def steps():
            rt.run(1)
            mu1["mu"] = rt.whole_state()[1].mu
            for k in range(1, PP_STEPS):
                if i == 0 and rank == 0 and k == PP_STEPS - 1:
                    prof["one_step"] = profile_run(lambda: rt.run(1))
                else:
                    rt.run(1)
        t0 = time.perf_counter()
        _, launches = counted(steps)
        wall = time.perf_counter() - t0
        losses = np.stack(rt.report.per_job_losses)
        m = rt.report.last_metrics
        N, P = rt.n, rt.pipeline_stages
        expect = {k: v * N for k, v in pattern_launches(
            stage_cfg, masked=grp == "uniform").items()}
        res = {"group": grp, "ranks": list(SHARDED_GROUPS[grp]),
               "options": opts, "stages": P, "data_shards": rt.data_shards,
               "stage": rt._stage_idx, "nano": N,
               "model_axis": list(rt.model_axis),
               "per_step_per_job_loss": losses.tolist(),
               "step_times_s": rt.report.step_times, "wall_s": wall,
               "peak_device_memory_bytes": torch.cuda.max_memory_allocated(),
               "resident_backbone_bytes": tree_bytes(rt.params),
               "pipe_useful_slots": int(m["pipe_useful_slots"]),
               "pipe_slots": int(m["pipe_slots"]),
               "launches": launches, "expected_launches_per_step": expect}
        res["occupancy_ok"] = (res["pipe_useful_slots"] == N * P
                               and res["pipe_slots"] == (N + P - 1) * P)
        if name in PP_REPLICA_OF or name in PP_REPLICA_OF.values():
            # the stage-local state's digest: the parent holds (c)'s
            # ranks to (b)'s at the same (stage, data) position
            mine = [rt.adapters, rt.opt_state.mu, rt.opt_state.nu]
            res["shard"] = rt._shard
            res["state_sha256"] = hashlib.sha256(
                _flat_state(mine).numpy().tobytes()).hexdigest()
        if name in PP_REPLICA_OF:
            # the model replicas of each (stage, data) rank: the same bits
            res["replicas_equal"] = _ranks_equal(mine,
                                                 group=mesh.model_group)
            if not res["replicas_equal"]:
                failed.append(f"{name} (model replicas differ)")
        if prof:
            res["profile_last_step"] = prof["one_step"]
        if rank == 0:
            want_loss, want_mu, solo_bytes = solos[grp]
            vs = {"step1_loss_abs_diff": float(np.abs(
                      losses[0] - want_loss).max()),
                  "step1_loss_ok": bool(np.allclose(
                      losses[0], want_loss, rtol=SHARD_LOSS_TOL,
                      atol=SHARD_LOSS_TOL)),
                  "step1_grad_rel": _grad_rel(mu1["mu"], want_mu,
                                              rt.ssm.layout),
                  "meshless_backbone_bytes": solo_bytes}
            vs["grad_ok"] = vs["step1_grad_rel"] <= SHARD_GRAD_RTOL
            vs["resident_ok"] = res["resident_backbone_bytes"] <= \
                (1 - PP_RESIDENT_CUT) * solo_bytes
            vs["ok"] = all(vs[k] for k in ("step1_loss_ok", "grad_ok",
                                           "resident_ok"))
            res["vs_meshless"] = vs
            if not vs["ok"]:
                failed.append(name)
        if not res["occupancy_ok"]:
            failed.append(f"{name} (occupancy)")
        del rt
        if name == PP_PLANTED:
            real, zeroing = _zero_first_receive()
            if res["stage"] == 1:
                mesh_mod.handoff = zeroing
            try:
                bad = make_rt()
                bad.run(1)
                mu = bad.whole_state()[1].mu
            finally:
                mesh_mod.handoff = real
            if rank == 0:
                rel = _grad_rel(mu, solos[grp][1], bad.ssm.layout)
                res["planted_zero_handoff"] = {
                    "step1_grad_rel": rel, "caught": rel > SHARD_GRAD_RTOL}
                if not res["planted_zero_handoff"]["caught"]:
                    failed.append(f"{name} (planted fault not caught)")
            del bad
        out["runs"][name] = res
        check_launches(f"pipeline_mode {name} rank {rank}", launches,
                       PP_STEPS, expect)
        if not np.isfinite(losses).all():
            raise AssertionError(f"pipeline_mode {name}: losses {losses}")
        torch.cuda.empty_cache()
        dist.barrier()
    out["failed"] = failed
    return out


def pipeline_mode_rank(rank, world, init_method, src, out_path):
    """A spawned gloo rank of the pipeline_mode phase: joins the world on
    cuda:0, runs ``pipeline_mode_runs`` and writes its results to
    *out_path* % rank, then raises if a check failed."""
    sys.path.insert(0, src)
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_mesh
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    init_mesh(rank, world, init_method, "gloo")
    out = pipeline_mode_runs(rank, get_config("tinyllama-1.1b"), dev)
    with open(out_path % rank, "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    if out["failed"]:
        raise AssertionError(f"pipeline_mode rank {rank}: {out['failed']}")


def pipeline_mode_phase(src, cfg):
    """PP_RANKS gloo ranks spawned onto cuda:0 run PP_RUNS
    (``pipeline_mode_runs``); the parent holds every rank's losses of a
    run equal and emits the walls, rank 0's idle share, every rank's peak
    memory, resident backbone bytes and launches.  The ranks share one
    H100: no time here is a multi-GPU number.  Returns the launches of
    every rank, summed."""
    import gc
    import tempfile
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="pipeline-mode-",
                           dir=os.path.join(ROOT, "build"))
    out_path = os.path.join(tmp, "%d.json")
    t0 = time.perf_counter()
    err = None
    try:
        run_ranks(pipeline_mode_rank, (
            PP_RANKS, f"file://{os.path.join(tmp, 'gloo')}", src, out_path),
            PP_RANKS)
    except Exception as e:            # emit what the ranks wrote first
        err = e
    ranks = []
    for r in range(PP_RANKS):
        if os.path.exists(out_path % r):
            with open(out_path % r) as f:
                ranks.append(json.load(f))
    seconds = time.perf_counter() - t0
    shutil.rmtree(tmp, ignore_errors=True)
    if len(ranks) < PP_RANKS:
        emit({"phase": "pipeline_mode_failed", "by_rank": ranks})
        raise AssertionError(f"pipeline_mode: {len(ranks)} of {PP_RANKS} "
                             "ranks finished") from err
    launches = {}
    for r in ranks:
        for run in r["runs"].values():
            for k, v in run["launches"].items():
                launches[k] = launches.get(k, 0) + v
    agree = {}
    for name, *_ in PP_RUNS:
        got = [r["runs"][name]["per_step_per_job_loss"] for r in ranks
               if name in r["runs"]]
        agree[name] = all(g == got[0] for g in got[1:])
    # (c)'s ranks against (b)'s at the same (stage, data) position: the
    # same losses, stage-local state bits and resident backbone
    replica_of = {}
    for name, model1 in PP_REPLICA_OF.items():
        by_pos = {(r["runs"][model1]["stage"], r["runs"][model1]["shard"]):
                  r["runs"][model1] for r in ranks if model1 in r["runs"]}
        replica_of[name] = [
            (lambda a, b: a["state_sha256"] == b["state_sha256"]
             and a["per_step_per_job_loss"] == b["per_step_per_job_loss"]
             and a["resident_backbone_bytes"] == b["resident_backbone_bytes"])
            (r["runs"][name], by_pos[(r["runs"][name]["stage"],
                                      r["runs"][name]["shard"])])
            for r in ranks]
    r0 = ranks[0]
    emit({"phase": "pipeline_mode", "model": cfg.name,
          "layers": cfg.num_layers, "stages": PP_STAGES,
          "layers_a_stage": cfg.num_layers // PP_STAGES,
          "steps_a_run": PP_STEPS,
          "groups": {g: [{"rank": k, "batch_size": TRAIN_BATCH,
                          "seq_len": TRAIN_SEQ} for k in rk]
                     for g, rk in SHARDED_GROUPS.items()},
          "block_t": TRAIN_BLOCK_T, "step1_grad_rtol": SHARD_GRAD_RTOL,
          "note": "the ranks share one H100: no time here is a multi-GPU "
                  "number",
          "seconds": seconds, "losses_equal_on_every_rank": agree,
          "model_replicas_equal_to_model_1_run": replica_of,
          "rank0_idle_share_step": r0["runs"][PP_RUNS[0][0]].get(
              "profile_last_step", {}).get("device_idle_share"),
          "by_rank": ranks, "launches": launches, "card": card_line()})
    if not all(agree.values()):
        raise AssertionError(f"pipeline_mode: ranks report different "
                             f"losses: {agree}")
    if not all(all(v) for v in replica_of.values()):
        raise AssertionError(f"pipeline_mode: the model replicas part from "
                             f"the model-1 run: {replica_of}")
    if err is not None:
        raise err
    return launches


# ------------------------------------------------------- tensor_parallel
# Tensor parallelism (tp_mode="auto") and the MoE over every mesh, on
# TP_RANKS gloo ranks sharing cuda:0: (a) tinyllama-1.1b at full width cut
# to 2 layers (it was 4: two paid for tp_serve in the run's time), data 1
# x model 2, the train group (ragged kernels, B9 on
# H/2 heads) and the uniform group (masked kernels); (b) qwen3-moe-30b-a3b
# at full width cut to 2 layers, data 1 x model 2 (64 of its 128 experts
# a rank), the capacity and the ragged dispatch; (c) qwen3-moe through
# tp_mode="dp" (data 2, gather) at 2 layers and "pipeline" (P = 2, N = 2)
# at 4.  Every rank first trains the meshless steps of each group (rank 0
# holds the runs against them; a fresh rank's first steps are the slow
# ones).  Each run: step 1's per-job losses within LOSS_ATOL of meshless;
# step 1's adapter gradients (Adam's first moments) per leaf and job,
# under "auto" against meshless within the larger of SHARD_GRAD_RTOL and
# twice the floor (``against_floor``: meshless against meshless with the
# adapters nudged by 2^-9, same run), since a row-parallel product's f32
# sum adds in another order than the whole product's and the rounding
# spreads through the norms (``tp_forward_probe``); under "dp" and
# "pipeline" within SHARD_GRAD_RTOL of the per-shard function they
# compute (``per_shard_step``: the MoE aux of each data shard or micro,
# ROADMAP C8); every rank's adapters bit-equal; launches a rank those of
# the cut config's pattern (a stage's under "pipeline"); and, where the
# backbone is split, its resident bytes at least TP_RESIDENT_CUT below
# meshless.  (d) The other families over the model axis (ROADMAP A8c), at
# full width and cut depth, data 1 x model 2, the train group:
# deepseek-v2-lite-16b at 2 layers (the dense layer and one MoE layer;
# MLA on 8 of 16 heads a rank, the latent computed whole), recurrentgemma
# -9b at 3 (one rglru, rglru, local_attn cycle; the one kv head shared),
# mamba2-2.7b, hubert-xlarge and internvl2-26b at 2 each; (e) the int8
# backbone over the model axis (A8b): tinyllama-1.1b at 2 layers and
# mamba2-2.7b at 2 (the first int8 training step of a recurrent family
# on the card), every base projection through B10, a row-parallel
# product's partials and a column-parallel product's dx partials from
# its f32 epilogue, summed over the axis before the one rounding; their
# meshless steps int8 too; (f) smollm-360m at full width (d 960, 15
# heads of 64 over 5 kv heads) cut to 2 layers: the axis of 2 would split
# its heads, so its attention runs whole on every rank and its MLP and
# vocab are cut.  Each of (d)-(f) meets the same bars.
# TP_PLANTED reruns a run for one step with a fault on its collective,
# which must read above the run's gradient limit: rank 1's partial of
# layer 0's first row-parallel product (wo) left out of its all-reduce
# (bf16, and int8: its codes zeroed); the SSD gated norm's sum of
# squares without rank 1's term; RG-LRU's gathered conv output with rank
# 1's block zeroed; MLA's latent without its cotangent summed over the
# axis (every rank's latent path then sees its own heads' cotangent
# only); smollm's whole attention's output zeroed on rank 1.
TP_RANKS = 2
TP_STEPS = 2
TP_AUTO = {"tp_mode": "auto"}
TP_INT8 = {"tp_mode": "auto", "quantize": "int8"}
TP_RUNS = (      # (name, arch, layers, moe_impl, group, GroupRuntime options)
    ("tl_train", "tinyllama-1.1b", 2, None, "train", TP_AUTO),
    ("tl_uniform", "tinyllama-1.1b", 2, None, "uniform", TP_AUTO),
    ("tl_int8", "tinyllama-1.1b", 2, None, "train", TP_INT8),
    ("ds_train", "deepseek-v2-lite-16b", 2, "ragged", "train", TP_AUTO),
    ("rg_train", "recurrentgemma-9b", 3, None, "train", TP_AUTO),
    ("mb_train", "mamba2-2.7b", 2, None, "train", TP_AUTO),
    ("mb_int8", "mamba2-2.7b", 2, None, "train", TP_INT8),
    ("hb_train", "hubert-xlarge", 2, None, "train", TP_AUTO),
    ("iv_train", "internvl2-26b", 2, None, "train", TP_AUTO),
    ("sm_train", "smollm-360m", 2, None, "train", TP_AUTO),
    ("moe_capacity", "qwen3-moe-30b-a3b", 2, "capacity", "train",
     {"tp_mode": "auto"}),
    ("moe_ragged", "qwen3-moe-30b-a3b", 2, "ragged", "train",
     {"tp_mode": "auto"}),
    ("moe_dp", "qwen3-moe-30b-a3b", 2, "ragged", "train", {"tp_mode": "dp"}),
    ("moe_pipeline", "qwen3-moe-30b-a3b", 4, "ragged", "train",
     {"tp_mode": "pipeline", "pipeline_stages": 2, "nano_batches": 2}))
TP_PLANTED = {"tl_train": "row_partial", "tl_int8": "row_partial",
              "mb_train": "ssd_norm", "rg_train": "rglru_u",
              "ds_train": "mla_latent", "sm_train": "whole_attn"}
TP_RESIDENT_CUT = 0.40


def tp_cfg(arch, layers, moe_impl=None):
    """A registry config at full width cut to *layers* layers."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    return dataclasses.replace(cfg, moe_impl=moe_impl) if moe_impl else cfg


def per_shard_step(cfg, params, specs, adapters, dev, parts: int = 2):
    """Step 1's (per-job losses, Adam first moments) of the function a
    data-parallel step over *parts* shards (or a pipeline over as many
    micros) computes, on one device: the meshless step's update over the
    job-wise halves of its first batch (``core/ssm._nano_index``: shard
    or micro i holds rows [i·r/parts, (i+1)·r/parts) of every job), each
    with the global denominators and its own MoE aux."""
    import torch
    from repro_torch.core.ssm import (SharedSuperModel, _nano_index,
                                      _per_job_token_counts)
    from repro_torch.data.pipeline import FusedBatcher
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import constant
    ssm = SharedSuperModel(cfg, specs, impl="cuda", block_t=TRAIN_BLOCK_T)
    fb = FusedBatcher(specs, cfg.vocab_size, block_t=TRAIN_BLOCK_T, seed=0)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in fb.next_batch().items()}
    idx = torch.as_tensor(_nano_index(fb.rows_per_job(), parts),
                          device=dev).reshape(parts, -1)
    slices = []
    for sel in idx:
        nb = {k: v.index_select(0, sel) for k, v in batch.items()}
        slices.append((nb, ssm.lora_ctx(nb["adapter_ids"])))
    denom = _per_job_token_counts(batch, len(specs), causal=cfg.causal)
    _, opt, m = ssm._update(params, adapters,
                            adamw.init(adapters, per_job=len(specs)), denom,
                            slices, constant(TRAIN_LR), True, 0.0)
    return m["per_job_loss"].cpu().numpy(), opt.mu


@contextlib.contextmanager
def tp_planted(kind: str, rank: int):
    """Within: the planted fault *kind* of ``TP_PLANTED`` on this rank.
    "row_partial": rank 1's partial of the first row-parallel product
    left out of its sum (its wo block zeroed for that call, an int8
    block's codes); "ssd_norm": rank 1's term of the SSD gated norm's
    sum of squares zeros; "rglru_u": RG-LRU's gathered conv output with
    rank 1's block zeroed, on every rank; "mla_latent": MLA's latent
    entering the rank's heads without its cotangent summed over the
    axis, on every rank; "whole_attn": rank 1's output of an attention
    that runs whole (the axis would split its heads) zeroed."""
    import torch
    from repro_torch.models import attention as A
    from repro_torch.models import mla, rglru, ssd
    from repro_torch.models import model as M
    from repro_torch.models.quant import QuantTensor
    seen = [0]

    def row_proj(tp, h, w, lora=None, ab=None, row_block=None):
        seen[0] += 1
        if seen[0] == 1:
            w = (QuantTensor(torch.zeros_like(w.q), w.scale)
                 if isinstance(w, QuantTensor) else torch.zeros_like(w))
        return real(tp, h, w, lora, ab, row_block)

    def gather_u(tp, u):
        g = real(tp, u)
        w = u.shape[-1]
        keep = torch.ones(g.shape[-1], dtype=g.dtype, device=g.device)
        keep[w:2 * w] = 0
        return g * keep
    mod, attr, fake = {
        "row_partial": (A, "row_proj", row_proj if rank == 1 else None),
        # zero terms that keep their graph: every rank's backward then
        # makes the same collectives
        "ssd_norm": (ssd, "_sum_squares", (lambda xf: real(xf) * 0)
                     if rank == 1 else None),
        "rglru_u": (rglru, "_gather_u", gather_u),
        "mla_latent": (mla, "_enter_latent", lambda tp, kv_a: kv_a),
        "whole_attn": (M, "attn_block", (lambda *a, **kw: (
            lambda o: (o[0] * 0, o[1]))(real(*a, **kw)))
            if rank == 1 else None)}[kind]
    real = getattr(mod, attr)
    if fake is not None:
        setattr(mod, attr, fake)
    try:
        yield
    finally:
        setattr(mod, attr, real)


def quant_launches(cfg) -> int:
    """B10's launches a training step of *cfg* with its backbone in int8
    (remat on): every quantized base projection once a forward pass (a
    scanned segment's twice), and once in the backward for its dx,
    except those of layer 0 that read the normed embedding (no gradient
    asked of it: attention's q, k, v; SSD's in-projection)."""
    from repro_torch.models import model as M
    per = {"attn": 4, "local_attn": 4, "ssd": 2}
    readers = {"attn": 3, "local_attn": 3, "ssd": 1}
    fwd = bwd = 0
    for seg in M.segment_plan(cfg):
        n = seg.repeats * sum(per[s.mixer] + 3 * (s.ffn == "swiglu")
                              for s in seg.specs)
        fwd += n * (2 if seg.scanned else 1)
        bwd += n
    return fwd + bwd - readers[M.layer_specs(cfg)[0].mixer]


def _flat_state(tree):
    """*tree*'s leaves flattened into one f32 host vector."""
    import torch
    from repro_torch.optim.adamw import tree_leaves
    leaves = [t for part in (tree if isinstance(tree, list) else [tree])
              for t in tree_leaves(part)]
    return torch.cat([t.detach().float().reshape(-1).cpu() for t in leaves])


def _ranks_equal(tree, group=None) -> bool:
    """Whether every rank (of *group*, default the world) holds the same
    bits of *tree* (a max and a min of its flattened leaves, on the
    host)."""
    import torch
    import torch.distributed as dist
    flat = _flat_state(tree)
    hi, lo = flat.clone(), flat.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
    return bool(torch.equal(hi, lo))


def tp_forward_probe(cfg, params, mesh, dev) -> dict:
    """Where a tensor-parallel forward parts from the meshless one, piece
    by piece on layer 0 of *cfg* (no adapters) at the train group's
    batch: this rank's block of each column-parallel product against
    the same columns of the whole product, the row-parallel products'
    f32 sum against the whole product, the vocab-split lookup and head,
    attention and the whole block.  For each: the share of elements
    that differ and the largest difference (every rank calls it: the
    pieces make the phase's collectives)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.data.pipeline import FusedBatcher
    from repro_torch.launch.mesh import model_group
    from repro_torch.models import model as M
    from repro_torch.models.attention import attn_block
    from repro_torch.models.layers import ModelAxis, dense, rms_norm
    from repro_torch.sharding.rules import shard_params
    tp = ModelAxis(*model_group(mesh))
    specs = train_specs(TRAIN_RANKS, prefix="probe")
    batch = FusedBatcher(specs, cfg.vocab_size, block_t=TRAIN_BLOCK_T,
                         seed=1).next_batch()
    tokens = torch.from_numpy(batch["tokens"]).to(dev)
    loc = shard_params(params, M.init_model(cfg, device="meta"), tp.size,
                       tp.index, cfg=cfg)
    first = lambda tree: M._tree_map(lambda v: v[0], tree)
    p, q = first(params["segments"][0]["0"]), first(loc["segments"][0]["0"])

    def diff(got, want):
        d = (got.float() - want.float()).abs()
        return {"differing": (d > 0).float().mean().item(),
                "max_abs": d.max().item()}
    out = {}
    with torch.no_grad():
        x = params["embed"][tokens.long()]
        out["embed"] = diff(M.embed_inputs(cfg, loc, {"tokens": tokens},
                                           tp=tp)[0], x)
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        for name, w, wl in (("wq", p["attn"]["wq"], q["attn"]["wq"]),
                            ("gate", p["ffn"]["gate"], q["ffn"]["gate"])):
            full = dense(h, w)
            out[f"column_{name}"] = diff(
                tp.column(h, wl), full[..., tp.block(full.shape[-1])])
        a = dense(h, p["attn"]["wq"])
        out["row_wo"] = diff(tp.row(a[..., tp.block(a.shape[-1])],
                                    q["attn"]["wo"]), dense(a, p["attn"]["wo"]))
        g = F.silu(dense(h, p["ffn"]["gate"]).float()).to(h.dtype) \
            * dense(h, p["ffn"]["up"])
        out["row_down"] = diff(tp.row(g[..., tp.block(g.shape[-1])],
                                      q["ffn"]["down"]),
                               dense(g, p["ffn"]["down"]))
        pos = torch.arange(h.shape[1], device=dev)[None].expand(
            h.shape[0], -1)
        spec = M.segment_plan(cfg)[0].specs[0]
        out["attention"] = diff(
            attn_block(cfg, q["attn"], h, positions=pos, tp=tp)[0],
            attn_block(cfg, p["attn"], h, positions=pos)[0])
        out["block"] = diff(
            M.apply_block(cfg, spec, q, {}, None, x, pos, None, None,
                          tp=tp)[0],
            M.apply_block(cfg, spec, p, {}, None, x, pos, None, None)[0])
        head = params["embed"].T if cfg.tie_embeddings else params["head"]
        full = dense(x, head)
        out["head"] = diff(M._logits(cfg, loc, x, tp=tp),
                           full[..., tp.block(full.shape[-1])])
    return out


def tensor_parallel_runs(rank, dev) -> dict:
    """One rank's part of the tensor_parallel phase: TP_RUNS through
    ``GroupRuntime`` from the seeds every rank shares, each held to the
    bars of the block comment above; rank 0's second step of the first
    run profiled.  Raises on a failed check, after returning what it
    measured to the caller's file."""
    import dataclasses
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core.ssm import SharedSuperModel
    from repro_torch.elastic.runtime import GroupRuntime
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import model as M
    kw = dict(lr=TRAIN_LR, impl="cuda", block_t=TRAIN_BLOCK_T, chunk_size=1,
              remat=True, seed=0, device=dev)
    meshes = {"auto": mesh_mod.make_local_mesh(model=TP_RANKS),
              "dp": mesh_mod.make_local_mesh(),
              "pipeline": mesh_mod.make_local_mesh(stages=TP_RANKS)}
    out = {"rank": rank, "runs": {}}
    failed = []
    held = {}                 # config key -> (cfg, params, references)
    for i, (name, arch, layers, impl, grp, opts) in enumerate(TP_RUNS):
        quantize = opts.get("quantize")
        key = (arch, layers, impl)
        if key not in held:
            held.clear()
            torch.cuda.empty_cache()
            cfg = tp_cfg(arch, layers, impl)
            params = M.init_model(cfg, seed=0, device=dev)
            held[key] = (cfg, params, {})
            if i == 0:
                out["forward_probe"] = tp_forward_probe(
                    cfg, params, meshes["auto"], dev)
        cfg, params, solos = held[key]
        ranks = SHARDED_GROUPS[grp]
        specs = train_specs(ranks, prefix=f"tp-{grp}")
        layout = SharedSuperModel(cfg, specs, block_t=TRAIN_BLOCK_T).layout
        adapters = train_adapters(cfg, ranks, layout, dev)
        mode = opts["tp_mode"]
        if rank > 0:              # rank 0 holds the runs against them
            solos.setdefault((grp, quantize), (None, None, None, 0.0))
            solos.setdefault((grp, "shards"), (None, None))
        if (grp, quantize) not in solos:
            # rank 0 takes the meshless steps and holds the runs (the
            # ranks share one card: two meshless steps of a wide vocab
            # at once, each with its whole f32 logits, do not fit)
            got = []
            for ad in (adapters, nudged(adapters, dev)):
                solo = GroupRuntime.from_specs(cfg, specs, params=params,
                                               adapters=ad,
                                               quantize=quantize, **kw)
                solo.run(1)
                got.append((np.stack(solo.report.per_job_losses)[0],
                            _first_moments(solo)))
            solos[(grp, quantize)] = (
                got[0][0], got[0][1], tree_bytes(solo.params),
                _grad_rel(got[1][1], got[0][1], layout))
            del solo
            torch.cuda.empty_cache()      # the other rank's steps need it
        if mode != "auto" and (grp, "shards") not in solos:
            solos[(grp, "shards")] = per_shard_step(cfg, params, specs,
                                                    adapters, dev)
        mesh = meshes[mode]

        def make_rt():
            return GroupRuntime.from_specs(cfg, specs, params=params,
                                           adapters=adapters, mesh=mesh,
                                           **dict(kw, **opts))
        rt = make_rt()
        rt.warm([1])
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        prof, mu1 = {}, {}

        def steps():
            rt.run(1)
            mu1["mu"] = rt.whole_state()[1].mu
            for k in range(1, TP_STEPS):
                if i == 0 and rank == 0 and k == TP_STEPS - 1:
                    prof["one_step"] = profile_run(lambda: rt.run(1))
                else:
                    rt.run(1)
        t0 = time.perf_counter()
        _, launches = counted(steps)
        wall = time.perf_counter() - t0
        losses = np.stack(rt.report.per_job_losses)
        P = rt.pipeline_stages
        expect = {k: v * rt.n for k, v in pattern_launches(
            dataclasses.replace(cfg, num_layers=layers // P),
            masked=grp == "uniform").items()}
        if quantize:
            expect["dequant_matmul_cuda"] = quant_launches(cfg)
        split = opts["tp_mode"] != "dp"
        res = {"arch": arch, "layers": layers, "moe_impl": impl,
               "group": grp, "ranks": list(ranks), "options": opts,
               "model_axis": list(rt.model_axis),
               "data_shards": rt.data_shards, "stages": P, "nano": rt.n,
               "per_step_per_job_loss": losses.tolist(),
               "step_times_s": rt.report.step_times, "wall_s": wall,
               "peak_device_memory_bytes": torch.cuda.max_memory_allocated(),
               "resident_backbone_bytes": tree_bytes(rt.params),
               "adapters_equal_on_every_rank": _ranks_equal(
                   rt.whole_state()[0]),
               "launches": launches, "expected_launches_per_step": expect}
        if prof:
            res["profile_last_step"] = prof["one_step"]
        if not res["adapters_equal_on_every_rank"]:
            failed.append(f"{name} (adapters differ across ranks)")
        want_loss, want_mu, solo_bytes, floor = solos[(grp, quantize)]
        if mode != "auto":        # the function over the shards or micros
            want_mu, floor = solos[(grp, "shards")][1], 0.0
        limit = against_floor(0.0, floor, SHARD_GRAD_RTOL)["limit"]
        if rank == 0:
            vs = {"step1_loss_abs_diff": float(np.abs(
                      losses[0] - want_loss).max()),
                  "grads_against": "meshless" if mode == "auto"
                  else "per_shard_step",
                  "step1_grad": against_floor(
                      _grad_rel(mu1["mu"], want_mu, rt.ssm.layout), floor,
                      SHARD_GRAD_RTOL),
                  "meshless_backbone_bytes": solo_bytes}
            if mode != "auto":
                vs["per_shard_loss_abs_diff"] = float(np.abs(
                    losses[0] - solos[(grp, "shards")][0]).max())
            vs["loss_ok"] = vs["step1_loss_abs_diff"] <= LOSS_ATOL
            # a vocab the axis does not divide (internvl2's 92,553) keeps
            # embedding and head whole on every rank, as the rules do;
            # at a cut depth they outweigh the layers, so the bar is
            # held on the rest (both sides' bytes without them)
            whole_vocab = 0
            if mode == "auto" and cfg.vocab_size % TP_RANKS:
                whole_vocab = tree_bytes([params["embed"],
                                          params.get("head", [])])
            vs["replicated_vocab_bytes"] = whole_vocab
            vs["resident_ok"] = (not split or
                                 res["resident_backbone_bytes"] - whole_vocab
                                 <= (1 - TP_RESIDENT_CUT)
                                 * (solo_bytes - whole_vocab))
            vs["ok"] = (vs["loss_ok"] and vs["step1_grad"]["ok"]
                        and vs["resident_ok"])
            res["vs_meshless"] = vs
            if not vs["ok"]:
                failed.append(name)
        del rt
        if name in TP_PLANTED:
            with tp_planted(TP_PLANTED[name], rank):
                bad = make_rt()
                bad.run(1)
                mu = bad.opt_state.mu
            if rank == 0:
                rel = _grad_rel(mu, want_mu, bad.ssm.layout)
                res["planted_fault"] = {
                    "kind": TP_PLANTED[name], "step1_grad_rel": rel,
                    "limit": limit, "caught": rel > limit}
                if not res["planted_fault"]["caught"]:
                    failed.append(f"{name} (planted fault not caught)")
            del bad
        out["runs"][name] = res
        check_launches(f"tensor_parallel {name} rank {rank}", launches,
                       TP_STEPS, expect)
        if not np.isfinite(losses).all():
            raise AssertionError(f"tensor_parallel {name}: losses {losses}")
        torch.cuda.empty_cache()
        dist.barrier()
    out["failed"] = failed
    return out


def tensor_parallel_rank(rank, world, init_method, src, out_path):
    """A spawned gloo rank of the tensor_parallel phase: joins the world
    on cuda:0, runs ``tensor_parallel_runs`` and writes its results to
    *out_path* % rank, then raises if a check failed."""
    sys.path.insert(0, src)
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_mesh
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    init_mesh(rank, world, init_method, "gloo")
    out = tensor_parallel_runs(rank, dev)
    with open(out_path % rank, "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    if out["failed"]:
        raise AssertionError(f"tensor_parallel rank {rank}: "
                             f"{out['failed']}")


def tensor_parallel_phase(src):
    """TP_RANKS gloo ranks spawned onto cuda:0 run TP_RUNS
    (``tensor_parallel_runs``); the parent holds every rank's losses of a
    run equal and emits the walls, rank 0's idle share, every rank's
    peak memory, resident backbone bytes and launches.  The ranks share
    one H100: no time here is a multi-GPU number.  Returns the launches
    of every rank, summed."""
    import gc
    import tempfile
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="tensor-parallel-",
                           dir=os.path.join(ROOT, "build"))
    out_path = os.path.join(tmp, "%d.json")
    t0 = time.perf_counter()
    err = None
    try:
        run_ranks(tensor_parallel_rank, (
            TP_RANKS, f"file://{os.path.join(tmp, 'gloo')}", src, out_path),
            TP_RANKS)
    except Exception as e:            # emit what the ranks wrote first
        err = e
    ranks = []
    for r in range(TP_RANKS):
        if os.path.exists(out_path % r):
            with open(out_path % r) as f:
                ranks.append(json.load(f))
    seconds = time.perf_counter() - t0
    shutil.rmtree(tmp, ignore_errors=True)
    if len(ranks) < TP_RANKS:
        emit({"phase": "tensor_parallel_failed", "by_rank": ranks})
        raise AssertionError(f"tensor_parallel: {len(ranks)} of {TP_RANKS} "
                             "ranks finished") from err
    launches = {}
    for r in ranks:
        for run in r["runs"].values():
            for k, v in run["launches"].items():
                launches[k] = launches.get(k, 0) + v
    agree = {}
    for name, *_ in TP_RUNS:
        got = [r["runs"][name]["per_step_per_job_loss"] for r in ranks]
        agree[name] = all(g == got[0] for g in got[1:])
    r0 = ranks[0]
    emit({"phase": "tensor_parallel", "ranks": TP_RANKS,
          "steps_a_run": TP_STEPS,
          "groups": {g: [{"rank": k, "batch_size": TRAIN_BATCH,
                          "seq_len": TRAIN_SEQ} for k in rk]
                     for g, rk in SHARDED_GROUPS.items()},
          "block_t": TRAIN_BLOCK_T, "step1_grad_rtol": SHARD_GRAD_RTOL,
          "step1_loss_atol": LOSS_ATOL,
          "note": "the ranks share one H100: no time here is a multi-GPU "
                  "number",
          "seconds": seconds, "losses_equal_on_every_rank": agree,
          "rank0_idle_share_step": r0["runs"][TP_RUNS[0][0]].get(
              "profile_last_step", {}).get("device_idle_share"),
          "by_rank": ranks, "launches": launches, "card": card_line()})
    if not all(agree.values()):
        raise AssertionError(f"tensor_parallel: ranks report different "
                             f"losses: {agree}")
    if err is not None:
        raise err
    return launches


# ------------------------------------------- tensor-parallel serving
# The tp_serve phase (ROADMAP A8a): the serve steps over a model axis,
# TPS_WORLD gloo ranks on cuda:0, against the meshless serve steps of
# the same seeded weights.  Each run prefills TPS_PROMPTS prompts of
# 16-200 tokens (two an adapter of the MIXED set: B1, and B9 in the
# prefill), right-padded to one width, each adapter's rows padded to
# TPS_ROWS (the engine's granule), then decodes from every row's last
# prompt token at its own position, greedy; the meshless serve,
# teacher-forced on those ids, gives the logits each step is held to.
#   (a) tinyllama-1.1b at full width and depth, data 1 x model 2 on
#       ranks 0-1 (the other ranks wait): prefill and TPS_DECODE decode
#       steps' logits within LOGIT_ATOL of meshless (teacher-forced);
#       fused vs solo ids exactly under the mesh (the TPS_SOLO_A adapter's
#       rows served alone, each adapter re-packed, every product on
#       TPS_ROWS rows (their tokens in the prefill): C1); the greedy ids
#       against meshless
#       recorded (first differing position); the rank's caches half the
#       meshless bytes; launches a rank (B1 once a projection a pass, B9
#       once a layer in the prefill).
#   (b) tinyllama-1.1b at full width cut to TPS_B_LAYERS, data 1 x model
#       8 over every rank: each of the 4 kv heads held by 2 ranks.  The
#       same checks, TPS_B_DECODE decode steps (caches a quarter of
#       meshless); fused vs solo needs the sums over the axis in row
#       blocks too (``ModelAxis.sum``: above m = 2 an all-reduce's order
#       follows the buffer's size).  Plus one train step of the train
#       cell's mixed group through GroupRuntime(tp_mode=
#       "auto"): step 1's adapter gradients against meshless within
#       max(SHARD_GRAD_RTOL, 2 x the 2^-9 nudge's floor), as
#       tensor_parallel holds "auto"; then the planted fault (each kv
#       head's cotangent from one replica, not the replicas' sum, on
#       every rank) must read above that limit.
#   (c) qwen3-moe-30b-a3b at full width cut to TPS_MOE_LAYERS, data 1 x
#       model 2 on ranks 0-1 (64 of 128 experts a rank): prefill and
#       TPS_MOE_DECODE decode steps within LOGIT_ATOL of the meshless
#       serve teacher-forced on the split's ids and experts (a row-
#       parallel sum's rounding can flip a token's top-k expert, and
#       that row's logits then move O(1): on an H100 2 of 8 requests,
#       0.74, unforced; recorded), the tokens whose experts flipped at
#       most twice the 2^-9 nudge's; a planted fault (rank 1's experts
#       left out of the sum) must read above LOGIT_ATOL.
#   (d)-(g) the other decoders over the model axis (ROADMAP A8c), each at
#       full width cut to its TPS_FAMILIES depth, data 1 x model 2 on
#       ranks 0-1: deepseek-v2-lite-16b (MLA's absorbed decode on 8 of
#       16 heads a rank, the latent cache whole; its MoE as (c), routes
#       forced), mamba2-2.7b (a rank's heads' SSD state, its channels'
#       conv tail), recurrentgemma-9b (RG-LRU's channels, the local
#       attention's one kv head shared) and internvl2-26b (text; its
#       vocab whole on every rank).  (a)'s checks, TPS_FAM_DECODE decode
#       steps, the TPS_SOLO_A adapter served alone, the caches the share
#       of the runtime cache specs (``tps_cache_share``).  The recurrent
#       mixers have no per-row position: there every prompt is
#       TPS_REC_PROMPT tokens, prefilled but its last, which the first
#       decode step takes at one shared position.
#   (h) smollm-360m at full width cut to 4 layers, data 1 x model 2 on
#       ranks 0-1: its 15 heads over 5 kv heads run whole on every rank
#       (the axis would split them), their caches whole; (a)'s checks.
TPS_WORLD = 8
TPS_PROMPTS = 8
TPS_ROWS = BLOCK_T
TPS_DECODE = 16               # decode steps of (a), (b) and (c)
TPS_B_DECODE = 4              # (eight ranks' collectives through the host)
TPS_MOE_DECODE = 8
TPS_B_LAYERS = 2
TPS_MOE_LAYERS = 2
TPS_SOLO = (0, 3)              # (b)'s adapters served alone: ranks 8, 64
TPS_SOLO_A = (3,)              # (a)'s (22 layers): rank 64
TPS_FAM_DECODE = 8
TPS_REC_PROMPT = 65
TPS_FAMILIES = (   # (part, arch, layers, moe_impl, recurrent)
    ("d", "deepseek-v2-lite-16b", 2, "ragged", False),
    ("e", "mamba2-2.7b", 2, None, True),
    ("f", "recurrentgemma-9b", 3, None, True),
    ("g", "internvl2-26b", 2, None, False),
    ("h", "smollm-360m", 4, None, False))


def tps_batch(cfg, dev, names, seed=3, width=None):
    """(tokens (B, S), adapter ids (B,), prompt lengths (B,)) of
    TPS_PROMPTS prompts of 16-200 tokens, two an adapter of *names*,
    adapter-major, each adapter's rows padded to TPS_ROWS (a pad row: one
    zero token), right-padded to one BLOCK_T-aligned width; with *width*
    every prompt (and pad row) is *width* tokens."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab_size, size=width or int(
        rng.integers(16, 201)), dtype=np.int32) for _ in range(TPS_PROMPTS)]
    per = TPS_PROMPTS // len(names)
    S = width or -(-max(len(p) for p in prompts) // BLOCK_T) * BLOCK_T
    B = TPS_ROWS * len(names)
    toks = np.zeros((B, S), np.int32)
    lens = np.full((B,), width or 1, np.int32)
    for k in range(len(names)):
        for j in range(per):
            p = prompts[k * per + j]
            toks[k * TPS_ROWS + j, :len(p)] = p
            lens[k * TPS_ROWS + j] = len(p)
    ids = np.repeat(np.arange(len(names), dtype=np.int32), TPS_ROWS)
    return (torch.from_numpy(toks).to(dev), torch.from_numpy(ids).to(dev),
            torch.from_numpy(lens).to(dev))


def tps_serve(cfg, specs, params, adapters, batch, mesh, steps, feed=None,
              row_block=None):
    """Prefill *batch* (``tps_batch``) through ``make_prefill_step(mesh=)``
    and decode *steps* tokens through ``make_serve_step(mesh=)`` (mesh
    None: meshless), greedy or fed *feed* (B, steps), the first from
    every row's last prompt token at its position; *row_block*: rows per
    decode product, and that many rows' tokens per prefill product.  A
    batch of prompts of one width (``tps_batch(width=)``) prefills all
    but its last token and decodes at one shared position (the recurrent
    mixers keep no per-row position).  Returns (prefill logits (B, V),
    decode logits (B, steps, V) f32, the ids chosen (B, steps), the
    caches)."""
    import torch
    from repro_torch.configs.base import InputShape
    from repro_torch.core.ssm import SharedSuperModel
    toks, ids, lens = batch
    ssm = SharedSuperModel(cfg, specs, impl="cuda", block_t=BLOCK_T)
    shape = InputShape("tp_serve", toks.shape[1] + steps, toks.shape[0],
                       "decode")
    shared = bool((lens == toks.shape[1]).all())
    pre = toks[:, :-1] if shared else toks
    lp, caches = ssm.make_prefill_step(shape, mesh=mesh)(
        params, adapters, {"tokens": pre, "adapter_ids": ids},
        row_block=row_block and row_block * pre.shape[1])
    step = ssm.make_serve_step(mesh=mesh)
    rows = torch.arange(toks.shape[0], device=toks.device)
    pos = toks.shape[1] - 1 if shared else (lens - 1).long()
    tok = toks[:, -1] if shared else toks[rows, pos]
    logits, chosen = [], []
    for t in range(steps):
        lg, _ = step(params, adapters, caches, {"tokens": tok[:, None],
                                                "adapter_ids": ids},
                     pos, row_block)
        logits.append(lg[:, 0].float())
        chosen.append(lg[:, 0].argmax(-1).to(torch.int32))
        tok = chosen[-1] if feed is None else feed[:, t]
        pos = pos + 1
    return (lp[:, 0].float(), torch.stack(logits, 1), torch.stack(chosen, 1),
            caches)


def tps_solo_adapters(adapters, layout, k):
    """Job *k*'s adapter alone, re-packed as a one-job group's."""
    from repro_torch.core.lora import (RankLayout, extract_adapter,
                                       merge_adapter_pair)
    lay = RankLayout((layout.ranks[k],), multiple=layout.multiple)

    def walk(t):
        if isinstance(t, dict) and set(t) == {"A", "B"}:
            return merge_adapter_pair([extract_adapter(t, layout, k)], lay)
        if isinstance(t, dict):
            return {kk: walk(v) for kk, v in t.items()}
        return [walk(v) for v in t]
    return walk(adapters)


@contextlib.contextmanager
def tps_routes(record=None, force=None):
    """Within: each call of ``models/moe.route`` appends its top-k experts
    (T, k) to the list *record*; with *force* (an earlier run's record,
    call by call) each call's experts are replaced by force's, their
    weights route's rule over this call's probabilities at them."""
    from repro_torch.models import moe
    real, calls = moe.route, iter(force or ())

    def route(cfg, params, xf):
        probs, top_w, top_i = real(cfg, params, xf)
        if force is not None:
            top_i = next(calls)
            top_w = probs.gather(-1, top_i)
            top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
        if record is not None:
            record.append(top_i)
        return probs, top_w, top_i
    moe.route = route
    try:
        yield
    finally:
        moe.route = real


def tps_flips(a, b) -> int:
    """Tokens whose expert set differs between two runs' routing records,
    over every call."""
    return sum(int((x.sort(-1).values != y.sort(-1).values).any(-1).sum())
               for x, y in zip(a, b))


@contextlib.contextmanager
def tps_drop_rank_experts(index):
    """Within: model rank *index*'s expert-parallel partial is zeros (a
    rank's experts left out of the sum: the planted fault of (c))."""
    from repro_torch.models import moe
    real = moe._expert_parallel_moe

    def dropped(*a, **kw):
        out = real(*a, **kw)
        return out * 0 if a[-1].index == index else out
    moe._expert_parallel_moe = dropped
    try:
        yield
    finally:
        moe._expert_parallel_moe = real


def tps_cache_share(cfg, caches, m: int) -> float:
    """The share of the whole *caches*' bytes a model rank holds under
    ``sharding/rules.runtime_cache_specs`` at data 1 x model *m*."""
    import math
    from repro_torch.sharding import rules
    sizes = {"data": 1, "model": m}
    specs = rules.runtime_cache_specs(sizes, caches, cfg)
    whole = loc = 0
    for seg_c, seg_s in zip(caches, specs):
        for k in seg_c:
            for t, spec in zip(seg_c[k], seg_s[k]):
                whole += t.numel() * t.element_size()
                loc += math.prod(rules.local_shape(tuple(t.shape), spec,
                                                   sizes)) * t.element_size()
    return loc / whole


def tps_part(cfg, params, mesh, dev, steps, solo=(), moe=False,
             width=None) -> tuple:
    """One serving part on *cfg* over *mesh* (every rank of *mesh* calls
    it): the meshless greedy serve (it warms the rank), the
    tensor-parallel greedy serve (counted, the decode products TPS_ROWS
    rows at a time), the meshless serve teacher-forced on its ids (the
    logits it is held to, within LOGIT_ATOL), and the adapters in *solo*
    served alone under the mesh.  With *moe* the teacher-forced serve
    takes the tensor-parallel serve's experts token by token
    (``tps_routes``): a row-parallel sum's rounding can flip a token's
    top-k expert, and that row's logits then move O(1), which is not the
    split's error; the flips are counted against the 2^-9 nudge's, and
    the unforced comparison is recorded.  Then the planted fault (model
    rank 1's experts left out, ``tps_drop_rank_experts``) must read above
    LOGIT_ATOL against its own forced serve.  *width*: every prompt that
    many tokens (``tps_batch``; the recurrent mixers).  Returns
    (readings, failed checks)."""
    import numpy as np
    import torch
    from repro_torch.core.jobs import LoRAJobSpec
    from repro_torch.core.ssm import SharedSuperModel
    from repro_torch.launch.mesh import model_group
    from repro_torch.models import model as M
    from repro_torch.models.layers import ModelAxis
    from repro_torch.sharding.rules import shard_params
    names = [f"tps{i}-r{r}" for i, r in enumerate(MIXED)]
    specs = [LoRAJobSpec(n, rank=r, batch_size=TPS_ROWS, seq_len=BLOCK_T)
             for n, r in zip(names, MIXED)]
    layout = SharedSuperModel(cfg, specs, block_t=BLOCK_T).layout
    adapters = train_adapters(cfg, MIXED, layout, dev)
    batch = tps_batch(cfg, dev, names, width=width)
    toks, _, lens = batch
    tp = ModelAxis(*model_group(mesh))
    local = shard_params(params, M.init_model(cfg, device="meta"), tp.size,
                         tp.index, cfg=cfg)
    serve = lambda p, ad, mesh_, feed=None: tps_serve(
        cfg, specs, p, ad, batch, mesh_, steps, feed=feed,
        row_block=TPS_ROWS)
    real = [k * TPS_ROWS + j for k in range(len(names))
            for j in range(TPS_PROMPTS // len(names))]

    def gap(got, want):
        """(B, 1 + steps) max |logit difference| a row and position."""
        return torch.cat([(got[0] - want[0]).abs().amax(-1, keepdim=True),
                          (got[1] - want[1]).abs().amax(-1)], 1)
    t0 = time.perf_counter()
    _, _, ml_ids, ml_c = serve(params, adapters, None)
    meshless_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    routes = []
    with tps_routes(record=routes):
        (tp_p, tp_d, ids, tp_c), launches = counted(
            lambda: serve(local, adapters, mesh))
    tp_s = time.perf_counter() - t0
    # the serve's high-water mark over its inputs (the dry run's
    # prediction is made apart, ``tps_dry_prediction``)
    inputs = tree_bytes([local, adapters, list(batch)])
    peak = torch.cuda.max_memory_allocated() - held + inputs
    tf_routes = []
    with tps_routes(record=tf_routes):
        tf = serve(params, adapters, None, feed=ids)
    d_pos = gap((tp_p, tp_d), tf)                            # (B, 1+steps)
    diff = (ids[real] != ml_ids[real]).cpu().numpy()
    first = [int(np.argmax(r)) if r.any() else None for r in diff]
    n_proj = sum(len(s.lora_targets) for s in M.layer_specs(cfg))
    want = dict({w.__name__: 0 for w in lora_wrappers()},
                ragged_lora_fwd=n_proj * (1 + steps),
                flash_attention_fwd=sum(s.mixer in ("attn", "mla")
                                        for s in M.layer_specs(cfg)))
    whole = M.whole_mixers(cfg, tp.size)
    out = {"layers": cfg.num_layers, "model_axis": [tp.size, tp.index],
           "whole_mixers": list(whole),
           "kv_heads_a_rank": (cfg.num_kv_heads if "attn" in whole
                               else tp.kv_local(cfg.num_kv_heads)),
           "rows": int(toks.shape[0]), "prompt_width": int(toks.shape[1]),
           "prompt_lens": lens[real].tolist(), "decode_steps": steps,
           "greedy_ids_equal_meshless": not diff.any(),
           "first_differing_position_by_request": first,
           "cache_bytes": tree_bytes(tp_c),
           "meshless_cache_bytes": tree_bytes(ml_c),
           "launches": launches, "launches_expected": want,
           "meshless_serve_s": meshless_s, "tp_serve_s": tp_s,
           "serve_peak_bytes_measured": peak}
    out["cache_share"] = out["cache_bytes"] / out["meshless_cache_bytes"]
    out["cache_share_expected"] = tps_cache_share(cfg, ml_c, tp.size)
    failed = []
    if moe:
        out["unforced_max_abs_diff"] = d_pos.max().item()
        out["unforced_rows_over_logit_atol"] = int(
            (d_pos[real] > LOGIT_ATOL).any(1).sum())
        with tps_routes(force=routes):
            d_pos = gap((tp_p, tp_d), serve(params, adapters, None,
                                            feed=ids))
        nudge_routes = []
        with tps_routes(record=nudge_routes):
            serve(params, nudged(adapters, dev), None, feed=ids)
        flips = {"split": tps_flips(routes, tf_routes),
                 "nudge": tps_flips(nudge_routes, tf_routes),
                 "tokens": sum(r.shape[0] for r in routes)}
        out["routing_flips"] = flips
        if flips["split"] > 2 * flips["nudge"]:
            failed.append(f"routing flips {flips}")
        bad_routes = []
        with tps_drop_rank_experts(1), tps_routes(record=bad_routes):
            bad = serve(local, adapters, mesh)
        with tps_routes(force=bad_routes):
            bad_gap = gap(bad[:2], serve(params, adapters, None,
                                         feed=bad[2])).max().item()
        out["planted_rank1_experts_dropped"] = {
            "max_abs_diff": bad_gap, "caught": bad_gap > LOGIT_ATOL}
        if not out["planted_rank1_experts_dropped"]["caught"]:
            failed.append("planted expert fault not caught")
    out.update({
        "logits": against_floor(d_pos.max().item(), 0.0, LOGIT_ATOL),
        "prefill_max_abs_diff": d_pos[:, 0].max().item(),
        "decode_max_abs_diff_by_step": d_pos[:, 1:].amax(0).tolist(),
        "rows_over_logit_atol": int((d_pos[real] > LOGIT_ATOL).any(1)
                                    .sum())})
    if not out["logits"]["ok"]:
        failed.append("logits vs meshless")
    if out["cache_share"] != out["cache_share_expected"]:
        failed.append(f"cache share {out['cache_share']}")
    if launches != want:
        failed.append(f"launches {launches} != {want}")
    if solo:
        same = []
        for k in solo:
            sel = slice(k * TPS_ROWS, (k + 1) * TPS_ROWS)
            alone = (toks[sel], torch.zeros_like(batch[1][sel]), lens[sel])
            got = tps_serve(cfg, [specs[k]], local,
                            tps_solo_adapters(adapters, layout, k), alone,
                            mesh, steps, row_block=TPS_ROWS)[2]
            n = TPS_PROMPTS // len(names)
            same.append(bool(torch.equal(got[:n], ids[sel][:n])))
        out["fused_vs_solo_ids_equal"] = dict(zip(map(str, solo), same))
        if not all(same):
            failed.append("fused vs solo ids")
    return out, failed


def tps_train(cfg, params, mesh, dev) -> tuple:
    """(b)'s train step: the train cell's mixed group through
    ``GroupRuntime(tp_mode="auto")`` on *mesh*, one step, its step-1
    gradients against the meshless step's within max(SHARD_GRAD_RTOL,
    2 x the nudge's floor); then the planted replica fault."""
    import numpy as np
    import torch
    from repro_torch.core.ssm import SharedSuperModel
    from repro_torch.elastic.runtime import GroupRuntime
    from repro_torch.models import layers
    kw = dict(lr=TRAIN_LR, impl="cuda", block_t=TRAIN_BLOCK_T, chunk_size=1,
              remat=True, seed=0, device=dev)
    specs = train_specs(TRAIN_RANKS, prefix="tps-train")
    layout = SharedSuperModel(cfg, specs, block_t=TRAIN_BLOCK_T).layout
    adapters = train_adapters(cfg, TRAIN_RANKS, layout, dev)
    got = []
    for ad in (adapters, nudged(adapters, dev)):
        solo = GroupRuntime.from_specs(cfg, specs, params=params,
                                       adapters=ad, **kw)
        solo.run(1)
        got.append((np.stack(solo.report.per_job_losses)[0],
                    _first_moments(solo)))
    del solo
    floor = _grad_rel(got[1][1], got[0][1], layout)
    make = lambda: GroupRuntime.from_specs(
        cfg, specs, params=params, adapters=adapters, mesh=mesh,
        tp_mode="auto", **kw)
    rt = make()
    t0 = time.perf_counter()
    _, launches = counted(lambda: rt.run(1))
    step_s = time.perf_counter() - t0
    res = {"step_s": step_s, "launches": launches,
           "launches_expected": pattern_launches(cfg),
           "loss_abs_diff": float(np.abs(np.stack(
               rt.report.per_job_losses)[0] - got[0][0]).max()),
           "step1_grad": against_floor(_grad_rel(rt.opt_state.mu,
                                                 got[0][1], layout),
                                       floor, SHARD_GRAD_RTOL),
           "adapters_equal_on_every_rank": _ranks_equal(rt.adapters)}
    del rt
    real = layers._KVColumns.backward

    def one_replica(ctx, g):
        # each kv head's cotangent from its first replica alone
        import torch.distributed as dist
        n = dist.get_world_size(ctx.group)
        blocks = [torch.empty_like(g) for _ in range(n)]
        dist.all_gather(blocks, g.contiguous(), group=ctx.group)
        r = n * (ctx.sl[0].stop - ctx.sl[0].start) // ctx.n
        return torch.cat(blocks[::r], dim=-1), None, None
    layers._KVColumns.backward = staticmethod(one_replica)
    try:
        bad = make()
        bad.run(1)
        rel = _grad_rel(bad.opt_state.mu, got[0][1], layout)
    finally:
        layers._KVColumns.backward = real
    res["planted_one_replica"] = {"step1_grad_rel": rel,
                                  "limit": res["step1_grad"]["limit"],
                                  "caught": rel > res["step1_grad"]["limit"]}
    failed = []
    if res["launches"] != res["launches_expected"]:
        failed.append(f"train launches {launches}")
    if not (res["step1_grad"]["ok"] and res["loss_abs_diff"] <= LOSS_ATOL
            and res["adapters_equal_on_every_rank"]):
        failed.append("train step vs meshless")
    if not res["planted_one_replica"]["caught"]:
        failed.append("planted replica fault not caught")
    return res, failed


def tps_pair_mesh():
    """A ("data", "model") mesh of data 1 x model 2 over ranks 0-1 (every
    rank makes its groups; ranks 2+ get None)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.launch.mesh import subgroup
    pair = subgroup([0, 1])
    singles = [subgroup([r]) for r in range(dist.get_world_size())]
    me = dist.get_rank()
    if me >= 2:
        return None
    return DeviceMesh.from_group([singles[me], pair], "cpu",
                                 mesh=torch.tensor([[0, 1]]),
                                 mesh_dim_names=("data", "model"))


def tp_serve_runs(rank, dev) -> dict:
    """One rank's part of the tp_serve phase ((a) and (c) on ranks 0-1,
    (b) on every rank), each check of the block comment above; returns
    its readings and the names of the checks that failed."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import model as M
    out, failed = {"rank": rank}, []
    torch.cuda.reset_peak_memory_stats()    # the pool ran earlier phases
    pair = tps_pair_mesh()
    wide = make_local_mesh(model=TPS_WORLD)
    parts = (("a", "tinyllama-1.1b", None, TPS_DECODE),
             ("c", "qwen3-moe-30b-a3b", TPS_MOE_LAYERS, TPS_MOE_DECODE))
    for part, arch, layers, steps in parts:
        if pair is not None:
            cfg = get_config(arch)
            if layers:
                cfg = dataclasses.replace(cfg, num_layers=layers)
            params = M.init_model(cfg, seed=0, device=dev)
            t0 = time.perf_counter()
            out[part], bad = tps_part(
                cfg, params, pair, dev, steps,
                solo=TPS_SOLO_A if part == "a" else (), moe=part == "c")
            out[part]["seconds"] = time.perf_counter() - t0
            failed += [f"({part}) {b}" for b in bad]
            del params
            torch.cuda.empty_cache()
        dist.barrier()
    for part, arch, layers, moe_impl, recurrent in TPS_FAMILIES:
        if pair is not None:
            cfg = dataclasses.replace(get_config(arch), num_layers=layers)
            if moe_impl:
                cfg = dataclasses.replace(cfg, moe_impl=moe_impl)
            params = M.init_model(cfg, seed=0, device=dev)
            t0 = time.perf_counter()
            out[part], bad = tps_part(
                cfg, params, pair, dev, TPS_FAM_DECODE, solo=TPS_SOLO_A,
                moe=bool(cfg.num_experts),
                width=TPS_REC_PROMPT if recurrent else None)
            out[part]["arch"] = arch
            out[part]["seconds"] = time.perf_counter() - t0
            failed += [f"({part}) {b}" for b in bad]
            del params
            torch.cuda.empty_cache()
        dist.barrier()
    cfg = dataclasses.replace(get_config("tinyllama-1.1b"),
                              num_layers=TPS_B_LAYERS)
    params = M.init_model(cfg, seed=0, device=dev)
    t0 = time.perf_counter()
    out["b"], bad = tps_part(cfg, params, wide, dev, TPS_B_DECODE,
                             solo=TPS_SOLO)
    failed += [f"(b) {x}" for x in bad]
    out["b"]["train"], bad = tps_train(cfg, params, wide, dev)
    failed += [f"(b) {x}" for x in bad]
    out["b"]["seconds"] = time.perf_counter() - t0
    out["peak_device_memory_bytes"] = torch.cuda.max_memory_allocated()
    out["failed"] = failed
    return out


def tps_dry_prediction(src):
    """Start the dry run's prediction of (a)'s tensor-parallel serve on
    rank 0 (its prefill and one decode step analyzed on meta tensors,
    ``launch/step_analysis``, in a fake world of 2: data 1 x model 2; the
    peak the larger of the two) in a process of its own (a fake world
    takes a process without a process group); returns a function that
    waits for it and returns its readings."""
    code = (f"import sys, json; sys.path[:0] = [{ROOT!r}, {src!r}]\n"
            "import chip_smoke\n"
            "print(json.dumps(chip_smoke._tps_dry_prediction()))\n")
    proc = subprocess.Popen([sys.executable, "-c", code], text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)

    def wait() -> dict:
        out, err = proc.communicate(timeout=600)
        if proc.returncode:
            return {"error": err[-2000:]}
        return json.loads(out.strip().splitlines()[-1])
    return wait


def _tps_dry_prediction() -> dict:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.core.jobs import LoRAJobSpec
    from repro_torch.core.ssm import SharedSuperModel
    from repro_torch.launch import step_analysis as SA
    from repro_torch.launch.mesh import fake_world, make_local_mesh
    from repro_torch.models import model as M
    from repro_torch.sharding.rules import shard_params
    cfg = get_config("tinyllama-1.1b")
    names = [f"tps{i}-r{r}" for i, r in enumerate(MIXED)]
    specs = [LoRAJobSpec(n, rank=r, batch_size=TPS_ROWS, seq_len=BLOCK_T)
             for n, r in zip(names, MIXED)]
    ssm = SharedSuperModel(cfg, specs, impl="torch", block_t=BLOCK_T)
    toks, ids, _ = tps_batch(cfg, "cpu", names)
    B, S = toks.shape
    shape = InputShape("tp_serve", S + TPS_DECODE, B, "decode")
    meta = lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")
    with fake_world(2, 0):
        mesh = make_local_mesh(model=2)
        full = M.init_model(cfg, device="meta")
        params = shard_params(full, full, 2, 0, cfg=cfg)
        adapters = M.init_adapters(cfg, MIXED, layout=ssm.layout,
                                   device="meta")
        pre, (_, caches) = SA.analyze(
            ssm.make_prefill_step(shape, mesh=mesh),
            (params, adapters, {"tokens": meta(toks),
                                "adapter_ids": meta(ids)}))
        step = ssm.make_serve_step(mesh=mesh)
        dec, _ = SA.analyze(
            lambda p, a, c, b: step(p, a, c, b, torch.full(
                (B,), S, dtype=torch.int32, device="meta"), TPS_ROWS),
            (params, adapters, caches,
             {"tokens": torch.empty((B, 1), dtype=torch.int32,
                                    device="meta"),
              "adapter_ids": meta(ids)}))
    return {"prefill_peak_bytes": pre.peak_bytes,
            "decode_peak_bytes": dec.peak_bytes,
            "serve_peak_bytes_predicted": max(pre.peak_bytes,
                                              dec.peak_bytes),
            "prefill_flops": pre.flops, "decode_flops": dec.flops,
            "decode_collectives": {k: [dec.collective_counts[k], v]
                                   for k, v in dec.collective_bytes.items()}}


def tp_serve_rank(rank, world, init_method, src, out_path):
    """A spawned gloo rank of the tp_serve phase: joins the world on
    cuda:0, runs ``tp_serve_runs``, writes its results to *out_path* %
    rank, then raises if a check failed."""
    sys.path.insert(0, src)
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_mesh
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    init_mesh(rank, world, init_method, "gloo")
    out = tp_serve_runs(rank, dev)
    with open(out_path % rank, "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    if out["failed"]:
        raise AssertionError(f"tp_serve rank {rank}: {out['failed']}")


def tp_serve_phase(src):
    """TPS_WORLD gloo ranks spawned onto cuda:0 run ``tp_serve_runs``;
    the parent emits rank 0's readings, every rank's failures and peak
    memory.  The ranks share one H100: no time here is a multi-GPU
    number.  Returns the launches of rank 0's counted serves and train
    step."""
    import gc
    import tempfile
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="tp-serve-", dir=os.path.join(ROOT,
                                                                "build"))
    out_path = os.path.join(tmp, "%d.json")
    t0 = time.perf_counter()
    dry_wait = tps_dry_prediction(src)   # its own process, beside the ranks
    err = None
    try:
        run_ranks(tp_serve_rank, (
            TPS_WORLD, f"file://{os.path.join(tmp, 'gloo')}", src, out_path),
            TPS_WORLD)
    except Exception as e:            # emit what the ranks wrote first
        err = e
    dry = dry_wait()
    ranks = []
    for r in range(TPS_WORLD):
        if os.path.exists(out_path % r):
            with open(out_path % r) as f:
                ranks.append(json.load(f))
    seconds = time.perf_counter() - t0
    shutil.rmtree(tmp, ignore_errors=True)
    if len(ranks) < TPS_WORLD:
        emit({"phase": "tp_serve_failed", "by_rank": ranks})
        raise AssertionError(f"tp_serve: {len(ranks)} of {TPS_WORLD} ranks "
                             "finished") from err
    r0 = ranks[0]
    if "serve_peak_bytes_predicted" in dry:
        dry["serve_peak_bytes_measured"] = r0["a"][
            "serve_peak_bytes_measured"]
        dry["rel_err"] = (abs(dry["serve_peak_bytes_predicted"]
                              - dry["serve_peak_bytes_measured"])
                          / dry["serve_peak_bytes_measured"])
    emit({"phase": "tp_serve", "ranks": TPS_WORLD, "seconds": seconds,
          "dryrun_rank0_a": dry,
          "logit_atol": LOGIT_ATOL, "step1_grad_rtol": SHARD_GRAD_RTOL,
          "note": "the ranks share one H100: no time here is a multi-GPU "
                  "number",
          "a": r0["a"], "b": r0["b"], "c": r0["c"],
          **{part: r0[part] for part, *_ in TPS_FAMILIES},
          "b_by_rank": [{k: r["b"].get(k) for k in (
              "model_axis", "cache_share", "logits")} for r in ranks],
          "failed_by_rank": [r["failed"] for r in ranks],
          "peak_device_memory_bytes_by_rank": [
              r["peak_device_memory_bytes"] for r in ranks],
          "card": card_line()})
    if err is not None:
        raise err
    launches = {}
    for part in (r0["a"], r0["b"], r0["c"], r0["b"]["train"],
                 *(r0[p] for p, *_ in TPS_FAMILIES)):
        for k, v in part["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return launches


# --------------------------------------------------------- dry run
# The dryrun line: the dry run's analysis (launch/step_analysis: the
# step on meta tensors, the card's branches, the flash kernel stood in
# for) of one step of the train cell's group through impl="torch", held
# against the same step on the card: the resident bytes (params,
# adapters, optimizer state) exactly equal to the real trees' bytes,
# the predicted peak within DRYRUN_PEAK_RTOL of max_memory_allocated()
# reset before the step (less what the process held beside the step's
# inputs).  A first step warms the card (cuBLAS workspaces, the device
# constants) and is not measured.
DRYRUN_PEAK_RTOL = 0.10


def _dryrun_predict() -> dict:
    """The dry run's numbers for the dryrun line: one train-cell step
    through impl="torch" on meta tensors (``launch/step_analysis``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.ssm import SharedSuperModel
    from repro_torch.data.pipeline import FusedBatcher
    from repro_torch.launch import step_analysis as SA
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import constant
    t0 = time.perf_counter()
    cfg = get_config("tinyllama-1.1b")
    specs = train_specs(TRAIN_RANKS, prefix="dry")
    ssm = SharedSuperModel(cfg, specs, impl="torch", block_t=TRAIN_BLOCK_T)
    batch = FusedBatcher(specs, cfg.vocab_size, block_t=TRAIN_BLOCK_T,
                         seed=0).next_batch()
    params = M.init_model(cfg, device="meta")
    adapters = M.init_adapters(cfg, TRAIN_RANKS, layout=ssm.layout,
                               device="meta")
    opt = adamw.init(adapters, per_job=len(specs))
    mbatch = {k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype,
                             device="meta") for k, v in batch.items()}
    rep, _ = SA.analyze(ssm.make_train_step(lr_fn=constant(TRAIN_LR),
                                            remat=True),
                        (params, adapters, opt, mbatch))
    return {"resident_bytes": tree_bytes(params) + tree_bytes(adapters)
            + tree_bytes([opt.mu, opt.nu, opt.step]),
            "inputs_bytes": rep.resident_bytes,
            "peak_bytes": rep.peak_bytes, "flops": rep.flops,
            "flops_f32": rep.flops_f32, "eager_bytes": rep.eager_bytes,
            "ops": rep.ops, "analysis_s": time.perf_counter() - t0}


def dryrun_prediction(src):
    """Start ``_dryrun_predict`` in a process of its own (host work that
    overlaps the card's phases); returns a function that waits for it and
    returns its numbers."""
    code = (f"import sys, json; sys.path[:0] = [{ROOT!r}, {src!r}]\n"
            "import chip_smoke\n"
            "print(json.dumps(chip_smoke._dryrun_predict()))\n")
    proc = subprocess.Popen([sys.executable, "-c", code], text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)

    def wait() -> dict:
        out, err = proc.communicate(timeout=900)
        if proc.returncode:
            raise AssertionError(f"dryrun prediction failed:\n{err[-3000:]}")
        return json.loads(out.strip().splitlines()[-1])
    return wait


def dryrun_step_bytes(cfg, params, dev, predicted) -> dict:
    """The dry run's *predicted* numbers (``dryrun_prediction``'s wait)
    against one train-cell step through impl="torch" on *params* on the
    card (every check above; raises on a failed one)."""
    import torch
    from repro_torch.core.ssm import SharedSuperModel
    from repro_torch.data.pipeline import FusedBatcher
    from repro_torch.launch import step_analysis as SA
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import constant
    specs = train_specs(TRAIN_RANKS, prefix="dry")
    ssm = SharedSuperModel(cfg, specs, impl="torch", block_t=TRAIN_BLOCK_T)
    batch = FusedBatcher(specs, cfg.vocab_size, block_t=TRAIN_BLOCK_T,
                         seed=0).next_batch()
    step = ssm.make_train_step(lr_fn=constant(TRAIN_LR), remat=True)
    gc_collect()
    adapters = train_adapters(cfg, TRAIN_RANKS, ssm.layout, dev)
    opt = adamw.init(adapters, per_job=len(specs))
    cbatch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    step(params, adapters, opt, cbatch)           # warm, not measured
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    inputs = sum(SA._granule(t.untyped_storage().nbytes())
                 for t in SA._tensors((params, adapters, opt, cbatch)))
    torch.cuda.reset_peak_memory_stats()
    out = step(params, adapters, opt, cbatch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del out
    real = tree_bytes(params) + tree_bytes(adapters) + tree_bytes(
        [opt.mu, opt.nu, opt.step])
    pred = predicted()
    beside = held - inputs               # what the process held besides
    measured = peak - beside
    res = {"phase": "dryrun", "group": list(TRAIN_RANKS),
           "batch_size": TRAIN_BATCH, "seq_len": TRAIN_SEQ, "impl": "torch",
           "resident_bytes_predicted": pred["resident_bytes"],
           "resident_bytes_real": real,
           "resident_exact": pred["resident_bytes"] == real,
           "peak_bytes_predicted": pred["peak_bytes"],
           "peak_bytes_measured": measured,
           "max_memory_allocated": peak, "held_beside_the_inputs": beside,
           "inputs_bytes_predicted": pred["inputs_bytes"],
           "inputs_bytes_real": inputs,
           "step_increment_predicted": pred["peak_bytes"]
           - pred["inputs_bytes"],
           "step_increment_measured": peak - held,
           "peak_rel_err": abs(pred["peak_bytes"] - measured) / measured,
           "peak_rtol": DRYRUN_PEAK_RTOL,
           **{k: pred[k] for k in ("flops", "flops_f32", "eager_bytes",
                                   "ops", "analysis_s")},
           "card": card_line()}
    res["peak_ok"] = res["peak_rel_err"] <= DRYRUN_PEAK_RTOL
    emit(res)
    if not (res["resident_exact"] and res["peak_ok"]):
        raise AssertionError(f"dryrun: resident exact {res['resident_exact']}"
                             f", peak off by {res['peak_rel_err']:.3f}")
    return res


def gc_collect():
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--times", help="comma-separated kernel wrappers: only "
                    "their training cases (dequant_matmul_cuda: its cases "
                    "of the kernels phase), each against its plain version "
                    "with its times")
    ap.add_argument("--floors", action="store_true", help="only the "
                    "depth sweep of what a 2^-9 nudge of the adapters moves "
                    "(floors_sweep)")
    ap.add_argument("--families", action="store_true", help="only the "
                    "families phase (families_phase)")
    ap.add_argument("--cluster", action="store_true", help="only the "
                    "cluster phase (cluster_phase)")
    ap.add_argument("--sharded", action="store_true", help="only the "
                    "sharded phase (sharded_phase)")
    ap.add_argument("--cluster-sharded", action="store_true", help="only "
                    "the cluster_sharded phase (cluster_sharded_phase)")
    ap.add_argument("--pipeline", action="store_true", help="only the "
                    "pipeline_mode phase (pipeline_mode_phase)")
    ap.add_argument("--tensor-parallel", action="store_true", help="only "
                    "the tensor_parallel phase (tensor_parallel_phase)")
    ap.add_argument("--tp-serve", action="store_true", help="only the "
                    "tp_serve phase (tp_serve_phase)")
    ap.add_argument("--dryrun", action="store_true", help="only the "
                    "dryrun line (dryrun_step_bytes)")
    ap.add_argument("--src", default=SRC, help="the directory holding the "
                    "repro_torch package to build and run (default: this "
                    "checkout's src)")
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(args.src, "repro_torch")):
        print("chip_smoke.py must run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    per_source = build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_seconds": per_source, "src": args.src})
    for name in build.SOURCES:
        log = build.BUILD_DIR / f"{name}.log"
        if log.exists():
            print(f"--- {name}\n{log.read_text()}", file=sys.stderr)
    if args.times:
        names = set(args.times.split(","))
        g = torch.Generator(device=dev).manual_seed(1)
        pool = train_kernel_cases(g, dev)
        if "dequant_matmul_cuda" in names:     # B10's kernels-phase cases
            pool += dequant_kernel_cases(g, dev)
        time_cases([c for c in pool if c[0] in names])
        return 0
    if args.floors:
        floors_sweep(dev)
        return 0
    if args.families:
        families_phase(dev)
        return 0
    if args.cluster:
        ckpt_dir = os.path.join(ROOT, "build", "chip_smoke_checkpoints")
        cluster_phase(get_config("tinyllama-1.1b"), dev, ckpt_dir)
        return 0
    if args.sharded:
        sharded_phase(os.path.abspath(args.src),
                      get_config("tinyllama-1.1b"), dev)
        return 0
    if args.cluster_sharded:
        cluster_sharded_phase(os.path.abspath(args.src),
                              get_config("tinyllama-1.1b"))
        return 0
    if args.pipeline:
        pipeline_mode_phase(os.path.abspath(args.src),
                            get_config("tinyllama-1.1b"))
        return 0
    if args.tensor_parallel:
        tensor_parallel_phase(os.path.abspath(args.src))
        return 0
    if args.tp_serve:
        tp_serve_phase(os.path.abspath(args.src))
        return 0
    if args.dryrun:
        from repro_torch.models import model as M
        cfg = get_config("tinyllama-1.1b")
        dryrun_step_bytes(cfg, M.init_model(cfg, seed=0, device=dev), dev,
                          dryrun_prediction(os.path.abspath(args.src)))
        return 0

    cfg = get_config("tinyllama-1.1b")
    sets = []
    for set_name, ranks in (("mixed", MIXED), ("uniform", UNIFORM)):
        names = [f"{set_name}{i}-r{r}" for i, r in enumerate(ranks)]
        # the same prompts and budgets in both sets: one batch geometry,
        # so the two kernels are measured on the same shapes
        sets.append((set_name, names, ranks,
                     make_requests(0, names, cfg.vocab_size)))
    rows, S = geometry(sets[0][3])
    rows_u, S_u = geometry(sets[1][3])
    assert rows == rows_u and S == S_u, "both sets share one geometry"

    kern = kernels_phase(rows, S, dev)
    # the dryrun line's prediction, on the host while the card works
    # (after the kernels phase, whose host times it would disturb)
    dry_predicted = dryrun_prediction(os.path.abspath(args.src))
    troute = torch_route_cases(rows, dev)
    from repro_torch.models import model as M
    params = M.init_model(cfg, seed=0, device=dev)
    ckpt_dir = os.path.join(ROOT, "build", "chip_smoke_checkpoints")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    measured = {}                 # steady steps: the calibrate phase's input
    serve_cfg = dataclasses.replace(cfg, num_layers=SERVE_LAYERS)
    counts = {"serve": serve_phase(
        serve_cfg, M.init_model(serve_cfg, seed=0, device=dev), sets, dev)}
    dryrun_step_bytes(cfg, params, dev, dry_predicted)
    counts["train"], bf16_losses, bf16_step = train_phase(
        cfg, params, dev, measured=measured)
    counts["train_torch"] = torch_phase(
        cfg, params, dev, phase="train", ranks=TRAIN_RANKS,
        cuda_losses=bf16_losses, cuda_step=bf16_step, measured=measured)
    # the uniform group's scalings alpha / r reach 8 (rank 2): there the
    # loop impl's unrounded x·A moves the gradients by more than
    # GRAD_RTOL (7.2% after 8 steps, PERF.md), so the phase asserts the
    # masked kernels' gradients against the ragged kernels' (ROUTE_RTOL)
    # and reports the loop's
    counts["train_uniform"], uni_losses, uni_step = train_phase(
        cfg, params, dev, phase="train_uniform", ranks=UNIFORM_RANKS,
        expect=MASKED_LAUNCHES, loop_rtol=None, measured=measured)
    # the uniform group's alpha / r reaches 8 (rank 2): the two routes'
    # one-ulp rounding differences, amplified 8x in the LoRA delta and
    # through Adam's normalized updates, move its losses apart by 0.028
    # at step 4 and 0.034 at step 8 (PERF.md §6), against 0.0017 by
    # step 2; so its first step (the same adapters: the forward alone) is
    # held to LOSS_ATOL, every step reported, and its gradients asserted
    counts["train_uniform_torch"] = torch_phase(
        cfg, params, dev, phase="train_uniform", ranks=UNIFORM_RANKS,
        cuda_losses=uni_losses, cuda_step=uni_step, measured=measured,
        held_steps=1)
    counts["nano"] = nano_phase(cfg, params, dev, measured=measured)
    counts["pipeline"] = pipeline_phase(cfg, params, dev)
    counts["elastic"] = elastic_phase(cfg, params, dev, ckpt_dir)
    counts["quant"] = quant_phase(cfg, params, sets, bf16_losses, bf16_step,
                                  dev, measured=measured)
    counts["wide"] = wide_phase(dev)
    counts["recurrent"] = recurrent_phase(dev)
    counts["families"] = families_phase(dev)
    hw, cal = calibrate_phase(cfg, measured)
    simulate_phase(cfg, cal)
    counts["engine"] = engine_phase(cfg, params, dev, hw)
    counts["launch"] = launch_phase(cfg, params, dev, measured)
    counts["cluster"] = cluster_phase(cfg, dev, ckpt_dir)
    with rank_pool(max(SHARDED_D, CS_RANKS, PP_RANKS, TP_RANKS, TPS_WORLD)):
        counts["sharded"] = sharded_phase(os.path.abspath(args.src), cfg,
                                          dev)
        del params
        counts["cluster_sharded"] = cluster_sharded_phase(
            os.path.abspath(args.src), cfg)
        # pipeline_mode last: its eight full-depth ranks leave CUDA
        # contexts in every pool process, and tensor_parallel's whole-vocab
        # steps need the room fresh processes leave (an OOM otherwise)
        counts["tensor_parallel"] = tensor_parallel_phase(
            os.path.abspath(args.src))
        counts["tp_serve"] = tp_serve_phase(os.path.abspath(args.src))
        counts["pipeline_mode"] = pipeline_mode_phase(
            os.path.abspath(args.src), cfg)

    csrc = "src/repro_torch/kernels/csrc/"
    # name: (source, TPU kernel replaced, headline (step, shape filter))
    lora_2048 = lambda step: (lambda r: r["step"] == step
                              and r["shape"]["d_out"] == 2048)
    masked = lambda op, d: (lambda r: r["shape"].get("op") == op
                            and r["shape"]["r_pad"] == 16
                            and d in [r["shape"].get(k) for k in
                                      ("d_in", "d_out", "d_x", "d_g")])
    src = {"ragged_lora_fwd": (csrc + "ragged_lora.cu",
                               "src/repro/kernels/ragged.py:152",
                               lora_2048("decode")),
           "fused_lora_cuda": (csrc + "fused_lora.cu",
                               "src/repro/kernels/fused_lora.py:62",
                               lora_2048("decode")),
           "flash_attention_fwd": (
               csrc + "flash_attention.cu",
               "src/repro/kernels/flash_attention.py:87",
               lambda r: r["step"] == "train" and r["shape"]["hd"] == 64),
           "ragged_lora_dgrad": (csrc + "ragged_bwd.cu",
                                 "src/repro/kernels/ragged.py:213",
                                 lora_2048("train")),
           "ragged_xa": (csrc + "ragged_bwd.cu",
                         "src/repro/kernels/ragged.py:262",
                         lora_2048("train")),
           "ragged_dxa": (csrc + "ragged_bwd.cu",
                          "src/repro/kernels/ragged.py:305",
                          lora_2048("train")),
           "ragged_wgrad": (csrc + "ragged_bwd.cu",
                            "src/repro/kernels/ragged.py:350",
                            lambda r: r["step"] == "train"
                            and r["shape"]["operand"] == "dA"
                            and r["shape"]["d_out"] == 2048),
           "grouped_matmul_cuda": (csrc + "grouped.cu",
                                   "src/repro/kernels/fused_lora.py:220",
                                   masked("dxa = dy_s . B^T", 2048)),
           "grouped_wgrad_cuda": (csrc + "grouped.cu",
                                  "src/repro/kernels/fused_lora.py:121",
                                  masked("dB = xa^T . dy_s", 2048)),
           "dequant_matmul_cuda": (csrc + "dequant.cu",
                                   "src/repro/kernels/fused_lora.py:179",
                                   lambda r: r["step"] == "train"
                                   and r["shape"]["op"][0] == "y"
                                   and r["shape"]["d_out"] == 5632)}
    summary = []
    for name, (source, replaces, headline) in src.items():
        mine = [r for r in kern if r["name"] == name]
        head = next(r for r in mine if headline(r))
        by_path = {path: c.get(name, 0) for path, c in counts.items()}
        if sum(by_path.values()) == 0:
            raise AssertionError(f"no main path launched {name}")
        summary.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": head["ms"], "call_ms": head["call_ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "at": {"step": head["step"], **head["shape"]}})
        if name == "flash_attention_fwd":
            summary[-1]["head_dims"] = {
                f'{r["shape"]["hd"]}/{r["shape"].get("vd", r["shape"]["hd"])}'
                : {**{k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "library_ms", "max_abs_err")},
                   **{k: r["shape"][k] for k in ("causal", "sdpa_backend")
                      if k in r["shape"]}}
                for r in mine if r["step"] == "train"}
        for key in ("cublas_bf16_ms", "pair_ms"):
            if key in head:
                summary[-1][key] = head[key]
        for key, archs in (("recurrent_widths", REC_ARCHS),
                           ("family_widths", FAM_ARCHS),
                           ("model_axis_widths", None)):
            rec = [r for r in mine if "d_in" in r["shape"]
                   and ("model_axis" in r["shape"]) == (archs is None)
                   and (archs is None or r["shape"].get("model") in archs)]
            if rec:                  # the LoRA kernels at those widths
                summary[-1][key] = [
                    {**{k: r["shape"][k] for k in ("d_in", "d_out", "model")
                        if k in r["shape"]},
                     **{k: r["shape"][k] for k in ("op", "operand",
                                                   "projection", "out")
                        if k in r["shape"]},
                     **{k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                          "library_ms", "max_abs_err",
                                          "cublas_bf16_ms") if k in r}}
                    for r in rec]
        if name in TORCH_ROUTE_OF:
            # the "torch" route's same-function time beside the kernels'
            # Function (forward: B1 or B6 alone; backward: B2-B5 or B7 +
            # B8 together), same inputs, this run
            route, part = TORCH_ROUTE_OF[name]
            summary[-1]["torch_route"] = [
                {"step": t["step"], "d_out": t["shape"]["d_out"],
                 "part": part, "function_ms": t[part + "_ms"],
                 "torch_ms": t["torch_" + part + "_ms"]}
                for t in troute if t["route"] == route and part + "_ms" in t]
    emit({"kernels": summary, "run_seconds": time.perf_counter() - START})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
