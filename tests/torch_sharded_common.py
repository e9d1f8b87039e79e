"""Test-process side of the port's sharded tests
(tests/test_torch_sharded_{parity,runtime}.py): the reference's inits
and single-device runs, the port's meshless runs, the spawn of the gloo
ranks (tests/torch_sharded_worker.py) and the tolerances.

Tolerances (the reference's tests/sharded_worker.py:52-75):
  * ``losses_close``: per-job losses at 1e-4 relative and absolute;
  * ``state_close``: adapters and Adam moments within 2.5e-2 everywhere
    (Adam divides by sqrt(v), so a float-order difference in a near-zero
    gradient can flip an update by up to 2 lr), and within 1e-5 for over
    85% of the coordinates (B starts at zero, so every coordinate is
    near zero over the first steps);
  * Adam steps and steps done: exactly.
Both bounds hold the sharded port against its meshless run (the same
function with the rows split over ranks), and against the reference's
single-device ``GroupRuntime`` ("xla") on the same jobs, seeds and
initial weights (two frameworks summing the same products in other
orders).  Where the port's contract is bit-exactness (``gather_solo``)
the test asserts equality.
"""
import os
import time

import numpy as np
import torch
import torch.multiprocessing as mp

import jax

from repro.configs import get_config as ref_get_config
from repro.core.jobs import LoRAJobSpec as RefSpec
from repro.core.ssm import SharedSuperModel as RefSSM
from repro.elastic.runtime import GroupRuntime as RefRuntime

from repro_torch.models.convert import adapters_from_numpy, params_from_numpy

import torch_sharded_worker as W

WORLD = 4
SPAWN_LIMIT_S = 300.0


def ref_cfg():
    import dataclasses
    return dataclasses.replace(ref_get_config("tinyllama-1.1b").reduced(),
                               dtype="float32")


def ref_init(key: str):
    """The reference's (params, adapters) of job set *key*, as its
    ``GroupRuntime.from_specs`` draws them from PRNGKey(SEED): numpy."""
    ssm = RefSSM(ref_cfg(), W.specs(key, RefSpec), impl="xla",
                 block_t=W.BT)
    params, adapters = ssm.init(jax.random.PRNGKey(W.SEED))
    return (jax.tree.map(np.asarray, params),
            jax.tree.map(np.asarray, adapters))


def port_weights(key: str) -> dict:
    params, adapters = ref_init(key)
    return {"params": params_from_numpy(params, "cpu"),
            "adapters": adapters_from_numpy(adapters, "cpu")}


def ref_summary(rt) -> dict:
    return {"losses": np.asarray(rt.report.per_job_losses, np.float64),
            "adapters": W.flat(jax.tree.map(np.asarray, rt.adapters)),
            "mu": W.flat(jax.tree.map(np.asarray, rt.opt_state.mu)),
            "nu": W.flat(jax.tree.map(np.asarray, rt.opt_state.nu)),
            "step": np.asarray(rt.opt_state.step).tolist(),
            "steps_done": dict(rt.steps_done)}


def ref_runs(key: str, at=(2, 4), **kw) -> dict:
    """The reference's single-device "xla" run of job set *key*, its
    summary taken after each step count in *at*."""
    rt = RefRuntime.from_specs(ref_cfg(), W.specs(key, RefSpec),
                               jax.random.PRNGKey(W.SEED),
                               **dict(dict(lr=W.LR, impl="xla",
                                           block_t=W.BT, remat=False,
                                           chunk_size=2), **kw))
    out, done = {}, 0
    for n in at:
        rt.run(n - done)
        done = n
        out[n] = ref_summary(rt)
    return out


def spawn(names, tmp_path, inputs, world=WORLD):
    """Start *world* gloo ranks running *names*; returns what
    ``collect`` takes."""
    inp = os.path.join(tmp_path, "inputs.pt")
    torch.save(inputs, inp)
    ctx = mp.start_processes(
        W.main, args=(world, os.path.join(tmp_path, "store"), inp,
                      str(tmp_path), list(names)),
        nprocs=world, join=False, start_method="spawn")
    return ctx, tmp_path, world


def collect(handle) -> list:
    """Join the ranks (bounded) and load every rank's results; a rank
    that raised fails every scenario it did not finish."""
    ctx, tmp_path, world = handle
    t0 = time.monotonic()
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() - t0 > SPAWN_LIMIT_S:
                raise TimeoutError(f"ranks still running after "
                                   f"{SPAWN_LIMIT_S} s")
    except Exception:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        for p in ctx.processes:
            p.join(10)
    out = []
    for r in range(world):
        path = os.path.join(tmp_path, f"{r}.pt")
        out.append(torch.load(path, weights_only=False)
                   if os.path.exists(path) else {})
    return out


def result(ranks: list, name: str, rank: int = 0):
    r = ranks[rank].get(name)
    if r is None:
        errs = [x[n]["err"] for x in ranks for n in x if not x[n]["ok"]]
        raise AssertionError(f"scenario {name} did not run on rank {rank}"
                             + (f"; first failure:\n{errs[0]}" if errs
                                else ""))
    assert r["ok"], r["err"]
    return r["res"]


# ------------------------------------------------------------ tolerances
def losses_close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=1e-4, atol=1e-4)


def state_close(ta: dict, tb: dict):
    assert ta.keys() == tb.keys(), (sorted(ta), sorted(tb))
    for k in ta:
        x, y = np.asarray(ta[k]), np.asarray(tb[k])
        np.testing.assert_allclose(x, y, atol=2.5e-2, rtol=0, err_msg=k)
        frac = np.mean(np.abs(x - y) < 1e-5)
        assert frac > 0.85, (k, frac, float(np.abs(x - y).max()))


def compare(want: dict, got: dict, exact_steps: bool = True):
    """Trajectory, trainable state and step accounting of two runs."""
    losses_close(want["losses"], got["losses"])
    for part in ("adapters", "mu", "nu"):
        state_close(want[part], got[part])
    if exact_steps:
        assert list(want["step"]) == list(got["step"])
        assert want["steps_done"] == got["steps_done"]


# ------------------------------------------- any config, per shard
def ref_weights(rcfg, key: str) -> dict:
    """The reference's (params, adapters) of job set *key* on config
    *rcfg*, drawn from PRNGKey(SEED), as numpy and as the port's trees."""
    ssm = RefSSM(rcfg, W.specs(key, RefSpec), impl="xla", block_t=W.BT)
    params, adapters = ssm.init(jax.random.PRNGKey(W.SEED))
    params = jax.tree.map(np.asarray, params)
    adapters = jax.tree.map(np.asarray, adapters)
    return {"np": (params, adapters),
            "port": {"params": params_from_numpy(params, "cpu"),
                     "adapters": adapters_from_numpy(adapters, "cpu")}}


def ref_shard_function(rcfg, key: str, weights, shards: int = 1,
                       nano: int = 1, steps: int = 2) -> dict:
    """The reference's function over data shards and nano slices (its
    ``shard_map`` step's body, evaluated shard by shard on one device):
    each step, the reference's ``loss_fn`` on every shard's rows
    (``shard_permutation``) and, within a shard, on every job-wise nano
    slice (``_nano_index``), each with the global per-job denominators
    and its own MoE aux; the gradients summed in f32; one AdamW update.
    One shard and one slice is the single-device step.  The batches are
    the reference's ``FusedBatcher``'s (seed 0, *shards* shards); impl
    "ref" (the gather oracle: any slice's geometry)."""
    import jax.numpy as jnp
    from repro.core import ssm as rs
    from repro.data.pipeline import FusedBatcher as RefBatcher
    from repro.data.pipeline import shard_permutation
    from repro.models import model as RM
    from repro.optim import adamw as ra
    specs = W.specs(key, RefSpec)
    K = len(specs)
    params, adapters = (jax.tree.map(jnp.asarray, t) for t in weights)
    ssm = RefSSM(rcfg, specs, impl="ref", block_t=W.BT, data_shards=shards)
    fb = RefBatcher(specs, rcfg.vocab_size, block_t=W.BT, seed=0,
                    shards=shards)
    rows = ssm.rows_per_job()
    perm = shard_permutation(rows, shards).reshape(shards, -1)
    idx = rs._nano_index([r // shards for r in rows], nano).reshape(nano, -1)

    def loss(ad, nb, denom):
        lora = ssm.lora_ctx(nb["adapter_ids"])
        total, aux = RM.loss_fn(rcfg, params, ad, lora, nb, remat=False,
                                per_job_denom=denom)
        return total, aux["per_job"]

    grad = jax.jit(jax.grad(loss, has_aux=True))
    opt = ra.init(adapters, per_job=K)
    losses = []
    for _ in range(steps):
        batch = fb.next_batch()
        denom = rs._per_job_token_counts(
            {k: jnp.asarray(v) for k, v in batch.items()}, K,
            causal=rcfg.causal)
        g_sum, per_job = None, np.zeros(K)
        for s in range(shards):
            for sl in idx:
                rows_s = perm[s][sl]
                g, pj = grad(adapters, {k: jnp.asarray(v[rows_s])
                                        for k, v in batch.items()}, denom)
                g = jax.tree.map(lambda t: t.astype(jnp.float32), g)
                g_sum = g if g_sum is None else jax.tree.map(
                    lambda a, b: a + b, g_sum, g)
                per_job = per_job + np.asarray(pj, np.float64)
        adapters, opt = ra.update(g_sum, opt, adapters, lr=W.LR,
                                  col_jobs=ssm.layout.col_jobs)
        losses.append(per_job)
    return {"losses": np.asarray(losses),
            "adapters": W.flat(jax.tree.map(np.asarray, adapters)),
            "mu": W.flat(jax.tree.map(np.asarray, opt.mu)),
            "nu": W.flat(jax.tree.map(np.asarray, opt.nu)),
            "step": np.asarray(opt.step).tolist(),
            "steps_done": {s.job_id: steps for s in specs}}
