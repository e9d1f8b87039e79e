"""The port's nano-batching and AIMD held against the JAX reference on the
CPU, on reduced tinyllama-1.1b (moved whole from
tests/test_torch_train.py, whose docstring states the weights and the
tolerances): N = 1 against N = 3 on a mixed and a uniform group (the
re-granulation contract), the nano helpers and the AIMD controller
against the reference's, ``GroupRuntime``'s AIMD trajectory under a
simulated clock, and the legal set that keeps nano slices whole token
tiles."""
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.jobs import LoRAJobSpec as RefSpec
from repro.core.nanobatch import AIMDController as RefAIMD
from repro.core.nanobatch import optimal_nano as ref_optimal_nano
from repro.core.nanobatch import pipeline_tick_counts as ref_tick_counts
from repro.core.nanobatch import simulate_step_time as ref_simulate
from repro.core.ssm import _nano_index as ref_nano_index
from repro.core.ssm import valid_nano_counts as ref_valid_nano_counts
from repro.elastic import runtime as ref_runtime
from repro.elastic.runtime import GroupRuntime as RefRuntime

from repro_torch.core.jobs import LoRAJobSpec
from repro_torch.core.nanobatch import (AIMDController, optimal_nano,
                                        pipeline_tick_counts,
                                        simulate_step_time)
from repro_torch.core.ssm import (SharedSuperModel, _nano_index,
                                  valid_nano_counts)
from repro_torch.data.pipeline import FusedBatcher
from repro_torch.elastic import runtime as port_runtime
from repro_torch.elastic.runtime import GroupRuntime
from repro_torch.models.convert import (adapters_from_numpy,
                                        params_from_numpy, to_numpy)
from repro_torch.optim import adamw
from repro_torch.optim.schedule import constant

from torch_train_common import (BT, LR, RANKS, RANKS_U, _adam_close, _cfgs,
                                _flat, _specs, _weights)

BATCH_N = (2, 3, 1)             # 6 rows: N = 3 slices of 2 rows, the last
#                                 straddling jobs 1 and 2


# ---------------------------------------------------------- nano batches
@pytest.fixture(scope="module")
def nano_setup():
    """Both layouts on a 6-row batch (batch sizes 2, 3, 1)."""
    ref_cfg, cfg = _cfgs("float32")
    out = {}
    for name, ranks in (("mixed", RANKS), ("uniform", RANKS_U)):
        _, params, adapters = _weights(ref_cfg, seed=7, ranks=ranks,
                                       batch=BATCH_N)
        specs = _specs(LoRAJobSpec, ranks, BATCH_N)
        batcher = FusedBatcher(specs, cfg.vocab_size, block_t=BT)
        batches = [{k: torch.from_numpy(v) for k, v in
                    batcher.next_batch().items()} for _ in range(3)]
        out[name] = (cfg, specs, params_from_numpy(params, "cpu"), adapters,
                     batches)
    return out


@pytest.mark.parametrize("layout", ["mixed", "uniform"])
def test_nano_batching_is_lossless(nano_setup, layout):
    """test_lossless.py's re-granulation contract with the port's "cuda"
    impl: N = 1 and N = 3 give the same per-job losses (1e-5 relative,
    1e-6 absolute) and adapters within the Adam bound.  The mixed group
    runs the ragged kernels at N = 1 and the densified masked ones at
    N = 3; the uniform group runs the masked ones at both."""
    cfg, specs, params, adapters, batches = nano_setup[layout]
    runs = {}
    for n in (1, 3):
        ssm = SharedSuperModel(cfg, specs, impl="cuda", block_t=BT)
        step = ssm.make_train_step(lr_fn=constant(LR), nano_batches=n,
                                   remat=False)
        ad = adapters_from_numpy(adapters, "cpu")
        opt = adamw.init(ad, per_job=len(specs))
        losses = []
        for b in batches:
            ad, opt, m = step(params, ad, opt, b)
            losses.append(m["per_job_loss"].numpy())
        runs[n] = (ad, losses)
    for a, b in zip(runs[1][1], runs[3][1]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    _adam_close(_flat(to_numpy(runs[3][0])), _flat(to_numpy(runs[1][0])))

# ------------------------------------------------------------------ AIMD
def test_nano_helpers_match_reference():
    """valid_nano_counts (with its seg_rows and stages filters),
    _nano_index, pipeline_tick_counts, simulate_step_time and
    optimal_nano equal the reference's over a grid of inputs."""
    for rows in (1, 6, 12, 16, 36, 64, 96):
        for max_n in (None, 4, rows):
            for stages in (1, 2, 4):
                assert valid_nano_counts(rows, max_n, stages=stages) == \
                    ref_valid_nano_counts(rows, max_n, stages=stages)
            for seq_len, block_t in ((32, 16), (32, 128), (512, 128)):
                kw = dict(seg_rows=[rows, 2 * rows], seq_len=seq_len,
                          block_t=block_t)
                assert valid_nano_counts(rows, max_n, **kw) == \
                    ref_valid_nano_counts(rows, max_n, **kw)
    for rows, n in (((4, 8), 2), ((6, 3, 9), 3), ((2,), 1)):
        for order in (None, list(range(len(rows)))[::-1]):
            np.testing.assert_array_equal(_nano_index(rows, n, order),
                                          ref_nano_index(rows, n, order))
    for ns, P in (([2, 2], 2), ([4, 4, 4], 4), ([8], 4), ([3, 5], 1)):
        assert pipeline_tick_counts(ns, P) == ref_tick_counts(ns, P)
    for n in (1, 3, 16):
        for tc, tm in ((0.01, 0.012), (5e-4, 1e-4)):
            assert simulate_step_time(n, t_comp=tc, t_comm=tm) == \
                ref_simulate(n, t_comp=tc, t_comm=tm)
            assert optimal_nano(64, t_comp=tc, t_comm=tm) == \
                ref_optimal_nano(64, t_comp=tc, t_comm=tm)


@pytest.mark.parametrize("rows,t_comp,t_comm,noise",
                         [(64, 0.010, 0.012, 0.0), (64, 5e-4, 1e-4, 0.0),
                          (16, 0.02, 0.001, 0.01), (96, 0.003, 0.04, 0.01)])
def test_aimd_controller_matches_reference(rows, t_comp, t_comm, noise):
    """The same observations give the same N trajectory and history."""
    rng = np.random.default_rng(0)
    port = AIMDController(rows=rows, max_n=rows)
    ref = RefAIMD(rows=rows, max_n=rows)
    n = port.n
    for _ in range(30):
        t = simulate_step_time(n, t_comp=t_comp, t_comm=t_comm)
        t *= 1.0 + noise * rng.standard_normal()
        n = port.update(t)
        assert ref.update(t) == n
    assert port.history == ref.history
    assert port.converged() == ref.converged()


def _sim_clock(monkeypatch, module, runtime_of):
    """Patch *module*'s clock: every compiled/built chunk step advances it
    by the chunk's length times the Eq. 1 model's step time at the
    runtime's current N, so AIMD reads a deterministic clock."""
    clock = [0.0]
    monkeypatch.setattr(module, "time",
                        types.SimpleNamespace(perf_counter=lambda: clock[0]))

    def wrap(get_step):
        def get(n, chunk, *a):
            fn = get_step(n, chunk, *a)

            def step(*args):
                clock[0] += chunk * simulate_step_time(
                    n, t_comp=0.010, t_comm=0.012, launch_overhead=1e-3)
                return fn(*args)
            return step
        return get
    rt = runtime_of()
    rt._get_step = wrap(rt._get_step)
    return rt


def test_group_runtime_aimd_matches_reference(monkeypatch):
    """``GroupRuntime(adaptive_nano=True)`` under a simulated clock: the
    port's nano trajectory equals the reference runtime's, chunk for
    chunk, including the rule that a single-step tail inside a longer
    run does not feed AIMD.  8 rows of 32 tokens at block_t 16: every
    divisor of 8 is legal for the CUDA kernels, so the port's tile-rule
    filter leaves the reference's legal set as it is."""
    ref_cfg, cfg = _cfgs("float32")
    ranks, batch = (4, 8), (4, 4)
    _, params, adapters = _weights(ref_cfg, ranks=ranks, batch=batch)
    kw = dict(lr=LR, block_t=BT, adaptive_nano=True, chunk_size=2,
              remat=False)
    ref_rt = _sim_clock(monkeypatch, ref_runtime, lambda: RefRuntime.from_specs(
        ref_cfg, _specs(RefSpec, ranks, batch), jax.random.PRNGKey(0),
        params=jax.tree.map(jnp.asarray, params),
        adapters=jax.tree.map(jnp.asarray, adapters), impl="ref", **kw))
    port_rt = _sim_clock(monkeypatch, port_runtime, lambda: GroupRuntime.from_specs(
        cfg, _specs(LoRAJobSpec, ranks, batch),
        params=params_from_numpy(params, "cpu"),
        adapters=adapters_from_numpy(adapters, "cpu"), impl="cuda",
        device="cpu", **kw))
    assert port_rt.aimd._legal == ref_rt.aimd._legal == [1, 2, 4, 8]
    for steps in (5, 4, 3):          # tails of 1 inside runs of 5 and 3
        ref_rt.run(steps)
        port_rt.run(steps)
    assert port_rt.report.nano_history == ref_rt.report.nano_history
    assert len(set(port_rt.report.nano_history)) > 1
    assert port_rt.aimd.history == ref_rt.aimd.history
    # the losses agree while the trajectories are close; later, Adam's
    # sign flips of near-zero gradient coordinates (up to 2 lr each, see
    # _adam_close) compound over the steps on either side, with or
    # without AIMD, so only the first two chunks are held to 1e-5
    np.testing.assert_allclose(np.stack(port_rt.report.per_job_losses)[:4],
                               np.stack(ref_rt.report.per_job_losses)[:4],
                               rtol=1e-5)


def test_aimd_legal_set_keeps_slices_whole_tiles():
    """The token-tile hazard of the contiguous nano split.  At 8 rows of
    32 tokens and block_t 128, N = 4 leaves 64-token slices: the
    reference's one-device AIMD still offers N = 4 (its legal set is
    every divisor) and its train step then fails on the slice; the port's
    legal set for "cuda" keeps only N whose slices are whole tiles, and
    leaves the other impls' as the reference has it."""
    ref_cfg, cfg = _cfgs("float32")
    rt = RefRuntime.from_specs(ref_cfg, _specs(RefSpec, (4, 8), (2, 2)),
                               jax.random.PRNGKey(0), impl="pallas",
                               block_t=128, adaptive_nano=True)
    assert rt.batcher.total_rows() == 8 and 4 in rt.aimd._legal
    rt.n = 4
    with pytest.raises((AssertionError, TypeError)):
        rt.run(1)
    for impl, legal in (("cuda", [1, 2]), ("loop", rt.aimd._legal)):
        port = GroupRuntime.from_specs(
            cfg, _specs(LoRAJobSpec, (4, 8), (2, 2)), impl=impl,
            block_t=128, adaptive_nano=True, device="cpu")
        assert port.batcher.total_rows() == 8
        assert port.aimd._legal == legal
