"""The port's pipelined ``GroupRuntime`` on the CPU: the dispatch/collect
split with the next chunk prefetched, against the sequential order, bit
for bit; the replay-exact in-flight migration of
tests/test_lossless.py::test_inflight_migration_is_bit_exact (there
through the cluster controller, here through the runtime calls it makes:
a destination fused from stale exports and warmed, then refreshed with
the fence's exports); ``discard_staged`` and ``warm`` against the data
streams; the periodic checkpoint's stream position; and the live publish
hook of tests/test_serve.py::test_live_publish_from_group_runtime.

Every comparison is within the port and exact (``torch.equal``): the same
arithmetic in the same order, whatever the chunking.  Models are reduced
tinyllama-1.1b in f32, the "cuda" impl (its plain versions on the CPU).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.checkpoint import stream_state
from repro_torch.configs import get_config
from repro_torch.core.jobs import LoRAJobSpec
from repro_torch.elastic.migrate import JobTrainState
from repro_torch.elastic.runtime import GroupRuntime, PendingChunk
from repro_torch.models import model as M
from repro_torch.optim.adamw import tree_leaves
from repro_torch.serve import AdapterPool, ServeEngine, ServeRequest

BT, LR, SEQ = 16, 1e-2, 32


@pytest.fixture(scope="module")
def cfg():
    return dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                               dtype="float32")


@pytest.fixture(scope="module")
def params(cfg):
    return M.init_model(cfg, seed=7, device="cpu")


def _specs():
    # ranks 4 and 20 pad to 16 and 32: a mixed group (ragged kernels)
    return [LoRAJobSpec("job-a", rank=4, batch_size=2, seq_len=SEQ),
            LoRAJobSpec("job-b", rank=20, batch_size=1, seq_len=SEQ)]


def _runtime(cfg, params, **kw):
    kw = dict(dict(seed=3, impl="cuda", block_t=BT, lr=LR, remat=False,
                   chunk_size=2, device="cpu"), **kw)
    return GroupRuntime.from_specs(cfg, _specs(), params=params, **kw)


def _assert_same_state(a: GroupRuntime, b: GroupRuntime):
    for x, y in zip(tree_leaves(a.adapters), tree_leaves(b.adapters)):
        assert torch.equal(x, y)
    for x, y in zip(tree_leaves(a.opt_state.mu),
                    tree_leaves(b.opt_state.mu)):
        assert torch.equal(x, y)
    for x, y in zip(tree_leaves(a.opt_state.nu),
                    tree_leaves(b.opt_state.nu)):
        assert torch.equal(x, y)
    assert torch.equal(a.opt_state.step, b.opt_state.step)
    assert np.array_equal(np.stack(a.report.per_job_losses),
                          np.stack(b.report.per_job_losses))
    assert a.steps_done == b.steps_done
    assert [stream_state(s) for s in a.batcher.streams] == \
        [stream_state(s) for s in b.batcher.streams]


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_pipelined_and_sequential_runs_are_bit_equal(cfg, params, impl):
    """``run`` (each chunk dispatched with the next one prefetched) and
    ``dispatch_chunk(L, prefetch=0)`` + ``collect_chunk`` chunk after
    chunk give the same adapters, Adam moments, losses and streams; a
    pending chunk's metrics stay tensors until it is collected."""
    piped = _runtime(cfg, params, impl=impl)
    piped.run(6)
    seq = _runtime(cfg, params, impl=impl)
    for i in range(3):
        pending = seq.dispatch_chunk(2, prefetch=0)
        assert isinstance(pending, PendingChunk)
        assert all(isinstance(v, torch.Tensor)
                   for v in pending.metrics.values())
        assert seq.report.steps == 2 * i    # nothing folded before collect
        seq.collect_chunk(pending)
    assert piped.report.steps == seq.report.steps == 6
    _assert_same_state(piped, seq)


def test_steps_done_lags_until_collect(cfg, params):
    rt = _runtime(cfg, params)
    pending = rt.dispatch_chunk(2, prefetch=2)
    assert rt.steps_done == {"job-a": 0, "job-b": 0} and rt.report.steps == 0
    rt.collect_chunk(pending)
    assert rt.steps_done == {"job-a": 2, "job-b": 2} and rt.report.steps == 2
    with pytest.raises(AssertionError):   # a prefetch of another length
        rt.dispatch_chunk(1)


def test_inflight_migration_is_bit_exact(cfg, params):
    """tests/test_lossless.py:450 on the port: a mixed-rank pair merged
    through the double-buffered path — the destination fused from
    snapshots at step k and warmed while the sources step k more, then
    refreshed with their exports at the fence — equals the stop-the-world
    merge at step 2k bit for bit: adapters, Adam moments, per-job Adam
    steps, step counts and stream positions."""
    small = LoRAJobSpec("small", rank=4, batch_size=2, seq_len=SEQ)
    wide = LoRAJobSpec("wide", rank=64, batch_size=1, seq_len=SEQ)
    k = 2
    kw = dict(impl="cuda", block_t=BT, lr=LR, remat=False, seed=7,
              chunk_size=k, device="cpu")

    def solos():
        return [GroupRuntime.from_states(
            cfg, params, [JobTrainState.fresh(s, cfg, i + 1, seed=7)], **kw)
            for i, s in enumerate((small, wide))]

    # stop the world at step 2k
    ref = solos()
    for rt in ref:
        rt.run(2 * k)
    ref_merged = GroupRuntime.from_states(
        cfg, params, [rt.export(rt.job_ids[0]) for rt in ref], **kw)
    ref_merged.run(k)

    # overlapped: destination prepared from stale snapshots at step k
    src = solos()
    for rt in src:
        rt.run(k)
    dest = GroupRuntime.from_states(
        cfg, params, [rt.export(rt.job_ids[0]) for rt in src], **kw)
    assert dest.steps_done == {"small": k, "wide": k}
    assert dest.warm([k]) >= 0.0
    for rt in src:
        rt.run(k)                        # the sources step past the snapshot
    for rt in src:                       # the fence: authoritative exports
        rt.discard_staged()
        dest.refresh_member(rt.export(rt.job_ids[0]))
    dest.run(k)

    for jid, rank in (("small", 4), ("wide", 64)):
        want, have = ref_merged.export(jid), dest.export(jid)
        assert have.opt_step == want.opt_step == 3 * k
        assert have.steps_done == want.steps_done == 3 * k
        assert {v.shape[-1] if key.endswith("A") else v.shape[-2]
                for key, v in have.adapter.items()} == {rank}
        for key in want.adapter:
            assert torch.equal(have.adapter[key], want.adapter[key])
            assert torch.equal(have.mu[key], want.mu[key])
            assert torch.equal(have.nu[key], want.nu[key])
        assert stream_state(have.stream) == stream_state(want.stream)


def test_refresh_member_refuses_after_stepping(cfg, params):
    rt = _runtime(cfg, params)
    rt.run(2)
    with pytest.raises(AssertionError, match="after stepping"):
        rt.refresh_member(rt.export("job-a"))


def test_discard_staged_rewinds_the_streams(cfg, params):
    """A fence between chunks: the prefetched next chunk is dropped and
    the streams rewound to where the collected chunk left them, the
    positions a run without prefetch reaches; an export then carries
    no data the group never trained on."""
    rt = _runtime(cfg, params)
    rt.collect_chunk(rt.dispatch_chunk(2, prefetch=2))
    seq = _runtime(cfg, params)
    seq.collect_chunk(seq.dispatch_chunk(2, prefetch=0))
    want = [stream_state(s) for s in seq.batcher.streams]
    assert [stream_state(s) for s in rt.batcher.streams] != want
    rt.discard_staged()
    assert [stream_state(s) for s in rt.batcher.streams] == want
    assert stream_state(rt.export("job-b").stream) == want[1]
    rt.discard_staged()                   # nothing staged: a no-op
    assert [stream_state(s) for s in rt.batcher.streams] == want
    # and the runtime trains on exactly the batches the sequential one does
    rt.run(2)
    seq.run(2)
    _assert_same_state(rt, seq)


def test_warm_consumes_no_data(cfg, params):
    """``warm`` builds the step closures (and, on the card, the kernels'
    libraries and tables) and returns its wall seconds; it stages a probe
    batch but rewinds the streams, so the warmed runtime trains on the
    same batches as a cold one, bit for bit."""
    rt = _runtime(cfg, params)
    before = [stream_state(s) for s in rt.batcher.streams]
    secs = rt.warm([2, 1])
    assert isinstance(secs, float) and secs >= 0.0
    assert (1, 2) in rt._step_cache and (1, 1) in rt._step_cache
    assert [stream_state(s) for s in rt.batcher.streams] == before
    assert rt.report.steps == 0 and rt._staged is None
    cold = _runtime(cfg, params)
    rt.run(3)
    cold.run(3)
    _assert_same_state(rt, cold)


def test_periodic_checkpoint_persists_the_pre_prefetch_position(
        cfg, params, tmp_path):
    """The hook fires at collect time, after the next chunk was
    prefetched: it writes the positions the collected chunk's state was
    trained to, so a job restored from it trains on exactly the batches
    the live group trains on next."""
    rt = _runtime(cfg, params, checkpoint_dir=str(tmp_path),
                  checkpoint_every=1)
    rt.collect_chunk(rt.dispatch_chunk(2, prefetch=2))
    assert rt.last_checkpoint_step == {"job-a": 2, "job-b": 2}
    spec = rt.specs[1]
    restored = JobTrainState.from_checkpoint(
        str(tmp_path / "job-b.npz"), spec, cfg, seed=3)
    assert restored.steps_done == 2
    live_next = stream_state(rt.batcher.streams[1])
    assert stream_state(restored.stream) != live_next     # prefetched past
    rt.discard_staged()
    assert stream_state(restored.stream) == \
        stream_state(rt.batcher.streams[1])
    # the restored job alone trains on the batches the live job trains on
    alone = GroupRuntime.from_states(cfg, params, [restored], impl="cuda",
                                     block_t=BT, lr=LR, remat=False,
                                     chunk_size=2, seed=3, device="cpu")
    control = GroupRuntime.from_states(cfg, params, [rt.export("job-b")],
                                       impl="cuda", block_t=BT, lr=LR,
                                       remat=False, chunk_size=2, seed=3,
                                       device="cpu")
    alone.run(2)
    control.run(2)
    _assert_same_state(alone, control)


def test_live_publish_from_group_runtime(cfg, params):
    """tests/test_serve.py:199 on the port: the ``publish_every`` hook
    fires during ``run`` (2 chunks, 2 publishes), an explicit
    ``publish_to`` serves the same tokens as the members' ``export``
    snapshots, and the published slices are the trained ones."""
    jobs = [LoRAJobSpec("job-a", rank=8, batch_size=1, seq_len=16),
            LoRAJobSpec("job-b", rank=4, batch_size=1, seq_len=16)]
    hook_pool = AdapterPool(cfg, multiple=8, device="cpu")
    rt = GroupRuntime.from_specs(cfg, jobs, params=params, seed=0, lr=LR,
                                 impl="cuda", block_t=BT, remat=False,
                                 chunk_size=2, publish_pool=hook_pool,
                                 publish_every=1, device="cpu")
    init = {jid: rt.export(jid).adapter for jid in rt.job_ids}
    rt.run(4)
    assert sorted(hook_pool.names) == ["job-a", "job-b"]
    assert hook_pool.version_of("job-a") == 1        # republished once

    pool_live = AdapterPool(cfg, multiple=8, device="cpu")
    rt.publish_to(pool_live)
    pool_snap = AdapterPool(cfg, multiple=8, device="cpu")
    for jid in rt.job_ids:
        pool_snap.publish_state(rt.export(jid))
    prompt = np.arange(1, 10, dtype=np.int32)
    reqs = [ServeRequest(prompt=prompt, adapter=jid, max_new_tokens=4)
            for jid in rt.job_ids]
    out_live = ServeEngine(cfg, rt.params, pool_live, impl="cuda",
                           block_t=BT).serve(reqs)
    out_snap = ServeEngine(cfg, rt.params, pool_snap, impl="cuda",
                           block_t=BT).serve(reqs)
    for a, b in zip(out_live, out_snap):
        assert np.array_equal(a.tokens, b.tokens)
    live = rt.export("job-a").adapter
    assert any(not torch.equal(live[key], init["job-a"][key])
               for key in live)
