"""The port's elastic layer on the CPU: lossless migration between groups
(the contract of tests/test_lossless.py::test_elastic_migration_is_lossless),
per-job checkpoints in the reference's ``.npz`` format, and resuming a
job across the two packages in both directions.

Models are reduced tinyllama-1.1b in f32.  Tolerances:
  * within the port, solo -> merged -> solo against solo throughout:
    test_lossless.py's 1e-5 relative and 1e-6 absolute on the per-step
    losses, its Adam bound on the adapters (within 2.5 lr everywhere and
    within 1e-5 for over 97% of the coordinates: Adam divides by
    sqrt(v), so a float-order difference in a near-zero gradient can flip
    one update by up to 2 lr);
  * across the packages, a resumed job's per-step losses at 1e-5
    relative (the frameworks sum the same products in other orders);
    checkpointed arrays, Adam steps and stream tokens exactly.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import checkpoint as ref_ckpt
from repro.configs import get_config as ref_get_config
from repro.core.jobs import LoRAJobSpec as RefSpec
from repro.core.ssm import SharedSuperModel as RefSSM
from repro.elastic.migrate import JobTrainState as RefState
from repro.elastic.migrate import diff_grouping as ref_diff_grouping
from repro.elastic.runtime import GroupRuntime as RefRuntime

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.core.jobs import LoRAJobSpec
from repro_torch.core.lora import RankLayout
from repro_torch.elastic.migrate import (JobTrainState, diff_grouping,
                                         fuse_states, unfuse_state)
from repro_torch.elastic.runtime import GroupRuntime
from repro_torch.models import model as M
from repro_torch.models.convert import (adapters_from_numpy,
                                        params_from_numpy)
from repro_torch.serve import AdapterPool

BT = 16
LR = 1e-2
# ranks 4 and 20 pad to 16 and 32: a mixed group (ragged kernels); each
# job alone is a uniform layout (masked kernels)
RANKS, BATCH, SEQ = (4, 20), (2, 1), 32


def _cfgs():
    ref = dataclasses.replace(ref_get_config("tinyllama-1.1b").reduced(),
                              dtype="float32")
    port = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                               dtype="float32")
    return ref, port


def _specs(cls, ranks=RANKS, batch=BATCH):
    return [cls(f"job-{i}", rank=r, batch_size=b, seq_len=SEQ)
            for i, (r, b) in enumerate(zip(ranks, batch))]


def _adam_close(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        np.testing.assert_allclose(g, w, atol=2.5 * LR, rtol=0, err_msg=k)
        assert np.mean(np.abs(w - g) < 1e-5) > 0.97, k


# ------------------------------------------------ lossless migration
def test_elastic_migration_is_lossless():
    """solo (a: k steps, b: k-1 steps) -> merged k steps -> a extracted,
    solo again k steps, against each job solo throughout.  The two jobs
    join at different Adam steps (k and k-1), which pins the per-job
    bias-correction accounting; the merged group runs the ragged kernels
    and each solo group the masked ones."""
    _, cfg = _cfgs()
    job_a, job_b = _specs(LoRAJobSpec)
    k = 3
    params = M.init_model(cfg, seed=7, device="cpu")
    kw = dict(lr=LR, impl="cuda", block_t=BT, remat=False, device="cpu")

    def fresh(spec, s):
        return JobTrainState.fresh(spec, cfg, s)

    def solo_curve(spec, s, steps):
        rt = GroupRuntime.from_states(cfg, params, [fresh(spec, s)], **kw)
        return [l[0] for l in rt.run(steps).per_job_losses]

    ref_a = solo_curve(job_a, 1, 3 * k)
    ref_b = solo_curve(job_b, 2, (k - 1) + 2 * k)

    ra = GroupRuntime.from_states(cfg, params, [fresh(job_a, 1)], **kw)
    ra.run(k)
    rb = GroupRuntime.from_states(cfg, params, [fresh(job_b, 2)], **kw)
    rb.run(k - 1)
    assert ra.ssm.layout.is_uniform and rb.ssm.layout.is_uniform
    merged = GroupRuntime.from_states(
        cfg, params, [ra.export(job_a.job_id), rb.export(job_b.job_id)],
        **kw)
    assert not merged.ssm.layout.is_uniform
    assert merged.opt_state.step.tolist() == [k, k - 1]
    assert merged.steps_done == {job_a.job_id: k, job_b.job_id: k - 1}
    merged.run(k)
    solo_again = GroupRuntime.from_states(
        cfg, params, [merged.export(job_a.job_id)], **kw)
    solo_again.run(k)

    got_a = ([l[0] for l in ra.report.per_job_losses]
             + [l[0] for l in merged.report.per_job_losses]
             + [l[0] for l in solo_again.report.per_job_losses])
    got_b = ([l[0] for l in rb.report.per_job_losses]
             + [l[1] for l in merged.report.per_job_losses])
    np.testing.assert_allclose(got_a, ref_a, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_b, ref_b[:len(got_b)], rtol=1e-5,
                               atol=1e-6)

    # the extracted state equals the solo-throughout state at 2k
    rt_ref = GroupRuntime.from_states(cfg, params, [fresh(job_a, 1)], **kw)
    rt_ref.run(2 * k)
    want, got = rt_ref.export(job_a.job_id), merged.export(job_a.job_id)
    _adam_close({k_: v.numpy() for k_, v in got.adapter.items()},
                {k_: v.numpy() for k_, v in want.adapter.items()})
    assert got.opt_step == want.opt_step == 2 * k
    assert got.steps_done == 2 * k
    # the exported stream is at the position of the solo run's
    np.testing.assert_array_equal(got.stream.next_batch()["tokens"],
                                  want.stream.next_batch()["tokens"])


def test_fuse_unfuse_is_a_copy_and_host_resident():
    """fuse_states then unfuse_state returns every member's slices, moments
    and step bit for bit, as CPU tensors; lanes beyond each rank stay
    zero in the fused tree."""
    _, cfg = _cfgs()
    specs = _specs(LoRAJobSpec)
    states = [JobTrainState.fresh(s, cfg, i) for i, s in enumerate(specs)]
    g = torch.Generator().manual_seed(0)
    for i, s in enumerate(states):
        s.mu = {k: torch.randn(v.shape, generator=g) for k, v in
                s.adapter.items()}
        s.nu = {k: torch.rand(v.shape, generator=g) for k, v in
                s.adapter.items()}
        s.opt_step = 3 + i
    layout = RankLayout(RANKS, 16)
    adapters, opt = fuse_states(cfg, states, layout)
    for idx, s in enumerate(states):
        back = unfuse_state(adapters, opt, idx, s.spec, layout=layout)
        assert back.opt_step == s.opt_step
        for part in ("adapter", "mu", "nu"):
            for k, v in getattr(s, part).items():
                got = getattr(back, part)[k]
                assert got.device.type == "cpu"
                torch.testing.assert_close(got, v, rtol=0, atol=0)
    act = torch.as_tensor(layout.active_cols)
    leaf = adapters["segments"][0]["0"]["q"]
    assert (leaf["A"][..., ~act] == 0).all()
    assert (leaf["B"][..., ~act, :] == 0).all()


# ------------------------------------------------------- checkpoints
def _trained_runtime(cfg, tmp_path, **kw):
    rt = GroupRuntime.from_specs(cfg, _specs(LoRAJobSpec), seed=3,
                                 impl="cuda", block_t=BT, lr=LR,
                                 remat=False, device="cpu", chunk_size=2,
                                 **kw)
    rt.run(2)
    return rt


def test_save_load_restore_roundtrip(tmp_path):
    """save_job -> load_job -> restore_job into another slot and another
    group returns the job's adapter, moments and Adam step exactly; the
    periodic hook writes every member with its steps and stream."""
    _, cfg = _cfgs()
    rt = _trained_runtime(cfg, tmp_path, checkpoint_dir=str(tmp_path),
                          checkpoint_every=1)
    paths = sorted(os.listdir(tmp_path))
    assert paths == ["job-0.npz", "job-1.npz"]
    z = ckpt.load_job(str(tmp_path / "job-1.npz"))
    assert int(z["__rank__"]) == 20 and str(z["__job_id__"]) == "job-1"
    meta = ckpt.load_meta(z)
    assert meta["steps_done"] == 2 and "state" in meta["stream"]
    # restore job-1 into slot 0 of a group that lists it first
    specs = _specs(LoRAJobSpec)[::-1]
    layout = RankLayout(tuple(s.rank for s in specs), 16)
    dest = GroupRuntime.from_specs(cfg, specs, seed=9, impl="cuda",
                                   block_t=BT, device="cpu")
    off, r_cap = layout.slice_of(0)
    ad, opt, step = ckpt.restore_job(str(tmp_path / "job-1.npz"), 0, off,
                                     dest.adapters, dest.opt_state, r_cap)
    assert step == 2 and opt.step.tolist() == [2, 0]
    want = rt.export("job-1")
    got = unfuse_state(ad, opt, 0, specs[0], layout=layout)
    for part in ("adapter", "mu", "nu"):
        for k, v in getattr(want, part).items():
            torch.testing.assert_close(getattr(got, part)[k], v, rtol=0,
                                       atol=0)
    # the other member's segment is untouched
    other = unfuse_state(ad, opt, 1, specs[1], layout=layout)
    orig = unfuse_state(dest.adapters, dest.opt_state, 1, specs[1],
                        layout=layout)
    for k, v in orig.adapter.items():
        torch.testing.assert_close(other.adapter[k], v, rtol=0, atol=0)


def test_load_job_raises_typed_errors(tmp_path):
    _, cfg = _cfgs()
    rt = _trained_runtime(cfg, tmp_path)
    good = rt.save_checkpoints(str(tmp_path))[0]
    with pytest.raises(FileNotFoundError):
        ckpt.load_job(str(tmp_path / "missing.npz"))
    data = open(good, "rb").read()
    bad = tmp_path / "truncated.npz"
    bad.write_bytes(data[:len(data) // 2])
    with pytest.raises(ckpt.CheckpointCorrupt):
        ckpt.load_job(str(bad))
    with pytest.raises(ckpt.CheckpointCorrupt):
        JobTrainState.from_checkpoint(str(bad), _specs(LoRAJobSpec)[0], cfg)
    partial = tmp_path / "partial.npz"
    np.savez(partial, **{"adapter/x": np.zeros(2, np.float32)})
    with pytest.raises(ckpt.CheckpointCorrupt, match="required keys"):
        ckpt.load_job(str(partial))
    no_moments = tmp_path / "no_moments.npz"
    ckpt.save_job(str(no_moments), "job-0", 0, RANKS[0], rt.adapters,
                  opt_state=None)
    with pytest.raises(ckpt.CheckpointCorrupt, match="moments"):
        JobTrainState.from_checkpoint(str(no_moments),
                                      _specs(LoRAJobSpec)[0], cfg)


# ------------------------------------------------- across the packages
def _ref_weights(ref_cfg):
    ssm = RefSSM(ref_cfg, _specs(RefSpec), impl="ref", block_t=BT)
    params, adapters = ssm.init(jax.random.PRNGKey(5))
    params = jax.tree.map(np.asarray, params)
    adapters = jax.tree.map(np.asarray, adapters)
    rng = np.random.default_rng(5)
    act = np.asarray(ssm.layout.active_cols)

    def fill_b(tree):
        for k, v in tree.items():
            if k == "B":
                tree[k] = (rng.standard_normal(v.shape) * 0.05
                           * act[:, None]).astype(np.float32)
            elif isinstance(v, dict):
                fill_b(v)
    for seg in adapters["segments"]:
        fill_b(seg)
    return params, adapters


def _resume_both(path, idx, ref_cfg, cfg, params, steps):
    """Resume job *idx* from *path* alone in each package; run *steps*."""
    ref_spec, spec = _specs(RefSpec)[idx], _specs(LoRAJobSpec)[idx]
    rs = RefState.from_checkpoint(path, ref_spec, ref_cfg)
    ps = JobTrainState.from_checkpoint(path, spec, cfg)
    for k, v in rs.adapter.items():
        np.testing.assert_array_equal(ps.adapter[k].numpy(), np.asarray(v))
        np.testing.assert_array_equal(ps.mu[k].numpy(), np.asarray(rs.mu[k]))
        np.testing.assert_array_equal(ps.nu[k].numpy(), np.asarray(rs.nu[k]))
    assert (ps.opt_step, ps.steps_done) == (rs.opt_step, rs.steps_done)
    ref_rt = RefRuntime.from_states(
        ref_cfg, jax.tree.map(jnp.asarray, params), [rs], impl="ref",
        block_t=BT, lr=LR, remat=False)
    port_rt = GroupRuntime.from_states(
        cfg, params_from_numpy(params, "cpu"), [ps], impl="cuda",
        block_t=BT, lr=LR, remat=False, device="cpu")
    ref_rt.run(steps)
    port_rt.run(steps)
    np.testing.assert_allclose(np.stack(port_rt.report.per_job_losses),
                               np.stack(ref_rt.report.per_job_losses),
                               rtol=1e-5)
    want, got = ref_rt.export(spec.job_id), port_rt.export(spec.job_id)
    assert got.opt_step == want.opt_step == rs.opt_step + steps
    assert got.steps_done == want.steps_done
    for key in ("tokens", "loss_mask"):
        np.testing.assert_array_equal(got.stream.next_batch()[key],
                                      want.stream.next_batch()[key])


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_resumes_across_packages(tmp_path, writer):
    """A two-job group trains 2 steps in one package and checkpoints every
    member; job-1 then resumes from its ``.npz`` alone in BOTH packages
    for 2 more steps: the loaded arrays are bit-equal, the losses agree,
    the Adam steps and the next stream tokens are the same."""
    ref_cfg, cfg = _cfgs()
    params, adapters = _ref_weights(ref_cfg)
    if writer == "reference":
        rt = RefRuntime.from_specs(
            ref_cfg, _specs(RefSpec), jax.random.PRNGKey(0),
            params=jax.tree.map(jnp.asarray, params),
            adapters=jax.tree.map(jnp.asarray, adapters), impl="ref",
            block_t=BT, lr=LR, remat=False, chunk_size=2)
    else:
        rt = GroupRuntime.from_specs(
            cfg, _specs(LoRAJobSpec), params=params_from_numpy(params, "cpu"),
            adapters=adapters_from_numpy(adapters, "cpu"), impl="cuda",
            block_t=BT, lr=LR, remat=False, chunk_size=2, device="cpu")
    rt.run(2)
    paths = rt.save_checkpoints(str(tmp_path))
    z_keys = set(ref_ckpt.load_job(paths[1]))
    assert z_keys == set(ckpt.load_job(paths[1]))
    _resume_both(paths[1], 1, ref_cfg, cfg, params, steps=2)


# ------------------------------------------------------- publishing
def test_publish_to_pool_serves_the_exported_slices():
    _, cfg = _cfgs()
    rt = GroupRuntime.from_specs(cfg, _specs(LoRAJobSpec), seed=3,
                                 impl="cuda", block_t=BT, lr=LR,
                                 device="cpu")
    pool = AdapterPool(cfg, capacity=4, multiple=16, device="cpu")
    assert rt.publish_to(pool) == {"job-0": 0, "job-1": 0}
    rt.run(1)
    assert rt.publish_to(pool, ["job-1"]) == {"job-1": 1}
    fused = pool.acquire(["job-1"])
    want = rt.export("job-1").adapter
    got = ckpt.slice_job(fused.adapters, 0, 20)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)


def test_diff_grouping_matches_reference():
    old = [("a", "b"), ("c",), ("d", "e")]
    new = [("b", "a"), ("c", "d"), ("e",)]
    assert diff_grouping(old, new) == ref_diff_grouping(old, new)
