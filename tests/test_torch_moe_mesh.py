"""The MoE over the data-parallel and pipeline meshes (ROADMAP A3) on
the CPU: four gloo ranks (one spawn for the file,
tests/torch_sharded_worker.py, scenarios ``moe_*``) train reduced f32
qwen3-moe-30b-a3b with either dispatch and reduced deepseek-v2-lite-16b
(MLA + MoE, cut to 3 layers) through ``tp_mode="dp"`` on each 2-rank
pair (D = 2: gather and psum at N = 1, gather at N = 2) and through
``tp_mode="pipeline"`` (P = 2 x D = 1, N = 2 micro-batches), the "ab"
job set, impl "cuda" (its kernels' plain versions), block_t 8.

Each run is held against the reference's function over shards, which
is what the reference's fully manual ``shard_map`` step computes for a
MoE model: its ``loss_fn`` on each shard's rows (and each job-wise nano
slice or micro) with the global denominators, the capacity from the
tokens the shard or slice holds and the load-balance aux over them
(``tests/torch_sharded_common.ref_shard_function``), the gradients
summed.  That is not the meshless function (ROADMAP C8): the capacity
dispatch drops other pairs and the aux differs, which the last test
shows.  Bars are PR 25's: per-job losses at 1e-4, adapters and moments
within 2.5e-2 and within 1e-5 for more than 85% of the coordinates,
Adam steps and steps done exactly.
"""
import dataclasses

import numpy as np
import pytest

from repro.configs import get_config as ref_get_config

import torch_sharded_common as C
import torch_sharded_worker as W
from torch_train_common import one_torch_thread  # noqa: F401

REF_RUNS = {("qr", 2, 1), ("qr", 2, 2), ("qc", 2, 1), ("qc", 2, 2),
            ("ds", 2, 1), ("qr", 1, 2), ("qc", 1, 2), ("ds", 1, 2),
            ("qc", 1, 1)}


def _ref_cfg(key):
    return W.moe_cfg(key, ref_get_config)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results, with the reference's per-shard runs made while
    the ranks work."""
    weights = {k: C.ref_weights(_ref_cfg(k), "ab") for k in W.MOE_CFGS}
    handle = C.spawn(W.MOE_MESH, tmp_path_factory.mktemp("moe_mesh"),
                     {k: w["port"] for k, w in weights.items()})
    ref = {(k, d, n): C.ref_shard_function(_ref_cfg(k), "ab",
                                           weights[k]["np"], shards=d,
                                           nano=n)
           for k, d, n in sorted(REF_RUNS)}
    return {"ranks": C.collect(handle), "ref": ref}


@pytest.mark.parametrize("key,name,nano", [
    ("qr", "g1", 1), ("qr", "p1", 1), ("qr", "g2", 2), ("qc", "g1", 1),
    ("qc", "g2", 2), ("ds", "g1", 1), ("ds", "p1", 1)])
def test_data_parallel_matches_the_reference_per_shard(runs, key, name,
                                                       nano):
    """``tp_mode="dp"`` on both pairs against the reference's function
    over the two shards (and the nano slices)."""
    want = runs["ref"][(key, 2, nano)]
    for rank in (0, 1, 2, 3):
        got = C.result(runs["ranks"], "moe_dp", rank)[key][name]
        C.compare(want, got)
        assert np.isfinite(got["aux"]).all() and (got["aux"] > 0).all()


@pytest.mark.parametrize("key", sorted(W.MOE_CFGS))
def test_pipeline_matches_the_reference_per_micro(runs, key):
    """``tp_mode="pipeline"`` (P = 2 x D = 1, N = 2) against the
    reference's function over the two micro-batches: the aux of each
    micro's MoE layers enters the loss on the stage that holds them."""
    want = runs["ref"][(key, 1, 2)]
    for rank in (0, 1, 2, 3):
        got = C.result(runs["ranks"], "moe_pipeline", rank)[key]
        C.compare(want, got)


def test_the_per_shard_function_is_not_the_meshless_one(runs):
    """The capacity dispatch over two shards drops other pairs than over
    the whole batch, and the aux is the shards' sum (C8): the losses of
    the reference's per-shard function and of its single-device step
    part, which is why the runs above are held to the former."""
    per_shard = runs["ref"][("qc", 2, 1)]["losses"]
    meshless = runs["ref"][("qc", 1, 1)]["losses"]
    assert np.abs(per_shard - meshless).max() > 1e-4
    got = C.result(runs["ranks"], "moe_dp", 0)["qc"]["g1"]["losses"]
    C.losses_close(per_shard, got)
