"""The dry run's second layout (ROADMAP A8e): every ``ok`` row prices the
reference's dry-run layout beside the executed one
(``launch/dryrun.layout_2d``).

  * the 2-D weights a rank (``param_bytes_2d``: each leaf's local shard
    under ``rules.param_specs`` with the "D" tag kept) equal, exactly,
    the sum of the local shard bytes that the reference's
    ``repro.sharding.rules.param_specs`` gives on ``jax.eval_shape``
    trees, for every registry config on both production meshes (no
    devices: the specs are taken against the axis sizes);
  * the FSDP all-gather bytes of a step equal the "D" leaves'
    gathered-minus-local bytes (the reference's specs without and with
    "D") times the passes counted (forward; a train step's backward
    once more);
  * the residual stream's saved activations and their "sp" split
    (``src/repro/sharding/specs.py:85-93``) follow their closed form;
  * the 2-D columns of production rows add up from the executed ones,
    and a row has one FLOPs count (the layouts compute the same
    products): ``tests/test_torch_dryrun.py::test_production_rows``,
    whose subprocess makes the rows.
"""
import dataclasses
import math

import pytest

import jax

from repro.configs import get_config as ref_get_config
from repro.models import model as RM
from repro.sharding import rules as ref_rules

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.registry import get_shape
from repro_torch.launch import dryrun
from repro_torch.models import model as M

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _ref_local_bytes(rcfg, sizes, drop=()) -> int:
    """Σ over the reference's backbone leaves (``jax.eval_shape``) of a
    rank's shard bytes under its ``param_specs``."""
    params = jax.eval_shape(lambda: RM.init_model(jax.random.PRNGKey(0),
                                                  rcfg))
    specs = ref_rules.param_specs(sizes, params, drop=drop)
    total = 0
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)
    for leaf, spec in zip(jax.tree.leaves(params),
                          jax.tree.leaves(specs, is_leaf=is_spec)):
        shape = list(leaf.shape)
        for i, entry in enumerate(spec):
            axes = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            shape[i] //= math.prod(sizes[a] for a in axes)
        total += math.prod(shape) * leaf.dtype.itemsize
    return total


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_2d_weights_equal_the_references_shards(arch, mesh):
    sizes = MESHES[mesh]
    want = _ref_local_bytes(ref_get_config(arch), sizes)
    assert dryrun.param_bytes_2d(get_config(arch), sizes) == want


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-v2-lite-16b",
                                  "mamba2-2.7b", "internvl2-26b"])
def test_fsdp_gathers_are_the_d_leaves_missing_bytes(arch):
    """A reduced config on data 2 x model 2: the gather units' bytes,
    summed over the units (a scanned cycle's times its cycles), equal
    the reference's 1-D less 2-D shard bytes; a train step gathers them
    twice, a serve step once."""
    sizes = {"data": 2, "model": 2}
    cfg = get_config(arch).reduced()
    rcfg = ref_get_config(arch).reduced()
    gathers = dryrun.fsdp_gathers(cfg, sizes)
    plan = M.segment_plan(cfg)
    total = sum(b * (plan[int(k[1])].repeats if len(k) == 2 else 1)
                for k, b in gathers.items())
    want = (_ref_local_bytes(rcfg, sizes, drop=("D", "B"))
            - _ref_local_bytes(rcfg, sizes))
    assert total == want > 0
    executed = {"peak": 10 ** 9, "params": 10 ** 8, "resident": 2 * 10 ** 8,
                "coll": {"network": 5.0}}
    for kind, passes in (("train_4k", 2), ("prefill_32k", 1)):
        row = dryrun.layout_2d(cfg, get_shape(kind), sizes, 4, True,
                               executed, "network")
        assert row["fsdp_gather_bytes"] == passes * want
        assert row["fsdp_gather_passes"] == passes
        assert row["collective_bytes_by_link_2d"] == {
            "network": 5.0 + passes * want}
        assert row["fsdp_gather_max_layer_bytes"] == max(gathers.values())


def test_saved_residual_and_its_sp_split():
    """qwen1.5-110b at train_4k, 16 rows a rank: 80 cycles of (16, 4096,
    8192) bf16 checkpoints, 85.9 GB, split over the 16 model ranks under
    "sp"; a batch under 16 splits over "data" too; a serve step saves
    nothing."""
    cfg = get_config("qwen1.5-110b")
    train = get_shape("train_4k")
    saved = dryrun.saved_residual_bytes(cfg, train, 16, True)
    assert saved == 80 * 16 * 4096 * 8192 * 2
    executed = {"peak": 2 * saved, "params": 0, "resident": 0, "coll": {}}
    sizes = MESHES["16x16"]
    row = dryrun.layout_2d(cfg, train, sizes, 16, True, executed, "network")
    assert row["saved_residual_bytes_2d"] == saved // 16
    small = dataclasses.replace(train, global_batch=8)
    row = dryrun.layout_2d(cfg, small, sizes, 16, True, executed, "network")
    assert row["saved_residual_bytes_2d"] == saved // 256
    assert dryrun.saved_residual_bytes(cfg, get_shape("prefill_32k"), 2,
                                       True) == 0


def test_saved_residual_without_remat_keeps_every_layer_input():
    """recurrentgemma-9b scans cycles of three layers: with remat one
    checkpoint a cycle, without it every layer's input."""
    cfg = get_config("recurrentgemma-9b")
    train = get_shape("train_4k")
    plan = M.segment_plan(cfg)
    one = 16 * train.seq_len * cfg.d_model * 2
    layers = sum(seg.repeats * len(seg.specs) for seg in plan)
    assert layers == cfg.num_layers
    cycles = sum(seg.repeats if seg.scanned else len(seg.specs)
                 for seg in plan)
    assert cycles < layers
    assert dryrun.saved_residual_bytes(cfg, train, 16, True) == cycles * one
    assert dryrun.saved_residual_bytes(cfg, train, 16, False) == \
        layers * one
