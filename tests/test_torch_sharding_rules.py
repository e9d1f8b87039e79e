"""The port's sharding rules (``repro_torch/sharding``) held equal to the
reference's (``repro.sharding.rules`` and ``specs``) on the CPU.

For every registry config at full size — the port's trees built on
``device="meta"`` (shapes only, nothing allocated), the reference's by
``jax.eval_shape`` — and over several mesh geometries (a 2 x 2 mesh,
16 x 16, a pod axis, and model degrees 3 and 7 that divide few dims, so
the divisibility drop fires), ``param_specs`` plain and with the
runtime's ``drop=("D", "B")`` are equal leaf by leaf, a spec being the
reference's ``PartitionSpec`` as a tuple.  ``logical_to_mesh`` and
``spec_for`` are equal for every logical axis, with and without manual
axes and sequence parallelism.  ``shard_params`` cuts each leaf the
runtime specs split over "model" to the rank's block, and a cut tree
cuts to itself.
"""
import functools

import numpy as np
import pytest
import torch

import jax

from repro.configs.registry import get_config as ref_get_config
from repro.models import model as RM
from repro.sharding import rules as ref_rules
from repro.sharding import specs as ref_specs

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import model as M
from repro_torch.sharding import rules, specs

GEOMETRIES = [{"data": 2, "model": 2}, {"data": 16, "model": 16},
              {"pod": 2, "data": 4, "model": 8}, {"data": 1, "model": 3},
              {"data": 5, "model": 7}]


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    cfg = ref_get_config(arch)
    return jax.eval_shape(lambda: RM.init_model(jax.random.PRNGKey(0), cfg))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return M.init_model(get_config(arch), device="meta")


def _flat(tree, path=()):
    """{path: leaf} of a nested dict/list tree (a PartitionSpec, a spec
    tuple or an array is a leaf)."""
    if isinstance(tree, dict):
        return {p: v for k, t in tree.items()
                for p, v in _flat(t, path + (str(k),)).items()}
    if isinstance(tree, list):
        return {p: v for i, t in enumerate(tree)
                for p, v in _flat(t, path + (str(i),)).items()}
    return {"/".join(path): tree}


@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_param_specs_match_the_reference(arch):
    ref_p, port_p = _ref_params(arch), _port_params(arch)
    shapes = {k: tuple(v.shape) for k, v in _flat(port_p).items()}
    assert shapes == {k: tuple(v.shape) for k, v in _flat(ref_p).items()}
    dropped = 0
    for sizes in GEOMETRIES:
        for drop in ((), ("D", "B")):
            want = {k: tuple(v) for k, v in _flat(ref_rules.param_specs(
                sizes, ref_p, drop=drop)).items()}
            got = _flat(rules.param_specs(sizes, port_p, drop=drop))
            assert got == want, (arch, sizes, drop)
            if drop:
                # a rule's "model" tag that did not divide its dim
                dropped += sum(
                    1 for k, s in got.items()
                    if "model" not in s and "model" in rules.leaf_spec(
                        {"model": 1}, k.split("/"), shapes[k], drop))
            # the same specs from shapes alone
            assert _flat(rules.param_specs(sizes, _flat_shapes(port_p),
                                           drop=drop)) == \
                _flat(rules.param_specs(sizes, port_p, drop=drop))
    if arch == "smollm-360m":
        assert dropped > 0     # 15 heads over a model axis of 2, 16, ...


def _flat_shapes(tree):
    if isinstance(tree, dict):
        return {k: _flat_shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_flat_shapes(v) for v in tree]
    return tuple(tree.shape)


def test_the_divisibility_drop():
    """A dim the model axis does not divide stays whole: tinyllama's
    vocab 32000 over 3, its 4 kv heads' 256 columns over 3 and 7."""
    p = _port_params("tinyllama-1.1b")
    s3 = rules.runtime_param_specs({"data": 1, "model": 3}, p)
    s2 = rules.runtime_param_specs({"data": 1, "model": 2}, p)
    assert s2["embed"] == ("model",) and s3["embed"] == ()
    attn2, attn3 = (s["segments"][0]["0"]["attn"] for s in (s2, s3))
    assert attn2["wk"] == (None, None, "model") and attn3["wk"] == ()
    assert s3["segments"][0]["0"]["ffn"]["gate"] == ()   # 5632 % 3
    assert rules.spec_of_shape({"model": 4}, (6, 8), ("M", "M")) == \
        (None, "model")


class _FakeMesh:
    """What the reference's ``logical_to_mesh`` / ``spec_for`` read of a
    mesh: its axis names and sizes."""

    def __init__(self, sizes):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)


LOGICAL = [None, "batch", "seq", "sp", "tokens", "tp", "expert", "data",
           "model", "pod", "nope", ("batch", "tp"), ("tokens",)]


@pytest.mark.parametrize("sizes", GEOMETRIES,
                         ids=["2x2", "16x16", "pod", "m3", "m7"])
def test_logical_axes_match_the_reference(sizes):
    mesh = _FakeMesh(sizes)
    for manual in ((), ("data",)):
        for sp in (False, True):
            with ref_specs.use_mesh(mesh, seq_over_batch=sp, manual=manual):
                for name in LOGICAL:
                    assert specs.logical_to_mesh(
                        sizes, name, manual=manual, seq_over_batch=sp) == \
                        ref_specs.logical_to_mesh(mesh, name), name
                for shape, axes in (((8, 64, 12), ("batch", "seq", "tp")),
                                    ((3, 14, 16), ("tokens", None, "tp")),
                                    ((16, 32), ("sp", "expert"))):
                    assert specs.spec_for(sizes, shape, axes, manual=manual,
                                          seq_over_batch=sp) == \
                        tuple(ref_specs.spec_for(mesh, shape, axes))


def test_shard_params_cuts_each_rank_its_block():
    """Every leaf the runtime specs split over "model" holds the rank's
    contiguous block; the others are the caller's leaves; the ranks'
    blocks put back together are the leaf; cutting a cut tree keeps it;
    a leaf of another shape is refused, and so is a call without the
    config (its kv heads and whole mixers decide the cut)."""
    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    params = M.init_model(cfg, seed=0, device="cpu")
    full = M.init_model(cfg, device="meta")
    spec = _flat(rules.runtime_param_specs({"data": 1, "model": 2}, full))
    cuts = [rules.shard_params(params, full, 2, r, cfg=cfg)
            for r in range(2)]
    whole, parts = _flat(params), [_flat(c) for c in cuts]
    for k, leaf in whole.items():
        dim = next((i for i, e in enumerate(spec[k]) if e == "model"), None)
        if dim is None:
            assert all(p[k] is leaf for p in parts), k
            continue
        assert torch.equal(torch.cat([p[k] for p in parts], dim), leaf), k
        assert parts[0][k].shape[dim] * 2 == leaf.shape[dim]
    assert spec["segments/0/0/ffn/w_in"] == (None, "model")      # E
    again = _flat(rules.shard_params(cuts[1], full, 2, 1,
                                      cfg=cfg))
    assert all(again[k] is v for k, v in parts[1].items())
    nbytes = lambda t: sum(v.numel() * v.element_size()
                           for v in _flat(t).values())
    assert nbytes(cuts[0]) < 0.6 * nbytes(params)
    bad = dict(params, embed=params["embed"][:3])
    with pytest.raises(ValueError, match="neither the whole"):
        rules.shard_params(bad, full, 2, 0, cfg=cfg)
    with pytest.raises(TypeError, match="cfg"):
        rules.shard_params(params, full, 2, 0)


@pytest.mark.parametrize("sizes", GEOMETRIES,
                         ids=["2x2", "16x16", "pod", "m3", "m7"])
def test_batch_specs_match_the_reference(sizes):
    """Rows over the batch axes where they divide the rows, else (with
    ``seq_axis``) the sequence over "data"."""
    from jax.sharding import AbstractMesh
    mesh = AbstractMesh(tuple(sizes.values()), tuple(sizes))
    batch = {"tokens": (16, 64), "labels": (3, 64), "loss_mask": (10, 35),
             "adapter_ids": (16,)}
    arrays = {k: np.zeros(v, np.int32) for k, v in batch.items()}
    for seq in (False, True):
        want = ref_rules.batch_shardings(mesh, arrays, seq_axis=seq)
        assert specs.batch_specs(sizes, batch, seq_axis=seq) == \
            {k: tuple(v.spec) for k, v in want.items()}, (sizes, seq)
