"""An encoder's cached prefill (ROADMAP A9): reduced hubert-xlarge (2
layers, d 256, 4 heads of 32, float32), a fused group of two adapters
(ranks 8 and 16, one row of 32 frames each: B 2, S 32), weights from the
reference's ``SharedSuperModel.init`` at ``PRNGKey(0)`` (B drawn from a
seeded numpy RNG), frames from the reference's ``make_batch`` at
``PRNGKey(1)``.

With a cache the port's attention writes k/v into it and attends over
the prompt's own keys without a causal mask, as the encoder's cacheless
forward does (``models/attention.attn_block``).  The reference's cached
branch goes through ``decode_attention``, which is causal whatever
``cfg.causal`` says (ROADMAP C14): its cached prefill is not its model's
function.  So the port's cached prefill is held against the reference's
CACHELESS prefill (1e-4 relative, other summation orders), against its
own cacheless prefill (1e-5), and layer 0's cache against the
reference's cached layer 0 (its k/v come before any attention, where
C14 does not reach).  A C14 case asserts that the reference still
differs from itself, so that a repair upstream would show.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.configs.base import InputShape as RefShape
from repro.core.jobs import LoRAJobSpec as RefSpec
from repro.core.ssm import SharedSuperModel as RefSSM
from repro.models import model as RM

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core.jobs import LoRAJobSpec
from repro_torch.core.ssm import SharedSuperModel
from repro_torch.models.convert import adapters_from_numpy, params_from_numpy

from torch_sharded_worker import solo_adapters
from torch_train_common import fill_b, one_torch_thread  # noqa: F401

ARCH = "hubert-xlarge"
RANKS, S, BT = (8, 16), 32, 16
SHAPE = dict(name="prefill", seq_len=S, global_batch=len(RANKS),
             kind="prefill")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def setup():
    rc = dataclasses.replace(ref_get_config(ARCH).reduced(), dtype="float32")
    pc = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
    rs = RefSSM(rc, [RefSpec(f"job-{i}", rank=r, batch_size=1, seq_len=S)
                     for i, r in enumerate(RANKS)], impl="ref", block_t=BT)
    params, adapters = jax.tree.map(np.asarray,
                                    jax.jit(rs.init)(jax.random.PRNGKey(0)))
    fill_b(adapters, np.asarray(rs.layout.active_cols)[:, None],
           np.random.default_rng(0))
    frames = np.array(RM.make_batch(rc, RefShape(**SHAPE),
                                    key=jax.random.PRNGKey(1))["frames"])
    ids = np.arange(len(RANKS), dtype=np.int32)
    ref = {}
    pj, aj = (jax.tree.map(jnp.asarray, t) for t in (params, adapters))
    batch = {"frames": jnp.asarray(frames), "adapter_ids": jnp.asarray(ids)}
    for cached in (False, True):
        lg, caches = jax.jit(rs.make_prefill_step(
            RefShape(**SHAPE), with_cache=cached))(pj, aj, batch)
        ref[cached] = (np.asarray(lg), caches)
    ssm = SharedSuperModel(pc, [LoRAJobSpec(f"job-{i}", rank=r, batch_size=1,
                                            seq_len=S)
                                for i, r in enumerate(RANKS)],
                           impl="cuda", block_t=BT)
    port = {"params": params_from_numpy(params, "cpu"),
            "adapters": adapters_from_numpy(adapters, "cpu"),
            "batch": {"frames": torch.from_numpy(frames),
                      "adapter_ids": torch.from_numpy(ids)}}
    return dict(pc=pc, ssm=ssm, ref=ref, **port)


def _prefill(s, cached, **kw):
    step = s["ssm"].make_prefill_step(InputShape(**SHAPE), with_cache=cached)
    return step(s["params"], s["adapters"], s["batch"], **kw)


def test_cached_prefill_is_the_encoders_function(setup):
    """The port's cached prefill against the reference's cacheless one
    (1e-4 relative) and its own cacheless one (1e-5)."""
    got, caches = _prefill(setup, True)
    assert caches is not None and got.shape == (len(RANKS), 1, 504)
    want = setup["ref"][False][0]
    assert _rel(got.numpy(), want) <= 1e-4
    plain, none = _prefill(setup, False)
    assert none is None
    assert _rel(got.numpy(), plain.numpy()) <= 1e-5


def test_layer0_cache_equals_the_references(setup):
    """Layer 0's cached k/v (the first S keys of a cache rounded up to
    whole decode chunks) equal the reference's cached layer 0, which
    C14 does not reach; every layer's keys past S stay zero."""
    _, caches = _prefill(setup, True)
    rc = setup["ref"][True][1]
    for part in ("k", "v"):
        mine = getattr(caches[0]["0"], part)
        want = np.asarray(getattr(rc[0]["0"], part))
        assert mine.shape[:2] == want.shape[:2]
        assert mine.shape[2] >= S and not mine[:, :, S:].any()
        np.testing.assert_allclose(mine[0, :, :S].numpy(), want[0, :, :S],
                                   rtol=1e-5, atol=1e-5)


def test_fused_and_solo_prefills_are_bit_equal(setup):
    """Each job's row prefilled alone, its adapter re-packed as a
    one-job group's, with the dense products on one row's tokens at a
    time: the fused batch's logits bit for bit."""
    fused, _ = _prefill(setup, True, row_block=S)
    lay = setup["ssm"].layout
    for k, r in enumerate(RANKS):
        ssm = SharedSuperModel(setup["pc"], [LoRAJobSpec(
            f"job-{k}", rank=r, batch_size=1, seq_len=S)], impl="cuda",
            block_t=BT)
        step = ssm.make_prefill_step(InputShape(**dict(SHAPE,
                                                       global_batch=1)))
        b = setup["batch"]
        solo, _ = step(setup["params"], solo_adapters(setup["adapters"],
                                                      lay, k, multiple=BT),
                       {"frames": b["frames"][k:k + 1],
                        "adapter_ids": torch.zeros(1, dtype=torch.int32)},
                       row_block=S)
        assert torch.equal(solo[0], fused[k]), k


def test_reference_cached_prefill_is_causal_c14(setup):
    """C14: the reference's cached prefill attends causally
    (``decode_attention``), so its last-position logits part from its
    cacheless ones by more than 0.1 (0.789 measured)."""
    cached, nocache = setup["ref"][True][0], setup["ref"][False][0]
    assert np.abs(cached - nocache).max() > 0.1
