"""One train step of the port through its LoRA impls against the
reference on the CPU: tests/test_lossless.py::test_impls_agree_on_train_step
("torch", "cuda" (its plain versions on the CPU) and "loop" against
"ref", and "torch" against the reference's "xla"), and
tests/test_ragged_kernels.py::test_unsharded_nano_slices_use_exact_fallback
for "torch".  Reduced tinyllama-1.1b in f32, the same weights (the
reference's ``init_model`` / ``init_adapters`` carried across) and the
same batch; per-job losses at the reference's rtol 1e-4 / atol 1e-5
between impls.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.core.jobs import LoRAJobSpec as RefSpec
from repro.core.ssm import SharedSuperModel as RefSSM
from repro.data.pipeline import FusedBatcher as RefBatcher
from repro.optim import adamw as ref_adamw
from repro.optim.schedule import constant as ref_constant

from repro_torch.configs import get_config
from repro_torch.core.jobs import LoRAJobSpec
from repro_torch.core.ssm import SharedSuperModel
from repro_torch.models.convert import adapters_from_numpy, params_from_numpy
from repro_torch.optim import adamw
from repro_torch.optim.schedule import constant


def _cfgs():
    ref = dataclasses.replace(ref_get_config("tinyllama-1.1b").reduced(),
                              dtype="float32")
    port = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                               dtype="float32")
    return ref, port


def _one_step_losses(jobs_ref, jobs_port, impls_ref, impls_port, nano=1,
                     block_t=8):
    """Per-job losses of one train step from the same weights and batch,
    through each reference impl and each port impl."""
    ref_cfg, cfg = _cfgs()
    ssm = RefSSM(ref_cfg, jobs_ref, impl="ref", block_t=block_t)
    params, adapters = ssm.init(jax.random.PRNGKey(7))
    batch = RefBatcher(jobs_ref, ref_cfg.vocab_size, block_t=block_t,
                       seed=1).next_batch()
    out = {}
    for impl in impls_ref:
        s = RefSSM(ref_cfg, jobs_ref, impl=impl, block_t=block_t)
        step = jax.jit(s.make_train_step(lr_fn=ref_constant(1e-2),
                                         nano_batches=nano, remat=False))
        opt = ref_adamw.init(adapters, per_job=len(jobs_ref))
        _, _, m = step(params, adapters, opt,
                       {k: jnp.asarray(v) for k, v in batch.items()})
        out["jax-" + impl] = np.asarray(m["per_job_loss"])
    p = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    a = adapters_from_numpy(jax.tree.map(np.asarray, adapters), "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for impl in impls_port:
        s = SharedSuperModel(cfg, jobs_port, impl=impl, block_t=block_t)
        step = s.make_train_step(lr_fn=constant(1e-2), nano_batches=nano,
                                 remat=False)
        _, _, m = step(p, a, adamw.init(a, per_job=len(jobs_port)), tb)
        out[impl] = m["per_job_loss"].numpy()
    return out


def test_impls_agree_on_train_step():
    """tests/test_lossless.py:435 for the port: one train step's per-job
    losses through "torch", "cuda" (its plain versions on the CPU) and
    "loop" against "ref" at the reference's rtol 1e-4 / atol 1e-5, and
    "torch" against the reference's "xla"."""
    specs = [("job-a", 4, 2), ("job-b", 8, 1)]
    out = _one_step_losses(
        [RefSpec(j, rank=r, batch_size=b, seq_len=32) for j, r, b in specs],
        [LoRAJobSpec(j, rank=r, batch_size=b, seq_len=32)
         for j, r, b in specs],
        ("xla",), ("ref", "torch", "cuda", "loop"))
    for impl in ("torch", "cuda", "loop"):
        np.testing.assert_allclose(out[impl], out["ref"], rtol=1e-4,
                                   atol=1e-5, err_msg=impl)
    np.testing.assert_allclose(out["torch"], out["jax-xla"], rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("ranks", [(4, 8), (4, 64)])
def test_unsharded_nano_slices_use_exact_fallback(ranks):
    """tests/test_ragged_kernels.py:278 for "torch": equal rows (2, 2), so
    the nano = 2 slices are single-job — the layout a scaled static map
    would get wrong.  "torch" at N = 2 agrees with "ref" and with the
    reference's "xla", on a uniform (4, 8: masked) and a mixed (4, 64:
    ragged) layout."""
    specs = [("job-a", ranks[0]), ("job-b", ranks[1])]
    out = _one_step_losses(
        [RefSpec(j, rank=r, batch_size=2, seq_len=32) for j, r in specs],
        [LoRAJobSpec(j, rank=r, batch_size=2, seq_len=32) for j, r in specs],
        ("xla",), ("ref", "torch"), nano=2)
    np.testing.assert_allclose(out["torch"], out["ref"], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(out["torch"], out["jax-xla"], rtol=1e-4,
                               atol=1e-5)


def test_equal_segments_follow_the_rows():
    """The SSM hands MultiLoRA the reference's segment facts: seg_rows
    the largest per-job row count, equal_segments when all are equal."""
    _, cfg = _cfgs()
    eq = SharedSuperModel(cfg, [LoRAJobSpec("a", 4, 2, seq_len=32),
                                LoRAJobSpec("b", 8, 2, seq_len=32)],
                          block_t=8)
    ctx = eq.lora_ctx(torch.zeros(4, dtype=torch.int32))
    assert (ctx.seg_rows, ctx.equal_segments) == (2, True)
    uneq = SharedSuperModel(cfg, [LoRAJobSpec("a", 4, 2, seq_len=32),
                                  LoRAJobSpec("b", 8, 1, seq_len=32)],
                            block_t=8)
    ctx = uneq.lora_ctx(torch.zeros(3, dtype=torch.int32))
    assert (ctx.seg_rows, ctx.equal_segments) == (2, False)
