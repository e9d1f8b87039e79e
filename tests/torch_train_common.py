"""Helpers shared by the port's training tests against the JAX reference
(tests/test_torch_train.py, tests/test_torch_train_nano.py): the reduced
tinyllama-1.1b configs of both packages, the job specs, the reference's
weights with a nonzero B (numpy trees), flattened trees, and
tests/test_lossless.py's bound for adapters after Adam steps.  The
tolerances are stated in each test file's docstring.  ``one_torch_thread``
is a module fixture for the recurrent families' test files."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.core.jobs import LoRAJobSpec as RefSpec
from repro.core.ssm import SharedSuperModel as RefSSM

from repro_torch.configs import get_config

BT = 16
RANKS = (4, 20, 8)
BATCH = (2, 1, 1)
SEQ = 32
LR = 1e-2
RANKS_U = (4, 8, 16)            # all pad to 16: the masked family


def _cfgs(dtype):
    ref = dataclasses.replace(ref_get_config("tinyllama-1.1b").reduced(),
                              dtype=dtype)
    port = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                               dtype=dtype)
    return ref, port


def _specs(cls, ranks=RANKS, batch=BATCH):
    return [cls(f"job-{i}", rank=r, batch_size=b, seq_len=SEQ)
            for i, (r, b) in enumerate(zip(ranks, batch))]


def _flat(tree, path=()):
    """{key path: leaf} of nested dicts and lists."""
    if isinstance(tree, dict):
        return {p: v for k, t in tree.items() for p, v in
                _flat(t, path + (k,)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, t in enumerate(tree) for p, v in
                _flat(t, path + (str(i),)).items()}
    return {path: np.asarray(jnp.asarray(tree, jnp.float32))
            if not isinstance(tree, np.ndarray) else tree.astype(np.float32)}


def _weights(ref_cfg, seed=0, ranks=RANKS, batch=BATCH):
    """Reference params + packed adapters (numpy trees), B nonzero."""
    ssm = RefSSM(ref_cfg, _specs(RefSpec, ranks, batch), impl="pallas",
                 block_t=BT)
    params, adapters = ssm.init(jax.random.PRNGKey(seed))
    params = jax.tree.map(np.asarray, params)
    adapters = jax.tree.map(np.asarray, adapters)
    act = np.asarray(ssm.layout.active_cols)
    rng = np.random.default_rng(seed)

    def fill_b(tree):
        for k, v in tree.items():
            if k == "B":
                tree[k] = (rng.standard_normal(v.shape) * 0.05 * act[:, None]
                           ).astype(np.float32)
            elif isinstance(v, dict):
                fill_b(v)
    for seg in adapters["segments"]:
        fill_b(seg)
    return ssm, params, adapters


def _adam_close(got: dict, want: dict):
    """test_lossless.py's bound for adapters after Adam steps."""
    assert got.keys() == want.keys()
    for p in want:
        w, g = want[p], got[p]
        np.testing.assert_allclose(g, w, atol=2.5 * LR, rtol=0,
                                   err_msg=str(p))
        assert np.mean(np.abs(w - g) < 1e-5) > 0.97, p


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for a test module's small CPU products, then
    the count it found: the test workers share the host's cores, and a
    thread a core in every worker oversubscribes them (a reduced train
    step that takes 0.1 s alone took 20-50 s beside five busy workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
