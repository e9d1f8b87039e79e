"""The flash kernel's (head dim, v width) pairs, and the plain flash at a
v narrower than q/k and without the causal mask, on the CPU.

``check_kernel_operands`` is the check the wrapper makes before any
build: it accepts exactly the pairs the kernel is instantiated at —
(32, 32), (64, 64), (128, 128), (192, 128) (MLA) and (80, 80)
(hubert-xlarge) — in bf16, and refuses every other pair for its widths.
Here, with CPU tensors, an accepted pair is refused only for its device.

``flash_attention_ref`` (what the wrapper runs on a CPU tensor, the
kernel's plain version) is held against the reference's
``flash_attention_ref`` and its Pallas kernel in interpret mode at
(48, 32) and (80, 80), causal and not, in float32: 1e-5 absolute (the
same f32 products, summed in other orders).
"""
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import flash_attention as ref_flash

from repro_torch.kernels import flash_attention

PAIRS = ((32, 32), (64, 64), (128, 128), (192, 128), (80, 80))
WIDTHS = (32, 48, 64, 80, 96, 128, 192, 256)


def test_kernel_takes_exactly_its_pairs():
    assert set(flash_attention.KERNEL_HEAD_DIMS) == set(PAIRS)
    for hd, vd in itertools.product(WIDTHS, WIDTHS):
        q = torch.zeros((4, 16, hd), dtype=torch.bfloat16)
        k = torch.zeros((2, 16, hd), dtype=torch.bfloat16)
        v = torch.zeros((2, 16, vd), dtype=torch.bfloat16)
        match = "device" if (hd, vd) in PAIRS else "head dim"
        with pytest.raises(ValueError, match=match):
            flash_attention.check_kernel_operands(q, k, v)


def test_kernel_refuses_k_narrower_than_q():
    q = torch.zeros((4, 16, 192), dtype=torch.bfloat16)
    k = torch.zeros((2, 16, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.check_kernel_operands(q, k, k)


def test_wrapper_checks_v_against_k():
    """v must have k's batch and key count; its width may differ."""
    q = torch.zeros((4, 16, 48))
    k = torch.zeros((4, 16, 48))
    with pytest.raises(ValueError):
        flash_attention.flash_attention_fwd(q, k, torch.zeros((4, 15, 32)))
    out, lse = flash_attention.flash_attention_fwd(q, k,
                                                   torch.zeros((4, 16, 32)))
    assert out.shape == (4, 16, 32) and lse.shape == (4, 16)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd,vd", [(48, 32), (80, 80), (192, 128)])
def test_plain_flash_matches_reference(hd, vd, causal):
    rng = np.random.default_rng(hd + vd + causal)
    BH, S = 4, 32
    q, k = (rng.standard_normal((BH, S, hd)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((BH, S, vd)).astype(np.float32)
    got, lse = flash_attention.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal)
    assert got.shape == (BH, S, vd) and lse.shape == (BH, S)
    want = ref_flash.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    pallas = ref_flash.flash_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=16, block_k=16, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=0,
                               atol=1e-5)
    # lse: the log-sum-exp of the scaled, masked scores
    s = np.einsum("bsd,btd->bst", q, k) * hd ** -0.5
    if causal:
        s = np.where(np.tri(S, dtype=bool)[None], s, -1e30)
    m = s.max(-1, keepdims=True)
    want_lse = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=0, atol=1e-5)
