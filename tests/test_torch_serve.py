"""The PyTorch port's serving path held against the JAX reference on the
CPU, on reduced tinyllama-1.1b.

Weights come from the reference's ``init_model`` / ``init_adapters``
(B drawn from a seeded numpy RNG, so that every adapter changes the
output), exported with ``np.asarray`` and carried across with
``models/convert.py``.  The port's "cuda" impl runs its kernels' plain
versions on CPU tensors; the reference's "pallas" impl runs its kernels
in interpret mode.  Tolerances:
  * f32 logits: 1e-4 absolute — same math, other summation orders;
  * bf16 logits: 0.1 absolute — both frameworks round every op to bf16,
    but XLA and PyTorch sum the CPU matmuls in other orders, and a
    one-ulp flip (2^-8 relative) in a hidden state carries through the
    layers to the O(1) logits;
  * token ids: exact — greedy argmax over f32 logits.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.core.lora import MultiLoRA as RefMultiLoRA
from repro.core.lora import RankLayout as RefRankLayout
from repro.models import attention as ref_attn
from repro.models import model as RM
from repro.serve import AdapterPool as RefPool
from repro.serve import ServeEngine as RefEngine
from repro.serve import ServeRequest as RefRequest

from repro_torch.configs import get_config
from repro_torch.core.jobs import LoRAJobSpec
from repro_torch.core.lora import MultiLoRA, RankLayout
from repro_torch.models import attention, layers
from repro_torch.models import model as M
from repro_torch.models.convert import adapters_from_numpy, params_from_numpy
from repro_torch.serve import AdapterPool, ServeEngine, ServeRequest


def _cfgs(dtype):
    ref = dataclasses.replace(ref_get_config("tinyllama-1.1b").reduced(),
                              dtype=dtype)
    port = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                               dtype=dtype)
    return ref, port


def _weights(ref_cfg, ranks, seed=0):
    """Reference params + packed adapters (numpy trees), B nonzero."""
    lay = RefRankLayout(tuple(ranks), 8)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    params = jax.tree.map(np.asarray, RM.init_model(k1, ref_cfg))
    adapters = jax.tree.map(np.asarray, RM.init_adapters(
        k2, ref_cfg, jnp.asarray(ranks, jnp.int32), layout=lay))
    rng = np.random.default_rng(seed)

    def fill_b(tree):
        for k, v in tree.items():
            if k == "B":
                act = np.asarray(lay.active_cols)[:, None]
                tree[k] = (rng.standard_normal(v.shape) * 0.05 * act
                           ).astype(np.float32)
            elif isinstance(v, dict):
                fill_b(v)
    for seg in adapters["segments"]:
        fill_b(seg)
    return lay, params, adapters


def _specs(ranks):
    return [LoRAJobSpec(f"ad{i}", rank=r, batch_size=1)
            for i, r in enumerate(ranks)]


def _engines(ranks, ref_impl, port_impl, block_t=8, capacity=None,
             dtype="float32"):
    """A reference and a port engine over the same weights."""
    ref_cfg, port_cfg = _cfgs(dtype)
    lay, params, adapters = _weights(ref_cfg, ranks)
    specs = _specs(ranks)
    ref_pool = RefPool(ref_cfg, capacity=capacity or len(ranks), multiple=8)
    ref_pool.publish_group(specs, adapters, lay)
    pool = AdapterPool(port_cfg, capacity=capacity or len(ranks), multiple=8,
                       device="cpu")
    pool.publish_group(specs, adapters_from_numpy(adapters, "cpu"),
                       RankLayout(tuple(ranks), 8))
    ref = RefEngine(ref_cfg, jax.tree.map(jnp.asarray, params), ref_pool,
                    impl=ref_impl, block_t=block_t)
    port = ServeEngine(port_cfg, params_from_numpy(params, "cpu"), pool,
                       impl=port_impl, block_t=block_t)
    return specs, ref, port, pool


def _requests(vocab, names, n, seed=0, max_new=4):
    rng = np.random.default_rng(seed)
    return [dict(prompt=rng.integers(1, vocab, size=int(rng.integers(3, 15)),
                                     dtype=np.int32),
                 adapter=names[i % len(names)], max_new_tokens=max_new)
            for i in range(n)]


# ------------------------------------------------- (a) decode_step logits
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 0.1)])
def test_decode_step_logits_match_reference(dtype, tol):
    ranks = (8, 4, 16)
    ref_cfg, port_cfg = _cfgs(dtype)
    lay, params, adapters = _weights(ref_cfg, ranks, seed=1)
    rng = np.random.default_rng(2)
    B, S, buf = 3, 8, 16
    aid = np.arange(B, dtype=np.int32)
    scal = (16.0 / np.asarray(ranks)).astype(np.float32)
    tokens = rng.integers(1, ref_cfg.vocab_size, (B, S)).astype(np.int32)
    pos = np.asarray([8, 5, 3], np.int32)
    nxt = rng.integers(1, ref_cfg.vocab_size, (B, 1)).astype(np.int32)

    ctx = RefMultiLoRA(adapter_ids=jnp.asarray(aid),
                       ranks=jnp.asarray(ranks, jnp.int32),
                       scalings=jnp.asarray(scal), impl="ref", layout=lay,
                       rows_all=(1, 1, 1))
    jp = jax.tree.map(jnp.asarray, params)
    ja = jax.tree.map(jnp.asarray, adapters)
    caches = RM.init_caches(ref_cfg, B, buf, ring=False)
    want0, caches = RM.decode_step(ref_cfg, jp, ja, ctx, jnp.asarray(tokens),
                                   0, caches)
    want1, _ = RM.decode_step(ref_cfg, jp, ja, ctx, jnp.asarray(nxt),
                              jnp.asarray(pos), caches)

    port = MultiLoRA(adapter_ids=torch.from_numpy(aid),
                     ranks=torch.tensor(ranks, dtype=torch.int32),
                     scalings=torch.from_numpy(scal), impl="ref",
                     layout=RankLayout(ranks, 8), rows_all=(1, 1, 1))
    tp = params_from_numpy(params, "cpu")
    ta = adapters_from_numpy(adapters, "cpu")
    tc = M.init_caches(port_cfg, B, buf, device="cpu")
    got0, tc = M.decode_step(port_cfg, tp, ta, port, torch.from_numpy(tokens),
                             0, tc)
    got1, _ = M.decode_step(port_cfg, tp, ta, port, torch.from_numpy(nxt),
                            torch.from_numpy(pos), tc)
    for got, want in ((got0, want0), (got1, want1)):
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=tol, rtol=0)


# --------------------------------------------- (b) serve vs the reference
@pytest.mark.parametrize("ranks", [(8, 4, 16), (8, 3, 6)])   # mixed, uniform
@pytest.mark.parametrize("ref_impl,port_impl", [("ref", "ref"),
                                                ("pallas", "cuda")])
def test_serve_token_ids_match_reference(ranks, ref_impl, port_impl):
    specs, ref, port, _ = _engines(ranks, ref_impl, port_impl)
    reqs = _requests(ref.cfg.vocab_size, [s.job_id for s in specs], n=4,
                     max_new=3)
    want = ref.serve([RefRequest(**r) for r in reqs])
    got = port.serve([ServeRequest(**r) for r in reqs])
    for a, b in zip(want, got):
        assert a.adapter == b.adapter and a.prompt_len == b.prompt_len
        assert a.tokens.tolist() == b.tokens.tolist()


# ----------------------------------------------- (c) fused == solo, port
@pytest.mark.parametrize("impl", ["cuda", "ref"])
@pytest.mark.parametrize("ranks", [(8,), (16, 8, 4), (16, 8, 4, 2, 8, 4, 16, 2)])
def test_fused_matches_solo_exactly(ranks, impl):
    """K in {1, 3, 8} mixed-rank adapters, ragged prompt lengths: each
    request's fused tokens == its solo tokens, id for id."""
    _, port_cfg = _cfgs("float32")
    specs, _, engine, _ = _engines(ranks, "ref", impl)
    reqs = [ServeRequest(**r) for r in _requests(
        port_cfg.vocab_size, [s.job_id for s in specs],
        n=max(4, len(ranks)), max_new=4)]
    fused = engine.serve(reqs)
    for r, f in zip(reqs, fused):
        solo = engine.serve([r])[0]
        assert np.array_equal(f.tokens, solo.tokens), (r.adapter, f, solo)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_does_not_depend_on_buffer_width(dtype):
    """A row's decode attention over caches of one and three key chunks
    (the columns past every row's kv_len holding other data), alone in a
    cache of two, and in row blocks (the serving decode path on the
    card): bit-equal in the storage dtype, since the key chunks have a
    fixed width whatever the buffer's.  A cache of another width is
    refused.  Against the reference's decode_attention: 1e-5 in f32,
    2e-2 in bf16 (its output rounded to bf16)."""
    rng = np.random.default_rng(0)
    C = attention.DECODE_CHUNK
    B, H, KV, hd, wide = 3, 4, 2, 16, 3 * C
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    pos = np.array([5, 17, C + 39])
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, wide, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, wide, KV, hd)).astype(np.float32)
    qt, kt, vt = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    pt = torch.from_numpy(pos)

    def port(rows, width, row_block=None):
        cache = attention.KVCache(kt[rows, :width].contiguous(),
                                  vt[rows, :width].contiguous())
        return attention.decode_attention(qt[rows], cache, pt[rows],
                                          window=None, row_block=row_block)

    out2 = port(slice(0, 3), 2 * C)
    assert torch.equal(out2, port(slice(0, 3), wide))
    assert torch.equal(out2[:2], port(slice(0, 2), C))
    assert torch.equal(out2, port(slice(0, 3), wide, row_block=2))
    with pytest.raises(ValueError, match="whole chunks"):
        port(slice(0, 3), C + 16)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = ref_attn.decode_attention(
        jnp.asarray(q, jdt), ref_attn.KVCache(jnp.asarray(k[:, :2 * C], jdt),
                                              jnp.asarray(v[:, :2 * C], jdt)),
        jnp.asarray(pos, jnp.int32), window=None, ring=False)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(out2.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_row_blocks_leave_products_unchanged():
    """``layers.dense`` with a row block runs n rows at a time (the
    decode path's solo row count on the card), without one all at once;
    the values are the same.  The engine blocks its decode steps only on
    the card."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 5, 24)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((24, 7)).astype(np.float32))
    whole = layers.dense(x, w)
    blocked = layers.dense(x, w, row_block=4)
    assert blocked.shape == (2, 5, 7)
    torch.testing.assert_close(blocked, whole, rtol=1e-6, atol=1e-6)
    ref_cfg, port_cfg = _cfgs("float32")
    lay, params, _ = _weights(ref_cfg, (8,), seed=0)
    engine = ServeEngine(port_cfg, params_from_numpy(params, "cpu"),
                         AdapterPool(port_cfg, capacity=2, multiple=8,
                                     device="cpu"), impl="cuda")
    assert engine._row_block is None


@pytest.mark.parametrize("steps", [0, 2])
def test_next_token_logits_fused_match_solo(steps):
    """After the prompt (steps=0: the prefill logits) and after greedy
    decode steps, fused logits equal solo ones on the CPU."""
    specs, _, engine, _ = _engines((8, 4, 16), "ref", "cuda")
    reqs = [ServeRequest(**r) for r in _requests(
        engine.cfg.vocab_size, [s.job_id for s in specs], n=5)]
    fused = engine.next_token_logits(reqs, steps)
    solo = torch.cat([engine.next_token_logits([r], steps) for r in reqs])
    assert fused.shape == (5, engine.cfg.vocab_size)
    torch.testing.assert_close(fused, solo, atol=1e-5, rtol=0)


def test_generation_matches_cacheless_forward():
    """Engine output == greedy continuation of the cache-less forward of
    one request at its true positions (no caches, no padding)."""
    specs, _, engine, pool = _engines((16, 4), "ref", "cuda")
    prompt = np.random.default_rng(3).integers(
        1, engine.cfg.vocab_size, size=9, dtype=np.int32)
    got = engine.serve([ServeRequest(prompt=prompt, adapter="ad1",
                                     max_new_tokens=5)])[0].tokens
    fused = pool.acquire(("ad1",))
    ctx = MultiLoRA(adapter_ids=torch.zeros(1, dtype=torch.int32),
                    ranks=fused.ranks, scalings=fused.scalings, impl="ref",
                    layout=fused.layout)
    seq = list(prompt)
    for _ in range(5):
        logits = M.forward(engine.cfg, engine.params, fused.adapters, ctx,
                           {"tokens": torch.tensor([seq])})
        seq.append(int(logits[0, -1].argmax()))
    assert got.tolist() == seq[len(prompt):]


# ------------------------------------------------- (d) requests and pool
def test_per_request_max_new_and_stop():
    specs, _, engine, _ = _engines((8, 4), "ref", "cuda")
    rng = np.random.default_rng(1)
    mk = lambda n, **kw: ServeRequest(
        prompt=rng.integers(1, engine.cfg.vocab_size, size=6,
                            dtype=np.int32),
        adapter=specs[0].job_id, max_new_tokens=n, **kw)
    a, b, c = engine.serve([mk(2), mk(7), mk(7)])
    assert len(a.tokens) == 2 and len(b.tokens) == 7 and len(c.tokens) == 7
    stop = int(b.tokens[3])
    req = ServeRequest(prompt=np.arange(1, 7, dtype=np.int32),
                       adapter=specs[0].job_id, max_new_tokens=7)
    full = engine.serve([req])[0].tokens
    stop = int(full[3])
    req.stop_token = stop
    cut = engine.serve([req])[0].tokens
    first = int(np.nonzero(full == stop)[0][0])
    assert cut.tolist() == full[:first + 1].tolist()


def test_engine_rejects_recurrent_mixers_and_encoders():
    for arch in ("mamba2-2.7b", "recurrentgemma-9b"):
        cfg = get_config(arch).reduced()
        pool = AdapterPool(cfg, multiple=8, device="cpu")
        with pytest.raises(ValueError, match="recurrent|ring"):
            ServeEngine(cfg, {}, pool, impl="ref", block_t=8)
    cfg = get_config("hubert-xlarge").reduced()
    with pytest.raises(ValueError, match="causal"):
        ServeEngine(cfg, {}, AdapterPool(cfg, device="cpu"), impl="ref")


def test_pool_lru_evict_refetch_round_trip():
    """capacity=2, three adapters: serving the third spills the LRU
    device copy; re-serving the spilled adapter refetches from the host
    copy and produces identical tokens."""
    specs, _, engine, pool = _engines((8, 4, 16), "ref", "cuda", capacity=2)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, engine.cfg.vocab_size, size=7, dtype=np.int32)
               for _ in range(3)]
    one = lambda i: engine.serve([ServeRequest(
        prompt=prompts[i], adapter=specs[i].job_id, max_new_tokens=3)])[0]
    first = [one(i) for i in range(3)]
    assert pool.stats["evictions"] >= 1
    assert len(pool.resident_names()) <= 2
    assert not pool.is_resident(specs[0].job_id)     # LRU victim
    fetches = pool.stats["h2d_fetches"]
    again = one(0)                                   # forces a refetch
    assert pool.stats["h2d_fetches"] == fetches + 1
    assert np.array_equal(again.tokens, first[0].tokens)


def test_pool_republish_versions_and_invalidates():
    """Republishing bumps the version, drops the stale pack, and the next
    serve uses the new weights."""
    specs, _, engine, pool = _engines((8, 4), "ref", "cuda")
    req = ServeRequest(prompt=np.arange(1, 9, dtype=np.int32),
                       adapter=specs[0].job_id, max_new_tokens=4)
    before = engine.serve([req])[0]
    assert pool.version_of(specs[0].job_id) == 0
    builds = pool.stats["pack_builds"]
    engine.serve([req])
    assert pool.stats["pack_builds"] == builds      # memoized pack
    nudged = {k: v + 0.5 for k, v in
              pool._entries[specs[0].job_id].host.items()}
    assert pool.publish(specs[0].job_id, nudged, rank=specs[0].rank) == 1
    after = engine.serve([req])[0]
    assert pool.stats["pack_builds"] == builds + 1
    assert not np.array_equal(before.tokens, after.tokens)


def test_convert_bf16_is_exact():
    a = np.asarray(jnp.asarray(np.random.default_rng(0).standard_normal(
        (4, 5)), jnp.float32).astype(jnp.bfloat16))
    t = params_from_numpy({"w": [a]}, "cpu")["w"][0]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))
