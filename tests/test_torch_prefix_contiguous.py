# The contiguous engine's prefix cache on the port (a radix trie over a
# block pool of its own, copy-publish at retire, seeded admission waves)
# against the JAX package's, on the same weights in float32: the trie's
# books and the published KV equal the JAX cache's after the same calls;
# the decoder's seeded suffix pass is held to the JAX one at 1e-4; greedy
# streams of the cached engine equal the cache-disabled engine's and the
# JAX cached engine's, hit and miss waves alike, through the async runner
# and through CUDASummarizer(cache_scope="template"), with equal savings.
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copilot_for_consensus_tpu.engine.generation import (
    GenerationEngine as JaxEngine,
)
from copilot_for_consensus_tpu.engine.prefix_cache import (
    PrefixCache as JaxPrefixCache,
)
from copilot_for_consensus_tpu.models import decoder as jdec
from copilot_for_consensus_tpu.models.configs import (
    decoder_config as jax_config,
)
from copilot_for_consensus_tpu.summarization.base import (
    ThreadContext as JaxThread,
)
from copilot_for_consensus_tpu.summarization.tpu_summarizer import (
    TPUSummarizer,
)
from copilot_for_consensus_tpu_torch.checkpoint.bridge import (
    params_from_numpy,
)
from copilot_for_consensus_tpu_torch.engine.async_runner import (
    AsyncEngineRunner,
)
from copilot_for_consensus_tpu_torch.engine.generation import (
    GenerationEngine,
)
from copilot_for_consensus_tpu_torch.engine.kv_pool import BlockPool
from copilot_for_consensus_tpu_torch.engine.prefix_cache import PrefixCache
from copilot_for_consensus_tpu_torch.models import decoder as tdec
from copilot_for_consensus_tpu_torch.models.configs import decoder_config
from copilot_for_consensus_tpu_torch.summarization.base import ThreadContext
from copilot_for_consensus_tpu_torch.summarization.summarizer import (
    CUDASummarizer,
)

CFG = decoder_config("tiny")
BLOCK = 4
CHUNK = 64
SHARED = 256
KW = dict(num_slots=4, max_len=384, prefill_buckets=(64, 128, 320),
          decode_window=4, prefill_chunk=CHUNK)


@functools.lru_cache(maxsize=None)
def _weights():
    jp = jdec.init_params(jax.random.PRNGKey(7), jax_config("tiny"),
                          dtype=jnp.float32)
    return jp, jax.tree.map(np.asarray, jp)


def _port(**kw):
    return GenerationEngine(CFG, params_from_numpy(_weights()[1], "cpu",
                                                   "float32"),
                            dtype="float32", device="cpu",
                            **{**KW, "telemetry": False, **kw})


def _jax(**kw):
    return JaxEngine(jax_config("tiny"), _weights()[0], dtype=jnp.float32,
                     kv_dtype=jnp.float32, attn_impl="xla",
                     **{**KW, "telemetry": False, **kw})


# ---------------------------------------------------------------------------
# the owned-pool trie against the JAX one
# ---------------------------------------------------------------------------


def _slot_cache(num_slots=3, max_len=32):
    """A fake slot cache with recognizable values a position (k != v)."""
    shape = (CFG.n_layers, num_slots, CFG.n_kv_heads, max_len,
             CFG.head_dim)
    base = np.random.default_rng(0).standard_normal(shape).astype(
        np.float32)
    return base, base * 2.0


def _pair(num_blocks=8):
    j = JaxPrefixCache(jax_config("tiny"), num_blocks=num_blocks,
                       block_size=BLOCK, kv_dtype=jnp.float32)
    t = PrefixCache(CFG, num_blocks=num_blocks, block_size=BLOCK,
                    kv_dtype=torch.float32, device="cpu")
    k, v = _slot_cache()
    jc = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
    tc = {"k": torch.tensor(k), "v": torch.tensor(v)}
    return j, t, jc, tc


#: publish scripts of the reference's trie tests: (tokens, slot,
#: eligible_tokens) a call
SCRIPTS = {
    "dedup_and_extension": [
        (list(range(50, 50 + 2 * BLOCK)), 0, None),
        (list(range(50, 50 + 2 * BLOCK)), 1, None),
        (list(range(50, 50 + 2 * BLOCK)) + list(range(4)), 0, None)],
    "eligibility_cap": [
        (list(range(3 * BLOCK)), 0, 2 * BLOCK + 1),
        (list(range(3 * BLOCK)), 0, 0)],
    "published_kv_equals_the_cache": [(list(range(2 * BLOCK)), 1, None)],
    "lru_eviction_under_a_small_pool": [
        ([1] * BLOCK + [1], 0, None), ([2] * BLOCK + [2], 1, None),
        ([3] * (2 * BLOCK) + [3], 2, None)],
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_owned_pool_publish_equals_jax(script):
    j, t, jc, tc = _pair(num_blocks=2 if "lru" in script else 8)
    for tokens, slot, elig in SCRIPTS[script]:
        want = j.publish(tokens, jc, slot, eligible_tokens=elig)
        assert t.publish(tokens, tc, slot, eligible_tokens=elig) == want
        assert t.blocks_in_use == j.blocks_in_use
    assert t.stats.as_dict() == j.stats.as_dict()
    # the same ids hold the same KV (the cache copied, k and v apart)
    for tokens, _slot, _elig in SCRIPTS[script]:
        mj, mt = j.lookup(tokens + [1]), t.lookup(tokens + [1])
        assert mt.block_ids == mj.block_ids and mt.tokens == mj.tokens
        for name in ("k", "v"):
            np.testing.assert_array_equal(
                t.pool[name][:, mt.block_ids].numpy(),
                np.asarray(j.pool[name][:, np.asarray(mj.block_ids,
                                                      np.int32)]))
        j.release(mj)
        t.release(mt)


def test_published_block_holds_the_slot_positions():
    _j, t, _jc, tc = _pair()
    t.publish(list(range(2 * BLOCK)), tc, slot=1)
    m = t.lookup(list(range(2 * BLOCK)) + [1])
    assert m.tokens == 2 * BLOCK
    for name in ("k", "v"):
        np.testing.assert_array_equal(
            t.pool[name][:, m.block_ids[1]].numpy(),
            tc[name][:, 1, :, BLOCK:2 * BLOCK].numpy())
    t.release(m)


def test_owned_and_shared_modes_guard_each_other():
    pool = BlockPool(CFG, num_blocks=8, block_size=BLOCK, device="cpu")
    shared = PrefixCache(shared=pool)
    with pytest.raises(RuntimeError, match="adopt_blocks"):
        shared.publish([1, 2, 3, 4], {"k": None, "v": None}, 0)
    owned = PrefixCache(CFG, num_blocks=4, block_size=BLOCK,
                        kv_dtype=torch.float32, device="cpu")
    with pytest.raises(RuntimeError, match="publish"):
        owned.adopt_blocks([1, 2, 3, 4], [0], 0)
    with pytest.raises(RuntimeError, match="adopt_blocks"):
        shared._alloc()
    # flush gives the owned pool its whole free list back
    _j, t, _jc, tc = _pair()
    t.publish(list(range(3 * BLOCK)), tc, 0)
    assert t.flush() == 3 and t.blocks_in_use == 0


# ---------------------------------------------------------------------------
# the decoder's seeded suffix pass against the JAX one
# ---------------------------------------------------------------------------


def test_prefill_seeded_matches_jax():
    rng = np.random.default_rng(3)
    b, s, p = 3, 16, 24
    tokens = rng.integers(3, CFG.vocab_size, size=(b, s))
    lengths = np.array([16, 5, 9], np.int32)
    pref_lens = np.array([24, 0, 12], np.int32)      # row 1: a miss row
    shape = (CFG.n_layers, b, CFG.n_kv_heads, p, CFG.head_dim)
    kp = rng.standard_normal(shape).astype(np.float32)
    vp = rng.standard_normal(shape).astype(np.float32)
    cfg = jax_config("tiny")
    want, wcache = jdec.prefill_seeded(
        _weights()[0], jnp.asarray(tokens), jnp.asarray(lengths),
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pref_lens), cfg,
        jdec.init_cache(cfg, b, s, dtype=jnp.float32))
    got, tcache = tdec.prefill_seeded(
        params_from_numpy(_weights()[1], "cpu", "float32"),
        torch.tensor(tokens), torch.tensor(lengths), torch.tensor(kp),
        torch.tensor(vp), torch.tensor(pref_lens), CFG,
        tdec.init_cache(CFG, b, s, dtype=torch.float32, device="cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(wcache[name]), rtol=1e-4,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# the engine: streams, savings, runner, summarizer
# ---------------------------------------------------------------------------


def _shared_prompts(seed, n, tail=40):
    rng = np.random.default_rng(seed)
    shared = rng.integers(3, CFG.vocab_size, size=SHARED).tolist()
    return [shared + rng.integers(3, CFG.vocab_size, size=tail).tolist()
            for _ in range(n)]


def test_shared_prefix_rounds_equal_plain_and_jax_with_savings():
    prompts = _shared_prompts(0, 8)
    plain, cached = _port(), _port(prefix_cache_blocks=32)
    jcached = _jax(prefix_cache_blocks=32)
    for _round in range(2):
        want = [c.tokens for c in plain.generate(prompts, max_new_tokens=8)]
        got = cached.generate(prompts, max_new_tokens=8)
        assert [c.tokens for c in got] == want
        assert [c.tokens for c in jcached.generate(
            prompts, max_new_tokens=8)] == want
    stats = cached.prefix_stats()
    assert stats == jcached.prefix_stats()
    assert stats["hits"] >= 8
    assert plain.prefill_tokens == 2 * 8 * len(prompts[0])
    assert stats["prefill_tokens"] <= plain.prefill_tokens // 2
    assert stats["prefill_tokens_saved"] >= 8 * SHARED


def test_mixed_hit_miss_wave_and_divergent_prefixes():
    rng = np.random.default_rng(1)
    batch1 = _shared_prompts(1, 3, tail=24)
    shared = batch1[0][:SHARED]
    divergent = shared[:CHUNK] + rng.integers(
        3, CFG.vocab_size, size=SHARED).tolist()
    cold = rng.integers(3, CFG.vocab_size, size=SHARED).tolist()
    batch2 = [batch1[0], divergent, cold]
    plain, cached = _port(), _port(prefix_cache_blocks=32)
    jcached = _jax(prefix_cache_blocks=32)
    for eng in (cached, jcached):
        eng.generate(batch1, max_new_tokens=4)          # warm the cache
    plain.generate(batch1, max_new_tokens=4)
    want = [c.tokens for c in plain.generate(batch2, max_new_tokens=4)]
    assert [c.tokens for c in cached.generate(batch2,
                                              max_new_tokens=4)] == want
    assert [c.tokens for c in jcached.generate(batch2,
                                               max_new_tokens=4)] == want
    assert cached.prefix_stats() == jcached.prefix_stats()


def test_async_runner_with_the_contiguous_prefix_cache():
    rng = np.random.default_rng(2)
    shared = rng.integers(3, CFG.vocab_size, size=SHARED).tolist()
    prompts = [shared + [10 + i] * 16 for i in range(6)]
    want = [c.tokens for c in _port().generate(prompts, max_new_tokens=5)]
    cached = _port(prefix_cache_blocks=32)
    runner = AsyncEngineRunner(cached).start()
    try:
        for elig in (None, len(shared)):
            hs = [runner.submit(list(p), 5, cache_eligible_tokens=elig)
                  for p in prompts]
            assert [h.result(timeout=300).tokens for h in hs] == want
    finally:
        runner.stop()
    assert cached.prefix_stats()["hits"] > 0


def _threads(cls, first, n):
    return [cls(thread_id=f"t{i}", subject=f"subject {i}",
                participants=[f"p{i}@x"], message_count=3,
                chunks=[{"chunk_id": f"c{i}", "text": f"body {i} " * 8}])
            for i in range(first, first + n)]


def test_summarizer_template_scope_hits_across_threads_like_jax():
    tsum = CUDASummarizer("tiny", engine=_port(prefix_cache_blocks=32),
                          max_new_tokens=4, cache_scope="template")
    jsum = TPUSummarizer("tiny", engine=_jax(prefix_cache_blocks=32),
                         max_new_tokens=4, cache_scope="template")
    assert 0 < tsum._cache_eligible == jsum._cache_eligible
    for summ, cls in ((tsum, ThreadContext), (jsum, JaxThread)):
        summ.summarize(_threads(cls, 0, 1)[0])
    want = jsum.summarize_batch(_threads(JaxThread, 1, 2))
    got = tsum.summarize_batch(_threads(ThreadContext, 1, 2))
    assert [g.summary_text for g in got] == [w.summary_text for w in want]
    stats = tsum.engine.prefix_stats()
    assert stats["hits"] >= 1 and stats["prefill_tokens_saved"] > 0
    # template scope: nothing beyond the shared span was published
    assert stats["blocks_published"] <= tsum._cache_eligible // CHUNK + 1
    for key in ("hits", "prefill_tokens_saved", "blocks_published"):
        assert stats[key] == jsum.engine.prefix_stats()[key], key


def test_a_failed_publish_is_contained_and_counted(monkeypatch):
    eng = _port(prefix_cache_blocks=32)

    def boom(*_a, **_k):
        raise RuntimeError("publish failed")

    monkeypatch.setattr(eng._prefix, "publish", boom)
    prompts = _shared_prompts(4, 2)
    want = [c.tokens for c in _port().generate(prompts, max_new_tokens=4)]
    assert [c.tokens for c in eng.generate(prompts,
                                           max_new_tokens=4)] == want
    assert eng.prefix_stats()["publish_failures"] == 2
    assert eng._prefix.pinned_refcount == 0 and not eng._prefix_pins


def test_contiguous_prefix_cache_keeps_the_sliding_window_refusal():
    swa = decoder_config("tiny-swa")             # window 64 < max_len 384
    with pytest.raises(ValueError, match="full attention"):
        GenerationEngine(swa, dtype="float32", device="cpu",
                         prefix_cache_blocks=4, **KW)
