# The port's paged engine (block pool, zero-copy prefix cache, K3 route)
# against the JAX package's paged kernel-route engine (kv_kernel="pallas",
# the Pallas kernel in interpret mode) and against the port's contiguous
# engine, on the same weights in float32: greedy token streams must be
# EQUAL, and the pool and prefix-cache books must agree with the JAX
# engine's. Decoder-level paged passes are held to the JAX ones at 1e-4,
# the tolerance of tests/test_torch_decoder.py.
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copilot_for_consensus_tpu.engine.generation import (
    GenerationEngine as JaxEngine,
)
from copilot_for_consensus_tpu.models import decoder as jdec
from copilot_for_consensus_tpu.models.configs import (
    decoder_config as jax_config,
)
from copilot_for_consensus_tpu.ops.paged_attention import (
    paged_attention_partial_pallas,
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
from copilot_for_consensus_tpu_torch.engine.generation import (
    GenerationEngine,
)
from copilot_for_consensus_tpu_torch.models import decoder as tdec
from copilot_for_consensus_tpu_torch.models.configs import decoder_config
from copilot_for_consensus_tpu_torch.ops.paged_attention import (
    paged_attention_partial,
)
from copilot_for_consensus_tpu_torch.summarization.base import ThreadContext
from copilot_for_consensus_tpu_torch.summarization.summarizer import (
    CUDASummarizer,
)

CFG = decoder_config("tiny")
KW = dict(num_slots=4, max_len=256, prefill_buckets=(64, 128, 192),
          decode_window=4, prefill_chunk=64)


@functools.lru_cache(maxsize=None)
def _weights():
    jp = jdec.init_params(jax.random.PRNGKey(7), jax_config("tiny"),
                          dtype=jnp.float32)
    return jp, jax.tree.map(np.asarray, jp)


def _port(paged_blocks=0, quantize=False, **kw):
    kw = {**KW, **kw}
    return GenerationEngine(CFG, params_from_numpy(_weights()[1], "cpu",
                                                   "float32"),
                            dtype="float32", quantize=quantize,
                            kv_pool_blocks=paged_blocks, device="cpu", **kw)


def _jax(paged_blocks, quantize=False, **kw):
    kw = {**KW, **kw}
    return JaxEngine(jax_config("tiny"), _weights()[0], dtype=jnp.float32,
                     kv_dtype=jnp.float32, attn_impl="xla",
                     quantize=quantize, kv_pool_blocks=paged_blocks,
                     kv_kernel="pallas", telemetry=False, **kw)


def _assert_same(want, got):
    for w, g in zip(want, got):
        assert g.tokens == w.tokens
        assert g.finish_reason == w.finish_reason
        assert g.prompt_len == w.prompt_len


@pytest.mark.parametrize("quantize", [False, "int8"])
def test_paged_streams_equal_jax_kernel_route_and_contiguous(quantize):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, CFG.vocab_size, size=70).tolist()
               for _ in range(6)]
    want = _jax(12, quantize).generate(prompts, max_new_tokens=10)
    paged = _port(12, quantize)
    got = paged.generate(prompts, max_new_tokens=10)
    _assert_same(want, got)
    _assert_same(_port(0, quantize).generate(prompts, max_new_tokens=10),
                 got)
    st = paged.kv_pool_stats()
    assert st["free_blocks"] == st["num_blocks"]   # all blocks returned
    assert st["paged_admits"] == 6
    assert st["peak_active"] == 4                  # num_slots bound


def test_sliding_window_paged_streams_equal_jax():
    """K3's window mask on the decode route: a 16-token window on
    70-token prompts masks most of each slot's pool blocks."""
    over = {"sliding_window": 16}
    jp = jdec.init_params(jax.random.PRNGKey(7),
                          jax_config("tiny-swa", **over), dtype=jnp.float32)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(3, CFG.vocab_size, size=70).tolist()
               for _ in range(6)]
    jeng = JaxEngine(jax_config("tiny-swa", **over), jp, dtype=jnp.float32,
                     kv_dtype=jnp.float32, attn_impl="xla",
                     kv_pool_blocks=12, kv_kernel="pallas", telemetry=False,
                     **KW)
    teng = GenerationEngine(
        decoder_config("tiny-swa", **over),
        params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", "float32"),
        dtype="float32", kv_pool_blocks=12, device="cpu", **KW)
    _assert_same(jeng.generate(prompts, max_new_tokens=10),
                 teng.generate(prompts, max_new_tokens=10))


def test_prefix_zero_copy_rounds_equal_jax():
    """Two rounds over prompts sharing a 128-token head: the second round
    admits every row by pointer, with the same streams and the same books
    as the JAX kernel-route engine and the same streams as the port's
    contiguous engine."""
    rng = np.random.default_rng(1)
    shared = rng.integers(3, CFG.vocab_size, size=128).tolist()
    prompts = [shared + rng.integers(3, CFG.vocab_size, size=30).tolist()
               for _ in range(6)]
    jeng = _jax(16, prefix_cache_blocks=8)
    paged = _port(16, prefix_cache_blocks=8)
    plain = _port(0)
    for _round in range(2):
        want = jeng.generate(prompts, max_new_tokens=6)
        got = paged.generate(prompts, max_new_tokens=6)
        _assert_same(want, got)
        _assert_same(plain.generate(prompts, max_new_tokens=6), got)
    st, jst = paged.kv_pool_stats(), jeng.kv_pool_stats()
    ps, jps = paged.prefix_stats(), jeng.prefix_stats()
    for key in ("zero_copy_admits", "paged_admits", "pinned_blocks",
                "free_blocks", "blocks_in_use", "headroom_blocks"):
        assert st[key] == jst[key], key
    for key in ("prefill_tokens", "prefill_tokens_saved", "lookups", "hits",
                "misses", "tokens_matched", "blocks_published",
                "blocks_in_use"):
        assert ps[key] == jps[key], key
    assert st["zero_copy_admits"] > 0
    assert ps["prefill_tokens_saved"] >= 6 * 128   # second round all hits
    assert st["pinned_blocks"] == 2                # 128 tokens / 64
    assert st["free_blocks"] == st["num_blocks"] - 2


def test_trie_yields_blocks_under_pool_pressure_like_jax():
    """A 12-block pool with the prefix cache on: each round publishes new
    2-block prompt heads until admission must reclaim idle trie leaves
    (LRU) for live slots. Streams, evictions and hits equal the JAX
    engine's."""
    rng = np.random.default_rng(6)
    heads = [rng.integers(3, CFG.vocab_size, size=128).tolist()
             for _ in range(5)]
    jeng = _jax(12, prefix_cache_blocks=1)
    paged = _port(12, prefix_cache_blocks=1)
    for rnd in range(4):
        prompts = [heads[(rnd + i) % 5]
                   + rng.integers(3, CFG.vocab_size, size=9).tolist()
                   for i in range(4)]
        _assert_same(jeng.generate(prompts, max_new_tokens=4),
                     paged.generate(prompts, max_new_tokens=4))
    ps, jps = paged.prefix_stats(), jeng.prefix_stats()
    for key in ("hits", "misses", "blocks_published", "blocks_evicted",
                "prefill_tokens_saved", "blocks_in_use"):
        assert ps[key] == jps[key], key
    assert ps["blocks_evicted"] > 0 and ps["hits"] > 0
    st = paged.kv_pool_stats()
    assert st["free_blocks"] + st["pinned_blocks"] == st["num_blocks"]


def test_capacity_exceeds_the_contiguous_equivalent():
    """8 blocks x 64 = 512 positions, two max_len=256 slots' worth of
    contiguous cache, serve six short streams at once."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(3, CFG.vocab_size, size=20).tolist()
               for _ in range(6)]
    eng = _port(8, num_slots=6)
    got = eng.generate(prompts, max_new_tokens=6)
    _assert_same(_jax(8, num_slots=6).generate(prompts, max_new_tokens=6),
                 got)
    st = eng.kv_pool_stats()
    assert st["num_blocks"] * st["block_size"] // eng.max_len == 2
    assert st["peak_active"] == 6
    assert st["free_blocks"] == st["num_blocks"]


def test_admission_waits_on_pool_pressure_not_slots():
    """Free-block accounting: worst-case footprints (128 prompt + 100 new
    + margin = 4 blocks) let 10 blocks admit at most 2 requests at once;
    the rest wait and are served as blocks free."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(3, CFG.vocab_size, size=128).tolist()
               for _ in range(4)]
    eng = _port(10)
    rids = [eng.submit(list(p), 100) for p in prompts]
    eng.step()
    assert 0 < len(eng._active) <= 2
    results = {}
    for _ in range(400):
        for c in eng.step():
            results[c.request_id] = c
        if len(results) == len(rids):
            break
    assert len(results) == len(rids)
    st = eng.kv_pool_stats()
    assert st["free_blocks"] == st["num_blocks"]
    assert st["peak_active"] == 2


def test_constructor_guards():
    with pytest.raises(ValueError, match="divide 128"):
        _port(16, prefill_chunk=48, max_len=192, prefill_buckets=(48,))
    with pytest.raises(ValueError, match="max_len"):
        _port(16, max_len=200, prefill_buckets=(64,))
    with pytest.raises(ValueError, match="cannot hold"):
        _port(3)
    # the paged route and the roles need the pool (the JAX engine's
    # messages); a contiguous prefix cache owns a pool of its own
    with pytest.raises(ValueError, match="kv_pool_blocks"):
        _port(0, kv_kernel="pallas")
    with pytest.raises(ValueError, match="kv_pool_blocks"):
        _port(0, role="prefill")
    assert _port(0, prefix_cache_blocks=8)._prefix.pool is not None
    swa = decoder_config("tiny-swa")            # window 64 < max_len 256
    with pytest.raises(ValueError, match="full attention"):
        GenerationEngine(swa, dtype="float32", device="cpu",
                         kv_pool_blocks=8, prefix_cache_blocks=1, **KW)
    # the contiguous engine keeps its cache, the paged one its pool
    assert _port(0)._pool is None and _port(5)._cache is None


def test_write_maps_drop_columns_past_max_len():
    eng = _port(8, num_slots=2)                           # max_len 256
    eng._tables[0] = eng._pool.alloc(4)                   # full table
    bids, offs = eng._write_maps([(0, eng._tables[0], 250, 9)], 9, 2)
    assert (bids[0, :6] != eng._pool.num_blocks).all()    # 250..255
    assert (offs[0, :6] == np.arange(250, 256) % 64).all()
    assert (bids[0, 6:] == eng._pool.num_blocks).all()    # >= max_len
    assert (bids[1] == eng._pool.num_blocks).all()        # no row: OOB
    eng._pool.free(eng._tables[0])
    eng._tables[0] = []


def _threads(cls, first, n):
    return [cls(thread_id=f"t{i}", subject=f"Topic {i}",
                participants=["alice@example.org", "bob@example.org"],
                message_count=2 + i,
                chunks=[{"chunk_id": f"c{i}", "text": f"Point {i}: ship "
                         f"the draft by Friday."}])
            for i in range(first, first + n)]


@pytest.mark.parametrize("scope", ["full", "template"])
def test_summaries_equal_tpu_summarizer_over_paged_engines(scope):
    # prompts of ~280 tokens: under prompt_limit, so none is truncated
    # (a truncated prompt publishes nothing)
    kw = dict(num_slots=2, max_len=512, prefill_buckets=(256, 512),
              prefix_cache_blocks=4)
    jsum = TPUSummarizer("tiny", engine=_jax(20, **kw), max_new_tokens=8,
                         cache_scope=scope)
    tsum = CUDASummarizer("tiny", engine=_port(20, **kw), max_new_tokens=8,
                          cache_scope=scope)
    assert tsum._cache_eligible == jsum._cache_eligible
    # the same threads twice (re-summarization), then new threads
    for first, n in ((0, 3), (0, 3), (3, 2)):
        want = jsum.summarize_batch(_threads(JaxThread, first, n))
        got = tsum.summarize_batch(_threads(ThreadContext, first, n))
        for w, g in zip(want, got):
            assert g.summary_text == w.summary_text
            assert g.prompt_tokens == w.prompt_tokens
            assert g.prompt_tokens < tsum.engine.prompt_limit
            assert g.completion_tokens == w.completion_tokens
    for key in ("prefill_tokens_saved", "hits", "blocks_published"):
        assert tsum.engine.prefix_stats()[key] == \
            jsum.engine.prefix_stats()[key], key
    assert tsum.engine.kv_pool_stats()["zero_copy_admits"] > 0


# ---------------------------------------------------------------------------
# decoder-level paged passes against the JAX package's
# ---------------------------------------------------------------------------


def _pool_inputs(rng, nbtot=12, blk=8):
    shape = (CFG.n_layers, nbtot, CFG.n_kv_heads, blk, CFG.head_dim)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _partials(pk, pv, tables, window):
    def jfn(li, q_rows, lengths, q_pos):
        return paged_attention_partial_pallas(
            q_rows, jnp.asarray(pk), jnp.asarray(pv),
            jnp.asarray([li], jnp.int32), jnp.asarray(tables), lengths,
            q_pos, window=window, interpret=True)

    tk, tv, tt = (torch.from_numpy(x) for x in (pk, pv, tables))

    def tfn(li, q_rows, lengths, q_pos):
        return paged_attention_partial(q_rows, tk, tv, li, tt, lengths,
                                       q_pos, window=window)
    return jfn, tfn


def test_decode_step_windowed_paged_matches_jax():
    rng = np.random.default_rng(9)
    jp, tree = _weights()
    tparams = params_from_numpy(tree, "cpu", "float32")
    pk, pv = _pool_inputs(rng)
    tables = rng.integers(0, 13, (3, 4)).astype(np.int32)    # 12 = pad
    positions = np.array([5, 0, 29], np.int64)               # 0: parked-like
    tokens = np.array([7, 11, 300], np.int64)
    w_sz, w = 4, 2
    shape = (CFG.n_layers, 3, CFG.n_kv_heads, w_sz, CFG.head_dim)
    k_win = rng.standard_normal(shape).astype(np.float32)
    v_win = rng.standard_normal(shape).astype(np.float32)
    jfn, tfn = _partials(pk, pv, tables, window=0)
    want = jdec.decode_step_windowed_paged(
        jp, jnp.asarray(tokens), jnp.asarray(positions), jnp.int32(w),
        jax_config("tiny"), jfn, jnp.asarray(k_win), jnp.asarray(v_win))
    got = tdec.decode_step_windowed_paged(
        tparams, torch.from_numpy(tokens), torch.from_numpy(positions), w,
        CFG, tfn, torch.from_numpy(k_win), torch.from_numpy(v_win))
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=1e-4,
                                   atol=1e-4)


def test_prefill_seeded_paged_matches_jax():
    rng = np.random.default_rng(10)
    jp, tree = _weights()
    tparams = params_from_numpy(tree, "cpu", "float32")
    pk, pv = _pool_inputs(rng)
    tables = rng.integers(0, 12, (3, 4)).astype(np.int32)
    pref = np.array([16, 0, 29], np.int64)                  # 0: a miss row
    lengths = np.array([5, 8, 1], np.int64)
    tokens = rng.integers(3, CFG.vocab_size, (3, 8)).astype(np.int64)
    jfn, tfn = _partials(pk, pv, tables, window=0)
    want = jdec.prefill_seeded_paged(
        jp, jnp.asarray(tokens), jnp.asarray(lengths), jnp.asarray(pref),
        jax_config("tiny"), jfn, all_logits=False)
    got = tdec.prefill_seeded_paged(
        tparams, torch.from_numpy(tokens), torch.from_numpy(lengths),
        torch.from_numpy(pref), CFG, tfn)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=1e-4,
                                   atol=1e-4)
