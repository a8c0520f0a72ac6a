# Speculative decoding on the port's engine against the JAX package's, on
# the same weights in float32 and the same numpy-made inputs:
# ``sampling.verify_draft`` (greedy output and accept counts equal; the
# sampled rule's emitted distribution within 0.02 of the serving one over
# 20,000 draws, the bound of tests/test_engine_sampling.py), the seeded
# suffix attention and ``decoder.verify_seeded`` within 1e-5 at f32 (bf16
# logits within rel-L2 5e-2), ``prefill_seeded_paged(all_logits=True)``,
# and whole engines — greedy streams with ``spec_decode=True`` equal the
# JAX engine's and the port's own with speculation off, on the contiguous
# cache and on the paged pool (K3's plain version here), with equal
# ``spec_stats()``. The constructor refuses what the JAX one refuses, in
# its words, and a persistent verify fault opens the supervisor's
# spec_verify breaker while plain decode serves on.
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copilot_for_consensus_tpu.engine.generation import (
    GenerationEngine as JaxEngine,
)
from copilot_for_consensus_tpu.engine.sampling import (
    SamplingConfig as JaxSampling,
)
from copilot_for_consensus_tpu.engine.sampling import (
    verify_draft as jax_verify_draft,
)
from copilot_for_consensus_tpu.models import decoder as jdec
from copilot_for_consensus_tpu.models.configs import (
    decoder_config as jax_config,
)
from copilot_for_consensus_tpu.ops.attention import (
    prefill_attention_seeded as jax_seeded,
)
from copilot_for_consensus_tpu.ops.paged_attention import (
    paged_attention_partial_pallas,
)
from copilot_for_consensus_tpu_torch.checkpoint.bridge import (
    params_from_numpy,
)
from copilot_for_consensus_tpu_torch.engine.async_runner import (
    AsyncEngineRunner,
)
from copilot_for_consensus_tpu_torch.engine.faults import (
    PERSISTENT,
    FaultPlan,
    FaultSpec,
)
from copilot_for_consensus_tpu_torch.engine.generation import (
    GenerationEngine,
)
from copilot_for_consensus_tpu_torch.engine.sampling import (
    SamplingConfig,
    verify_draft,
)
from copilot_for_consensus_tpu_torch.engine.supervisor import (
    SupervisorConfig,
)
from copilot_for_consensus_tpu_torch.models import decoder as tdec
from copilot_for_consensus_tpu_torch.models.configs import decoder_config
from copilot_for_consensus_tpu_torch.ops.attention import (
    prefill_attention_seeded,
)
from copilot_for_consensus_tpu_torch.ops.paged_attention import (
    paged_attention_partial,
)

CFG = decoder_config("tiny")
KW = dict(num_slots=4, max_len=256, prefill_buckets=(64, 128, 192),
          decode_window=4, prefill_chunk=64)
NEW = 40          # long enough for the tiny model's streams to repeat


@functools.lru_cache(maxsize=None)
def _weights():
    jp = jdec.init_params(jax.random.PRNGKey(7), jax_config("tiny"),
                          dtype=jnp.float32)
    return jp, jax.tree.map(np.asarray, jp)


def _port(paged_blocks=0, **kw):
    return GenerationEngine(CFG, params_from_numpy(_weights()[1], "cpu",
                                                   "float32"),
                            dtype="float32", kv_pool_blocks=paged_blocks,
                            device="cpu", **{**KW, "telemetry": False, **kw})


def _jax(paged_blocks=0, **kw):
    return JaxEngine(jax_config("tiny"), _weights()[0], dtype=jnp.float32,
                     kv_dtype=jnp.float32, attn_impl="xla",
                     kv_pool_blocks=paged_blocks,
                     kv_kernel="pallas" if paged_blocks else "auto",
                     telemetry=False, **{**KW, **kw})


def _copy_prompts(seed=2, n=4, half=60):
    """The JAX spec tests' copy-heavy prompts: the back half repeats
    16-token spans of the front half."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        head = rng.integers(3, CFG.vocab_size, size=half).tolist()
        tail = []
        while len(tail) < half:
            s0 = int(rng.integers(0, half - 16))
            tail.extend(head[s0:s0 + 16])
        out.append(head + tail[:half])
    return out


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------------------
# verify_draft
# ---------------------------------------------------------------------------


def _greedy_case(seed):
    rng = np.random.default_rng(seed)
    b, s, v = 6, 9, 64
    logits = rng.standard_normal((b, s, v)).astype(np.float32)
    am = logits.argmax(-1)
    draft = am[:, :-1].copy()
    # row 1 breaks at 2, row 2 at 0, row 4 drafts past its length and
    # row 5 is a 0-length row whose (matching) draft must not count
    draft[1, 2] = (draft[1, 2] + 1) % v
    draft[2, 0] = (draft[2, 0] + 5) % v
    lens = np.array([8, 8, 8, 3, 5, 0], np.int64)
    return logits, draft, lens


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_verify_draft_greedy_equals_jax(seed):
    logits, draft, lens = _greedy_case(seed)
    want_out, want_acc = jax_verify_draft(
        jnp.asarray(logits), jnp.asarray(draft.astype(np.int32)),
        jnp.asarray(lens.astype(np.int32)), jax.random.PRNGKey(0),
        JaxSampling())
    out, acc = verify_draft(torch.from_numpy(logits),
                            torch.from_numpy(draft), torch.from_numpy(lens),
                            None, SamplingConfig())
    assert out.numpy().tolist() == np.asarray(want_out).tolist()
    assert acc.numpy().tolist() == np.asarray(want_acc).tolist()
    assert acc.numpy().tolist() == [8, 2, 0, 3, 5, 0]


def _first_token_marginal(logits, draft_tok, lens, cfg, n=20000):
    """The first emitted token over ``n`` independent draws: the row
    repeated n times in one call (each row draws independently)."""
    b = n
    lg = torch.from_numpy(np.repeat(logits, b, axis=0))
    draft = torch.full((b, logits.shape[1] - 1), draft_tok,
                       dtype=torch.int64)
    gen = torch.Generator().manual_seed(42)
    out, acc = verify_draft(lg, draft, torch.full((b,), lens), gen, cfg)
    v = logits.shape[-1]
    return (np.bincount(out[:, 0].numpy(), minlength=v) / b,
            acc.numpy())


@pytest.mark.parametrize("draft_tok,lens,top_k", [
    (3, 2, 0),       # p's mode: mostly accepted
    (0, 2, 0),       # a tail token: mostly rejected
    (0, 0, 0),       # a 0-draft row: one plain sample
    (5, 2, 3),       # top-k filtered: p is the filtered distribution
])
def test_verify_draft_sampled_emits_the_serving_distribution(
        draft_tok, lens, top_k):
    v = 8
    rng = np.random.default_rng(7)
    lg = rng.standard_normal((1, 3, v)).astype(np.float32)
    lg[0, 0, 3] += 2.0                                  # 3 is the mode
    cfg = SamplingConfig(temperature=1.0, top_k=top_k)
    jcfg = JaxSampling(temperature=1.0, top_k=top_k)
    from copilot_for_consensus_tpu.engine.sampling import _filter_logits

    p = np.asarray(jax.nn.softmax(_filter_logits(jnp.asarray(lg[0, 0]),
                                                 jcfg)))
    emp, acc = _first_token_marginal(lg, draft_tok, lens, cfg)
    assert np.abs(emp - p).max() < 0.02, (emp, p)
    if lens == 0:
        assert acc.max() == 0


def test_verify_draft_accepts_a_sure_token():
    """A drafted token holding ~all of p is always accepted: the
    correction branch is dead."""
    lg = np.full((1, 3, 8), -30.0, np.float32)
    lg[0, :, 5] = 30.0
    gen = torch.Generator().manual_seed(0)
    for _ in range(16):
        out, acc = verify_draft(torch.from_numpy(lg),
                                torch.full((1, 2), 5, dtype=torch.int64),
                                torch.tensor([2]), gen,
                                SamplingConfig(temperature=1.0))
        assert int(acc[0]) == 2
        assert out[0].tolist() == [5, 5, 5]


# ---------------------------------------------------------------------------
# the seeded suffix attention and verify_seeded
# ---------------------------------------------------------------------------


def _seeded_inputs(dtype=np.float32):
    rng = np.random.default_rng(3)
    b, hq, hkv, s, d, p = 4, 4, 2, 6, 16, 20
    q = rng.standard_normal((b, hq, s, d)).astype(dtype)
    k = rng.standard_normal((b, hkv, s, d)).astype(dtype)
    v = rng.standard_normal((b, hkv, s, d)).astype(dtype)
    kp = rng.standard_normal((b, hkv, p, d)).astype(dtype)
    vp = rng.standard_normal((b, hkv, p, d)).astype(dtype)
    # mixed prefixes (0 among them), padding, and row 3 fully masked
    # (no prefix, no valid suffix)
    pref = np.array([0, 7, 20, 0], np.int64)
    kvl = np.array([6, 3, 1, 0], np.int64)
    return q, k, v, kp, vp, pref, kvl


def test_prefill_attention_seeded_matches_jax_f32():
    args = _seeded_inputs()
    want = jax_seeded(*(jnp.asarray(a) for a in args[:5]),
                      jnp.asarray(args[5].astype(np.int32)),
                      kv_lengths=jnp.asarray(args[6].astype(np.int32)))
    got = prefill_attention_seeded(*(torch.from_numpy(a) for a in args[:6]),
                                   kv_lengths=torch.from_numpy(args[6]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert not got[3].any()                   # the fully masked row: 0


def _verify_inputs():
    rng = np.random.default_rng(11)
    max_len, b, s = 64, 4, 5
    shape = (CFG.n_layers, b, CFG.n_kv_heads, max_len, CFG.head_dim)
    kc = rng.standard_normal(shape).astype(np.float32)
    vc = rng.standard_normal(shape).astype(np.float32)
    tokens = rng.integers(3, CFG.vocab_size, (b, s)).astype(np.int64)
    lengths = np.array([5, 1, 3, 5], np.int64)
    # row 1 starts at 0 (a first chunk), row 3 is parked at max_len
    pref = np.array([17, 0, 40, max_len], np.int64)
    return kc, vc, tokens, lengths, pref


@pytest.mark.parametrize("kv_len", [None, 48])
def test_verify_seeded_matches_jax_f32(kv_len):
    jp, tree = _weights()
    kc, vc, tokens, lengths, pref = _verify_inputs()
    want = jdec.verify_seeded(
        jp, jnp.asarray(tokens.astype(np.int32)),
        jnp.asarray(lengths.astype(np.int32)),
        jnp.asarray(pref.astype(np.int32)), jax_config("tiny"),
        {"k": jnp.asarray(kc), "v": jnp.asarray(vc)}, kv_len=kv_len)
    got = tdec.verify_seeded(
        params_from_numpy(tree, "cpu", "float32"), torch.from_numpy(tokens),
        torch.from_numpy(lengths), torch.from_numpy(pref), CFG,
        {"k": torch.from_numpy(kc), "v": torch.from_numpy(vc)},
        kv_len=kv_len)
    for g, w in zip(got, want):
        # the parked row attends a prefix past kv_len's reach: only the
        # engine's discarded output, compared all the same
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_verify_seeded_bf16_logits_within_rel_l2():
    jp, tree = _weights()
    kc, vc, tokens, lengths, pref = _verify_inputs()
    jbf = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp)
    want, _, _ = jdec.verify_seeded(
        jbf, jnp.asarray(tokens.astype(np.int32)),
        jnp.asarray(lengths.astype(np.int32)),
        jnp.asarray(pref.astype(np.int32)), jax_config("tiny"),
        {"k": jnp.asarray(kc, jnp.bfloat16),
         "v": jnp.asarray(vc, jnp.bfloat16)})
    got, _, _ = tdec.verify_seeded(
        params_from_numpy(tree, "cpu", "bfloat16"), torch.from_numpy(tokens),
        torch.from_numpy(lengths), torch.from_numpy(pref), CFG,
        {"k": torch.from_numpy(kc).bfloat16(),
         "v": torch.from_numpy(vc).bfloat16()})
    live = [0, 1, 2]                  # the parked row's output is dropped
    assert _rel_l2(got.float().numpy()[live],
                   np.asarray(want, np.float32)[live]) < 5e-2


def test_prefill_seeded_paged_all_logits_matches_jax():
    rng = np.random.default_rng(10)
    jp, tree = _weights()
    shape = (CFG.n_layers, 12, CFG.n_kv_heads, 8, CFG.head_dim)
    pk = rng.standard_normal(shape).astype(np.float32)
    pv = rng.standard_normal(shape).astype(np.float32)
    tables = rng.integers(0, 13, (3, 4)).astype(np.int32)     # 12 = pad
    pref = np.array([16, 0, 29], np.int64)
    lengths = np.array([5, 8, 1], np.int64)
    tokens = rng.integers(3, CFG.vocab_size, (3, 8)).astype(np.int64)

    def jfn(li, q_rows, lns, q_pos):
        return paged_attention_partial_pallas(
            q_rows, jnp.asarray(pk), jnp.asarray(pv),
            jnp.asarray([li], jnp.int32), jnp.asarray(tables), lns, q_pos,
            window=0, interpret=True)

    tk, tv, tt = (torch.from_numpy(x) for x in (pk, pv, tables))

    def tfn(li, q_rows, lns, q_pos):
        return paged_attention_partial(q_rows, tk, tv, li, tt, lns, q_pos)

    want = jdec.prefill_seeded_paged(
        jp, jnp.asarray(tokens), jnp.asarray(lengths), jnp.asarray(pref),
        jax_config("tiny"), jfn, all_logits=True)
    got = tdec.prefill_seeded_paged(
        params_from_numpy(tree, "cpu", "float32"), torch.from_numpy(tokens),
        torch.from_numpy(lengths), torch.from_numpy(pref), CFG, tfn,
        all_logits=True)
    assert got[0].shape == (3, 8, CFG.vocab_size)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_spec_runs():
    """The JAX spec engines' streams and spec_stats, contiguous and
    paged (the paged one runs the Pallas kernel in interpret mode): built
    once for the module."""
    out = {}
    for paged in (0, 16):
        eng = _jax(paged, spec_decode=True)
        comps = eng.generate(_copy_prompts(), max_new_tokens=NEW)
        out[paged] = ([c.tokens for c in comps], eng.spec_stats())
    return out


@pytest.mark.parametrize("paged", [0, 16], ids=["contiguous", "paged"])
def test_spec_streams_equal_jax_and_spec_off(jax_spec_runs, paged):
    want, want_stats = jax_spec_runs[paged]
    eng = _port(paged, spec_decode=True)
    got = [c.tokens for c in eng.generate(_copy_prompts(),
                                          max_new_tokens=NEW)]
    assert got == want
    plain = [c.tokens for c in _port(paged).generate(_copy_prompts(),
                                                     max_new_tokens=NEW)]
    assert got == plain
    stats = eng.spec_stats()
    assert stats == want_stats
    assert stats["verify_dispatches"] > 0 and stats["accepted_tokens"] > 0
    if paged:
        st = eng.kv_pool_stats()
        assert st["free_blocks"] == st["num_blocks"]


def test_spec_on_int8_weights_equals_spec_off():
    """The verify pass over int8 leaves (K2's plain version here) takes
    the same route as the decode step's."""
    prompts = _copy_prompts(seed=0)
    want = [c.tokens for c in _port(quantize="int8").generate(
        prompts, max_new_tokens=NEW)]
    eng = _port(quantize="int8", spec_decode=True)
    assert [c.tokens for c in eng.generate(prompts,
                                           max_new_tokens=NEW)] == want
    assert eng.spec_stats()["verify_dispatches"] > 0


def test_sampled_spec_streams_run_to_their_budget():
    eng = _port(spec_decode=True,
                sampling=SamplingConfig(temperature=0.8, top_k=8))
    comps = eng.generate(_copy_prompts(), max_new_tokens=NEW)
    for c in comps:
        assert c.finish_reason in ("eos", "length")
        assert 0 < len(c.tokens) <= NEW
        assert all(0 <= t < CFG.vocab_size for t in c.tokens)
    assert eng.spec_stats()["lookups"] > 0


def test_verify_steps_reach_the_telemetry():
    eng = _port(spec_decode=True, telemetry=True)
    eng.generate(_copy_prompts(), max_new_tokens=NEW)
    steps = [r for r in eng.telemetry.recorder.as_dicts()
             if r["kind"] == "verify"]
    st = eng.spec_stats()
    assert len(steps) == st["verify_dispatches"]
    assert sum(r["draft_tokens"] for r in steps) == st["drafted_tokens"]
    assert sum(r["accepted_tokens"] for r in steps) == \
        st["accepted_tokens"]


@pytest.mark.parametrize("kw,cfg_name", [
    (dict(spec_draft_lens=(0, 4), max_len=5), "tiny"),
    (dict(max_len=256), "tiny-swa"),
    (dict(spec_draft_lens=(-1, 4)), "tiny"),
])
def test_constructor_refuses_what_jax_refuses_in_its_words(kw, cfg_name):
    over = {"sliding_window": 16} if cfg_name == "tiny-swa" else {}
    with pytest.raises(ValueError) as want:
        JaxEngine(jax_config(cfg_name, **over), None, dtype=jnp.float32,
                  spec_decode=True, telemetry=False,
                  **{**KW, "prefill_buckets": (4,), **kw})
    with pytest.raises(ValueError) as got:
        GenerationEngine(decoder_config(cfg_name, **over), dtype="float32",
                         device="cpu", spec_decode=True, telemetry=False,
                         **{**KW, "prefill_buckets": (4,), **kw})
    assert str(got.value) == str(want.value)


def _cycle_params(period=7):
    """The JAX spec tests' copy-cycle fixture: zeroed attention and FFN
    outputs and one-hot embeddings and lm_head make greedy generation the
    cycle t -> 3 + ((t - 3 + 1) % period), so the drafts always hit."""
    _, tree = _weights()
    tree = jax.tree.map(np.copy, tree)
    tree["layers"]["wo"] = np.zeros_like(tree["layers"]["wo"])
    tree["layers"]["w_down"] = np.zeros_like(tree["layers"]["w_down"])
    emb = np.zeros((CFG.vocab_size, CFG.d_model), np.float32)
    head = np.zeros((CFG.d_model, CFG.vocab_size), np.float32)
    for i in range(period):
        emb[3 + i, i] = 1.0
        head[i, 3 + (i + 1) % period] = 1.0
    tree["tok_emb"], tree["lm_head"] = emb, head
    return tree


def _cycle_engine(tree, **kw):
    return GenerationEngine(CFG, params_from_numpy(tree, "cpu", "float32"),
                            dtype="float32", device="cpu", num_slots=4,
                            max_len=96, prefill_buckets=(48,),
                            decode_window=4, spec_decode=True,
                            spec_draft_lens=(0, 4, 8), **kw)


def test_persistent_verify_fault_opens_the_spec_breaker():
    """Persistent verify faults flip the engine to plain decode (served
    traffic completes, equal to the fault-free run), the breaker opens,
    and the half-open probe restores speculation once the faults clear."""
    tree = _cycle_params()
    prompts = [[3 + ((i + j) % 7) for j in range(14)] for i in range(4)]
    base = {i: c.tokens for i, c in enumerate(
        _cycle_engine(tree).generate([list(p) for p in prompts],
                                     max_new_tokens=12))}
    eng = _cycle_engine(tree, faults=FaultPlan(specs=[
        FaultSpec(kind="verify", at=1, count=PERSISTENT)]))
    cfg = SupervisorConfig(replay_budget=8, verify_breaker_threshold=2,
                           breaker_probe_after_s=0.05)
    runner = AsyncEngineRunner(eng, supervisor=cfg).start()
    sup = runner.supervisor
    try:
        handles = [runner.submit(list(p), 12) for p in prompts]
        outputs = {i: h.result(timeout=120.0).tokens
                   for i, h in enumerate(handles)}
        assert outputs == base
        assert sup.verify_breaker.trips >= 1
        verify_faults = [f for f in eng.faults.stats()["log"]
                         if f["kind"] == "verify"]
        assert len(verify_faults) >= cfg.verify_breaker_threshold
        eng.faults.clear("verify")
        time.sleep(0.1)                 # past breaker_probe_after_s
        spec0 = eng.spec_dispatches
        handles = [runner.submit(list(p), 12) for p in prompts]
        outputs = {i: h.result(timeout=120.0).tokens
                   for i, h in enumerate(handles)}
        assert outputs == base
        assert sup.verify_breaker.state == "closed"
        assert eng.spec_dispatches > spec0
    finally:
        runner.stop()


def test_spec_on_an_fp8_cache_keeps_the_jax_engines_first_tokens():
    """The verify pass over an fp8 slot cache (read as bytes, cast to the
    compute dtype): against the JAX engine with the same KV dtype, the bar
    of tests/test_torch_kv_dtype.py — each stream's first decode tokens
    agree — and the pass runs."""
    kw = dict(spec_decode=True, kv_dtype="float8_e4m3fn")
    eng = _port(**kw)
    got = [c.tokens for c in eng.generate(_copy_prompts(),
                                          max_new_tokens=NEW)]
    jeng = JaxEngine(jax_config("tiny"), _weights()[0], dtype=jnp.float32,
                     attn_impl="xla", telemetry=False, **{**KW, **kw})
    want = [c.tokens for c in jeng.generate(_copy_prompts(),
                                            max_new_tokens=NEW)]
    for a, b in zip(got, want):
        assert a[:3] == b[:3], (a, b)
    assert eng._cache["k"].dtype == torch.float8_e4m3fn
    assert eng.spec_stats()["verify_dispatches"] > 0
