# Piggyback prefill on the port's contiguous engine against the JAX
# package's, on the same weights in float32: the reference's five oracles
# (greedy streams of the piggyback engine equal the wave engine's and the
# JAX piggyback engine's), the decoder's piggyback step and the chunk
# buffers' cache write held to the JAX functions (f32 at 1e-4, bf16 logits
# within rel-L2 5e-2), and the engine plumbing around the feed: where
# piggyback is off, deadlines, queue depth and the telemetry step kind.
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
from copilot_for_consensus_tpu_torch.checkpoint.bridge import (
    params_from_numpy,
)
from copilot_for_consensus_tpu_torch.engine.generation import (
    GenerationEngine,
)
from copilot_for_consensus_tpu_torch.models import decoder as tdec
from copilot_for_consensus_tpu_torch.models.configs import decoder_config

CFG = decoder_config("tiny")
#: the reference tests' geometry: lane capacity W*C = 64
PIGGY = dict(num_slots=4, max_len=128, prefill_buckets=(16, 32, 96),
             decode_window=8, prefill_chunk=8, prefill_rows=2,
             piggyback_min_prompt=20)
WAVE = dict(num_slots=4, max_len=128, prefill_buckets=(16, 32, 96),
            decode_window=8, piggyback_min_prompt=10**9)


@functools.lru_cache(maxsize=None)
def _weights():
    jp = jdec.init_params(jax.random.PRNGKey(7), jax_config("tiny"),
                          dtype=jnp.float32)
    return jp, jax.tree.map(np.asarray, jp)


def _port(base, **kw):
    return GenerationEngine(CFG, params_from_numpy(_weights()[1], "cpu",
                                                   "float32"),
                            dtype="float32", device="cpu",
                            **{**base, "telemetry": False, **kw})


def _jax(base, **kw):
    return JaxEngine(jax_config("tiny"), _weights()[0], dtype=jnp.float32,
                     kv_dtype=jnp.float32, attn_impl="xla",
                     **{**base, "telemetry": False, **kw})


def _prompt(seed, n):
    rng = np.random.default_rng(seed)
    return rng.integers(3, CFG.vocab_size, size=n).tolist()


def _staggered(eng):
    """The reference's staggered join: one prompt decodes two steps, then
    a second joins mid-decode."""
    rid1 = eng.submit(_prompt(40, 28), max_new_tokens=10)
    done = {}
    for _ in range(2):
        for c in eng.step():
            done[c.request_id] = c
    rid2 = eng.submit(_prompt(41, 45), max_new_tokens=10)
    while len(done) < 2:
        for c in eng.step():
            done[c.request_id] = c
    return [done[rid1].tokens, done[rid2].tokens]


#: the five oracles of the reference's piggyback tests: (prompts, new
#: tokens, slots); None = the staggered join
CASES = {
    "mixed": ([_prompt(1, 40), _prompt(2, 25), _prompt(3, 5),
               _prompt(4, 33)], 6, 4),
    "lane_packing": ([_prompt(10 + i, 20 + i) for i in range(6)], 5, 4),
    "oversize_to_wave": ([_prompt(20, 90), _prompt(21, 30),
                          _prompt(22, 70), _prompt(23, 64)], 5, 4),
    "more_rows_than_slots": ([_prompt(30 + i, 24 + i) for i in range(6)],
                             4, 2),
    "staggered_joins": None,
}


def _streams(factory, base, case):
    if CASES[case] is None:
        return _staggered(factory(base)), None
    prompts, new, slots = CASES[case]
    eng = factory(base, num_slots=slots)
    return [c.tokens for c in eng.generate(prompts, max_new_tokens=new)], \
        eng


@pytest.mark.parametrize("case", sorted(CASES))
def test_piggyback_equals_wave_and_jax(case):
    piggy, eng = _streams(_port, PIGGY, case)
    wave, _ = _streams(_port, WAVE, case)
    want, _ = _streams(_jax, PIGGY, case)
    assert piggy == wave
    assert piggy == want
    if eng is not None:
        assert eng.piggy_dispatches > 0 and eng.piggy_tokens > 0
        assert eng.piggy_rows >= 1


def test_staggered_join_rides_a_dispatch_beside_a_decoding_slot():
    # the second prompt piggybacks while the first decodes: the garbage
    # decode lane of its parked slot must not reach a live timeline
    eng = _port(PIGGY)
    eng.submit(_prompt(40, 28), max_new_tokens=30)
    eng.step()
    eng.step()
    assert len(eng._active) == 1
    eng.submit(_prompt(41, 45), max_new_tokens=10)
    before = eng.piggy_dispatches
    eng.step()
    assert eng.piggy_dispatches == before + 1
    assert len(eng._active) == 2


# ---------------------------------------------------------------------------
# the decoder's piggyback step and the chunk write against the JAX ones
# ---------------------------------------------------------------------------


def _step_inputs(rng, b=3, p=2, c=8, w_sz=4, s_max=32):
    """One step's inputs: lane 0 holds a packed second row (begin > 0),
    lane 1 a partial final chunk, row 2 of the decode batch is parked."""
    shape = (CFG.n_layers, b, CFG.n_kv_heads, s_max, CFG.head_dim)
    win = (CFG.n_layers, b, CFG.n_kv_heads, w_sz, CFG.head_dim)
    buf = (CFG.n_layers, p, CFG.n_kv_heads, w_sz * c, CFG.head_dim)
    f32 = np.float32
    return dict(
        tokens=rng.integers(3, CFG.vocab_size, size=b),
        positions=np.array([5, 17, s_max], np.int32),
        cache_k=rng.standard_normal(shape).astype(f32),
        cache_v=rng.standard_normal(shape).astype(f32),
        k_win=rng.standard_normal(win).astype(f32),
        v_win=rng.standard_normal(win).astype(f32),
        pre_tok=rng.integers(3, CFG.vocab_size, size=(p, c)),
        rope_base=np.array([8, 0], np.int32),
        kv_begin=np.array([8, 0], np.int32),
        kv_len=np.array([2 * 8 + 8, 3 * 8 + 5], np.int32),
        sel_rel=np.array([7, 4], np.int32),
        kbuf=rng.standard_normal(buf).astype(f32),
        vbuf=rng.standard_normal(buf).astype(f32),
        w=2, s_max=s_max)


def _run_jax_step(x, dtype):
    cfg = jax_config("tiny")
    params = jax.tree.map(lambda a: jnp.asarray(a, dtype), _weights()[0])
    arr = functools.partial(jnp.asarray, dtype=dtype)
    return jdec.decode_step_piggyback(
        params, jnp.asarray(x["tokens"]), jnp.asarray(x["positions"]),
        x["w"], cfg, {"k": arr(x["cache_k"]), "v": arr(x["cache_v"])},
        arr(x["k_win"]), arr(x["v_win"]), jnp.asarray(x["pre_tok"]),
        jnp.asarray(x["rope_base"]), jnp.asarray(x["kv_begin"]),
        jnp.asarray(x["kv_len"]), jnp.asarray(x["sel_rel"]),
        arr(x["kbuf"]), arr(x["vbuf"]), kv_len=24)


def _run_port_step(x, dtype):
    params = params_from_numpy(_weights()[1], "cpu", dtype)
    t = functools.partial(torch.tensor, dtype=dtype)
    kbuf, vbuf = t(x["kbuf"]), t(x["vbuf"])
    out = tdec.decode_step_piggyback(
        params, torch.tensor(x["tokens"]),
        torch.tensor(x["positions"]).long(), x["w"], CFG,
        {"k": t(x["cache_k"]), "v": t(x["cache_v"])}, t(x["k_win"]),
        t(x["v_win"]), torch.tensor(x["pre_tok"]),
        torch.tensor(x["rope_base"]), torch.tensor(x["kv_begin"]),
        torch.tensor(x["kv_len"]), torch.tensor(x["sel_rel"]), kbuf, vbuf,
        kv_len=24)
    return out, kbuf


def test_decode_step_piggyback_matches_jax_f32():
    x = _step_inputs(np.random.default_rng(0))
    want = _run_jax_step(x, jnp.float32)
    got, kbuf = _run_port_step(x, torch.float32)
    for w_, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-4,
                                   atol=1e-4)
    # the step wrote its chunk's KV into its buffer columns in place
    c = x["pre_tok"].shape[1]
    np.testing.assert_array_equal(
        kbuf[:, :, :, x["w"] * c:(x["w"] + 1) * c].numpy(),
        got[3].numpy())


def test_decode_step_piggyback_bf16_logits_within_rel_l2():
    x = _step_inputs(np.random.default_rng(1))
    want = np.asarray(_run_jax_step(x, jnp.bfloat16)[0], np.float32)
    got = _run_port_step(x, torch.bfloat16)[0][0].float().numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 5e-2, rel


def test_merge_prefill_writes_live_columns_like_the_jax_drop():
    rng = np.random.default_rng(2)
    s_max, p, buf = 32, 2, 16
    cache = rng.standard_normal((CFG.n_layers, 3, CFG.n_kv_heads, s_max,
                                 CFG.head_dim)).astype(np.float32)
    kbuf = rng.standard_normal((CFG.n_layers, p, CFG.n_kv_heads, buf,
                                CFG.head_dim)).astype(np.float32)
    # lane 0: two packed rows (slot 1 at 0..5, slot 2 at 6..14); lane 1
    # idle. JAX takes out-of-range maps for the rest and drops them.
    sidx = np.full((p, buf), 3, np.int32)
    pidx = np.full((p, buf), s_max, np.int32)
    sidx[0, :6], pidx[0, :6] = 1, np.arange(6)
    sidx[0, 6:15], pidx[0, 6:15] = 2, np.arange(9)
    want = jdec.merge_prefill({"k": jnp.asarray(cache),
                               "v": jnp.asarray(cache)},
                              jnp.asarray(kbuf), jnp.asarray(kbuf),
                              jnp.asarray(sidx), jnp.asarray(pidx))
    lanes, cols = np.nonzero(sidx < 3)
    got = tdec.merge_prefill(
        {"k": torch.tensor(cache), "v": torch.tensor(cache)},
        torch.tensor(kbuf), torch.tensor(kbuf), lanes, cols,
        sidx[lanes, cols], pidx[lanes, cols])
    np.testing.assert_array_equal(got["k"].numpy(), np.asarray(want["k"]))
    np.testing.assert_array_equal(got["v"].numpy(), np.asarray(want["v"]))


# ---------------------------------------------------------------------------
# engine plumbing
# ---------------------------------------------------------------------------


def test_piggyback_is_off_where_the_reference_turns_it_off():
    assert _port(PIGGY)._piggyback_ok
    assert not _port(PIGGY, windows_per_dispatch=2)._piggyback_ok
    assert not _port(PIGGY, max_len=128, kv_pool_blocks=40)._piggyback_ok
    swa = decoder_config("tiny-swa")              # window 64 < max_len 128
    eng = GenerationEngine(swa, dtype="float32", device="cpu",
                           telemetry=False, **PIGGY)
    assert not eng._piggyback_ok
    # off: an eligible prompt takes the wave and no dispatch piggybacks
    eng = _port(PIGGY, kv_pool_blocks=40, prefill_chunk=8)
    eng.generate([_prompt(1, 40)], max_new_tokens=3)
    assert eng.piggy_dispatches == 0 and not eng._prefilling


def test_prefilling_counts_in_queue_depth_and_expires():
    eng = _port(PIGGY)
    eng.submit(_prompt(1, 40), max_new_tokens=4, deadline_s=60.0)
    rid = eng.submit(_prompt(2, 30), max_new_tokens=4, deadline_s=0.0)
    eng._admit()
    assert len(eng._prefilling) == 2 and eng.queue_depth == 2
    eng._expire_deadlines()
    assert [r.request_id for r, _t in eng._prefilling] == [0]
    assert eng._done[rid].finish_reason == "deadline"


def test_piggyback_records_its_step_kind_and_tokens():
    eng = _port(PIGGY, telemetry=True)
    eng.generate([_prompt(1, 40), _prompt(2, 25)], max_new_tokens=3)
    kinds = [r.kind for r in eng.telemetry.recorder.records()]
    assert "piggyback" in kinds and "prefill" not in kinds
    rec = next(r for r in eng.telemetry.recorder.records()
               if r.kind == "piggyback")
    assert rec.tokens >= 65                  # both prompts rode it
    assert {t.admit_kind for t in eng.telemetry.completed} == {"piggyback"}


def test_verify_waits_while_prompts_piggyback():
    # spec decode keeps the piggyback dispatch while the feed is pending
    eng = _port(PIGGY, spec_decode=True, max_len=128)
    head = _prompt(5, 12)
    eng.submit(head * 3, max_new_tokens=12)
    for _ in range(3):
        eng.step()
    eng.submit(_prompt(6, 30), max_new_tokens=4)
    eng._admit()
    assert eng._prefilling
    spec0 = eng.spec_dispatches
    eng._decode_once()
    assert eng.spec_dispatches == spec0 and eng.piggy_dispatches >= 1
