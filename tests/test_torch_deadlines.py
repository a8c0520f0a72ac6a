# Per-request deadlines on the port's engine, against the JAX engine on the
# same weights in float32: expired queued work is dropped uncomputed, an
# expired active slot is retired with its partial output, both with
# finish_reason "deadline" — the same requests, reasons and tokens as the
# JAX engine's — and the other slots' greedy streams are those of a run
# without the expired request. A slot retired between dispatches parks as
# an eos retirement parks it (the next dispatch does not write its column
# over a live one; its pool blocks go back). The summarizer raises the
# structured EngineFailed for a drop with no tokens.
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

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
    Completion,
    GenerationEngine,
)
from copilot_for_consensus_tpu_torch.engine.journal import EngineJournal
from copilot_for_consensus_tpu_torch.engine.supervisor import EngineFailed
from copilot_for_consensus_tpu_torch.models.configs import decoder_config
from copilot_for_consensus_tpu_torch.summarization.base import (
    ThreadContext,
)
from copilot_for_consensus_tpu_torch.summarization.summarizer import (
    CUDASummarizer,
)

KW = dict(num_slots=3, max_len=128, prefill_buckets=(32,), prefill_chunk=32,
          decode_window=4)
PROMPTS = [[5, 9, 13], list(range(40, 61)), [7] * 9, [3, 4]]


@functools.lru_cache(maxsize=None)
def _weights():
    cfg = jax_config("tiny")
    jp = jdec.init_params(jax.random.PRNGKey(7), cfg, dtype=jnp.float32)
    return cfg, jp, jax.tree.map(np.asarray, jp)


def _pair(paged=False, **kw):
    cfg, jp, tree = _weights()
    blocks = 20 if paged else 0
    kw = {**KW, **kw}
    jeng = JaxEngine(cfg, jp, dtype=jnp.float32, kv_dtype=jnp.float32,
                     attn_impl="xla", kv_pool_blocks=blocks,
                     kv_kernel="pallas" if paged else "auto",
                     telemetry=True, **kw)
    teng = GenerationEngine(decoder_config("tiny"),
                            params_from_numpy(tree, "cpu", "float32"),
                            dtype="float32", kv_pool_blocks=blocks,
                            device="cpu", **kw)
    return jeng, teng


def _port(**kw):
    _, _, tree = _weights()
    return GenerationEngine(decoder_config("tiny"),
                            params_from_numpy(tree, "cpu", "float32"),
                            dtype="float32", device="cpu", **{**KW, **kw})


def _run(eng, expire_after=None, expire_rid=None) -> dict:
    """Step until every request is done; after step ``expire_after`` the
    deadline of request ``expire_rid`` (active by then) is set in the
    past, as a deadline that expires mid-decode would be."""
    done = {}
    steps = 0
    while eng._queue or eng._active or eng._done:
        steps += 1
        for c in eng.step():
            done[c.request_id] = (c.tokens, c.finish_reason)
        if steps == expire_after:
            req = next(r for r in eng._active.values()
                       if r.request_id == expire_rid)
            req.deadline_at = time.monotonic() - 1.0
            eng._deadlines_in_use = True
    return done


def test_deadline_completion_surfaces_as_structured_failure():
    dead = Completion(request_id=5, prompt_len=8, tokens=[],
                      finish_reason="deadline")
    with pytest.raises(EngineFailed) as ei:
        CUDASummarizer._checked(dead)
    assert ei.value.reason == "deadline-expired"
    assert ei.value.request_id == 5
    ok = Completion(request_id=6, prompt_len=8, tokens=[1, 2],
                    finish_reason="length")
    assert CUDASummarizer._checked(ok) is ok
    # a deadline retirement with partial tokens is a (short) summary
    partial = Completion(request_id=7, prompt_len=8, tokens=[3],
                         finish_reason="deadline")
    assert CUDASummarizer._checked(partial) is partial


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_deadline_expired_work_is_dropped_not_computed(paged):
    jeng, teng = _pair(paged)
    out = {}
    for name, eng in (("jax", jeng), ("port", teng)):
        rid = eng.submit([1, 2, 3], 8, deadline_s=0.0)
        rid_live = eng.submit([4, 5, 6], 4)
        out[name] = (_run(eng), eng.deadline_expired, rid, rid_live)
    assert out["port"] == out["jax"]
    done, expired, rid, rid_live = out["port"]
    assert done[rid] == ([], "deadline")
    assert done[rid_live][1] in ("eos", "length") and done[rid_live][0]
    assert expired == 1
    # the telemetry counter moved too
    m = teng.telemetry.metrics
    assert m.counters["engine_recovery_deadline_expired_total"]
    # the dropped request never reached a wave: one row prefilled
    assert teng.telemetry.recorder.records()[0].rows == 1


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_deadline_mid_decode_retires_with_partial_output(paged):
    jeng, teng = _pair(paged)
    base_j, base_t = _pair(paged)
    out = {}
    for name, eng, base in (("jax", jeng, base_j), ("port", teng, base_t)):
        rids = [eng.submit(list(p), 24) for p in PROMPTS]
        got = _run(eng, expire_after=2, expire_rid=rids[1])
        # the same requests without the one that expires
        want = base.generate([p for i, p in enumerate(PROMPTS) if i != 1],
                             24)
        out[name] = (got, [(c.tokens, c.finish_reason) for c in want],
                     rids)
    assert out["port"][0] == out["jax"][0]
    got, want, rids = out["port"]
    tokens, reason = got[rids[1]]
    assert reason == "deadline" and 0 < len(tokens) < 24
    # the other slots' greedy streams are untouched by the retirement
    assert [got[r] for i, r in enumerate(rids) if i != 1] == want
    assert teng.deadline_expired == 1
    if paged:
        st = teng.kv_pool_stats()
        assert st["free_blocks"] == st["num_blocks"]     # all returned


def test_expired_request_retires_its_journal_row():
    j = EngineJournal(":memory:")
    teng = _port(journal=j)
    teng.submit([1, 2, 3], 8, deadline_s=0.0)
    assert j.depth() == 1 and j.unfinished()[0].deadline_wall > 0
    comps = teng.step()
    assert [c.finish_reason for c in comps] == ["deadline"]
    assert j.depth() == 0 and j.stats()["retired"] == 1


def test_summarizer_deadline_reaches_the_runner_and_fails_in_words():
    teng = _port()
    summ = CUDASummarizer(engine=teng, max_new_tokens=4, deadline_s=0.0)
    thread = ThreadContext(thread_id="t", subject="s", chunks=[])
    with pytest.raises(EngineFailed, match="deadline"):
        summ.summarize_async(thread)(60.0)
    with pytest.raises(EngineFailed, match="deadline"):
        summ._engine_generate([[5, 6, 7]])
    summ.close()
    assert teng.deadline_expired == 2

