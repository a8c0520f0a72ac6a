# The request journal on the port's engine (engine/journal.py, a copy of
# the JAX package's) against the JAX engine on the same weights in float32:
# the rows the two engines journal for the same submits are equal, field
# by field, and so are their checkpointed tokens; a warm restart after an
# in-process "kill" (the engine dropped, the sqlite file surviving) gives
# streams bit-identical to the uninterrupted run and to the JAX engine's
# own restart; expired, overlong and already-complete rows are handled as
# the JAX engine handles them. The runner cases of
# tests/test_engine_journal.py run on the port's copied runner, and the
# real-process SIGKILL (slow, as in the JAX package) drives the port's
# storm driver.
import functools
import json
import os
import signal
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from copilot_for_consensus_tpu.engine.generation import (
    GenerationEngine as JaxEngine,
)
from copilot_for_consensus_tpu.engine.journal import (
    EngineJournal as JaxJournal,
)
from copilot_for_consensus_tpu.models import decoder as jdec
from copilot_for_consensus_tpu.models.configs import (
    decoder_config as jax_config,
)
from copilot_for_consensus_tpu_torch.checkpoint.bridge import (
    params_from_numpy,
)
from copilot_for_consensus_tpu_torch.engine.async_runner import (
    AsyncEngineRunner,
)
from copilot_for_consensus_tpu_torch.engine.generation import (
    Completion,
    GenerationEngine,
)
from copilot_for_consensus_tpu_torch.engine.journal import EngineJournal
from copilot_for_consensus_tpu_torch.models.configs import decoder_config

#: the JAX package's journal test engine: tiny, f32 compute and KV
KW = dict(num_slots=4, max_len=96, prefill_buckets=(48,), decode_window=4)
PROMPTS = [
    [5, 9, 13, 6, 11, 4, 9, 2],
    [7, 8, 9, 10, 11, 12],
    [3, 4, 5, 6, 7, 8, 9, 10, 11],
    [40, 41, 42, 43, 44],
    [11, 12, 13, 14, 15, 16, 17],
    [21, 22, 23, 24],
]
#: the row fields both engines write the same way (deadline_wall and
#: journaled_wall are wall-clock stamps: compared as set or unset)
ROW_FIELDS = ("request_id", "prompt", "max_new_tokens", "tokens", "attempt",
              "cache_eligible_tokens", "correlation_id", "tenant",
              "priority", "trace_id", "span_id")


@functools.lru_cache(maxsize=None)
def _weights():
    cfg = jax_config("tiny")
    jp = jdec.init_params(jax.random.PRNGKey(7), cfg, dtype=jnp.float32)
    return cfg, jp, jax.tree.map(np.asarray, jp)


def _jax_engine(journal=None, **kw):
    cfg, jp, _ = _weights()
    return JaxEngine(cfg, jp, dtype=jnp.float32, kv_dtype=jnp.float32,
                     attn_impl="xla", telemetry=False, journal=journal,
                     **{**KW, **kw})


def _port_engine(journal=None, **kw):
    _, _, tree = _weights()
    return GenerationEngine(decoder_config("tiny"),
                            params_from_numpy(tree, "cpu", "float32"),
                            dtype="float32", device="cpu", telemetry=False,
                            journal=journal, **{**KW, **kw})


def _rows(journal) -> list[dict]:
    return [{**{f: getattr(e, f) for f in ROW_FIELDS},
             "deadline": bool(e.deadline_wall)}
            for e in journal.unfinished()]


def _submit_mix(eng):
    """The same submits on either engine: a tenant and a batch priority,
    a deadline, the defaults, and a publish cap."""
    rids = []
    for i, p in enumerate(PROMPTS):
        kw = [{"tenant": "ietf", "priority": "batch"},
              {"deadline_s": 600.0}, {}][i % 3]
        if i == 4:
            kw["cache_eligible_tokens"] = 4
        rids.append(eng.submit(list(p), 16, correlation_id=f"c-{i}", **kw))
    return rids


def _drain(eng, names: dict, got: dict) -> int:
    dup = 0
    steps = 0
    while (eng._active or eng._queue or eng._done) and steps < 400:
        steps += 1
        for c in eng.step():
            cid = names[c.request_id]
            dup += cid in got
            got[cid] = (c.tokens, c.finish_reason, c.prompt_len)
    return dup


def test_rows_journaled_equal_the_jax_engines():
    jj = JaxJournal(":memory:", checkpoint_every=2)
    tj = EngineJournal(":memory:", checkpoint_every=2)
    jeng, teng = _jax_engine(jj), _port_engine(tj)
    assert _submit_mix(jeng) == _submit_mix(teng)
    want = _rows(jj)
    assert want and _rows(tj) == want
    assert {r["priority"] for r in want} == {"batch", "interactive"}
    # the checkpointed tokens after every step, and the rows retired at
    # harvest, step for step
    checkpointed = False
    for _ in range(8):
        jc, tc = jeng.step(), teng.step()
        assert [(c.request_id, c.tokens) for c in tc] == \
            [(c.request_id, c.tokens) for c in jc]
        assert _rows(tj) == _rows(jj)
        assert tj.stats() == jj.stats()
        checkpointed |= any(r["tokens"] for r in _rows(tj))
    assert checkpointed


def test_submit_without_a_priority_journals_interactive():
    # the reference's default lane; the port's Request used to default to
    # "" and would have journaled (and replayed) a different row
    jj, tj = JaxJournal(":memory:"), EngineJournal(":memory:")
    jeng, teng = _jax_engine(jj), _port_engine(tj)
    jeng.submit([5, 6, 7], 4, correlation_id="p")
    teng.submit([5, 6, 7], 4, correlation_id="p")
    assert _rows(tj) == _rows(jj)
    assert _rows(tj)[0]["priority"] == "interactive"
    assert teng._queue[0].priority == jeng._queue[0].priority == \
        "interactive"


def _kill_and_restart(make, journal_cls, path):
    """Serve PROMPTS for 4 steps, drop the engine (the process death: no
    close, no flush), rebuild on the same file and serve the rest."""
    eng = make(journal_cls(path, checkpoint_every=2))
    rids = [eng.submit(list(p), 16, correlation_id=f"w-{i}")
            for i, p in enumerate(PROMPTS)]
    names = {rid: f"w-{i}" for i, rid in enumerate(rids)}
    got: dict = {}
    dup = 0
    for _ in range(4):
        for c in eng.step():
            dup += names[c.request_id] in got
            got[names[c.request_id]] = (c.tokens, c.finish_reason,
                                        c.prompt_len)
    depth = eng.journal.depth()
    rows = _rows(eng.journal)
    del eng
    eng2 = make(journal_cls(path, checkpoint_every=2))
    dup += _drain(eng2, dict(eng2.journal_recovered), got)
    return {"depth": depth, "rows": rows, "dup": dup, "got": got,
            "replayed": eng2.journal_replayed,
            "recovered": eng2.journal_recovered,
            "final_depth": eng2.journal.depth(),
            "stats": eng2.journal_stats()}


def test_warm_restart_is_bit_identical_to_uninterrupted_and_to_jax(
        tmp_path):
    ref = {f"w-{i}": (c.tokens, c.finish_reason, c.prompt_len)
           for i, c in enumerate(_port_engine().generate(
               [list(p) for p in PROMPTS], 16))}
    port = _kill_and_restart(_port_engine, EngineJournal,
                             str(tmp_path / "port.sqlite3"))
    jax_run = _kill_and_restart(_jax_engine, JaxJournal,
                                str(tmp_path / "jax.sqlite3"))
    assert port["depth"] > 0, "storm finished before the kill"
    assert port["replayed"] == port["depth"]
    assert port["dup"] == 0
    assert port["got"] == ref                  # lost 0, bit-identical
    assert port["final_depth"] == 0
    for key in ("depth", "rows", "got", "replayed", "recovered",
                "final_depth", "stats"):
        assert port[key] == jax_run[key], key


def _late(j):
    # a deadline that passed during the outage: dropped, never computed
    j.record_submit(0, [5, 6, 7], 8, correlation_id="late",
                    deadline_wall=time.time() - 5.0)
    j.checkpoint(0, [50, 51])


def _overlong(j):
    # prompt + checkpointed tokens beyond prompt_limit (48): abandoned
    j.record_submit(0, list(range(3, 43)), 64, correlation_id="big")
    j.checkpoint(0, list(range(3, 23)))


def _complete(j):
    # the whole budget checkpointed before the kill: emitted, no compute
    j.record_submit(0, [5, 6, 7], 4, correlation_id="done")
    j.checkpoint(0, [50, 51, 52, 53])


@pytest.mark.parametrize("setup,want", [
    (_late, ([50, 51], "deadline", 0, 0)),
    (_overlong, (None, None, 0, 1)),
    (_complete, ([50, 51, 52, 53], "length", 0, 0))],
    ids=["expired", "overlong", "already_complete"])
def test_recovery_of_rows_that_need_no_compute_equals_jax(tmp_path, setup,
                                                          want):
    out = {}
    for name, make, jcls in (("port", _port_engine, EngineJournal),
                             ("jax", _jax_engine, JaxJournal)):
        path = str(tmp_path / f"{name}.sqlite3")
        j = jcls(path)
        setup(j)
        j.close()
        eng = make(jcls(path))
        comps = eng.step()
        out[name] = ([(c.request_id, c.tokens, c.finish_reason,
                       c.prompt_len) for c in comps],
                     eng.journal_replayed, eng.journal_abandoned,
                     eng.journal.depth(), eng.journal_stats(),
                     eng.deadline_expired)
    assert out["port"] == out["jax"]
    comps, replayed, abandoned, depth = out["port"][:4]
    tokens, reason = want[:2]
    assert (replayed, abandoned, depth) == (want[2], want[3], 0)
    if tokens is None:
        assert comps == []
    else:
        assert [(c[1], c[2]) for c in comps] == [(tokens, reason)]


def test_journal_stats_surface(tmp_path):
    assert _port_engine().journal_stats() == {
        "enabled": False, "replayed": 0, "abandoned": 0}
    eng = _port_engine(EngineJournal(str(tmp_path / "j.sqlite3")))
    st = eng.journal_stats()
    assert st["enabled"] is True and st["depth"] == 0
    assert set(st) == set(_jax_engine(
        JaxJournal(":memory:")).journal_stats())


def test_runner_with_supervisor_takes_over_a_warm_restarted_engine(
        tmp_path):
    # the copied runner's restart audit and harvest on the port's engine:
    # recovered work drains through the dispatcher and the journal empties
    path = str(tmp_path / "j.sqlite3")
    eng = _port_engine(EngineJournal(path, checkpoint_every=2))
    for i, p in enumerate(PROMPTS):
        eng.submit(list(p), 16, correlation_id=f"r-{i}")
    for _ in range(3):
        eng.step()
    assert eng.journal.depth() > 0
    del eng
    eng2 = _port_engine(EngineJournal(path, checkpoint_every=2))
    assert eng2.journal_replayed > 0
    runner = AsyncEngineRunner(eng2, supervisor=True).start()
    deadline = time.monotonic() + 60
    while eng2.journal.depth() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert eng2.journal.depth() == 0
    assert runner.stop() is True


# ---------------------------------------------------------------------------
# runner integration (stub engine): the JAX package's cases on the port's
# copied runner
# ---------------------------------------------------------------------------


class _StubJournalEngine:
    """Minimal engine surface the runner needs, with a real journal:
    submit journals, step() either parks work forever ('park'),
    completes everything ('complete'), or raises ('fail')."""

    prompt_limit = 4096

    def __init__(self, journal, mode="park"):
        self.journal = journal
        self.mode = mode
        self.telemetry = None
        self._queue = []
        self._active = {}
        self._generated = {}
        self._prefilling = []
        self._done = {}
        self._next = 0

    def submit(self, prompt, max_new_tokens, **kw):
        rid = self._next
        self._next += 1
        self.journal.record_submit(
            rid, prompt, max_new_tokens,
            correlation_id=kw.get("correlation_id", ""))
        self._queue.append(SimpleNamespace(
            request_id=rid, prompt=list(prompt),
            max_new_tokens=max_new_tokens, cache_eligible_tokens=None,
            correlation_id=kw.get("correlation_id", ""), tenant="",
            priority="", deadline_at=float("inf")))
        return rid

    def step(self):
        if self.mode == "fail":
            raise RuntimeError("stub step failure")
        if self.mode == "park":
            return []
        comps = []
        for req in self._queue:
            comps.append(Completion(
                request_id=req.request_id,
                prompt_len=len(req.prompt), tokens=[1, 2],
                finish_reason="length"))
            self.journal.record_retire(req.request_id)
        self._queue = []
        return comps


def _runner(eng, **kw):
    return AsyncEngineRunner(eng, **kw).start()


def test_runner_stop_keeps_journal_rows(tmp_path):
    j = EngineJournal(str(tmp_path / "j.sqlite3"))
    eng = _StubJournalEngine(j, mode="park")
    r = _runner(eng)
    h1 = r.submit([1, 2, 3], 8, correlation_id="keep-1")
    h2 = r.submit([4, 5], 8, correlation_id="keep-2")
    deadline = time.monotonic() + 5
    while not eng._queue and time.monotonic() < deadline:
        time.sleep(0.01)
    assert r.stop() is True
    for h in (h1, h2):
        with pytest.raises(RuntimeError, match="runner stopped"):
            h.result(timeout=5)
    assert j.depth() == 2
    assert {e.correlation_id for e in j.unfinished()} == {
        "keep-1", "keep-2"}


def test_runner_legacy_failure_abandons_rows(tmp_path):
    j = EngineJournal(str(tmp_path / "j.sqlite3"))
    eng = _StubJournalEngine(j, mode="fail")
    r = _runner(eng)
    h = r.submit([1, 2, 3], 8, correlation_id="gone")
    with pytest.raises(RuntimeError, match="stub step failure"):
        h.result(timeout=5)
    deadline = time.monotonic() + 5
    while j.depth() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert j.depth() == 0
    assert j.stats()["abandoned"] == 1
    r.stop()


def test_runner_drain_completes_then_reports(tmp_path):
    j = EngineJournal(str(tmp_path / "j.sqlite3"))
    eng = _StubJournalEngine(j, mode="complete")
    r = _runner(eng)
    h = r.submit([1, 2], 4)
    assert r.drain(timeout=5) is True
    assert h.result(timeout=1).tokens == [1, 2]
    assert j.depth() == 0
    assert r.stop() is True


def test_runner_drain_times_out_on_parked_work(tmp_path):
    j = EngineJournal(str(tmp_path / "j.sqlite3"))
    eng = _StubJournalEngine(j, mode="park")
    r = _runner(eng)
    r.submit([1, 2], 4)
    t0 = time.monotonic()
    assert r.drain(timeout=0.3) is False
    assert time.monotonic() - t0 < 3.0
    r.stop()
    assert j.depth() == 1    # evacuate-and-journal: the row survives


def test_runner_drain_unblocks_on_stop(tmp_path):
    j = EngineJournal(str(tmp_path / "j.sqlite3"))
    eng = _StubJournalEngine(j, mode="park")
    r = _runner(eng)
    r.submit([1], 4)
    out = {}

    def drainer():
        out["drained"] = r.drain(timeout=30.0)

    t = threading.Thread(target=drainer)
    t.start()
    time.sleep(0.1)
    r.stop()
    t.join(timeout=5)
    assert not t.is_alive()
    assert out["drained"] is False


# ---------------------------------------------------------------------------
# real-process SIGKILL (slow, as in the JAX package): the port's storm
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_real_process_sigkill_and_warm_restart(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")

    def child(journal, out, result, kill_after=0):
        cmd = [sys.executable, "-m",
               "copilot_for_consensus_tpu_torch.tools.journal_storm",
               "--journal", str(journal), "--out", str(out),
               "--result", str(result), "--requests", "10",
               "--new-tokens", "20", "--seed", "5", "--device", "cpu"]
        if kill_after:
            cmd += ["--kill-after-step", str(kill_after)]
        return subprocess.run(cmd, env=env, capture_output=True,
                              text=True, timeout=300)

    r = child(tmp_path / "ref.sqlite3", tmp_path / "ref.jsonl",
              tmp_path / "ref.json")
    assert r.returncode == 0, r.stderr[-2000:]

    r = child(tmp_path / "kill.sqlite3", tmp_path / "kill.jsonl",
              tmp_path / "kill.json", kill_after=6)
    assert r.returncode in (-signal.SIGKILL, 137), (
        "child was not SIGKILLed", r.returncode, r.stderr[-500:])

    r = child(tmp_path / "kill.sqlite3", tmp_path / "kill.jsonl",
              tmp_path / "resume.json")
    assert r.returncode == 0, r.stderr[-2000:]
    resume = json.loads((tmp_path / "resume.json").read_text())
    assert resume["resume"] is True
    assert resume["journal_replayed"] > 0
    assert resume["journal_depth"] == 0

    def lines(p):
        out, dup = {}, 0
        for line in p.read_text().splitlines():
            d = json.loads(line)
            dup += d["cid"] in out
            out[d["cid"]] = d["tokens"]
        return out, dup

    ref, _ = lines(tmp_path / "ref.jsonl")
    got, dup = lines(tmp_path / "kill.jsonl")
    assert dup == 0
    assert set(got) == set(ref)                       # lost 0
    assert all(got[c] == ref[c] for c in ref)         # bit-identical
    for cid, tokens in resume["resumed"].items():     # resumed from the
        assert got[cid][:len(tokens)] == tokens       # checkpoint
