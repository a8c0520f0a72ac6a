"""Durable engine request journal: a serving-process crash costs
latency, not work.

PR 8 gave the *pipeline* that contract for broker outages (the durable
publish outbox) and PR 7 contains *in-process* engine failures
(supervisor + request replay) — but a serving-process death still lost
every queued and in-flight engine request plus all generated-so-far
tokens. This module is the process-level mirror of both: the same
sqlite-WAL file discipline as the publish outbox
(``bus/broker.py:_Outbox``), holding one row per live engine request.

Contract (docs/RESILIENCE.md#process-lifecycle):

* ``engine.submit`` journals the request — prompt, params, scheduling
  identity, correlation/trace ids — BEFORE the request enters any
  engine queue, so there is no window where admitted work is
  journal-invisible.
* Accepted tokens checkpoint incrementally: every ``checkpoint_every``
  decode steps and on every step that retires a request. A crash loses
  at most the tokens accepted since the last checkpoint — and loses
  them as *latency* (they are recomputed from the checkpoint), never
  as work.
* Retirement deletes the row at harvest. Terminal structured failures
  delivered to a live caller (``EngineFailed``, watchdog suspects)
  *abandon* the row — the caller owns the retry now, and replaying it
  at the next restart would duplicate work the caller already saw
  fail.
* On restart, :meth:`unfinished` rows resubmit as prompt+generated
  continuations through the PR-7 replay machinery (seeded prefill;
  greedy bit-identical at f32); :meth:`supersede` re-keys the row to
  the continuation's request id while preserving the ORIGINAL identity
  (prompt, budget, accepted tokens, attempt count), so a second crash
  still recovers the original request.

Everything here is import-light host code (sqlite + json only — no
jax): the journal is unit-testable against stub engines and usable
from host-only processes.
"""

from __future__ import annotations

import json
import sqlite3
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Iterable


@dataclass
class JournalEntry:
    """One unfinished request as recovered from the journal."""

    request_id: int
    prompt: list[int]
    max_new_tokens: int
    #: accepted tokens as of the last checkpoint (recovery resumes the
    #: continuation from here; anything accepted after the checkpoint
    #: is recomputed — latency, not loss)
    tokens: list[int] = field(default_factory=list)
    #: process-restart / replay attempts already consumed
    attempt: int = 0
    cache_eligible_tokens: int | None = None
    correlation_id: str = ""
    tenant: str = ""
    priority: str = ""
    #: absolute wall-clock deadline (0.0 = none). Wall clock, not
    #: monotonic: a monotonic stamp is meaningless across processes.
    deadline_wall: float = 0.0
    #: pipeline trace parent captured at submit (attempt-numbered
    #: ``engine_replay`` spans parent here on recovery)
    trace_id: str = ""
    span_id: str = ""
    journaled_wall: float = 0.0


class EngineJournal:
    """Bounded-risk durable request journal (sqlite WAL; ``:memory:``
    for tests — pass a path when rows must survive a process death,
    which is the point). Thread-safe: the engine's dispatcher thread
    writes the hot path, runner/watchdog threads abandon rows, and the
    metrics scrape reads ``depth()``.

    ``checkpoint_every`` is the decode-step cadence between incremental
    token checkpoints — the knob behind the
    ``copilot_engine_journal_checkpoint_lag`` gauge: smaller loses
    fewer tokens to a crash, larger costs fewer sqlite writes."""

    def __init__(self, path: str = ":memory:", *,
                 checkpoint_every: int = 8):
        self.path = path
        self.checkpoint_every = max(1, int(checkpoint_every))
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.execute("PRAGMA synchronous=NORMAL")
        self._lock = threading.Lock()
        with self._lock, self._db:
            self._db.execute("""
                CREATE TABLE IF NOT EXISTS requests (
                    rid INTEGER PRIMARY KEY,
                    prompt TEXT NOT NULL,
                    max_new_tokens INTEGER NOT NULL,
                    resumed TEXT NOT NULL DEFAULT '[]',
                    tokens TEXT NOT NULL DEFAULT '[]',
                    attempt INTEGER NOT NULL DEFAULT 0,
                    cache_eligible INTEGER,
                    correlation_id TEXT NOT NULL DEFAULT '',
                    tenant TEXT NOT NULL DEFAULT '',
                    priority TEXT NOT NULL DEFAULT '',
                    deadline_wall REAL NOT NULL DEFAULT 0.0,
                    trace_id TEXT NOT NULL DEFAULT '',
                    span_id TEXT NOT NULL DEFAULT '',
                    journaled_at REAL NOT NULL
                )""")
            # cached row count, seeded from the durable file: depth()
            # is read every engine step for the gauge — that must not
            # cost a sqlite COUNT(*) per step (the _Outbox move)
            self._n = int(self._db.execute(
                "SELECT COUNT(*) FROM requests").fetchone()[0])
        # counters (stats(); process-local, not durable)
        self._journaled = 0
        self._retired = 0
        self._abandoned = 0
        self._checkpoints = 0

    # -- hot path --------------------------------------------------------

    def record_submit(self, request_id: int, prompt: Iterable[int],
                      max_new_tokens: int, *,
                      cache_eligible_tokens: int | None = None,
                      correlation_id: str = "", tenant: str = "",
                      priority: str = "",
                      deadline_wall: float = 0.0,
                      trace_id: str = "", span_id: str = "") -> None:
        """Journal one request BEFORE it enters any engine queue."""
        with self._lock, self._db:
            existed = self._db.execute(
                "SELECT 1 FROM requests WHERE rid = ?",
                (int(request_id),)).fetchone() is not None
            self._db.execute(
                "INSERT OR REPLACE INTO requests (rid, prompt, "
                "max_new_tokens, resumed, tokens, attempt, "
                "cache_eligible, correlation_id, tenant, priority, "
                "deadline_wall, trace_id, span_id, journaled_at) "
                "VALUES (?, ?, ?, '[]', '[]', 0, ?, ?, ?, ?, ?, ?, ?, ?)",
                (int(request_id), json.dumps(list(prompt)),
                 int(max_new_tokens), cache_eligible_tokens,
                 correlation_id, tenant, priority, float(deadline_wall),
                 trace_id, span_id, time.time()))
            if not existed:
                self._n += 1
            self._journaled += 1

    def checkpoint(self, request_id: int,
                   generated: Iterable[int]) -> None:
        """Record the tokens accepted so far for one request.
        ``generated`` is relative to the row's CURRENT prompt (the
        continuation after a supersede); the row's durable ``tokens``
        column is always relative to the ORIGINAL prompt."""
        self.checkpoint_many([(request_id, generated)])

    def checkpoint_many(
            self, pairs: Iterable[tuple[int, Iterable[int]]]) -> None:
        pairs = [(int(rid), list(gen)) for rid, gen in pairs]
        if not pairs:
            return
        with self._lock, self._db:
            for rid, gen in pairs:
                row = self._db.execute(
                    "SELECT resumed FROM requests WHERE rid = ?",
                    (rid,)).fetchone()
                if row is None:
                    continue
                resumed = json.loads(row[0])
                self._db.execute(
                    "UPDATE requests SET tokens = ? WHERE rid = ?",
                    (json.dumps(resumed + gen), rid))
                self._checkpoints += 1

    def record_retire(self, request_id: int) -> None:
        """The request completed and its output was harvested: the row
        leaves the journal (crash-after-this replays nothing)."""
        self._delete(request_id, retired=True)

    def record_abandon(self, request_id: int) -> None:
        """A terminal structured failure was DELIVERED to a live caller
        (EngineFailed / suspect / deadline): the caller owns the retry,
        so the row must not replay at the next restart."""
        self._delete(request_id, retired=False)

    def _delete(self, request_id: int, *, retired: bool) -> None:
        with self._lock, self._db:
            cur = self._db.execute(
                "DELETE FROM requests WHERE rid = ?",
                (int(request_id),))
            if cur.rowcount:
                self._n -= cur.rowcount
                if retired:
                    self._retired += cur.rowcount
                else:
                    self._abandoned += cur.rowcount

    # -- recovery --------------------------------------------------------

    def unfinished(self) -> list[JournalEntry]:
        """Every journaled request that never retired, oldest first —
        the warm-restart work list."""
        with self._lock:
            rows = self._db.execute(
                "SELECT rid, prompt, max_new_tokens, tokens, attempt, "
                "cache_eligible, correlation_id, tenant, priority, "
                "deadline_wall, trace_id, span_id, journaled_at "
                "FROM requests ORDER BY rid").fetchall()
        return [JournalEntry(
            request_id=r[0], prompt=json.loads(r[1]),
            max_new_tokens=r[2], tokens=json.loads(r[3]), attempt=r[4],
            cache_eligible_tokens=r[5], correlation_id=r[6],
            tenant=r[7], priority=r[8], deadline_wall=r[9],
            trace_id=r[10], span_id=r[11], journaled_wall=r[12])
            for r in rows]

    def supersede(self, old_rid: int, new_rid: int,
                  resumed_tokens: Iterable[int]) -> None:
        """ATOMICALLY re-key ``old_rid``'s row onto the continuation
        ``new_rid``, preserving the ORIGINAL identity (prompt, budget,
        correlation/trace ids) with ``resumed_tokens`` as the accepted
        prefix the continuation resumes from and attempt+1. One UPDATE
        in one transaction — at no instant does the journal hold two
        live rows for one request, so a crash anywhere around a
        resubmission replays exactly one of {original, continuation},
        never both. Callers therefore SUPPRESS the continuation's own
        ``record_submit`` (``GenerationEngine._journal_suppress``) and
        let this re-key be the row's only mutation. Future checkpoints
        of the continuation land as resumed+generated — a second crash
        recovers the original request, not the continuation."""
        tok = json.dumps(list(resumed_tokens))
        with self._lock, self._db:
            self._db.execute(
                "UPDATE requests SET rid = ?, resumed = ?, tokens = ?, "
                "attempt = attempt + 1 WHERE rid = ?",
                (int(new_rid), tok, tok, int(old_rid)))

    # -- introspection ---------------------------------------------------

    def depth(self) -> int:
        with self._lock:
            return self._n

    def stats(self) -> dict:
        with self._lock:
            return {
                "depth": self._n,
                "journaled": self._journaled,
                "retired": self._retired,
                "abandoned": self._abandoned,
                "checkpoints": self._checkpoints,
            }

    def close(self) -> None:
        # Terminal teardown: snapshot the handle under the lock, close
        # outside it (sqlite's own close is thread-safe; a concurrent
        # writer surfaces a ProgrammingError it already tolerates).
        with self._lock:
            db = self._db
        db.close()


def resolve_journal(journal: Any) -> EngineJournal | None:
    """``journal=`` argument semantics (the ``resolve_telemetry`` /
    ``resolve_supervisor`` pattern): None/False disables, a string is a
    database path, a dict is ``{"path": ..., "checkpoint_every": ...}``,
    an :class:`EngineJournal` instance is used as-is."""
    if journal is None or journal is False:
        return None
    if isinstance(journal, EngineJournal):
        return journal
    if isinstance(journal, str):
        return EngineJournal(journal)
    if isinstance(journal, dict):
        cfg = dict(journal)
        return EngineJournal(
            cfg.get("path", ":memory:"),
            checkpoint_every=int(cfg.get("checkpoint_every", 8)))
    raise ValueError(
        f"journal must be None/False, a path, a config dict or an "
        f"EngineJournal, got {type(journal).__name__}")
