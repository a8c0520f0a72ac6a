"""Broker-grade inter-process bus: one ROUTER socket, durable queues.

The distributed-bus role the reference fills with RabbitMQ (publisher
confirms ``rabbitmq_publisher.py:146-149``; manual ack + nack-requeue
``rabbitmq_subscriber.py:504-560``; durable pre-declared queues
``infra/rabbitmq/definitions.json``). Design:

* **One broker socket.** All routing keys multiplex over a single ZMQ
  ROUTER endpoint — no per-key ports, no hash collisions (the round-1
  port-hash topology collided 17 keys into 64 ports). Publishers and
  consumers are DEALER clients doing strict request/reply with timeouts.
* **Durable by default.** Every published envelope lands in a sqlite
  (WAL) queue table before the publisher confirm is sent; a broker crash
  or restart loses nothing. In-flight deliveries carry a lease — if a
  consumer dies mid-message, the lease expires and the message requeues.
* **Ack / nack-requeue / DLQ.** Callback success acks; failure nacks and
  requeues with an attempt count; past ``max_redeliveries`` the message
  parks in the dead-letter state, visible to the failed-queues CLI.
* **At-least-once.** Retries on timeouts can duplicate deliveries; the
  pipeline is idempotent end-to-end (deterministic ids, upserts), same
  contract as the reference's bus.

The broker runs embedded (``Broker.start()`` thread) or standalone:
``python -m copilot_for_consensus_tpu_torch.bus.broker --port 5700 --db q.db``.
"""

from __future__ import annotations

import contextlib
import json
import sqlite3
import threading
import time
from typing import Any

from copilot_for_consensus_tpu_torch.bus.base import (
    BusSaturated,
    EventCallback,
    EventPublisher,
    EventSubscriber,
    PoisonEnvelope,
    PublishError,
)

try:
    import zmq

    HAS_ZMQ = True
except ImportError:  # pragma: no cover - environment without pyzmq
    HAS_ZMQ = False

DEFAULT_PORT = 5700
DEFAULT_LEASE_S = 30.0
# Subscribers that don't set a group share one queue per routing key
# (competing consumers) — the reference's one-durable-queue-per-key
# topology. Distinct groups each get every message (service fan-out).
DEFAULT_GROUP = "default"


class _QueueStore:
    """sqlite-backed message queues. One table, state machine per row:
    pending → inflight → (acked | pending | dead).

    Consumer groups (the AMQP binding model, reference
    ``infra/rabbitmq/definitions.json``): a binding is (routing_key,
    group); publish inserts one row per bound group so distinct groups
    each see every message (service fan-out) while consumers sharing a
    group compete (replicas). Messages published before any binding
    exists are parked (``grp=''``) and handed to the first group that
    binds the key."""

    def __init__(self, path: str = ":memory:"):
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.execute("PRAGMA synchronous=NORMAL")
        self._lock = threading.Lock()
        with self._lock, self._db:
            self._db.execute("""
                CREATE TABLE IF NOT EXISTS messages (
                    id INTEGER PRIMARY KEY AUTOINCREMENT,
                    rk TEXT NOT NULL,
                    grp TEXT NOT NULL DEFAULT '',
                    envelope TEXT NOT NULL,
                    state TEXT NOT NULL DEFAULT 'pending',
                    attempts INTEGER NOT NULL DEFAULT 0,
                    lease_expires REAL,
                    enqueued_at REAL NOT NULL,
                    reason TEXT
                )""")
            try:  # pre-group db files: add the column in place
                self._db.execute(
                    "ALTER TABLE messages ADD COLUMN grp TEXT "
                    "NOT NULL DEFAULT ''")
            except sqlite3.OperationalError:
                pass
            try:  # pre-quarantine db files: dead-letter reason column
                self._db.execute(
                    "ALTER TABLE messages ADD COLUMN reason TEXT")
            except sqlite3.OperationalError:
                pass
            self._db.execute("""
                CREATE TABLE IF NOT EXISTS bindings (
                    rk TEXT NOT NULL,
                    grp TEXT NOT NULL,
                    UNIQUE (rk, grp)
                )""")
            self._db.execute(
                "CREATE INDEX IF NOT EXISTS idx_rk_grp_state "
                "ON messages (rk, grp, state, id)")
            # Broker (re)start: whatever was in flight requeues.
            self._db.execute(
                "UPDATE messages SET state='pending', lease_expires=NULL "
                "WHERE state='inflight'")

    def bind(self, rks: list[str], grp: str) -> None:
        with self._lock, self._db:
            for rk in rks:
                self._db.execute(
                    "INSERT OR IGNORE INTO bindings (rk, grp) VALUES (?, ?)",
                    (rk, grp))
                # Parked pre-bind messages go to the first binder.
                self._db.execute(
                    "UPDATE messages SET grp=? "
                    "WHERE rk=? AND grp='' AND state='pending'", (grp, rk))

    def enqueue(self, rk: str, envelope: str) -> tuple[int, int]:
        """Insert one row per bound group; returns (last row id, depth)
        where depth is the key's worst per-group pending count AFTER the
        insert — piggybacked on the publisher confirm so producers get
        backpressure feedback for free with every publish."""
        now = time.time()
        with self._lock, self._db:
            groups = [g for (g,) in self._db.execute(
                "SELECT grp FROM bindings WHERE rk=?", (rk,))]
            last = 0
            for grp in (groups or [""]):
                cur = self._db.execute(
                    "INSERT INTO messages (rk, grp, envelope, enqueued_at) "
                    "VALUES (?, ?, ?, ?)", (rk, grp, envelope, now))
                last = cur.lastrowid
            return last, self._depth_locked(rk)

    def enqueue_many(self, items: list[tuple[str, str]]
                     ) -> dict[str, int]:
        """Grouped publish: every (rk, envelope) lands in ONE locked
        transaction — one sqlite commit and one broker round-trip for
        a whole dispatch wave's follow-up events, instead of one each.
        Returns the post-insert depth per distinct key (the same
        backpressure piggyback as :meth:`enqueue`)."""
        now = time.time()
        with self._lock, self._db:
            groups_of: dict[str, list[str]] = {}
            for rk, envelope in items:
                if rk not in groups_of:
                    groups_of[rk] = [g for (g,) in self._db.execute(
                        "SELECT grp FROM bindings WHERE rk=?", (rk,))]
                for grp in (groups_of[rk] or [""]):
                    self._db.execute(
                        "INSERT INTO messages "
                        "(rk, grp, envelope, enqueued_at) "
                        "VALUES (?, ?, ?, ?)", (rk, grp, envelope, now))
            return {rk: self._depth_locked(rk) for rk in groups_of}

    def _depth_locked(self, rk: str) -> int:
        # Parked rows (grp='', published before any consumer bound —
        # possibly never: report.published and *.failed have no
        # subscriber by design) are retention, not backlog: counting
        # them would make watermark pacing stall a stage forever
        # against a queue nothing drains. Depth = work a LIVE consumer
        # group is behind on.
        row = self._db.execute(
            "SELECT MAX(n) FROM (SELECT COUNT(*) AS n FROM messages "
            "WHERE rk=? AND state='pending' AND grp != '' GROUP BY grp)",
            (rk,)).fetchone()
        return int(row[0] or 0)

    def depth(self, rk: str) -> int:
        """Worst per-group pending count for one key — the watermark
        poll the pacing publisher uses between confirms."""
        with self._lock:
            return self._depth_locked(rk)

    def fetch(self, rks: list[str], grp: str, limit: int, lease_s: float
              ) -> list[tuple[int, str, str, int]]:
        """Atomically move up to ``limit`` pending messages (across the
        given keys, within one group) to inflight. Returns
        (id, rk, envelope, attempts)."""
        now = time.time()
        qmarks = ",".join("?" for _ in rks)
        with self._lock, self._db:
            rows = self._db.execute(
                f"SELECT id, rk, envelope, attempts FROM messages "
                f"WHERE state='pending' AND grp=? AND rk IN ({qmarks}) "
                f"ORDER BY id LIMIT ?", (grp, *rks, limit)).fetchall()
            if rows:
                ids = [r[0] for r in rows]
                self._db.execute(
                    f"UPDATE messages SET state='inflight', "
                    f"lease_expires=? WHERE id IN "
                    f"({','.join('?' for _ in ids)})",
                    (now + lease_s, *ids))
            return rows

    def ack(self, ids: list[int]) -> None:
        if not ids:
            return
        with self._lock, self._db:
            self._db.execute(
                f"DELETE FROM messages WHERE id IN "
                f"({','.join('?' for _ in ids)}) AND state='inflight'",
                ids)

    def nack(self, ids: list[int], max_redeliveries: int,
             poison: bool = False, reason: str | None = None) -> None:
        if not ids:
            return
        qmarks = ",".join("?" for _ in ids)
        with self._lock, self._db:
            if poison:
                # Quarantine: a deterministically-unprocessable message
                # (schema-invalid, non-retryable handler error) skips
                # the redelivery budget entirely — straight to the
                # dead-letter state with a structured reason, attempts
                # untouched so the operator sees it never cycled.
                self._db.execute(
                    f"UPDATE messages SET state='dead', "
                    f"lease_expires=NULL, reason=? "
                    f"WHERE id IN ({qmarks}) AND state='inflight'",
                    (reason or "poison", *ids))
                return
            self._db.execute(
                f"UPDATE messages SET attempts=attempts+1, "
                f"lease_expires=NULL, state=CASE WHEN attempts+1 >= ? "
                f"THEN 'dead' ELSE 'pending' END, "
                f"reason=CASE WHEN attempts+1 >= ? THEN ? ELSE reason END "
                f"WHERE id IN ({qmarks}) AND state='inflight'",
                (max_redeliveries, max_redeliveries,
                 reason or "redelivery budget exhausted", *ids))

    def expire_leases(self, parked_ttl_s: float = 300.0) -> int:
        with self._lock, self._db:
            cur = self._db.execute(
                "UPDATE messages SET state='pending', lease_expires=NULL "
                "WHERE state='inflight' AND lease_expires < ?",
                (time.time(),))
            # Parked rows (published with no binding) exist only to cover
            # the startup race where a subscriber binds moments later; a
            # key nothing ever binds (e.g. a terminal event with no
            # consumer) must not grow the db forever — AMQP drops
            # unroutable messages outright, we just do it on a delay.
            self._db.execute(
                "DELETE FROM messages WHERE grp='' AND state='pending' "
                "AND enqueued_at < ?", (time.time() - parked_ttl_s,))
            return cur.rowcount

    def counts(self) -> dict[str, dict[str, int]]:
        """Per-key state split. Pre-bind retention rows surface as
        ``parked`` (not ``pending``): no live consumer group owes that
        work, so backpressure (watermark pacing, the ingestion pacer)
        and the queue-depth gauges/alerts must not count it as
        backlog. ``pending`` is the WORST single consumer group's
        backlog (same semantics as :meth:`depth` and the
        ``copilot_bus_pending`` gauge the 1000-message SLO alerts on) —
        summing across groups would inflate a 4-consumer key 4x past
        the depth any one consumer actually owes. Other states sum
        across groups."""
        with self._lock:
            rows = self._db.execute(
                "SELECT rk, CASE WHEN grp='' AND state='pending' "
                "THEN 'parked' ELSE state END AS st, grp, COUNT(*) "
                "FROM messages GROUP BY rk, st, grp").fetchall()
        out: dict[str, dict[str, int]] = {}
        for rk, state, _grp, n in rows:
            states = out.setdefault(rk, {})
            if state == "pending":
                states[state] = max(states.get(state, 0), n)
            else:
                states[state] = states.get(state, 0) + n
        return out

    def dead_letters(self, rk: str | None = None
                     ) -> list[tuple[int, str, str, int, str]]:
        q = ("SELECT id, rk, envelope, attempts, "
             "COALESCE(reason, '') FROM messages WHERE state='dead'")
        args: tuple = ()
        if rk:
            q += " AND rk=?"
            args = (rk,)
        with self._lock:
            return self._db.execute(q + " ORDER BY id", args).fetchall()

    def requeue_dead(self, rk: str | None = None) -> int:
        q = "UPDATE messages SET state='pending', attempts=0, " \
            "reason=NULL WHERE state='dead'"
        args: tuple = ()
        if rk:
            q += " AND rk=?"
            args = (rk,)
        with self._lock, self._db:
            return self._db.execute(q, args).rowcount

    def purge_dead(self, rk: str | None = None) -> int:
        q = "DELETE FROM messages WHERE state='dead'"
        args: tuple = ()
        if rk:
            q += " AND rk=?"
            args = (rk,)
        with self._lock, self._db:
            return self._db.execute(q, args).rowcount

    def close(self) -> None:
        with self._lock:
            self._db.close()


class Broker:
    """The broker process: ROUTER socket + durable queue store."""

    def __init__(self, port: int = DEFAULT_PORT, db_path: str = ":memory:",
                 host: str = "127.0.0.1", max_redeliveries: int = 3,
                 lease_s: float = DEFAULT_LEASE_S,
                 expire_interval_s: float = 1.0):
        if not HAS_ZMQ:
            raise PublishError("pyzmq is not available")
        self.host = host
        self.port = port
        self.store = _QueueStore(db_path)
        self.max_redeliveries = max_redeliveries
        self.lease_s = lease_s
        # Lease-expiry sweep cadence: the sweep used to run on EVERY
        # fetch, fine with one consumer per stage but a broker-loop
        # saturator under worker pools (N workers × 20 idle polls/s
        # each = hundreds of full-table parked-row scans per second on
        # the single request thread — counts()/depth() clients then
        # time out). Expiry only needs lease granularity (30 s), so
        # once a second is already 30× finer than required.
        self.expire_interval_s = expire_interval_s
        self._last_expire = 0.0   # only touched on the run() thread
        self._ctx = zmq.Context.instance()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._bound = threading.Event()

    # ---- request handling -------------------------------------------

    def _handle(self, req: dict) -> dict:
        op = req.get("op")
        if op == "pub":
            mid, depth = self.store.enqueue(req["rk"],
                                            json.dumps(req["envelope"]))
            # publisher confirm + the key's pending depth, so every
            # producer gets backpressure feedback with its confirm
            return {"ok": True, "id": mid, "depth": depth}
        if op == "pub_batch":
            depths = self.store.enqueue_many(
                [(it["rk"], json.dumps(it["envelope"]))
                 for it in req.get("items", [])])
            return {"ok": True, "n": len(req.get("items", [])),
                    "depths": depths}
        if op == "depth":
            return {"ok": True, "depth": self.store.depth(req["rk"])}
        if op == "bind":
            self.store.bind(list(req.get("rks", [])),
                            req.get("group", DEFAULT_GROUP))
            return {"ok": True}
        if op == "fetch":
            # sweep cadence tracks the lease: a test broker with a
            # 50 ms lease sweeps (nearly) every fetch, the production
            # 30 s lease sweeps at most once a second
            now = time.time()
            if now - self._last_expire >= min(self.expire_interval_s,
                                              self.lease_s / 2):
                self._last_expire = now
                self.store.expire_leases()
            rows = self.store.fetch(req["rks"],
                                    req.get("group", DEFAULT_GROUP),
                                    int(req.get("max", 16)), self.lease_s)
            return {"ok": True, "msgs": [
                {"id": i, "rk": rk, "envelope": json.loads(env),
                 "attempts": at} for i, rk, env, at in rows]}
        if op == "ack":
            self.store.ack(list(req.get("ids", [])))
            return {"ok": True}
        if op == "nack":
            self.store.nack(list(req.get("ids", [])), self.max_redeliveries,
                            poison=bool(req.get("poison")),
                            reason=req.get("reason"))
            return {"ok": True}
        if op == "counts":
            return {"ok": True, "counts": self.store.counts()}
        if op == "dead":
            return {"ok": True, "msgs": [
                {"id": i, "rk": rk, "envelope": json.loads(env),
                 "attempts": at, "reason": reason}
                for i, rk, env, at, reason in self.store.dead_letters(
                    req.get("rk"))]}
        if op == "requeue_dead":
            return {"ok": True, "n": self.store.requeue_dead(req.get("rk"))}
        if op == "purge_dead":
            return {"ok": True, "n": self.store.purge_dead(req.get("rk"))}
        if op == "ping":
            return {"ok": True}
        return {"ok": False, "error": f"unknown op {op!r}"}

    # ---- run loop ----------------------------------------------------

    def run(self) -> None:
        sock = self._ctx.socket(zmq.ROUTER)
        sock.setsockopt(zmq.LINGER, 0)
        if self.port == 0:
            self.port = sock.bind_to_random_port(f"tcp://{self.host}")
        else:
            # A broker restarting right after a crash can race the old
            # socket's TIME_WAIT; retry instead of dying on EADDRINUSE.
            # Deadline stays under start()'s _bound.wait(5) so a failed
            # bind surfaces there rather than binding after the caller
            # already gave up. Non-transient errnos re-raise immediately.
            deadline = time.time() + 4
            while True:
                try:
                    sock.bind(f"tcp://{self.host}:{self.port}")
                    break
                except zmq.ZMQError as exc:
                    if exc.errno != zmq.EADDRINUSE or time.time() > deadline:
                        raise
                    # stop-aware backoff: a broker stopped while waiting
                    # out TIME_WAIT must exit, not finish the bind retry
                    if self._stop.wait(0.2):
                        sock.close()
                        return
        self._bound.set()
        poller = zmq.Poller()
        poller.register(sock, zmq.POLLIN)
        try:
            while not self._stop.is_set():
                if not dict(poller.poll(timeout=100)):
                    continue
                frames = sock.recv_multipart()
                identity, payload = frames[0], frames[-1]
                try:
                    reply = self._handle(json.loads(payload))
                except Exception as exc:   # malformed request
                    reply = {"ok": False, "error": str(exc)}
                sock.send_multipart(
                    [identity, b"", json.dumps(reply).encode()])
        finally:
            sock.close()

    def start(self) -> "Broker":
        self._thread = threading.Thread(target=self.run, name="bus-broker",
                                        daemon=True)
        self._thread.start()
        if not self._bound.wait(timeout=5):
            raise PublishError("broker failed to bind")
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.store.close()

    @property
    def address(self) -> str:
        return f"tcp://{self.host}:{self.port}"


class _Client:
    """One DEALER connection doing strict request/reply with timeouts."""

    def __init__(self, address: str, timeout_ms: int = 5000,
                 retries: int = 3):
        if not HAS_ZMQ:
            raise PublishError("pyzmq is not available")
        self.address = address
        self.timeout_ms = timeout_ms
        self.retries = retries
        self._ctx = zmq.Context.instance()
        self._sock = None
        self._lock = threading.Lock()

    def _connect(self):
        if self._sock is not None:
            self._sock.close(linger=0)
        self._sock = self._ctx.socket(zmq.DEALER)
        self._sock.setsockopt(zmq.LINGER, 0)
        self._sock.connect(self.address)

    def request(self, req: dict) -> dict:
        """Send one request, await the reply. Times out → reconnect and
        retry (at-least-once: a retried 'pub' may duplicate; consumers
        are idempotent by pipeline contract)."""
        with self._lock:
            if self._sock is None:
                self._connect()
            payload = json.dumps(req).encode()
            last = "no attempt made"
            for attempt in range(1, max(1, self.retries) + 1):
                self._sock.send_multipart([b"", payload])
                poller = zmq.Poller()
                poller.register(self._sock, zmq.POLLIN)
                if dict(poller.poll(timeout=self.timeout_ms)):
                    frames = self._sock.recv_multipart()
                    reply = json.loads(frames[-1])
                    if not reply.get("ok"):
                        raise PublishError(reply.get("error", "broker nak"))
                    return reply
                last = (f"timeout after {self.timeout_ms}ms on attempt "
                        f"{attempt}/{self.retries}")
                self._connect()      # stale socket: drop + reconnect
            raise PublishError(f"broker unreachable at {self.address} "
                               f"({last})")

    def close(self):
        with self._lock:
            if self._sock is not None:
                self._sock.close(linger=0)
                self._sock = None


class _Outbox:
    """Bounded durable publish outbox: envelopes the broker could not
    confirm park here (sqlite WAL, same file discipline as
    ``_QueueStore``; ``:memory:`` for embedded publishers — set
    ``outbox_path`` when parked work must survive a publisher-process
    restart too). Strictly FIFO: rows leave only after the broker
    confirmed them, so replay order == publish order."""

    def __init__(self, path: str = ":memory:", cap: int = 10000):
        self.cap = cap
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.execute("PRAGMA synchronous=NORMAL")
        self._lock = threading.Lock()
        with self._lock, self._db:
            self._db.execute("""
                CREATE TABLE IF NOT EXISTS outbox (
                    id INTEGER PRIMARY KEY AUTOINCREMENT,
                    rk TEXT NOT NULL,
                    envelope TEXT NOT NULL,
                    parked_at REAL NOT NULL
                )""")
            # cached row count (seeded from durable files): depth() is
            # on the publish hot path, where it almost always answers
            # "empty" — that must not cost a sqlite query per publish
            self._n = int(self._db.execute(
                "SELECT COUNT(*) FROM outbox").fetchone()[0])

    def depth(self) -> int:
        with self._lock:
            return self._n

    def append(self, rk: str, envelope_json: str) -> int:
        with self._lock, self._db:
            cur = self._db.execute(
                "INSERT INTO outbox (rk, envelope, parked_at) "
                "VALUES (?, ?, ?)", (rk, envelope_json, time.time()))
            self._n += 1
            return cur.lastrowid

    def oldest(self, limit: int) -> list[tuple[int, str, str]]:
        with self._lock:
            return self._db.execute(
                "SELECT id, rk, envelope FROM outbox ORDER BY id "
                "LIMIT ?", (limit,)).fetchall()

    def remove(self, ids: list[int]) -> None:
        if not ids:
            return
        with self._lock, self._db:
            cur = self._db.execute(
                f"DELETE FROM outbox WHERE id IN "
                f"({','.join('?' for _ in ids)})", ids)
            self._n -= cur.rowcount

    def close(self) -> None:
        with self._lock:
            self._db.close()


class BrokerPublisher(EventPublisher):
    """Publishes with broker confirms (the role of RabbitMQ publisher
    confirms, ``rabbitmq_publisher.py:146-149``) — and, new in the
    pipeline fault plane round, SURVIVES the broker being away:

    * **Outage ride-through.** A publish the broker cannot confirm
      parks in a bounded durable outbox instead of raising into the
      handler (where it used to become nack → redelivery → dead
      letter); a stop-aware backoff thread replays parked envelopes in
      publish order once the broker is back, so a broker restart costs
      latency, not work. Outbox overflow raises the structured
      :class:`BusSaturated` (``reason="outbox-full"``) — honest
      backpressure, never a silent drop.
    * **Depth-watermark backpressure.** Every confirm carries the
      routing key's broker-side pending depth. With
      ``high_watermark`` configured, a publish that lands at/above it
      blocks (stop-aware, bounded by ``saturation_max_wait_s``) until
      the key drains below ``low_watermark`` — pacing the producer at
      the source — and ``saturation()`` exposes the hot keys so
      services can throttle their own consumption too.
    * **Fault plane.** ``faults`` (a ``bus/faults.py`` boundary or
      plan) fires the ``publish`` boundary: injected faults take the
      exact outage path above, which is how the chaos harness proves
      the ride-through deterministically.

    Config keys: ``timeout_ms``, ``retries``, ``outbox_path``,
    ``outbox_cap``, ``high_watermark`` (0 = off), ``low_watermark``
    (default half of high), ``saturation_poll_s``,
    ``saturation_max_wait_s``."""

    def __init__(self, config: Any = None, client=None, faults=None):
        from copilot_for_consensus_tpu_torch.bus.faults import resolve_boundary

        cfg = dict(config or {})
        self._address = cfg.get("address") or (
            f"tcp://{cfg.get('host', '127.0.0.1')}:"
            f"{cfg.get('port', DEFAULT_PORT)}")
        self._client = client if client is not None else _Client(
            self._address, timeout_ms=int(cfg.get("timeout_ms", 5000)),
            retries=int(cfg.get("retries", 3)))
        self._depth_client = None  # lazy single-try client (pacing polls)
        self.high_watermark = int(cfg.get("high_watermark", 0) or 0)
        self.low_watermark = int(
            cfg.get("low_watermark", max(1, self.high_watermark // 2)))
        self.saturation_poll_s = float(cfg.get("saturation_poll_s", 0.05))
        # Pace bound: must stay WELL below the broker lease
        # (DEFAULT_LEASE_S, 30s) — a pace can run inside a consumer
        # handler that is itself holding a lease, and blocking past it
        # turns backpressure into lease-expiry redeliveries (duplicate
        # work) exactly when the bus is already saturated.
        self.saturation_max_wait_s = float(
            cfg.get("saturation_max_wait_s", 10.0))
        # How stale a last-confirm depth snapshot may be before
        # saturation() re-polls the broker for that key: without a
        # refresh, a key hot at its last publish would read saturated
        # forever once the producer goes quiet, throttling every
        # service until process restart.
        self.saturation_refresh_s = float(
            cfg.get("saturation_refresh_s", 1.0))
        self.outbox = _Outbox(cfg.get("outbox_path", ":memory:"),
                              cap=int(cfg.get("outbox_cap", 10000)))
        self.faults = resolve_boundary(faults)
        #: rk -> (last known pending depth, monotonic stamp)
        self._depths: dict[str, tuple[int, float]] = {}
        # publish-window buffer (grouped publishes): THREAD-local —
        # a service's worker pool shares one publisher, and each
        # worker's wave must flush only its own buffered follow-ups
        self._window = threading.local()
        self._stop = threading.Event()
        self._replay_lock = threading.Lock()
        self._replayer: threading.Thread | None = None
        self._stats_lock = threading.Lock()
        self._stats = {"confirmed": 0, "parked": 0, "replayed": 0,
                       "overflow": 0, "throttle_waits": 0}

    def _bump(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self._stats[key] += n

    # ---- publish path ------------------------------------------------

    def publish_envelope(self, envelope, routing_key=None):
        if routing_key is None:
            from copilot_for_consensus_tpu_torch.core.events import EVENT_TYPES

            cls = EVENT_TYPES.get(envelope.get("event_type", ""))
            routing_key = cls.routing_key if cls else "unrouted"
        from copilot_for_consensus_tpu_torch.obs import trace

        # Trace-context propagation (obs/trace.py): stamp once at first
        # publish; an envelope that already carries a trace_id (outbox
        # replay, DLQ/startup requeue) keeps it, so at-least-once
        # delivery never orphans a trace.
        env = dict(trace.inject(envelope, routing_key))
        buf = getattr(self._window, "buf", None)
        if buf is not None:
            # Inside a publish window (batched wave dispatch): buffer —
            # the publish span is already recorded with the correct
            # per-envelope parent above; the broker sees the whole
            # window as ONE pub_batch request at flush.
            buf.append((routing_key, env))
            return
        outage: BaseException | None = None
        if self.faults is not None:
            try:
                self.faults.check("publish")
            except Exception as exc:  # injected fault == broker outage
                outage = exc
        # Ordering: while anything is parked, new publishes park BEHIND
        # it — rows leave the outbox only after their confirm, so the
        # per-publisher order survives the outage.
        if outage is None and self.outbox.depth() == 0:
            try:
                reply = self._client.request(
                    {"op": "pub", "rk": routing_key, "envelope": env})
            except PublishError as exc:
                outage = exc
            else:
                self._bump("confirmed")
                self._pace(routing_key, int(reply.get("depth", 0)))
                return
        self._park(routing_key, env, outage)

    @contextlib.contextmanager
    def publish_window(self):
        """Grouped publishes for one batched dispatch: every
        ``publish`` inside the window buffers (spans and trace stamps
        recorded immediately, with their real per-envelope parents)
        and the window exit sends ONE ``pub_batch`` broker request —
        one round-trip and one broker-side transaction for the wave's
        whole follow-up fan-out. Reentrant-safe per thread (an inner
        window joins the outer one); the outage path parks the whole
        buffer in the outbox in order, so ride-through semantics are
        identical to per-publish. Raises :class:`BusSaturated` only
        when the outbox overflows — the caller (wave dispatch) nacks
        the wave and redelivery regenerates the publishes."""
        outer = getattr(self._window, "buf", None)
        if outer is not None:
            yield          # nested: the outer window owns the flush
            return
        buf: list[tuple[str, dict]] = []
        self._window.buf = buf
        try:
            yield
        finally:
            # flush even when the body raised: envelopes whose
            # finishers already succeeded are about to be acked — their
            # follow-ups must reach the broker (or the outbox)
            self._window.buf = None
            self._flush_window(buf)

    def _flush_window(self, buf: list[tuple[str, dict]]) -> None:
        if not buf:
            return
        outage: BaseException | None = None
        if self.faults is not None:
            try:
                # one boundary fire per flush: the wave pays one
                # publish round-trip, so it offers one fault window
                self.faults.check("publish")
            except Exception as exc:
                outage = exc
        # Sub-batch cap: an UNBOUNDED pub_batch would land a whole
        # wave's fan-out past the watermark before pacing could see it
        # (the overload arm measured depth = wave size, not watermark).
        # Capping each broker request at HALF the watermark restores
        # pacing granularity — worst transient = existing backlog (hw,
        # where pacing engages) + one sub-batch (hw/2) = 1.5×hw,
        # strictly inside the 2×hw depth SLO the watermark is sized
        # against — while an unwatermarked publisher still gets
        # bounded transactions.
        cap = max(1, self.high_watermark // 2) \
            if self.high_watermark > 0 else 128
        start = 0
        while outage is None and start < len(buf):
            if self.outbox.depth() > 0:
                break                   # park behind the backlog
            chunk = buf[start:start + cap]
            try:
                reply = self._client.request({
                    "op": "pub_batch",
                    "items": [{"rk": rk, "envelope": env}
                              for rk, env in chunk]})
            except PublishError as exc:
                outage = exc
                break
            start += len(chunk)
            self._bump("confirmed", len(chunk))
            depths = {rk: int(d) for rk, d in
                      (reply.get("depths") or {}).items()}
            for rk, d in depths.items():
                self._note_depth(rk, d)
            for rk, d in depths.items():
                if self.high_watermark and d >= self.high_watermark:
                    # one pace against the hottest key is enough:
                    # _pace re-polls until IT drains, which bounds
                    # the producer exactly like per-publish pacing
                    self._pace(rk, d)
                    break
        # Broker away (or injected fault): park the window's REMAINDER
        # in publish order — the replay thread preserves FIFO, so the
        # ride-through contract is unchanged under grouping. If the
        # outbox hits its cap mid-park, the un-parked tail cannot go
        # anywhere: count every dropped envelope as overflow (visible
        # in outbox_stats) and raise the structured BusSaturated — the
        # wave dispatch nacks its envelopes on this raise, and
        # redelivery regenerates ALL the wave's publishes (the parked
        # portion's replay duplicates are absorbed by idempotent ids).
        remainder = buf[start:]
        for k, (rk, env) in enumerate(remainder):
            try:
                self._park(rk, env, outage)
            except BusSaturated:
                dropped = len(remainder) - k
                if dropped > 1:        # _park counted the first one
                    self._bump("overflow", dropped - 1)
                raise

    def _park(self, routing_key: str, env: dict,
              cause: BaseException | None) -> None:
        with self._replay_lock:
            depth = self.outbox.depth()
            if depth >= self.outbox.cap:
                self._bump("overflow")
                raise BusSaturated(
                    f"publish outbox full ({depth} envelopes parked, "
                    f"cap {self.outbox.cap}) while the broker is "
                    f"unreachable" + (f": {cause}" if cause else ""),
                    routing_key=routing_key, depth=depth,
                    limit=self.outbox.cap, reason="outbox-full")
            self.outbox.append(routing_key, json.dumps(env))
            self._bump("parked")
            self._ensure_replayer()

    def _ensure_replayer(self) -> None:
        # caller holds _replay_lock
        if self._replayer is not None and self._replayer.is_alive():
            return
        self._replayer = threading.Thread(
            target=self._replay_loop, name="bus-publish-replay",
            daemon=True)
        self._replayer.start()

    def _replay_loop(self) -> None:
        """Drain the outbox oldest-first once the broker confirms again.
        Stop-aware exponential backoff between failed rounds (never a
        bare sleep — the jaxlint ``blocking-call`` contract); exits
        when the outbox is empty (re-spawned by the next park)."""
        backoff = 0.1
        while not self._stop.is_set():
            try:
                batch = self.outbox.oldest(16)
                if not batch:
                    with self._replay_lock:
                        if self.outbox.depth() == 0:
                            self._replayer = None
                            return
                    continue
                sent: list[int] = []
                try:
                    for oid, rk, env_json in batch:
                        if self.faults is not None:
                            self.faults.check("publish")
                        reply = self._client.request(
                            {"op": "pub", "rk": rk,
                             "envelope": json.loads(env_json)})
                        sent.append(oid)
                        self._note_depth(rk, int(reply.get("depth", 0)))
                except Exception:  # broker still away (or injected fault)
                    pass
                finally:
                    if sent:
                        self.outbox.remove(sent)
                        self._bump("replayed", len(sent))
            except Exception:
                # close() raced us past its join timeout and shut the
                # outbox db (sqlite ProgrammingError) — or some other
                # infra failure. Durable rows confirmed but not removed
                # replay again next start: at-least-once, absorbed by
                # the idempotent-ids contract.
                if self._stop.is_set():
                    return
                if self._stop.wait(backoff):
                    return
                backoff = min(backoff * 2, 2.0)
                continue
            if sent:
                backoff = 0.1           # broker is back: full speed
            elif self._stop.wait(backoff):
                return
            else:
                backoff = min(backoff * 2, 2.0)

    # ---- backpressure ------------------------------------------------

    def _note_depth(self, rk: str, depth: int) -> None:
        self._depths[rk] = (int(depth), time.monotonic())

    def _poll_depth(self, rk: str) -> int | None:
        """One best-effort broker depth query (single try, short
        timeout); None when the broker is unreachable."""
        if self._depth_client is None:
            self._depth_client = _Client(self._address,
                                         timeout_ms=1500, retries=1)
        try:
            depth = int(self._depth_client.request(
                {"op": "depth", "rk": rk})["depth"])
        except PublishError:
            return None
        self._note_depth(rk, depth)
        return depth

    def _pace(self, rk: str, depth: int) -> None:
        self._note_depth(rk, depth)
        if not self.high_watermark or depth < self.high_watermark:
            return
        # Saturated: hold THIS producer (stop-aware, bounded) until the
        # key drains below the low watermark — backpressure lands where
        # the flood originates instead of 4x past the SLO downstream.
        self._bump("throttle_waits")
        deadline = time.monotonic() + self.saturation_max_wait_s
        while time.monotonic() < deadline:
            if self._stop.wait(self.saturation_poll_s):
                break
            cur = self._poll_depth(rk)
            if cur is None:
                break       # outage mid-pace: the outbox takes over
            if cur < self.low_watermark:
                break

    def saturation(self) -> dict[str, int]:
        if not self.high_watermark:
            return {}
        hot: dict[str, int] = {}
        now = time.monotonic()
        for rk, (depth, at) in list(self._depths.items()):
            if depth < self.high_watermark:
                continue
            if now - at >= self.saturation_refresh_s:
                # Stale snapshot: the key was hot at its last confirm
                # but the producer has gone quiet since — re-poll so a
                # drained queue stops throttling consumers. Broker
                # unreachable reads as not-hot: the outbox ride-through
                # governs outages, not the consumption throttle.
                refreshed = self._poll_depth(rk)
                if refreshed is None:
                    continue
                depth = refreshed
            if depth >= self.high_watermark:
                hot[rk] = depth
        return hot

    def pending_depths(self) -> dict[str, int]:
        if self._depth_client is None:
            self._depth_client = _Client(self._address,
                                         timeout_ms=1500, retries=1)
        try:
            counts = self._depth_client.request({"op": "counts"})["counts"]
        except PublishError:
            return {}
        return {rk: states.get("pending", 0)
                for rk, states in counts.items()}

    def outbox_stats(self) -> dict[str, int]:
        with self._stats_lock:
            out = dict(self._stats)
        out["outbox_depth"] = self.outbox.depth()
        return out

    def close(self):
        self._stop.set()
        with self._replay_lock:
            replayer = self._replayer
        if replayer is not None:
            # A replayer mid-request against an unreachable broker can
            # block for the client's full retry budget before it sees
            # the stop flag — wait at least that long so the outbox db
            # closes after the thread is really done (the loop also
            # survives a lost race, exiting on the first closed-db
            # error once stop is set).
            budget = max(5.0,
                         getattr(self._client, "timeout_ms", 5000)
                         / 1000.0
                         * max(1, getattr(self._client, "retries", 3))
                         + 1.0)
            replayer.join(timeout=budget)
        self._client.close()
        if self._depth_client is not None:
            self._depth_client.close()
        self.outbox.close()


class BrokerSubscriber(EventSubscriber):
    """Pull-based consumer: fetch → dispatch → ack/nack per message.
    ``group`` names this consumer's queue group: subscribers sharing a
    group compete (replicas), distinct groups each see every message
    (distinct services) — same contract as ``InProcSubscriber``.

    Failure classification (the poison-quarantine contract,
    docs/RESILIENCE.md): a handler raising ``RetryableError`` (or any
    bus-level ``PublishError``) nacks onto the normal lease/redelivery
    path; ``PoisonEnvelope`` or any other exception — a deterministic
    failure redelivery cannot fix — quarantines straight to the
    dead-letter table with a structured reason, skipping the
    redelivery budget. Every failure is logged with routing key +
    event id and counted in ``copilot_bus_dispatch_failures_total``."""

    def __init__(self, config: Any = None, group: str | None = None,
                 client=None, faults=None):
        from copilot_for_consensus_tpu_torch.bus.faults import resolve_boundary
        from copilot_for_consensus_tpu_torch.obs.logging import get_logger
        from copilot_for_consensus_tpu_torch.obs.metrics import NoopMetrics

        cfg = dict(config or {})
        address = cfg.get("address") or (
            f"tcp://{cfg.get('host', '127.0.0.1')}:"
            f"{cfg.get('port', DEFAULT_PORT)}")
        self._address = address
        self._timeout_ms = int(cfg.get("timeout_ms", 5000))
        self._retries = int(cfg.get("retries", 3))
        self._client = client if client is not None else _Client(
            address, timeout_ms=self._timeout_ms, retries=self._retries)
        self.poll_interval_s = float(cfg.get("poll_interval_s", 0.05))
        # Prefetch: how many envelopes one fetch leases (the broker-side
        # `max`). `prefetch` is the config-surface name (`bus.prefetch`,
        # plumbed per service by the runner so pool sizing and prefetch
        # tune together); `batch` kept as the legacy alias.
        self.batch = int(cfg.get("prefetch", cfg.get("batch", 16)))
        self.group = group or cfg.get("group") or DEFAULT_GROUP
        self.faults = resolve_boundary(faults)
        #: shared with the owning pipeline's collector by the runner
        self.metrics = NoopMetrics()
        self.logger = get_logger()
        self._routes: dict[str, EventCallback] = {}
        self._batch_routes: dict[str, Any] = {}
        self._counts_client: _Client | None = None
        self._stop = threading.Event()
        #: (rk, what, started_at) of the in-progress handler dispatch
        #: — what StageWorkerPool.stop() names when this consumer's
        #: worker thread fails to join. Written only by the consume
        #: thread; other threads take a stale-tolerant snapshot read
        #: (GIL-atomic tuple swap, the azure_monitor counter pattern).
        self._current: tuple | None = None

    def subscribe(self, routing_keys, callback):
        for rk in routing_keys:
            self._routes[rk] = callback
        self._client.request({"op": "bind", "rks": list(routing_keys),
                              "group": self.group})

    def subscribe_batch(self, routing_keys, callback) -> bool:
        """Register a wave callback (``bus/base.py:BatchEventCallback``)
        for keys already subscribed via :meth:`subscribe`: a fetch wave
        of same-key envelopes dispatches as ONE callback call with
        grouped ack/nack round-trips; keys without a batch route (and
        wave-level callback failures) keep exact per-envelope
        semantics."""
        for rk in routing_keys:
            self._batch_routes[rk] = callback
        return True

    def counts(self, timeout_ms: int | None = None
               ) -> dict[str, dict[str, int]]:
        """Broker-side per-key state counts (pending/inflight/dead) — the
        ops introspection surface for gauges and the failed-queues CLI.
        ``timeout_ms`` uses a dedicated single-try client so metric
        scrapes fail fast during a broker outage instead of tying up the
        HTTP worker for the full retry budget."""
        if timeout_ms is None:
            return self._client.request({"op": "counts"})["counts"]
        if self._counts_client is None:
            self._counts_client = _Client(self._address,
                                          timeout_ms=timeout_ms, retries=1)
        return self._counts_client.request({"op": "counts"})["counts"]

    def _classify_failure(self, msg: dict, exc: BaseException) -> dict:
        """Map a handler exception to the broker verdict, logging and
        counting it (``bus/broker.py:476`` used to swallow these into a
        bare ``ok = False`` — a redelivery storm with no diagnosis)."""
        from copilot_for_consensus_tpu_torch.core.retry import RetryableError

        envelope = msg.get("envelope") or {}
        transient = isinstance(exc, (RetryableError, PublishError)) \
            and not isinstance(exc, PoisonEnvelope)
        kind = "transient" if transient else "poison"
        # correlation_id + trace_id ride the failure log line (and the
        # dead-letter row keeps the whole envelope), so an operator can
        # pull the trace for a quarantined envelope straight from the
        # copilot_bus_dispatch_failures_total diagnosis.
        data = envelope.get("data") or {}
        tctx = envelope.get("trace") or {}
        self.logger.error(
            "bus dispatch failed",
            routing_key=msg["rk"], group=self.group, kind=kind,
            event_id=envelope.get("event_id", ""),
            event_type=envelope.get("event_type", ""),
            correlation_id=data.get("correlation_id", ""),
            trace_id=tctx.get("trace_id", ""),
            attempts=msg.get("attempts", 0),
            error=str(exc), error_type=type(exc).__name__)
        self.metrics.increment("bus_dispatch_failures_total",
                               labels={"queue": msg["rk"], "kind": kind})
        if transient:
            return {"op": "nack", "ids": [msg["id"]]}
        reason = (exc.reason if isinstance(exc, PoisonEnvelope)
                  else f"{type(exc).__name__}: {exc}")
        self.metrics.increment("bus_poison_total",
                               labels={"queue": msg["rk"]})
        return {"op": "nack", "ids": [msg["id"]], "poison": True,
                "reason": reason[:500]}

    def current_dispatch(self) -> str | None:
        """Human-readable description of the in-progress handler
        dispatch (None when idle) — the stuck-worker diagnostic
        ``StageWorkerPool.stop()`` logs on a join timeout."""
        cur = self._current
        if cur is None:
            return None
        rk, what, t0 = cur
        return f"{rk} {what} ({time.monotonic() - t0:.1f}s)"

    def _dispatch(self, msg: dict) -> None:
        from copilot_for_consensus_tpu_torch.obs import trace

        cb = self._routes.get(msg["rk"])
        verdict = {"op": "ack", "ids": [msg["id"]]}
        if cb is not None:
            # broker-side redelivery count → trace attempt annotation,
            # so a retried delivery's stage span says so
            trace.annotate_delivery(msg["envelope"],
                                    int(msg.get("attempts", 0)))
            self._current = (msg["rk"], f"id={msg['id']}",
                             time.monotonic())
            try:
                cb(msg["envelope"])
            except Exception as exc:
                verdict = self._classify_failure(msg, exc)
            finally:
                self._current = None
        if self.faults is not None:
            try:
                self.faults.check("ack")
            except Exception:
                # Injected ack fault == consumer died before acking:
                # the lease expires and the message redelivers — the
                # at-least-once path the idempotent handlers absorb.
                return
        try:
            self._client.request(verdict)
        except PublishError:
            # Broker unreachable: the lease will expire and the message
            # redelivers — at-least-once holds without us crashing.
            pass

    def _settle(self, acks: list[int],
                nacks: list[tuple[dict, BaseException]]) -> None:
        """Grouped verdict round-trips for a dispatched wave: ONE ack
        request for every success (the broker ack op takes an id list),
        one nack per distinct classification. The injected ``ack``
        fault covers the whole wave — a consumer crash before settling
        loses every verdict at once, exactly like the real failure."""
        if self.faults is not None:
            try:
                self.faults.check("ack")
            except Exception:
                # consumer died before acking: leases expire, the wave
                # redelivers — at-least-once, absorbed by idempotency
                return
        verdicts: list[dict] = []
        if acks:
            verdicts.append({"op": "ack", "ids": acks})
        transient: list[int] = []
        for m, exc in nacks:
            v = self._classify_failure(m, exc)
            if v.get("poison"):
                verdicts.append(v)
            else:
                transient.extend(v["ids"])
        if transient:
            verdicts.append({"op": "nack", "ids": transient})
        for v in verdicts:
            try:
                self._client.request(v)
            except PublishError:
                # Broker unreachable: leases expire and redeliver.
                pass

    def _dispatch_batch(self, rk: str, msgs: list[dict]) -> None:
        """One wave, one callback call, grouped settle. A wave-level
        callback raise falls back to per-envelope dispatch so a single
        bad message degrades to the exact single-dispatch path instead
        of failing its neighbours (handlers are idempotent by pipeline
        contract, so the partial re-execution is absorbed)."""
        from copilot_for_consensus_tpu_torch.obs import trace

        cb = self._batch_routes[rk]
        for m in msgs:
            trace.annotate_delivery(m["envelope"],
                                    int(m.get("attempts", 0)))
        self._current = (rk, f"wave x{len(msgs)}", time.monotonic())
        try:
            outcomes = cb([m["envelope"] for m in msgs])
            if outcomes is None:
                outcomes = [None] * len(msgs)
        except Exception:
            for m in msgs:
                self._dispatch(m)
            return
        finally:
            self._current = None
        acks = [m["id"] for m, out in zip(msgs, outcomes) if out is None]
        nacks = [(m, out) for m, out in zip(msgs, outcomes)
                 if out is not None]
        self._settle(acks, nacks)

    def drain(self, max_messages: int | None = None) -> int:
        """Process what's queued now; returns the number handled.
        Fetched waves group into consecutive same-key runs: keys with a
        registered batch route dispatch as one wave, the rest one by
        one."""
        n = 0
        while max_messages is None or n < max_messages:
            if self.faults is not None:
                try:
                    self.faults.check("fetch")
                except Exception as exc:
                    # surfaces exactly like a broker outage so
                    # start_consuming backs off and reconnects
                    raise PublishError(
                        f"injected fetch fault: {exc}") from exc
            want = self.batch if max_messages is None else min(
                self.batch, max_messages - n)
            reply = self._client.request(
                {"op": "fetch", "rks": sorted(self._routes),
                 "group": self.group, "max": want})
            msgs = reply.get("msgs", [])
            if not msgs:
                break
            i = 0
            while i < len(msgs):
                rk = msgs[i]["rk"]
                j = i + 1
                if rk in self._batch_routes:
                    while j < len(msgs) and msgs[j]["rk"] == rk:
                        j += 1
                    self._dispatch_batch(rk, msgs[i:j])
                else:
                    self._dispatch(msgs[i])
                n += j - i
                i = j
        return n

    def start_consuming(self):
        """Consume until stop(); survives broker outages by backing off and
        reconnecting (the reference subscriber's reconnect loop,
        ``rabbitmq_subscriber.py``)."""
        self._stop.clear()
        backoff = self.poll_interval_s
        while not self._stop.is_set():
            try:
                n = self.drain()
            except PublishError:
                self._stop.wait(min(backoff, 5.0))
                backoff = min(backoff * 2, 5.0)
                continue
            backoff = self.poll_interval_s
            if n == 0:
                self._stop.wait(self.poll_interval_s)

    def stop(self):
        self._stop.set()

    def close(self):
        self.stop()
        self._client.close()
        if self._counts_client is not None:
            self._counts_client.close()


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="copilot bus broker")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=DEFAULT_PORT)
    ap.add_argument("--db", default=":memory:",
                    help="sqlite path for durable queues")
    ap.add_argument("--max-redeliveries", type=int, default=3)
    ap.add_argument("--lease-s", type=float, default=DEFAULT_LEASE_S)
    args = ap.parse_args(argv)
    broker = Broker(port=args.port, db_path=args.db, host=args.host,
                    max_redeliveries=args.max_redeliveries,
                    lease_s=args.lease_s)
    print(f"broker listening on {broker.address} (db={args.db})",
          flush=True)
    broker.run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
