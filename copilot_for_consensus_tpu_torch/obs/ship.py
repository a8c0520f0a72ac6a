"""Cross-process telemetry plane: crash-safe shipping + merged exposition.

Every telemetry surface before this module — the flight recorder
(engine/telemetry.py), the TraceCollector (obs/trace.py), the
``copilot_*`` metric registries — is process-local: a multichip bench
child communicates by printing one summary JSON line, so its
histograms, spans and post-mortems are invisible to the driver and
vanish entirely on SIGKILL. This module makes telemetry a durable,
mergeable artifact:

* :class:`TelemetrySpool` — a per-process sqlite WAL spool holding an
  append-only row log (``(seq, kind, payload)``; kinds: ``metrics`` /
  ``span`` / ``step``). Same file discipline as the PR-12 engine
  journal and the PR-8 outbox: WAL + ``synchronous=NORMAL``, every
  multi-row write inside one transaction, so committed rows survive a
  SIGKILL mid-storm and a reader can recover them from the dead
  process's file.
* :class:`TelemetryShipper` — snapshots an ``InMemoryMetrics``
  registry (shipping *deltas*, so repeated flushes don't double-count),
  a ``TraceCollector`` ring, and a ``FlightRecorder`` into the spool.
  An optional pump thread flushes on an interval; it is stop-aware
  (polls an Event, no bare sleep) and owner-joined, per the racecheck
  thread-lifecycle / blocking-call disciplines.
* :class:`TelemetryAggregator` — merges N spools (or live registries)
  into ONE exposition: counters sum, gauges last-write-wins (within a
  process; shipping preserves per-process order), histogram buckets
  merge element-wise, and every merged series gains the reserved
  ``proc``/``role`` labels (``obs.metrics.RESERVED_LABELS`` — a
  registry declaring them fails at registration). Spans merge by
  ``trace_id`` with ``proc`` stamped on, so ``tools/tracepath.py``
  reconstructs DAGs whose stages ran in different OS processes.
  Ingestion dedups by ``(proc, seq)``: shipping is at-least-once into
  the aggregator, re-ingesting a spool applies only rows it has not
  seen (docs/RESILIENCE.md "spool commit ≠ delivery").

The merged registry re-exports through the existing
``InMemoryMetrics.render_prometheus`` text format — one scrape for an
N-process topology, same exact-format contract the observability pack
tests pin.
"""

from __future__ import annotations

import json
import os
import pathlib
import sqlite3
import threading
import time
import weakref
from typing import Any, Iterable

from copilot_for_consensus_tpu_torch.obs.metrics import (
    RESERVED_LABELS,
    InMemoryMetrics,
    check_registry_labels,
)

#: spool filename suffix — the aggregator's directory scan and
#: tracepath's source sniffing key off it
SPOOL_SUFFIX = ".spool.sqlite3"

#: row kinds a spool may hold (doc + test anchor)
ROW_KINDS = ("metrics", "span", "step")

#: shipping-plane health series (full exposition names, the BUS_METRICS
#: style) — emitted into the registry being shipped, so ship health
#: rides the same spool it reports on and shows up per-proc in the
#: merged exposition.
SHIP_METRICS = {
    "copilot_ship_rows_total": (
        "counter", ("kind",),
        "spool rows committed by this process's shipper, by row kind "
        "(metrics | span | step)"),
    "copilot_ship_flush_seconds": (
        "histogram", (),
        "one shipper flush: snapshot + delta + single spool "
        "transaction (the <1% overhead budget's unit of work)"),
    "copilot_ship_spool_rows": (
        "gauge", (),
        "total committed rows in this process's spool (recovery "
        "readers compare against this for loss accounting)"),
}

# proc/role are stamped by the aggregator; the shipping plane's own
# registry obeys the same registration-time contract it introduces.
check_registry_labels(SHIP_METRICS, owner="SHIP_METRICS")


def _enc_labels(key: tuple) -> list:
    """Label key tuple → JSON-friendly ``[[k, v], ...]``."""
    return [[k, v] for k, v in key]


def _dec_labels(pairs: Iterable) -> dict:
    return {k: v for k, v in pairs}


# ---------------------------------------------------------------------------
# spool
# ---------------------------------------------------------------------------


class TelemetrySpool:
    """Crash-safe per-process telemetry spool (sqlite WAL).

    File discipline matches the engine journal (engine/journal.py):
    WAL + ``synchronous=NORMAL`` so committed transactions survive
    process SIGKILL; every multi-row append is ONE transaction; the
    handle is closed explicitly. ``seq`` is an AUTOINCREMENT primary
    key starting at 1 with no deletes, so a gap in a recovered spool
    means a committed row was lost — :func:`read_spool` reports that
    as ``lost`` and the chaos gate asserts it stays 0.
    """

    def __init__(self, path: str | os.PathLike, *, proc: str,
                 role: str = ""):
        self.path = str(path)
        self.proc = proc
        self.role = role
        pathlib.Path(self.path).parent.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()
        self._db = sqlite3.connect(self.path, check_same_thread=False)
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.execute("PRAGMA synchronous=NORMAL")
        with self._lock, self._db:
            self._db.execute(
                "CREATE TABLE IF NOT EXISTS meta ("
                " key TEXT PRIMARY KEY, value TEXT NOT NULL)")
            self._db.execute(
                "CREATE TABLE IF NOT EXISTS rows ("
                " seq INTEGER PRIMARY KEY AUTOINCREMENT,"
                " kind TEXT NOT NULL,"
                " payload TEXT NOT NULL)")
            self._db.execute(
                "INSERT OR REPLACE INTO meta VALUES ('proc', ?)", (proc,))
            self._db.execute(
                "INSERT OR REPLACE INTO meta VALUES ('role', ?)", (role,))
            self._db.execute(
                "INSERT OR REPLACE INTO meta VALUES ('pid', ?)",
                (str(os.getpid()),))
            self._db.execute(
                "INSERT OR REPLACE INTO meta VALUES ('started_wall', ?)",
                (repr(time.time()),))
        with self._lock:
            cur = self._db.execute("SELECT COUNT(*) FROM rows")
            self._n = int(cur.fetchone()[0])

    def append(self, rows: Iterable[tuple[str, dict]]) -> int:
        """Commit ``(kind, payload)`` rows in ONE transaction.

        All-or-nothing: after a SIGKILL either every row of a flush is
        recoverable or none is — no torn flushes. Returns the total
        committed row count.
        """
        batch = [(kind, json.dumps(payload, sort_keys=True))
                 for kind, payload in rows]
        with self._lock:
            if batch:
                with self._db:
                    for kind, payload in batch:
                        self._db.execute(
                            "INSERT INTO rows (kind, payload) "
                            "VALUES (?, ?)", (kind, payload))
                self._n += len(batch)
            return self._n

    def committed_rows(self) -> int:
        with self._lock:
            return self._n

    def close(self) -> None:
        # Terminal teardown, the EngineJournal idiom: snapshot the
        # handle under the lock, close outside it.
        with self._lock:
            db = self._db
        db.close()


def read_spool(path: str | os.PathLike) -> dict:
    """Read a spool file — typically one left by a SIGKILLed process.

    Opens its own handle (read path, no writes), so it works on a file
    whose writer died mid-WAL; sqlite replays the committed WAL frames
    on open. Returns ``{path, proc, role, meta, rows, lost}`` where
    ``rows`` is ``[(seq, kind, payload), ...]`` in seq order and
    ``lost`` counts seq gaps (committed rows that vanished — the chaos
    gate's zero-loss assertion).
    """
    db = sqlite3.connect(str(path))
    try:
        meta = {k: v for k, v in
                db.execute("SELECT key, value FROM meta")}
        rows = [(int(seq), kind, json.loads(payload))
                for seq, kind, payload in db.execute(
                    "SELECT seq, kind, payload FROM rows ORDER BY seq")]
    finally:
        db.close()
    lost = (rows[-1][0] - len(rows)) if rows else 0
    return {"path": str(path), "proc": meta.get("proc", ""),
            "role": meta.get("role", ""), "meta": meta,
            "rows": rows, "lost": lost}


def list_spools(directory: str | os.PathLike) -> list[str]:
    """Spool files under ``directory`` (non-recursive), sorted."""
    root = pathlib.Path(directory)
    if not root.is_dir():
        return []
    return sorted(str(p) for p in root.iterdir()
                  if p.name.endswith(SPOOL_SUFFIX))


# ---------------------------------------------------------------------------
# shipper
# ---------------------------------------------------------------------------


class TelemetryShipper:
    """Ships one process's telemetry into its crash-safe spool.

    Sources are all optional: an ``InMemoryMetrics`` registry (shipped
    as snapshot *deltas* so the aggregator can sum counters and merge
    histogram buckets without double counting), a ``TraceCollector``
    (each finished span shipped once), and a ``FlightRecorder`` (each
    StepRecord shipped once, watermarked by its monotonic ``seq``).

    ``flush()`` is synchronous and cheap — one snapshot diff plus one
    spool transaction — and safe to call from the serving loop (the
    journal_storm child flushes per step so every completed step is
    recoverable after its SIGKILL). ``start()`` runs a pump thread
    that flushes every ``interval_s``; the pump is stop-aware (waits
    on the stop Event, never a bare sleep) and ``stop()`` joins it —
    the racecheck thread-lifecycle contract, with a fixture pair and
    tripwire pinning it (tests/fixtures/racecheck/ship_pump.py).
    """

    def __init__(self, path: str | os.PathLike | None = None, *,
                 proc: str, role: str = "",
                 metrics: InMemoryMetrics | None = None,
                 collector: Any = None, recorder: Any = None,
                 interval_s: float = 0.25):
        if path is None:
            base = get_default_spool_dir()
            if not base:
                raise ValueError(
                    "TelemetryShipper needs a spool path (or a default "
                    "spool dir via set_default_spool_dir)")
            path = spool_path(base, proc)
        self.proc = proc
        self.role = role
        self.interval_s = float(interval_s)
        self._metrics = metrics
        self._collector = collector
        self._recorder = recorder
        self._spool = TelemetrySpool(path, proc=proc, role=role)
        # flush state — only ever touched inside flush() under the lock
        self._lock = threading.Lock()
        self._last: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        self._shipped_span_ids: set[str] = set()
        self._shipped_step_seq = 0
        self._flushes = 0
        self._shipped = {kind: 0 for kind in ROW_KINDS}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        _live.add(self)

    @property
    def path(self) -> str:
        return self._spool.path

    # -- shipping -------------------------------------------------------

    def _metrics_delta(self) -> dict | None:
        """Diff the registry against the last-shipped snapshot."""
        snap = self._metrics.snapshot()
        prev = self._last
        counters = []
        for name, series in snap["counters"].items():
            prev_series = prev["counters"].get(name, {})
            for key, value in series.items():
                dv = value - prev_series.get(key, 0.0)
                if dv != 0.0:
                    counters.append([name, _enc_labels(key), dv])
        gauges = []
        for name, series in snap["gauges"].items():
            prev_series = prev["gauges"].get(name, {})
            for key, value in series.items():
                if key not in prev_series or prev_series[key] != value:
                    gauges.append([name, _enc_labels(key), value])
        histograms = []
        for name, series in snap["histograms"].items():
            prev_series = prev["histograms"].get(name, {})
            for key, (total, count, buckets) in series.items():
                p = prev_series.get(key, [0.0, 0, [0] * len(buckets)])
                dcount = count - p[1]
                dsum = total - p[0]
                if dcount or dsum:
                    dbuckets = [b - pb for b, pb in zip(buckets, p[2])]
                    histograms.append(
                        [name, _enc_labels(key), dsum, dcount, dbuckets])
        self._last = snap
        if not (counters or gauges or histograms):
            return None
        return {"namespace": self._metrics.namespace,
                "buckets": list(self._metrics.buckets),
                "counters": counters, "gauges": gauges,
                "histograms": histograms}

    def mark(self) -> None:
        """Baseline the shipper at the registry's CURRENT state without
        shipping anything: subsequent flushes ship deltas from here.
        Bench children call this after warmup so compile-time
        observations never pollute the shipped histograms (the merged
        TTFT/ITL columns must measure the timed window, same as the
        direct columns)."""
        with self._lock:
            if self._metrics is not None:
                self._last = self._metrics.snapshot()
            if self._recorder is not None:
                records = self._recorder.records()
                if records:
                    self._shipped_step_seq = records[-1].seq

    def flush(self) -> int:
        """Ship everything new since the last flush in ONE spool
        transaction. Returns the number of rows appended."""
        with self._lock:
            t0 = time.monotonic()
            rows: list[tuple[str, dict]] = []
            if self._metrics is not None:
                delta = self._metrics_delta()
                if delta is not None:
                    rows.append(("metrics", delta))
            if self._collector is not None:
                current = self._collector.spans()
                current_ids = set()
                for s in current:
                    d = s.as_dict() if hasattr(s, "as_dict") else dict(s)
                    current_ids.add(d.get("span_id", ""))
                    if d.get("span_id", "") not in self._shipped_span_ids:
                        rows.append(("span", d))
                # forget ids the ring evicted — bounds the dedup set to
                # the collector capacity
                self._shipped_span_ids = current_ids
            if self._recorder is not None:
                for rec in self._recorder.records():
                    if rec.seq > self._shipped_step_seq:
                        rows.append(("step", rec.as_dict()))
                        self._shipped_step_seq = rec.seq
            total = self._spool.append(rows)
            self._flushes += 1
            for kind, _payload in rows:
                self._shipped[kind] += 1
            if self._metrics is not None:
                for kind, n in self._shipped.items():
                    self._metrics.set_counter(
                        "ship_rows_total", float(n), {"kind": kind})
                self._metrics.observe("ship_flush_seconds",
                                      time.monotonic() - t0)
                self._metrics.gauge("ship_spool_rows", float(total))
            return len(rows)

    # -- pump thread ----------------------------------------------------

    def start(self) -> "TelemetryShipper":
        """Start the background pump (idempotent)."""
        with self._lock:
            if self._thread is not None:
                return self
            self._stop.clear()
            thread = threading.Thread(
                target=self._pump, name=f"telemetry-ship-{self.proc}",
                daemon=True)
            self._thread = thread
        thread.start()
        return self

    def _pump(self) -> None:
        # Stop-aware: wake on the Event, never a bare sleep, so stop()
        # returns within one poll interval (racecheck thread-lifecycle
        # + blocking-call disciplines).
        while not self._stop.is_set():
            self._stop.wait(self.interval_s)
            try:
                self.flush()
            except Exception:
                # shipping must never take the serving process down
                pass

    def stop(self) -> None:
        """Stop and join the pump thread (owner-joined)."""
        self._stop.set()
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5.0)

    def close(self) -> None:
        """Stop the pump, ship a final flush, close the spool."""
        self.stop()
        try:
            self.flush()
        except Exception:
            pass
        self._spool.close()

    def stats(self) -> dict:
        with self._lock:
            return {"proc": self.proc, "role": self.role,
                    "path": self._spool.path,
                    "committed_rows": self._spool.committed_rows(),
                    "flushes": self._flushes,
                    "shipped": dict(self._shipped)}


# ---------------------------------------------------------------------------
# aggregator
# ---------------------------------------------------------------------------


class TelemetryAggregator:
    """Merges N processes' telemetry into one exposition.

    Merge semantics (the tentpole contract, pinned by
    tests/test_telemetry_ship.py):

    * counters **sum** — each shipped row is a delta, so applying every
      row once yields the true total;
    * gauges are **last-write-wins** within a process (rows apply in
      seq order; different procs never collide because ``proc`` is in
      the label set);
    * histograms **merge buckets** element-wise (sum, count and each
      cumulative bucket add);
    * every merged series gains the reserved ``proc``/``role`` labels;
      a spool whose own labels claim them is rejected loudly;
    * a series shipped as two different types by two processes is a
      **type conflict** and raises — one exposition, one TYPE line.

    Ingestion dedups by ``(proc, seq)``: re-ingesting the same spool
    (the at-least-once delivery case) applies nothing new.
    """

    def __init__(self, namespace: str = "copilot"):
        self._metrics = InMemoryMetrics(namespace=namespace)
        self._lock = threading.Lock()
        self._types: dict[tuple[str, str], str] = {}
        self._applied: dict[str, int] = {}   # proc -> max applied seq
        self._lost: dict[str, int] = {}
        self._spans: list[dict] = []
        self._steps: dict[str, list[dict]] = {}

    @property
    def metrics(self) -> InMemoryMetrics:
        return self._metrics

    # -- merge plumbing -------------------------------------------------

    def _check_type(self, name: str, typ: str) -> None:
        seen = self._types.get(("series", name))
        if seen is None:
            self._types[("series", name)] = typ
        elif seen != typ:
            raise ValueError(
                f"cross-process type conflict for series {name!r}: "
                f"{seen} vs {typ} — one exposition renders one TYPE "
                f"line per series, refusing to merge")

    def _stamp(self, pairs: Iterable, proc: str, role: str) -> dict:
        labels = _dec_labels(pairs)
        clash = [lb for lb in labels if lb in RESERVED_LABELS]
        if clash:
            raise ValueError(
                f"spool from proc {proc!r} ships reserved label(s) "
                f"{clash}; {RESERVED_LABELS} are stamped by the "
                f"aggregator (see obs.metrics.check_registry_labels)")
        labels["proc"] = proc
        labels["role"] = role
        return labels

    def _apply_metrics(self, payload: dict, proc: str, role: str) -> None:
        for name, pairs, dv in payload.get("counters", ()):
            self._check_type(name, "counter")
            self._metrics.increment(name, dv, self._stamp(pairs, proc, role))
        for name, pairs, value in payload.get("gauges", ()):
            self._check_type(name, "gauge")
            self._metrics.gauge(name, value, self._stamp(pairs, proc, role))
        for name, pairs, dsum, dcount, dbuckets in payload.get(
                "histograms", ()):
            self._check_type(name, "histogram")
            self._metrics.merge_histogram(
                name, self._stamp(pairs, proc, role), dsum, dcount,
                dbuckets)

    def _apply_span(self, payload: dict, proc: str, role: str) -> None:
        d = dict(payload)
        d["proc"] = proc
        if role and not d.get("service"):
            d["service"] = role
        self._spans.append(d)

    # -- ingestion ------------------------------------------------------

    def ingest_spool(self, path: str | os.PathLike) -> dict:
        """Ingest one spool; dedups by (proc, seq). Returns per-call
        stats (``applied``, ``skipped``, ``lost``, ``proc``)."""
        spool = read_spool(path)
        proc, role = spool["proc"], spool["role"]
        applied = skipped = 0
        with self._lock:
            watermark = self._applied.get(proc, 0)
            for seq, kind, payload in spool["rows"]:
                if seq <= watermark:
                    skipped += 1
                    continue
                if kind == "metrics":
                    self._apply_metrics(payload, proc, role)
                elif kind == "span":
                    self._apply_span(payload, proc, role)
                elif kind == "step":
                    self._steps.setdefault(proc, []).append(dict(payload))
                watermark = seq
                applied += 1
            self._applied[proc] = watermark
            self._lost[proc] = spool["lost"]
        return {"proc": proc, "role": role, "applied": applied,
                "skipped": skipped, "lost": spool["lost"]}

    def ingest_dir(self, directory: str | os.PathLike) -> list[dict]:
        """Ingest every spool file under ``directory``."""
        return [self.ingest_spool(p) for p in list_spools(directory)]

    def merge_registry(self, metrics: InMemoryMetrics, *, proc: str,
                       role: str = "") -> None:
        """Merge a live in-process registry (no spool round-trip) —
        the aggregating process's own series join the exposition the
        same way shipped ones do."""
        snap = metrics.snapshot()
        payload = {
            "counters": [[n, _enc_labels(k), v]
                         for n, s in snap["counters"].items()
                         for k, v in s.items()],
            "gauges": [[n, _enc_labels(k), v]
                       for n, s in snap["gauges"].items()
                       for k, v in s.items()],
            "histograms": [[n, _enc_labels(k), e[0], e[1], list(e[2])]
                           for n, s in snap["histograms"].items()
                           for k, e in s.items()],
        }
        with self._lock:
            self._apply_metrics(payload, proc, role)

    def merge_spans(self, spans: Iterable[Any], *, proc: str,
                    role: str = "") -> None:
        """Merge live spans (Span objects or dicts), proc-stamped."""
        with self._lock:
            for s in spans:
                d = s.as_dict() if hasattr(s, "as_dict") else dict(s)
                self._apply_span(d, proc, role)

    # -- views ----------------------------------------------------------

    def render_prometheus(self) -> str:
        """ONE merged scrape, the existing exact text format."""
        return self._metrics.render_prometheus()

    def spans(self) -> list[dict]:
        with self._lock:
            return list(self._spans)

    def spans_by_trace(self) -> dict[str, list[dict]]:
        out: dict[str, list[dict]] = {}
        for d in self.spans():
            out.setdefault(d.get("trace_id", ""), []).append(d)
        return out

    def steps(self, proc: str | None = None) -> list[dict]:
        with self._lock:
            if proc is not None:
                return list(self._steps.get(proc, ()))
            return [d for rows in self._steps.values() for d in rows]

    def stats(self) -> dict:
        with self._lock:
            return {"procs": sorted(self._applied),
                    "rows_applied": dict(self._applied),
                    "lost": dict(self._lost),
                    "spans": len(self._spans),
                    "steps": sum(len(v) for v in self._steps.values())}


# ---------------------------------------------------------------------------
# default spool dir + live-shipper registry — the conftest failure hook
# bundles every live shipper's spool next to the flight-record dumps
# (one telemetry-bundle artifact; satellite of the COPILOT_FLIGHT_
# RECORD_DIR plumbing).
# ---------------------------------------------------------------------------

_default_spool_dir: str | None = None
_live: "weakref.WeakSet[TelemetryShipper]" = weakref.WeakSet()


def set_default_spool_dir(path: str | None) -> None:
    global _default_spool_dir
    _default_spool_dir = path


def get_default_spool_dir() -> str | None:
    return _default_spool_dir


def spool_path(directory: str | os.PathLike, proc: str) -> str:
    """Canonical spool filename for ``proc`` under ``directory``."""
    safe = "".join(c if (c.isalnum() or c in "-_.") else "-"
                   for c in proc) or "proc"
    return str(pathlib.Path(directory) / f"{safe}{SPOOL_SUFFIX}")


def dump_all(directory: str | None = None, tag: str = "telemetry") \
        -> list[str]:
    """Flush every live shipper and write a bundle manifest into
    ``directory``. Never raises — this runs from failure hooks where a
    second error would mask the first. Returns written paths."""
    directory = directory or _default_spool_dir
    if not directory:
        return []
    spools: list[dict] = []
    for shipper in list(_live):
        try:
            shipper.flush()
            spools.append(shipper.stats())
        except Exception:
            continue
    if not spools:
        return []
    try:
        root = pathlib.Path(directory)
        root.mkdir(parents=True, exist_ok=True)
        manifest = root / f"{tag}-spools.json"
        manifest.write_text(json.dumps(
            {"dumped_wall": time.time(), "spools": spools}, indent=2,
            sort_keys=True))
        return [str(manifest)] + [s["path"] for s in spools]
    except Exception:
        return [s["path"] for s in spools]
