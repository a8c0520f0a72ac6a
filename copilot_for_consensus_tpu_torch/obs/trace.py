"""Pipeline-wide distributed tracing: trace-context propagation over the
bus, per-stage spans, and a bounded trace collector.

PR 5's flight recorder stopped at the engine boundary: ``RequestTrace``
spans cover submit→retire inside a serving engine, but a message's
journey across the host pipeline (archive → parse → chunk → embed →
summarize → report) was invisible — ``correlation_id`` was never
carried in bus envelopes, so per-stage latency attribution had to be
re-derived from ad-hoc bench timers. This module is the
Dapper/OpenTelemetry-shaped answer, sized to this codebase:

* **Trace context over the bus.** Every published envelope carries a
  ``trace`` header block (``trace_id`` / ``span_id`` /
  ``parent_span_id`` / ``published_at``), injected once at first
  publish (``inject``) and preserved verbatim across redelivery,
  outbox replay, and requeue — at-least-once delivery yields annotated
  retries (``attempt``), never orphan traces. The publish itself is
  recorded as a zero-ish-duration ``publish`` span whose id IS the
  envelope's ``span_id``, so the consumer's stage span has a recorded
  parent and the DAG stays connected.
* **Stage spans.** ``BaseService.handle_envelope`` opens one ``stage``
  span per dispatch (``stage_span``), recording queue wait (publish →
  consume gap off ``published_at``), handler service time, redelivery
  attempt, and status; store writes / vector upserts / engine submits
  open ``child_span``s under it (the ``TracingDocumentStore`` /
  ``TracingVectorStore`` wrappers + explicit spans at the engine
  submit sites). The engine's own ``RequestTrace`` joins by the shared
  ``correlation_id`` attribute.
* **Bounded collector.** ``TraceCollector`` is a lock-cheap ring (one
  GIL-atomic deque append per span, the ``FlightRecorder``
  discipline) with Perfetto (Chrome trace event) and OTLP-JSON export
  and auto-dump on dispatch failure — the host-pipeline flight
  recorder. ``tools/tracepath.py`` reconstructs the per-thread stage
  DAG from it and names the bottleneck stage.

Everything here is host-side dict work — no device ops, no extra
syncs, no env reads (the test harness plumbs the CI dump dir through
``set_default_dump_dir``, same contract as ``engine/telemetry.py``).
"""

from __future__ import annotations

import collections
import contextlib
import json
import pathlib
import threading
import time
import uuid
from dataclasses import asdict, dataclass, field
from typing import Any, Iterable, Mapping

from copilot_for_consensus_tpu_torch.obs.metrics import check_registry_labels

#: envelope key carrying the trace context block
TRACE_KEY = "trace"

#: span kinds the pipeline emits (doc + test anchor). ``stage`` spans
#: are the only ones that land in the stage latency histograms.
SPAN_KINDS = ("publish", "stage", "store_write", "vector_upsert",
              "retrieval", "engine_submit", "engine_replay")

# ---------------------------------------------------------------------------
# Metric registry — what the tracing layer emits, in the
# engine/telemetry.py:METRICS style: the observability-pack contract
# test checks infra/grafana + infra/prometheus references against it,
# and a registry⇄emission test keeps it honest both ways. Histograms
# are emitted by services/base.py per dispatch; the span counters are
# refreshed from the collector ledger at scrape time
# (services/bootstrap.py:_BusGaugeMetrics, via set_counter).
# ---------------------------------------------------------------------------

#: metric name (sans namespace) → (type, label names, help)
PIPELINE_METRICS: dict[str, tuple[str, tuple[str, ...], str]] = {
    "pipeline_stage_duration_seconds": (
        "histogram", ("stage",),
        "Handler service time per pipeline stage span."),
    "pipeline_stage_queue_wait_seconds": (
        "histogram", ("stage",),
        "Publish → consume gap per stage span (includes redelivery "
        "latency on retries)."),
    "pipeline_spans_open_total": (
        "counter", (),
        "Spans opened by the pipeline tracer (all kinds)."),
    "pipeline_spans_dropped_total": (
        "counter", (),
        "Spans evicted from the bounded trace ring (size the "
        "collector up if this moves during an investigation)."),
}

# proc/role are stamped by the cross-process aggregator (obs/ship.py);
# declaring them here must fail at import, not at scrape time.
check_registry_labels(PIPELINE_METRICS, owner="PIPELINE_METRICS")


def prometheus_series(namespace: str = "copilot") -> dict[str, str]:
    """Full series name → type, for contract tests and docs."""
    return {f"{namespace}_{name}": typ
            for name, (typ, _labels, _help) in PIPELINE_METRICS.items()}


def _new_trace_id() -> str:
    return uuid.uuid4().hex                  # 16 bytes hex (OTLP shape)


def _new_span_id() -> str:
    return uuid.uuid4().hex[:16]             # 8 bytes hex (OTLP shape)


@dataclass
class Span:
    """One finished pipeline span. ``start_wall`` anchors to wall clock
    (cross-process join + Perfetto ts); durations are measured with
    ``time.monotonic()`` around the work."""

    trace_id: str
    span_id: str
    parent_span_id: str
    name: str                  # stage/service name or routing key
    kind: str                  # one of SPAN_KINDS
    service: str = ""
    start_wall: float = 0.0
    duration_s: float = 0.0
    status: str = "ok"         # ok | error
    error: str = ""
    correlation_id: str = ""
    event_type: str = ""
    routing_key: str = ""
    queue_wait_s: float = 0.0
    attempt: int = 0
    attrs: dict[str, Any] = field(default_factory=dict)

    def as_dict(self) -> dict:
        return asdict(self)


class TraceCollector:
    """Bounded ring of finished :class:`Span`s. Append is one deque op
    under the GIL (the maxlen does the eviction) plus one short lock
    for the opened-counter — cheap enough to stay on by default in
    every service's dispatch loop."""

    def __init__(self, capacity: int = 8192):
        self.capacity = capacity
        self._ring: "collections.deque[Span]" = collections.deque(
            maxlen=capacity)
        self._lock = threading.Lock()
        self._opened = 0
        self._dump_seq = 0

    def record(self, span: Span) -> Span:
        self._ring.append(span)
        with self._lock:
            self._opened += 1
        return span

    def spans(self) -> list[Span]:
        return list(self._ring)

    def as_dicts(self) -> list[dict]:
        return [s.as_dict() for s in self.spans()]

    def stats(self) -> dict[str, int]:
        with self._lock:
            opened = self._opened
        retained = len(self._ring)
        return {"opened": opened, "retained": retained,
                "dropped": max(0, opened - retained),
                "capacity": self.capacity}

    def reset(self, capacity: int | None = None) -> None:
        """Clear the ring (benches reset between arms so per-arm orphan
        audits don't see the previous arm's evictions)."""
        if capacity is not None:
            self.capacity = capacity
        self._ring = collections.deque(maxlen=self.capacity)
        with self._lock:
            self._opened = 0

    # -- export ---------------------------------------------------------

    def export_perfetto(self, spans: Iterable[Span] | None = None) -> dict:
        """Chrome trace event format (Perfetto/chrome://tracing): one
        complete ("X") event per span, pid = service, tid = trace id —
        loadable next to the engines' device traces so a device step
        and the pipeline stage that submitted it sit in one timeline."""
        events = []
        for s in (self.spans() if spans is None else spans):
            events.append({
                "name": f"{s.kind}:{s.name}",
                "ph": "X",
                "ts": s.start_wall * 1e6,
                "dur": max(s.duration_s, 1e-6) * 1e6,
                "pid": s.service or "pipeline",
                "tid": s.trace_id[:8],
                "args": {
                    "trace_id": s.trace_id, "span_id": s.span_id,
                    "parent_span_id": s.parent_span_id,
                    "correlation_id": s.correlation_id,
                    "event_type": s.event_type,
                    "routing_key": s.routing_key,
                    "queue_wait_s": round(s.queue_wait_s, 6),
                    "attempt": s.attempt, "status": s.status,
                    **s.attrs,
                },
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_otlp(self, spans: Iterable[Span] | None = None) -> dict:
        """OTLP-JSON shape (``ExportTraceServiceRequest``): what an
        OpenTelemetry collector's HTTP receiver accepts, so the ring
        can be forwarded to any OTLP backend without a vendored SDK."""
        by_service: dict[str, list[dict]] = {}
        for s in (self.spans() if spans is None else spans):
            start_ns = int(s.start_wall * 1e9)
            attrs = [{"key": k, "value": {"stringValue": str(v)}}
                     for k, v in (
                         ("correlation_id", s.correlation_id),
                         ("event_type", s.event_type),
                         ("routing_key", s.routing_key),
                         ("queue_wait_s", round(s.queue_wait_s, 6)),
                         ("attempt", s.attempt),
                         ("kind", s.kind),
                         *sorted(s.attrs.items())) if v not in ("", None)]
            by_service.setdefault(s.service or "pipeline", []).append({
                "traceId": s.trace_id,
                "spanId": s.span_id,
                "parentSpanId": s.parent_span_id,
                "name": s.name,
                "startTimeUnixNano": str(start_ns),
                "endTimeUnixNano": str(
                    start_ns + int(s.duration_s * 1e9)),
                "status": {"code": 2 if s.status == "error" else 1,
                           **({"message": s.error} if s.error else {})},
                "attributes": attrs,
            })
        return {"resourceSpans": [{
            "resource": {"attributes": [{
                "key": "service.name",
                "value": {"stringValue": svc}}]},
            "scopeSpans": [{
                "scope": {"name": "copilot_for_consensus_tpu_torch.obs.trace"},
                "spans": spans_}],
        } for svc, spans_ in sorted(by_service.items())]}

    def dump(self, *, error: BaseException | None = None,
             extra: dict | None = None) -> dict:
        out = {
            "dumped_wall": time.time(),
            "stats": self.stats(),
            "spans": self.as_dicts(),
        }
        if error is not None:
            out["error"] = {"type": type(error).__name__,
                            "message": str(error)}
        if extra:
            out.update(extra)
        return out

    def dump_to_file(self, directory: str | None = None,
                     tag: str = "pipeline-trace",
                     error: BaseException | None = None,
                     fmt: str = "raw") -> str:
        """Write the ring as JSON: ``fmt`` raw (span dicts, what
        tools/tracepath reads) | perfetto | otlp."""
        directory = directory or _default_dump_dir
        if not directory:
            raise ValueError("no pipeline-trace dump directory configured")
        path = pathlib.Path(directory)
        path.mkdir(parents=True, exist_ok=True)
        with self._lock:
            self._dump_seq += 1
            seq = self._dump_seq
        if fmt == "perfetto":
            data: dict = self.export_perfetto()
        elif fmt == "otlp":
            data = self.export_otlp()
        else:
            data = self.dump(error=error)
        target = path / f"{tag}-{int(time.time())}-{seq}.json"
        target.write_text(json.dumps(data, indent=2, default=str))
        return str(target)


# ---------------------------------------------------------------------------
# process-global collector + ambient span context
# ---------------------------------------------------------------------------

_collector = TraceCollector()
_default_dump_dir: str | None = None
_tls = threading.local()        # per-thread ambient (trace_id, span_id)


def get_collector() -> TraceCollector:
    return _collector


def configure(capacity: int | None = None) -> TraceCollector:
    """Resize + clear the global ring (benches size it to their span
    volume so orphan audits never chase ring evictions)."""
    _collector.reset(capacity=capacity)
    return _collector


def set_default_dump_dir(path: str | None) -> None:
    global _default_dump_dir
    _default_dump_dir = path


def get_default_dump_dir() -> str | None:
    return _default_dump_dir


def dump_all(directory: str | None = None, tag: str = "pipeline-trace"
             ) -> list[str]:
    """Dump the global collector when it holds spans; never raises —
    this runs from test-failure hooks where a second error would mask
    the first. Returns written paths."""
    directory = directory or _default_dump_dir
    if not directory or not len(_collector._ring):
        return []
    try:
        return [_collector.dump_to_file(directory=directory, tag=tag)]
    except Exception:
        return []


def dump_on_failure(error: BaseException | None = None,
                    tag: str = "dispatch-failure") -> str | None:
    """Auto-dump hook for dispatch failures (the flight-recorder
    ``record_error`` contract): writes only when a dump dir is
    configured, never raises."""
    if not _default_dump_dir:
        return None
    try:
        return _collector.dump_to_file(directory=_default_dump_dir,
                                       tag=tag, error=error)
    except Exception:
        return None


def current_ids() -> tuple[str, str] | None:
    """Ambient (trace_id, span_id) on this thread, or None."""
    return getattr(_tls, "ctx", None)


@contextlib.contextmanager
def use_context(trace_id: str, span_id: str, service: str = ""):
    """Re-establish an ambient span captured on another thread (the
    pipelined-summarization harvester, the engine replay path) so
    spans and publishes made here stay in the originating trace.
    Pass ``service`` so child/publish spans opened here attribute to
    the originating service instead of the fake-service fallbacks
    (store-method names, "publisher")."""
    prev = getattr(_tls, "ctx", None)
    prev_span = getattr(_tls, "span", None)
    _tls.ctx = (trace_id, span_id)
    # A service-only carrier (never recorded): span()/inject() read
    # only .service off the ambient span for attribution.
    _tls.span = Span(trace_id=trace_id, span_id=span_id,
                     parent_span_id="", name=service or "context",
                     kind="context",
                     service=service) if service else None
    try:
        yield
    finally:
        _tls.ctx = prev
        _tls.span = prev_span


def set_worker_label(label: str) -> None:
    """Thread-ambient worker identity (``<service>-w<i>``), set by a
    :class:`~copilot_for_consensus_tpu_torch.services.pool.StageWorkerPool`
    worker thread at start so every stage span it dispatches carries
    which pool member did the work. Empty string clears it."""
    _tls.worker = label


def worker_label() -> str:
    return getattr(_tls, "worker", "") or ""


@contextlib.contextmanager
def span(name: str, kind: str = "stage", *, service: str = "",
         correlation_id: str = "", event_type: str = "",
         routing_key: str = "", queue_wait_s: float = 0.0,
         attempt: int = 0, parent: tuple[str, str] | None = None,
         collector: TraceCollector | None = None,
         extra_duration_s: float = 0.0, **attrs):
    """Open a span: parented under ``parent`` (or the thread's ambient
    span), made ambient for its body, recorded on exit. An exception
    marks status=error and propagates. ``extra_duration_s`` is added
    to the measured body time — batched stage dispatch attributes each
    envelope its amortized share of the wave's shared work, which the
    span body itself never executes."""
    amb = parent if parent is not None else getattr(_tls, "ctx", None)
    if amb is not None:
        trace_id, parent_span_id = amb
    else:
        trace_id, parent_span_id = _new_trace_id(), ""
    if not service:
        # child spans inherit the owning service from the ambient span
        # (a store write under the parsing stage belongs to "parsing",
        # not to a fake service named after the store method)
        amb_span = getattr(_tls, "span", None)
        service = amb_span.service if amb_span is not None else name
    s = Span(trace_id=trace_id, span_id=_new_span_id(),
             parent_span_id=parent_span_id, name=name, kind=kind,
             service=service, start_wall=time.time(),
             correlation_id=correlation_id, event_type=event_type,
             routing_key=routing_key, queue_wait_s=queue_wait_s,
             attempt=attempt, attrs=dict(attrs))
    prev = getattr(_tls, "ctx", None)
    prev_span = getattr(_tls, "span", None)
    _tls.ctx = (s.trace_id, s.span_id)
    _tls.span = s
    t0 = time.monotonic()
    try:
        yield s
    except BaseException as exc:
        s.status = "error"
        s.error = f"{type(exc).__name__}: {exc}"
        raise
    finally:
        s.duration_s = time.monotonic() - t0 + extra_duration_s
        _tls.ctx = prev
        _tls.span = prev_span
        (collector or _collector).record(s)


def child_span(kind: str, name: str = "", *, service: str = "",
               correlation_id: str = "", **attrs):
    """A child operation under the ambient stage span (store writes,
    vector upserts, engine submits). Same contract as :func:`span`,
    just named for call-site readability."""
    return span(name or kind, kind=kind, service=service,
                correlation_id=correlation_id, **attrs)


# ---------------------------------------------------------------------------
# envelope propagation
# ---------------------------------------------------------------------------


def inject(envelope: Mapping[str, Any], routing_key: str = "",
           service: str = "",
           collector: TraceCollector | None = None) -> dict[str, Any]:
    """Stamp a trace context onto an envelope at publish time.

    First publish: allocates the message's ``span_id``, records the
    ``publish`` span (parent = the publishing handler's ambient stage
    span; a publish with no ambient span roots a new trace — the
    ingestion trigger), and returns a COPY of the envelope carrying the
    ``trace`` block. Re-publish of an envelope that already carries a
    ``trace_id`` (outbox replay, redelivery requeue, DLQ requeue,
    startup requeue of a foreign envelope) returns it unchanged — the
    context, and therefore the DAG, survives at-least-once delivery."""
    existing = envelope.get(TRACE_KEY)
    if isinstance(existing, Mapping) and existing.get("trace_id"):
        return dict(envelope) if not isinstance(envelope, dict) \
            else envelope
    amb = getattr(_tls, "ctx", None)
    if amb is not None:
        trace_id, parent_span_id = amb
    else:
        trace_id, parent_span_id = _new_trace_id(), ""
    if not service:
        # attribute the publish to the service whose stage span is
        # ambient (falls back for root publishes / foreign threads)
        amb_span = getattr(_tls, "span", None)
        service = amb_span.service if amb_span is not None \
            else "publisher"
    span_id = _new_span_id()
    now = time.time()
    corr = ""
    data = envelope.get("data")
    if isinstance(data, Mapping):
        corr = str(data.get("correlation_id", "") or "")
    (collector or _collector).record(Span(
        trace_id=trace_id, span_id=span_id,
        parent_span_id=parent_span_id,
        name=routing_key or envelope.get("event_type", "publish"),
        kind="publish", service=service,
        start_wall=now, duration_s=0.0, correlation_id=corr,
        event_type=str(envelope.get("event_type", "")),
        routing_key=routing_key))
    env = dict(envelope)
    env[TRACE_KEY] = {"trace_id": trace_id, "span_id": span_id,
                      "parent_span_id": parent_span_id,
                      "published_at": now}
    return env


def extract(envelope: Mapping[str, Any]) -> dict[str, Any] | None:
    """The envelope's trace block, or None (foreign/pre-trace
    envelopes)."""
    ctx = envelope.get(TRACE_KEY)
    if isinstance(ctx, Mapping) and ctx.get("trace_id"):
        return dict(ctx)
    return None


def annotate_delivery(envelope: Mapping[str, Any], attempt: int) -> None:
    """Subscriber-side: stamp the redelivery attempt onto the envelope's
    trace block before dispatch, so the stage span is annotated (a
    retry is a new span with the SAME parent — never an orphan).
    REPLACES the trace dict instead of mutating it: the in-proc broker
    fan-out shallow-copies envelopes per consumer group, so an in-place
    write would bleed one group's attempt count into another group's
    pristine delivery."""
    if attempt <= 0 or not isinstance(envelope, dict):
        return
    ctx = envelope.get(TRACE_KEY)
    if isinstance(ctx, Mapping):
        envelope[TRACE_KEY] = {**ctx, "attempt": int(attempt)}


@contextlib.contextmanager
def stage_span(service: str, envelope: Mapping[str, Any], *,
               extra_duration_s: float = 0.0, wave: int = 0):
    """The per-dispatch stage span ``BaseService.handle_envelope``
    opens: parented on the envelope's publish span, queue wait from
    the publish stamp, attempt from the redelivery annotation. Yields
    the live :class:`Span` so the service can emit its stage metrics
    off the measured fields after the body runs.

    Batched dispatch (``BaseService.handle_envelopes``) opens one span
    per envelope with ``extra_duration_s`` = the wave's shared service
    time / wave size (honest amortized per-message residence — the
    quantity tracepath's bottleneck attribution is declared over) and
    ``wave`` = the wave size. The pool worker label, when a
    StageWorkerPool thread set one, rides every stage span."""
    ctx = extract(envelope)
    parent: tuple[str, str] | None = None
    queue_wait = 0.0
    attempt = 0
    if ctx is not None:
        parent = (str(ctx["trace_id"]), str(ctx.get("span_id", "")))
        published_at = float(ctx.get("published_at", 0.0) or 0.0)
        if published_at:
            queue_wait = max(0.0, time.time() - published_at)
        attempt = int(ctx.get("attempt", 0) or 0)
    corr = ""
    data = envelope.get("data")
    if isinstance(data, Mapping):
        corr = str(data.get("correlation_id", "") or "")
    attrs: dict[str, Any] = {}
    w = worker_label()
    if w:
        attrs["worker"] = w
    if wave:
        attrs["wave"] = int(wave)
    with span(service, kind="stage", service=service,
              correlation_id=corr,
              event_type=str(envelope.get("event_type", "")),
              queue_wait_s=queue_wait, attempt=attempt,
              parent=parent, extra_duration_s=extra_duration_s,
              **attrs) as s:
        yield s


# ---------------------------------------------------------------------------
# audits
# ---------------------------------------------------------------------------


def orphan_spans(spans: Iterable[Span | Mapping[str, Any]]
                 ) -> list[dict[str, Any]]:
    """Spans claiming a parent that is not in the set (same trace).
    Root spans (empty parent) are never orphans. Zero is the chaos
    gate's invariant: at-least-once delivery must yield annotated
    retries, not disconnected trace fragments."""
    dicts = [s.as_dict() if isinstance(s, Span) else dict(s)
             for s in spans]
    by_trace: dict[str, set[str]] = {}
    for d in dicts:
        by_trace.setdefault(d["trace_id"], set()).add(d["span_id"])
    return [d for d in dicts
            if d.get("parent_span_id")
            and d["parent_span_id"] not in by_trace.get(d["trace_id"],
                                                        set())]


# ---------------------------------------------------------------------------
# store wrappers — the child-span choke points build_pipeline wires in
# (the bus/faults.py _Wrapper delegation pattern; reads pass through)
# ---------------------------------------------------------------------------


class _TracingWrapper:
    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, name):
        return getattr(self.inner, name)


class TracingDocumentStore(_TracingWrapper):
    """Child ``store_write`` spans around document-store mutations
    (reads pass through — the interesting attribution is write
    latency under the stage span)."""

    def _traced(self, method: str, collection: str, *args, **kwargs):
        if getattr(_tls, "ctx", None) is None:     # no ambient trace
            return getattr(self.inner, method)(collection, *args,
                                               **kwargs)
        with child_span("store_write", method, collection=collection):
            return getattr(self.inner, method)(collection, *args,
                                               **kwargs)

    def upsert_document(self, collection, doc):
        return self._traced("upsert_document", collection, doc)

    def insert_document(self, collection, doc):
        return self._traced("insert_document", collection, doc)

    def insert_or_ignore(self, collection, doc):
        return self._traced("insert_or_ignore", collection, doc)

    def insert_many(self, collection, docs, ignore_duplicates=False):
        return self._traced("insert_many", collection, docs,
                            ignore_duplicates)

    def update_document(self, collection, doc_id, fields):
        return self._traced("update_document", collection, doc_id,
                            fields)

    def update_documents(self, collection, doc_ids, fields):
        return self._traced("update_documents", collection, doc_ids,
                            fields)

    def delete_document(self, collection, doc_id):
        return self._traced("delete_document", collection, doc_id)

    def delete_documents(self, collection, flt):
        return self._traced("delete_documents", collection, flt)


class TracingVectorStore(_TracingWrapper):
    """Child ``vector_upsert`` spans around ingest-path vector
    mutations (the FaultingVectorStore boundary set)."""

    def _traced(self, method: str, *args):
        if getattr(_tls, "ctx", None) is None:
            return getattr(self.inner, method)(*args)
        with child_span("vector_upsert", method):
            return getattr(self.inner, method)(*args)

    def add_embeddings(self, items):
        return self._traced("add_embeddings", items)

    def delete(self, ids):
        return self._traced("delete", ids)

    def delete_by_filter(self, flt):
        return self._traced("delete_by_filter", flt)
