"""Shared service plumbing: event dispatch, retry, failure events, metrics.

Mirrors the crosscutting behavior every reference service repeats
(SURVEY.md §3.5): handler wraps ``handle_event_with_retry``; terminal
failures publish the stage's ``*Failed`` event to its ``.failed`` queue;
every handled event bumps counters and a latency histogram.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, Mapping

from copilot_for_consensus_tpu_torch.bus.base import (
    EventPublisher,
    PoisonEnvelope,
    PublishError,
)
from copilot_for_consensus_tpu_torch.core.events import Event
from copilot_for_consensus_tpu_torch.core.retry import (
    RetryExhaustedError,
    RetryPolicy,
    RetryableError,
)
from copilot_for_consensus_tpu_torch.obs import trace
from copilot_for_consensus_tpu_torch.obs.errors import ErrorReporter
from copilot_for_consensus_tpu_torch.obs.logging import Logger, get_logger
from copilot_for_consensus_tpu_torch.obs.metrics import (
    MetricsCollector,
    NoopMetrics,
)
from copilot_for_consensus_tpu_torch.storage.base import DocumentStore


def accepts_kwargs(fn: Callable, names: tuple[str, ...]) -> set[str]:
    """Which of ``names`` can be passed to ``fn`` as keyword arguments
    (explicitly or via ``**kwargs``). The services probe their
    summarizer/provider capabilities ONCE with this at construction —
    duck-typed stand-ins keep their short signatures and simply lose
    the optional tags (correlation_id, tenant, ...)."""
    import inspect

    try:
        params = list(inspect.signature(fn).parameters.values())
    except (TypeError, ValueError):
        return set()
    var_kw = any(p.kind is inspect.Parameter.VAR_KEYWORD
                 for p in params)
    have = {p.name for p in params}
    return {n for n in names if var_kw or n in have}


class BaseService:
    """Owns adapters; routes envelopes to ``on_<EventType>`` methods."""

    name = "base"
    #: event types this service consumes (routing keys derived from them)
    consumes: tuple[str, ...] = ()

    def __init__(
        self,
        publisher: EventPublisher,
        store: DocumentStore,
        *,
        logger: Logger | None = None,
        metrics: MetricsCollector | None = None,
        error_reporter: ErrorReporter | None = None,
        retry: RetryPolicy | None = None,
        throttle_pause_s: float = 0.05,
    ):
        self.publisher = publisher
        self.store = store
        self.logger = (logger or get_logger()).bind(service=self.name)
        self.metrics = metrics or NoopMetrics()
        self.error_reporter = error_reporter
        self.retry = retry or RetryPolicy()
        # Bus backpressure (bus/base.py:BusSaturated): when the
        # publisher reports saturated downstream keys, the handler
        # pauses briefly BEFORE consuming the next event, so this
        # stage's intake slows until the queue it feeds drains below
        # the watermark. Stop-aware (the release event), off unless
        # the bus config sets a high_watermark.
        self.throttle_pause_s = throttle_pause_s
        self._throttle_release = threading.Event()
        # Saturation snapshot shared across the service's worker pool:
        # one publisher.saturation() poll per refresh window for the
        # WHOLE service, not one per event per worker — an N-worker
        # pool must not multiply broker depth polls by N. TTL follows
        # the publisher's own staleness budget; publishers without one
        # (in-proc: saturation() is a lock-cheap local read) poll every
        # event as before.
        self._sat_refresh_s = float(
            getattr(publisher, "saturation_refresh_s", 0.0) or 0.0)
        self._sat_lock = threading.Lock()
        self._sat_cache: tuple[float, dict] = (0.0, {})

    # -- bus wiring ------------------------------------------------------

    def routing_keys(self) -> list[str]:
        from copilot_for_consensus_tpu_torch.core.events import EVENT_TYPES
        return [EVENT_TYPES[t].routing_key for t in self.consumes]

    def wave_routing_keys(self) -> list[str]:
        """Routing keys of the event types this service can dispatch as
        a wave (an ``on_wave_<EventType>`` method exists) — what the
        runner registers for the bus driver's opt-in batch dispatch."""
        from copilot_for_consensus_tpu_torch.core.events import EVENT_TYPES
        return [EVENT_TYPES[t].routing_key for t in self.consumes
                if callable(getattr(self, f"on_wave_{t}", None))]

    def handle_envelope(self, envelope: Mapping[str, Any]) -> None:
        """Bus callback. Raises to trigger nack/requeue on transient
        errors; terminal errors publish the failure event and then
        raise :class:`PoisonEnvelope` so bus drivers with a dead-letter
        table quarantine the envelope (skipping the redelivery budget —
        a deterministic failure cannot be retried into success) while
        the ``*Failed`` event remains the requeue-able operator record."""
        etype = envelope.get("event_type", "")
        handler: Callable | None = getattr(self, f"on_{etype}", None)
        if handler is None:
            return
        self._bus_throttle()
        t0 = time.monotonic()
        # One stage span per dispatch (obs/trace.py): parented on the
        # envelope's publish span, queue wait from the publish stamp,
        # redelivery attempt from the subscriber's annotation. Publishes
        # the handler makes (follow-up events, failure events) parent
        # under it via the thread-ambient context, keeping the trace DAG
        # connected end-to-end. The failure auto-dump runs AFTER the
        # span context exits (outer finally): the span only records on
        # exit, and a dump taken mid-span would omit the error span
        # itself and present its already-recorded failure-event publish
        # as an orphan.
        try:
            dump_exc = self._handle_in_span(envelope, etype, handler, t0)
        except PoisonEnvelope as exc:
            trace.dump_on_failure(exc.__cause__ or exc)
            raise
        if dump_exc is not None:
            trace.dump_on_failure(dump_exc)

    def _handle_in_span(self, envelope: Mapping[str, Any], etype: str,
                        handler: Callable, t0: float
                        ) -> BaseException | None:
        """Returns the terminal error to auto-dump for (retry
        exhaustion), or None; terminal unexpected errors raise
        PoisonEnvelope and are dumped by the caller."""
        with trace.stage_span(self.name, envelope) as sp:
            try:
                self.retry.run(
                    lambda: handler(Event.from_envelope(envelope)),
                    event_type=etype)
                self.metrics.increment(
                    f"{self.name}_events_total",
                    labels={"event": etype, "ok": "true"})
            except RetryExhaustedError as exc:
                # Transient, already retried with backoff in-process: the
                # failure event is the record; redelivering would repeat
                # the whole retry budget for the same outcome.
                self.metrics.increment(
                    f"{self.name}_events_total",
                    labels={"event": etype, "ok": "false"})
                self.logger.error("retries exhausted", event=etype,
                                  error=str(exc.last_error))
                if self.error_reporter is not None:
                    self.error_reporter.report(exc, {"event": etype})
                sp.status = "error"
                sp.error = (f"RetryExhaustedError: "
                            f"{exc.last_error}")
                self._publish_failure(envelope, exc.last_error,
                                      attempts=exc.attempts)
                return exc
            except PublishError:
                # Bus-level trouble mid-handler (broker outage past the
                # outbox, BusSaturated overflow): transient by definition
                # — propagate so the driver nacks onto the lease/
                # redelivery path instead of minting a failure event the
                # same broker couldn't carry.
                self.metrics.increment(
                    f"{self.name}_events_total",
                    labels={"event": etype, "ok": "false"})
                raise
            except Exception as exc:  # unexpected → terminal failure
                self.metrics.increment(
                    f"{self.name}_events_total",
                    labels={"event": etype, "ok": "false"})
                self.logger.error("handler failed", event=etype,
                                  error=str(exc),
                                  error_type=type(exc).__name__)
                if self.error_reporter is not None:
                    self.error_reporter.report(exc, {"event": etype})
                self._publish_failure(envelope, exc, attempts=1)
                raise PoisonEnvelope(
                    f"{type(exc).__name__}: {exc}") from exc
            finally:
                dt = time.monotonic() - t0
                self.metrics.observe(f"{self.name}_handle_seconds", dt,
                                     labels={"event": etype})
                # per-stage trace metrics (obs/trace.PIPELINE_METRICS)
                self.metrics.observe("pipeline_stage_duration_seconds",
                                     dt, labels={"stage": self.name})
                self.metrics.observe(
                    "pipeline_stage_queue_wait_seconds",
                    sp.queue_wait_s, labels={"stage": self.name})

    def _saturation_snapshot(self) -> dict:
        """The service-level saturation cache: within
        ``_sat_refresh_s`` of the last poll every worker reuses the
        snapshot; on expiry ONE caller claims the refresh (stamping the
        cache first so concurrent workers ride the stale copy instead
        of stampeding the broker) and polls outside the lock."""
        sat = getattr(self.publisher, "saturation", None)
        if not callable(sat):
            return {}
        now = time.monotonic()
        if self._sat_refresh_s > 0:
            with self._sat_lock:
                stamp, snap = self._sat_cache
                if now - stamp < self._sat_refresh_s:
                    return snap
                self._sat_cache = (now, snap)   # claim the refresh
        try:
            hot = sat()
        # a broken saturation poll must degrade to "no shed signal",
        # not fail dispatch — no envelope is acked here
        except Exception:  # jaxlint: disable=dura-ack-swallow
            hot = {}
        if self._sat_refresh_s > 0:
            with self._sat_lock:
                self._sat_cache = (time.monotonic(), hot)
        return hot

    # -- batched (wave) dispatch ----------------------------------------

    def handle_envelopes(self, envelopes) -> list:
        """Batch bus callback (``bus/base.py:BatchEventCallback``): a
        fetch wave of envelopes dispatched through the stage's
        ``on_wave_<EventType>`` hot path when one exists — one store
        multi-get, one bulk write-back, grouped publishes — with one
        outcome per envelope so the driver's per-message ack/nack/
        quarantine semantics hold unchanged under batching. Event types
        without a wave handler (and every envelope of a wave that
        failed as a whole) take the exact single-dispatch path."""
        envelopes = list(envelopes)
        outcomes: list = [None] * len(envelopes)
        groups: dict[str, list[int]] = {}
        for i, env in enumerate(envelopes):
            etype = str(env.get("event_type", "")) \
                if isinstance(env, Mapping) else ""
            groups.setdefault(etype, []).append(i)
        for etype, idxs in groups.items():
            wave = getattr(self, f"on_wave_{etype}", None) \
                if etype else None
            if not callable(wave):
                for i in idxs:
                    outcomes[i] = self._dispatch_single(envelopes[i])
            else:
                self._handle_wave(etype, wave,
                                  [envelopes[i] for i in idxs],
                                  idxs, outcomes)
        return outcomes

    def _dispatch_single(self, envelope) -> BaseException | None:
        """One envelope through :meth:`handle_envelope`, its raise
        captured as the envelope's outcome (what the batch driver
        classifies exactly like a single-dispatch raise)."""
        try:
            self.handle_envelope(envelope)
            return None
        except Exception as exc:
            return exc

    def _handle_wave(self, etype: str, wave_handler: Callable,
                     envs: list, idxs: list[int], outcomes: list) -> None:
        """Run one wave: shared phase (store round-trips, no publishes)
        once for the whole wave, then one stage span + finisher
        (publishes) per envelope so every envelope records its own
        amortized residence and its follow-up events parent under ITS
        span — per-trace correctness under batching.

        A shared-phase failure falls back to per-envelope dispatch:
        one missing document (the event-before-store-visibility race)
        must nack only ITS envelope, never the wave."""
        self._bus_throttle()
        t0 = time.monotonic()
        try:
            events = [Event.from_envelope(env) for env in envs]
            finishers = wave_handler(events)
        except Exception as exc:
            self.metrics.increment(
                f"{self.name}_wave_fallback_total",
                labels={"event": etype})
            self.logger.info("wave fallback to single dispatch",
                             event=etype, wave=len(envs),
                             error=str(exc),
                             error_type=type(exc).__name__)
            for i, env in zip(idxs, envs):
                outcomes[i] = self._dispatch_single(env)
            return
        amortized = (time.monotonic() - t0) / max(1, len(envs))
        if finishers is None:
            finishers = [None] * len(envs)
        # Grouped publishes: publishers with a publish_window (the
        # broker driver) buffer every finisher's follow-up events and
        # flush them as ONE pub_batch round-trip — spans and trace
        # stamps still record per envelope at publish() time. A flush
        # failure surfacing here (outbox overflow) is bus-level
        # trouble for the WHOLE wave: nack everything not already
        # classified; redelivery regenerates the publishes
        # (idempotent ids absorb the parked portion's replay).
        window = getattr(self.publisher, "publish_window", None)
        try:
            with (window() if callable(window)
                  else contextlib.nullcontext()):
                for (i, env), fin in zip(zip(idxs, envs), finishers):
                    outcomes[i] = self._finish_wave_envelope(
                        etype, env, fin, amortized, len(envs))
        except PublishError as exc:
            for i in idxs:
                if outcomes[i] is None:
                    outcomes[i] = exc

    def _finish_wave_envelope(self, etype: str, envelope,
                              finisher: Callable | None,
                              amortized_s: float, wave: int
                              ) -> BaseException | None:
        """Per-envelope tail of a wave: stage span (amortized shared
        time + the finisher's own publishes), stage metrics, and the
        single-dispatch failure classification — a finisher's
        PublishError nacks onto the redelivery path, anything else
        publishes the stage's *Failed event and quarantines."""
        t0 = time.monotonic()
        try:
            with trace.stage_span(self.name, envelope,
                                  extra_duration_s=amortized_s,
                                  wave=wave) as sp:
                try:
                    if finisher is not None:
                        finisher()
                    self.metrics.increment(
                        f"{self.name}_events_total",
                        labels={"event": etype, "ok": "true"})
                except (PublishError, RetryableError):
                    # Transient trouble in the finisher (bus outage
                    # past the outbox; a retryable store-visibility
                    # race like the orchestrator finisher's
                    # DocumentNotFoundError): nack, redeliver — the
                    # re-run's writes are idempotent. Classifying
                    # these as terminal would quarantine work the
                    # lease/redelivery path exists to recover.
                    self.metrics.increment(
                        f"{self.name}_events_total",
                        labels={"event": etype, "ok": "false"})
                    raise
                except Exception as exc:
                    self.metrics.increment(
                        f"{self.name}_events_total",
                        labels={"event": etype, "ok": "false"})
                    self.logger.error("wave finisher failed",
                                      event=etype, error=str(exc),
                                      error_type=type(exc).__name__)
                    if self.error_reporter is not None:
                        self.error_reporter.report(exc, {"event": etype})
                    self._publish_failure(envelope, exc, attempts=1)
                    raise PoisonEnvelope(
                        f"{type(exc).__name__}: {exc}") from exc
                finally:
                    dt = time.monotonic() - t0 + amortized_s
                    self.metrics.observe(
                        f"{self.name}_handle_seconds", dt,
                        labels={"event": etype})
                    self.metrics.observe(
                        "pipeline_stage_duration_seconds", dt,
                        labels={"stage": self.name})
                    self.metrics.observe(
                        "pipeline_stage_queue_wait_seconds",
                        sp.queue_wait_s, labels={"stage": self.name})
        except PoisonEnvelope as exc:
            trace.dump_on_failure(exc.__cause__ or exc)
            return exc
        except Exception as exc:
            return exc
        return None

    def _bus_throttle(self) -> None:
        """One bounded, stop-aware pause per event while the publisher
        reports saturated downstream keys (depth-watermark
        backpressure). A no-op for publishers without depth feedback
        or with no watermark configured."""
        hot = self._saturation_snapshot()
        if not hot:
            return
        self.metrics.increment("bus_throttle_total",
                               labels={"service": self.name})
        self._throttle_release.wait(self.throttle_pause_s)

    def stop_throttling(self) -> None:
        """Release any in-progress (and all future) throttle pauses —
        shutdown must never wait out a backpressure pause."""
        self._throttle_release.set()

    def _publish_failure(self, envelope: Mapping[str, Any],
                         error: BaseException | None,
                         attempts: int) -> None:
        evt = self.failure_event(envelope, error, attempts)
        if evt is not None:
            self.publisher.publish(evt)

    def failure_event(self, envelope: Mapping[str, Any],
                      error: BaseException | None,
                      attempts: int) -> Event | None:
        """Override: map a failed envelope to the stage's *Failed event."""
        return None

    def startup(self) -> None:
        """Override: startup requeue of stuck documents."""
