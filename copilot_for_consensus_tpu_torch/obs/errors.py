"""Error reporting abstraction (parity with ``copilot_error_reporting``).

Drivers: console (structured log), silent, collecting (tests), and
``http`` — the Sentry-role driver (reference
``copilot_error_reporting/sentry_error_reporter.py``): events POST as
JSON to a configurable endpoint with fingerprint-based rate limiting,
release/environment tags, and best-effort delivery that never takes the
pipeline down with the error tracker.
"""

from __future__ import annotations

import abc
import hashlib
import json
import threading
import time
import traceback
from typing import Any

from copilot_for_consensus_tpu_torch.obs.logging import Logger, get_logger


def extract_correlation_ids(context: dict[str, Any] | None) -> list[str]:
    """Normalize the correlation ids out of a report context: accepts
    ``correlation_id`` (one) and/or ``correlation_ids`` (many) and
    returns a de-duplicated, order-preserving list. Every reporter
    driver uses this so an engine error names the requests in flight
    the same way regardless of where the report lands."""
    if not context:
        return []
    ids: list[str] = []
    one = context.get("correlation_id")
    if one:
        ids.append(str(one))
    many = context.get("correlation_ids")
    if isinstance(many, (list, tuple)):
        ids.extend(str(c) for c in many if c)
    elif many:
        ids.append(str(many))
    seen: set[str] = set()
    out = []
    for c in ids:
        if c not in seen:
            seen.add(c)
            out.append(c)
    return out


class ErrorReporter(abc.ABC):
    @abc.abstractmethod
    def report(self, exc: BaseException, context: dict[str, Any] | None = None) -> None: ...


class ConsoleErrorReporter(ErrorReporter):
    def __init__(self, logger: Logger | None = None):
        self.logger = logger or get_logger()

    def report(self, exc, context=None):
        self.logger.error(
            "unhandled error",
            error=str(exc),
            error_type=type(exc).__name__,
            traceback="".join(traceback.format_exception(exc)),
            **(context or {}),
        )


class SilentErrorReporter(ErrorReporter):
    def report(self, exc, context=None):
        pass


class CollectingErrorReporter(ErrorReporter):
    """Stores reports for assertions in tests."""

    def __init__(self):
        self.reports: list[tuple[BaseException, dict]] = []

    def report(self, exc, context=None):
        self.reports.append((exc, dict(context or {})))


class HTTPErrorReporter(ErrorReporter):
    """Sentry-role driver: POST error events to a tracking endpoint.

    Shapes the event like an error tracker expects (type, message,
    stacktrace, fingerprint, tags, timestamp), dedup-rate-limits by
    fingerprint (at most one send per ``min_interval_s`` per distinct
    error site), sends from a background thread with a bounded queue,
    and degrades to the console reporter when the endpoint is down —
    an outage of the tracker must never cascade into the pipeline.
    """

    def __init__(self, endpoint: str, *, release: str = "",
                 environment: str = "production",
                 min_interval_s: float = 60.0, queue_size: int = 256,
                 timeout_s: float = 5.0,
                 fallback: ErrorReporter | None = None):
        import collections

        self.endpoint = endpoint
        self.release = release
        self.environment = environment
        self.min_interval_s = min_interval_s
        self.timeout_s = timeout_s
        self.fallback = fallback or ConsoleErrorReporter()
        self._last_sent: dict[str, float] = {}
        self._queue: "collections.deque[dict]" = collections.deque(
            maxlen=queue_size)
        self._wake = threading.Event()
        self.sent = 0
        self.suppressed = 0
        self._thread = threading.Thread(target=self._pump, daemon=True,
                                        name="error-reporter")
        self._thread.start()

    @staticmethod
    def _fingerprint(exc: BaseException) -> str:
        tb = exc.__traceback__
        frames = []
        while tb is not None:
            frames.append(f"{tb.tb_frame.f_code.co_filename}:"
                          f"{tb.tb_frame.f_code.co_name}")
            tb = tb.tb_next
        raw = f"{type(exc).__name__}|{'|'.join(frames[-5:])}"
        return hashlib.sha256(raw.encode()).hexdigest()[:16]

    def report(self, exc, context=None):
        fp = self._fingerprint(exc)
        now = time.time()
        if now - self._last_sent.get(fp, 0.0) < self.min_interval_s:
            self.suppressed += 1
            return
        self._last_sent[fp] = now
        event = {
            "timestamp": now,
            "fingerprint": fp,
            "error_type": type(exc).__name__,
            "message": str(exc),
            "stacktrace": "".join(traceback.format_exception(exc)),
            "release": self.release,
            "environment": self.environment,
            "tags": {k: str(v) for k, v in (context or {}).items()},
        }
        # Correlation ids are first-class on the event (not flattened
        # into a tag string): the error tracker's UI joins them against
        # the logstore, and an engine failure's ids name the requests
        # that were in flight (engine/telemetry.py flight recorder).
        ids = extract_correlation_ids(context)
        if ids:
            event["correlation_ids"] = ids
        self._queue.append(event)
        self._wake.set()

    def _pump(self) -> None:
        import urllib.request

        while True:
            self._wake.wait(1.0)
            self._wake.clear()
            while self._queue:
                event = self._queue.popleft()
                req = urllib.request.Request(
                    self.endpoint, method="POST",
                    data=json.dumps(event).encode(),
                    headers={"Content-Type": "application/json"})
                try:
                    with urllib.request.urlopen(
                            req, timeout=self.timeout_s):
                        self.sent += 1
                except Exception:
                    # OSError covers the common network failures, but a
                    # schemeless endpoint (ValueError) or a malformed
                    # response (http.client.HTTPException) must not kill
                    # the sender thread either — a dead pump silently
                    # disables error reporting forever.
                    # endpoint down: hand the event to the fallback and
                    # drop the rest of this batch rather than spin
                    try:
                        self.fallback.report(
                            RuntimeError(event["message"]),
                            {"error_type": event["error_type"],
                             "via": "http_reporter_fallback"})
                    except Exception:
                        pass
                    break


def create_error_reporter(config: Any = None) -> ErrorReporter:
    cfg = dict(config or {})
    driver = cfg.get("driver", "console")
    if driver == "console":
        return ConsoleErrorReporter()
    if driver == "silent":
        return SilentErrorReporter()
    if driver == "collecting":
        return CollectingErrorReporter()
    if driver == "http":
        endpoint = cfg.get("endpoint")
        if not endpoint:
            raise ValueError("http error_reporter needs an endpoint")
        return HTTPErrorReporter(
            endpoint,
            release=cfg.get("release", ""),
            environment=cfg.get("environment", "production"),
            min_interval_s=float(cfg.get("min_interval_s", 60.0)))
    raise ValueError(f"unknown error_reporter driver {driver!r}")
