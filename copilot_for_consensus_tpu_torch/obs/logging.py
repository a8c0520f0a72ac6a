"""Structured JSON logging with correlation ids.

Parity with ``copilot_logging`` (ABC Logger / StdoutLogger JSON-lines /
SilentLogger). Correlation ids flow through every pipeline stage so a
document's journey can be traced across services from the logs alone —
the reference's substitute for a distributed tracer (SURVEY.md §5).
"""

from __future__ import annotations

import abc
import json
import sys
import threading
import time
from typing import Any, IO

_LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40}


class Logger(abc.ABC):
    @abc.abstractmethod
    def log(self, level: str, message: str, **fields: Any) -> None: ...

    def debug(self, message: str, **fields: Any) -> None:
        self.log("debug", message, **fields)

    def info(self, message: str, **fields: Any) -> None:
        self.log("info", message, **fields)

    def warning(self, message: str, **fields: Any) -> None:
        self.log("warning", message, **fields)

    def error(self, message: str, **fields: Any) -> None:
        self.log("error", message, **fields)

    def bind(self, **fields: Any) -> "BoundLogger":
        return BoundLogger(self, fields)


class BoundLogger(Logger):
    """Logger with pre-bound context fields (service name, correlation id)."""

    def __init__(self, parent: Logger, fields: dict[str, Any]):
        self.parent = parent
        self.fields = fields

    def log(self, level: str, message: str, **fields: Any) -> None:
        self.parent.log(level, message, **{**self.fields, **fields})


class StdoutLogger(Logger):
    """One JSON object per line to stdout (Loki/Promtail-friendly)."""

    def __init__(self, service: str = "", level: str = "info",
                 stream: IO[str] | None = None):
        self.service = service
        self.min_level = _LEVELS.get(level, 20)
        self.stream = stream or sys.stdout
        self._lock = threading.Lock()

    def log(self, level: str, message: str, **fields: Any) -> None:
        if _LEVELS.get(level, 20) < self.min_level:
            return
        record = {
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
            "level": level,
            "service": self.service,
            "message": message,
        }
        record.update(fields)
        line = json.dumps(record, default=str)
        with self._lock:
            self.stream.write(line + "\n")
            self.stream.flush()


class SilentLogger(Logger):
    def log(self, level: str, message: str, **fields: Any) -> None:
        pass


class ShippingLogger(Logger):
    """Tees records to a local logger AND ships them to the logstore
    (``tools/logstore.py`` — the Loki/Promtail role) as JSON lines over
    TCP. Shipping is best-effort: the sink being down must never block
    or crash the pipeline, so sends are background, bounded-queue,
    drop-oldest, with lazy reconnects."""

    def __init__(self, tee: Logger, host: str, port: int,
                 queue_size: int = 4096):
        import collections

        self.tee = tee
        self.host, self.port = host, port
        self._queue: "collections.deque[str]" = collections.deque(
            maxlen=queue_size)
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._sock = None
        self._thread = threading.Thread(target=self._pump, daemon=True,
                                        name="log-shipper")
        self._thread.start()

    def log(self, level: str, message: str, **fields: Any) -> None:
        self.tee.log(level, message, **fields)
        record = {"ts": time.time(), "level": level, "message": message,
                  **fields}
        if isinstance(self.tee, StdoutLogger) and self.tee.service:
            record.setdefault("service", self.tee.service)
        self._queue.append(json.dumps(record, default=str))
        self._wake.set()

    def _pump(self) -> None:
        import socket

        while not self._stop.is_set():
            self._wake.wait(1.0)
            self._wake.clear()
            while self._queue:
                line = self._queue.popleft()
                try:
                    if self._sock is None:
                        self._sock = socket.create_connection(
                            (self.host, self.port), timeout=3)
                    self._sock.sendall(line.encode() + b"\n")
                except OSError:
                    try:
                        if self._sock is not None:
                            self._sock.close()
                    finally:
                        self._sock = None
                    # put it back (front) and back off; the deque's
                    # maxlen sheds oldest records under pressure. The
                    # backoff is stop-aware so close() never waits out
                    # a sleeping shipper thread.
                    self._queue.appendleft(line)
                    if self._stop.wait(1.0):
                        return
                    break

    def close(self) -> None:
        """Stop the shipper thread (unsent records are dropped — the
        shipping contract is best-effort)."""
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=2)
        # swap locally: a pump thread that outlived the join may still
        # set self._sock = None in its error handler
        sock, self._sock = self._sock, None
        if sock is not None:
            sock.close()


class MemoryLogger(Logger):
    """Captures records for assertions in tests."""

    def __init__(self):
        self.records: list[dict[str, Any]] = []

    def log(self, level: str, message: str, **fields: Any) -> None:
        self.records.append({"level": level, "message": message, **fields})


_default_logger: Logger = StdoutLogger()


def set_default_logger(logger: Logger) -> None:
    global _default_logger
    _default_logger = logger


def get_logger() -> Logger:
    return _default_logger


def create_logger(config: Any = None) -> Logger:
    """Config-driven logger construction (drivers: stdout, silent,
    memory, shipping)."""
    cfg = dict(config or {})
    driver = cfg.get("driver", "stdout")
    if driver == "stdout":
        return StdoutLogger(service=cfg.get("service", ""),
                            level=cfg.get("level", "info"))
    if driver == "silent":
        return SilentLogger()
    if driver == "memory":
        return MemoryLogger()
    if driver == "shipping":
        return ShippingLogger(
            StdoutLogger(service=cfg.get("service", ""),
                         level=cfg.get("level", "info")),
            host=cfg.get("host", "127.0.0.1"),
            port=int(cfg.get("port", 5140)))
    raise ValueError(f"unknown logger driver {driver!r}")
