"""Structured JSON logging with correlation ids.

Parity with ``copilot_logging`` (ABC Logger / StdoutLogger JSON-lines).
Correlation ids flow through every pipeline stage so a
document's journey can be traced across services from the logs alone —
the reference's substitute for a distributed tracer (SURVEY.md §5).

The port's copy of the part of the JAX package's ``obs/logging.py`` (which
imports no JAX either) that the async runner of
``copilot_for_consensus_tpu_torch.engine`` calls: the default logger. The
reference's other drivers (silent, memory, shipping) and its config-driven
``create_logger`` come with the first port caller that picks a driver.
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


_default_logger: Logger = StdoutLogger()


def set_default_logger(logger: Logger) -> None:
    global _default_logger
    _default_logger = logger


def get_logger() -> Logger:
    return _default_logger

