"""In-process event retry for event-vs-DB visibility races.

Parity with the reference's ``copilot_event_retry`` package
(``event_handler.py:48`` / ``retry_policy.py:14-31``): an event can arrive
before the document write it refers to is visible; handlers raise
``DocumentNotFoundError`` (or any ``RetryableError``) and the wrapper retries
with exponential backoff + full jitter, up to ``max_attempts``, then raises
``RetryExhaustedError`` carrying dead-letter info for the `.failed` queue.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Any, Callable

from copilot_for_consensus_tpu_torch.core.factory import register_driver


class RetryableError(Exception):
    """Base class for errors that should trigger an in-process retry."""


class DocumentNotFoundError(RetryableError):
    """The document referenced by an event is not visible in the store yet."""


class RetryExhaustedError(Exception):
    """All retry attempts failed; carries dead-letter context."""

    def __init__(self, message: str, *, attempts: int, last_error: BaseException,
                 event_type: str = "", dlq_info: dict[str, Any] | None = None):
        super().__init__(message)
        self.attempts = attempts
        self.last_error = last_error
        self.event_type = event_type
        self.dlq_info = dlq_info or {}


@dataclass(frozen=True)
class RetryConfig:
    max_attempts: int = 8
    base_delay: float = 0.05
    max_delay: float = 5.0
    jitter: str = "full"  # "full" | "none"
    ttl_seconds: float | None = None  # wall-clock budget across attempts


@dataclass
class RetryPolicy:
    config: RetryConfig = field(default_factory=RetryConfig)
    sleep: Callable[[float], None] = time.sleep
    rng: random.Random = field(default_factory=random.Random)

    def delay_for(self, attempt: int) -> float:
        """Delay before attempt ``attempt`` (1-based; no delay before first)."""
        raw = min(self.config.base_delay * (2 ** (attempt - 1)), self.config.max_delay)
        if self.config.jitter == "full":
            return self.rng.uniform(0.0, raw)
        return raw

    def run(self, fn: Callable[[], Any], *, event_type: str = "",
            on_retry: Callable[[int, BaseException], None] | None = None) -> Any:
        start = time.monotonic()
        last: BaseException | None = None
        for attempt in range(1, max(1, self.config.max_attempts) + 1):
            try:
                return fn()
            except RetryableError as exc:
                last = exc
                if attempt >= self.config.max_attempts:
                    break
                if (self.config.ttl_seconds is not None
                        and time.monotonic() - start > self.config.ttl_seconds):
                    break
                if on_retry is not None:
                    on_retry(attempt, exc)
                self.sleep(self.delay_for(attempt))
        assert last is not None
        raise RetryExhaustedError(
            f"retries exhausted for {event_type or 'handler'}: {last}",
            attempts=attempt, last_error=last, event_type=event_type,
            dlq_info={"error": str(last), "error_type": type(last).__name__,
                      "attempts": attempt},
        )


def handle_event_with_retry(handler: Callable[[dict], Any], envelope: dict,
                            policy: RetryPolicy | None = None) -> Any:
    """Run ``handler(envelope)`` under the retry policy."""
    policy = policy or RetryPolicy()
    return policy.run(lambda: handler(envelope),
                      event_type=envelope.get("event_type", ""))


def create_event_retry(config: Any = None) -> RetryPolicy:
    cfg = dict(config or {})
    driver = cfg.get("driver", "default")
    if driver == "noop":
        return RetryPolicy(RetryConfig(max_attempts=1))
    return RetryPolicy(RetryConfig(
        max_attempts=max(1, int(cfg.get("max_attempts", 8))),
        base_delay=float(cfg.get("base_delay", 0.05)),
        max_delay=float(cfg.get("max_delay", 5.0)),
        jitter=cfg.get("jitter", "full"),
        ttl_seconds=cfg.get("ttl_seconds"),
    ))


register_driver("event_retry", "default", create_event_retry)
register_driver("event_retry", "noop", create_event_retry)
