"""Validating decorators: schema-check every envelope at the bus boundary.

Parity with the reference's ``validating_publisher.py`` /
``validating_subscriber.py`` cross-cutting wrappers — invalid events are
rejected at publish time (raise) and quarantined at consume time (routed to
the subscriber's invalid-event hook instead of the handler).
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

from copilot_for_consensus_tpu_torch.bus.base import (
    EventCallback,
    EventPublisher,
    EventSubscriber,
    PoisonEnvelope,
    PublishError,
)
from copilot_for_consensus_tpu_torch.core.validation import (
    FileSchemaProvider,
    SchemaValidationError,
    validate_envelope,
)


class ValidatingPublisher(EventPublisher):
    def __init__(self, inner: EventPublisher,
                 provider: FileSchemaProvider | None = None):
        self.inner = inner
        self.provider = provider

    def connect(self):
        self.inner.connect()

    def publish_envelope(self, envelope, routing_key=None):
        try:
            validate_envelope(envelope, self.provider)
        except (SchemaValidationError, FileNotFoundError) as exc:
            raise PublishError(f"refusing to publish invalid event: {exc}") from exc
        self.inner.publish_envelope(envelope, routing_key)

    def close(self) -> None:
        # Explicit: the base class's concrete no-op close() would
        # otherwise shadow delegation and leak the inner driver's
        # resources (the broker publisher's outbox + replay thread).
        self.inner.close()

    def saturation(self) -> dict[str, int]:
        # Explicit for the same reason as close(): EventPublisher
        # defines a concrete {} default, so __getattr__ alone would
        # never fire and the wrapper would hide the inner driver's
        # depth feedback — silently disabling the services' consumption
        # throttle and the ingestion pacer in the assembled pipeline
        # (every service publisher is validating-wrapped).
        return self.inner.saturation()

    def pending_depths(self) -> dict[str, int]:
        return self.inner.pending_depths()

    def __getattr__(self, name):
        # Driver capability passthrough (outbox_stats()/faults/...) —
        # same delegation contract as ValidatingSubscriber below. Only
        # covers names the base class does NOT define; anything with a
        # concrete default needs explicit delegation above.
        return getattr(self.inner, name)


class ValidatingSubscriber(EventSubscriber):
    def __init__(self, inner: EventSubscriber,
                 provider: FileSchemaProvider | None = None,
                 on_invalid: Callable[[Mapping[str, Any], Exception], None] | None = None):
        self.inner = inner
        self.provider = provider
        self.on_invalid = on_invalid
        self.invalid_count = 0

    def connect(self):
        self.inner.connect()

    def close(self):
        self.inner.close()

    def subscribe(self, routing_keys, callback: EventCallback):
        def guarded(envelope):
            try:
                validate_envelope(envelope, self.provider)
            except (SchemaValidationError, FileNotFoundError) as exc:
                self.invalid_count += 1
                if self.on_invalid is not None:
                    self.on_invalid(envelope, exc)
                # An invalid event can never become valid by retry:
                # poison-quarantine it (drivers with a dead-letter
                # table park it there with the reason, skipping the
                # redelivery budget) instead of silently acking it out
                # of existence.
                raise PoisonEnvelope(
                    f"schema validation failed: {exc}") from exc
            callback(envelope)

        self.inner.subscribe(routing_keys, guarded)

    def subscribe_batch(self, routing_keys, callback) -> bool:
        """Explicit delegation (the base class defines a concrete
        ``return False`` default — ``__getattr__`` alone would never
        fire, silently disabling batch dispatch through the wrapper):
        validates each envelope of the wave, quarantines the invalid
        ones per-envelope (``PoisonEnvelope`` outcome, same contract as
        the single-dispatch ``guarded`` path), and forwards only the
        valid subset to the service's wave callback."""

        def guarded_batch(envelopes):
            outcomes: list = [None] * len(envelopes)
            valid_idx: list[int] = []
            valid: list = []
            for i, envelope in enumerate(envelopes):
                try:
                    validate_envelope(envelope, self.provider)
                except (SchemaValidationError, FileNotFoundError) as exc:
                    self.invalid_count += 1
                    if self.on_invalid is not None:
                        self.on_invalid(envelope, exc)
                    outcomes[i] = PoisonEnvelope(
                        f"schema validation failed: {exc}")
                else:
                    valid_idx.append(i)
                    valid.append(envelope)
            if valid:
                inner_out = callback(valid)
                if inner_out is None:
                    inner_out = [None] * len(valid)
                for i, out in zip(valid_idx, inner_out):
                    outcomes[i] = out
            return outcomes

        return self.inner.subscribe_batch(routing_keys, guarded_batch)

    def start_consuming(self):
        self.inner.start_consuming()

    def stop(self):
        self.inner.stop()

    def __getattr__(self, name):
        return getattr(self.inner, name)
