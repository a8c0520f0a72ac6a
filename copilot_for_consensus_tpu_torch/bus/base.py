"""Publisher/Subscriber ABCs shared by every bus driver."""

from __future__ import annotations

import abc
from typing import Any, Callable, Mapping

from copilot_for_consensus_tpu_torch.core.events import Event

# Callback receives the envelope dict; raising triggers nack/requeue.
EventCallback = Callable[[Mapping[str, Any]], None]

# Batch callback (opt-in, `subscribe_batch`): receives a wave of
# same-routing-key envelopes and returns one outcome per envelope IN
# ORDER — None acks; an exception instance classifies exactly like the
# single-dispatch raise (PoisonEnvelope / non-retryable → quarantine,
# RetryableError / PublishError → nack-redeliver). Returning None means
# "all acked". Raising from the callback itself signals a wave-level
# infrastructure failure: drivers fall back to per-envelope dispatch so
# one bad message can never fail its neighbours.
BatchEventCallback = Callable[[list], "list[BaseException | None] | None"]


class PublishError(Exception):
    pass


class BusSaturated(PublishError):
    """Structured backpressure signal: the bus cannot absorb more work.

    Raised by publishers when the durable publish outbox overflows
    (``reason="outbox-full"``) — the caller must slow down or shed;
    also carried (not raised) by ``saturation()`` when a routing key's
    broker-side depth crossed the high watermark
    (``reason="queue-depth"``). Analogue of the engine's
    ``EngineOverloaded``: honest backpressure instead of silent loss.
    """

    def __init__(self, message: str, *, routing_key: str = "",
                 depth: int = 0, limit: int = 0,
                 reason: str = "queue-depth"):
        super().__init__(message)
        self.routing_key = routing_key
        self.depth = depth
        self.limit = limit
        self.reason = reason


class PoisonEnvelope(Exception):
    """Classification signal: this envelope can never be processed, no
    matter how often it redelivers — schema-invalid at the bus edge
    (``bus/validating.py``) or a deterministic (non-``RetryableError``)
    handler failure. Subscriber drivers that support quarantine skip
    the redelivery budget and park it in the dead-letter table with
    ``reason``; drivers without poison support degrade to the normal
    redelivery budget."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class EventPublisher(abc.ABC):
    """Publishes event envelopes to a topic exchange by routing key."""

    def connect(self) -> None:  # drivers override when they hold connections
        pass

    def close(self) -> None:
        pass

    def saturation(self) -> dict[str, int]:
        """Routing keys whose last-known broker-side depth is at/above
        this publisher's high watermark (empty when unconfigured or
        healthy) — the signal services throttle consumption on.
        Drivers without depth feedback return {}."""
        return {}

    def pending_depths(self) -> dict[str, int]:
        """Best-effort snapshot of broker-side pending depth per
        routing key (the ingestion pacing surface). Drivers without an
        introspection channel — or with an unreachable broker —
        return {}."""
        return {}

    @abc.abstractmethod
    def publish_envelope(self, envelope: Mapping[str, Any],
                         routing_key: str | None = None) -> None: ...

    def publish(self, event: Event, routing_key: str | None = None) -> None:
        """Publish a typed event (envelope built + routing key from type)."""
        self.publish_envelope(
            event.to_envelope(), routing_key or type(event).routing_key
        )

    def __enter__(self):
        self.connect()
        return self

    def __exit__(self, *exc):
        self.close()


class EventSubscriber(abc.ABC):
    """Consumes envelopes from queues bound to routing keys.

    Semantics contract (all drivers):
    * one logical queue per routing key; competing subscribers on the same
      queue share work;
    * the callback completing normally acks the message;
    * the callback raising requeues it, up to ``max_redeliveries``, after
      which the envelope goes to the dead-letter queue ``<rk>.dlq``.
    """

    def connect(self) -> None:
        pass

    def close(self) -> None:
        pass

    @abc.abstractmethod
    def subscribe(self, routing_keys: list[str], callback: EventCallback) -> None: ...

    def subscribe_batch(self, routing_keys: list[str],
                        callback: BatchEventCallback) -> bool:
        """Opt-in batch dispatch: register a wave callback for keys the
        subscriber ALSO has a single-envelope route for (the fallback
        path). Returns True when the driver supports batch dispatch;
        this default (drivers without it) is False and registers
        nothing — callers keep the per-envelope path.

        NOTE for wrappers with ``__getattr__`` delegation: this is a
        concrete base-class default, so delegating wrappers must
        forward it explicitly (the race-wrapper-shadow contract)."""
        return False

    @abc.abstractmethod
    def start_consuming(self) -> None:
        """Blocking consume loop (runs until stop())."""

    @abc.abstractmethod
    def stop(self) -> None: ...

    def __enter__(self):
        self.connect()
        return self

    def __exit__(self, *exc):
        self.close()


class NoopPublisher(EventPublisher):
    def publish_envelope(self, envelope, routing_key=None):
        pass


class NoopSubscriber(EventSubscriber):
    def subscribe(self, routing_keys, callback):
        pass

    def start_consuming(self):
        pass

    def stop(self):
        pass
