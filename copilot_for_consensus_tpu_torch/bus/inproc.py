"""In-process topic broker: the default bus for single-host pipelines and
tests.

Implements the same observable semantics as the reference's RabbitMQ setup
(topic exchange ``copilot.events``, one durable queue per routing key,
manual ack / nack-requeue, redelivery cap with dead-lettering —
``rabbitmq_subscriber.py:504-560``) without a broker process. Publishers and
subscribers rendezvous on a named broker in a process-global registry.

Delivery modes:
* ``drain()`` — pump queues until empty on the caller's thread (tests and
  the single-process pipeline runner);
* ``start_consuming()`` — blocking loop with a condition variable (service
  deployments, one consumer thread per service).
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Mapping

from copilot_for_consensus_tpu_torch.bus.base import (
    EventCallback,
    EventPublisher,
    EventSubscriber,
    PoisonEnvelope,
)

DEFAULT_EXCHANGE = "copilot.events"
DLQ_SUFFIX = ".dlq"


@dataclass
class _Queue:
    """One queue per (routing_key, group): groups model RabbitMQ's
    queue-per-service topology — different groups each get a copy of every
    message (fan-out, e.g. SourceDeletionRequested cleaned up by every
    stage), while consumers inside one group compete round-robin (N
    replicas of one service sharing its queue)."""

    routing_key: str
    group: str
    items: deque = field(default_factory=deque)  # (envelope, redeliveries)
    callbacks: list[EventCallback] = field(default_factory=list)
    rr_next: int = 0  # round-robin cursor over competing consumers

    @property
    def name(self) -> str:
        return self.routing_key


class InProcBroker:
    def __init__(self, name: str = DEFAULT_EXCHANGE, max_redeliveries: int = 3):
        self.name = name
        self.max_redeliveries = max_redeliveries
        self._queues: dict[tuple[str, str], _Queue] = {}
        self._pending: dict[str, deque] = {}   # published before any bind
        self._lock = threading.RLock()
        self._work = threading.Condition(self._lock)
        self.published_count = 0
        self.dead_lettered: list[tuple[str, Mapping[str, Any]]] = []

    def queue(self, routing_key: str, group: str = "default") -> _Queue:
        with self._lock:
            key = (routing_key, group)
            if key not in self._queues:
                q = _Queue(routing_key, group)
                # First queue on this key inherits messages parked before
                # any consumer was bound (topic exchanges drop these;
                # in-proc keeps them so publish-then-subscribe works).
                parked = self._pending.pop(routing_key, None)
                if parked:
                    q.items.extend(parked)
                self._queues[key] = q
            return self._queues[key]

    def _group_queues(self, routing_key: str) -> list[_Queue]:
        return [q for (rk, _), q in self._queues.items()
                if rk == routing_key]

    def publish(self, envelope: Mapping[str, Any], routing_key: str) -> None:
        with self._work:
            # Only live queues (with consumers) receive copies; otherwise
            # park, so messages never strand in a dead group's queue.
            queues = [q for q in self._group_queues(routing_key)
                      if q.callbacks]
            if queues:
                for q in queues:
                    q.items.append((dict(envelope), 0))
            else:
                self._pending.setdefault(routing_key,
                                         deque()).append((dict(envelope), 0))
            self.published_count += 1
            self._work.notify_all()

    def bind(self, routing_key: str, callback: EventCallback,
             group: str = "default") -> None:
        with self._lock:
            self.queue(routing_key, group).callbacks.append(callback)

    def unbind(self, routing_key: str, callback: EventCallback,
               group: str = "default") -> None:
        with self._lock:
            q = self._queues.get((routing_key, group))
            if q is None:
                return
            if callback in q.callbacks:
                q.callbacks.remove(callback)
            if not q.callbacks:
                # Last consumer gone: drop the queue and re-park its
                # undelivered messages for the next subscriber.
                del self._queues[(routing_key, group)]
                if q.items:
                    self._pending.setdefault(routing_key,
                                             deque()).extend(q.items)

    def queue_depth(self, routing_key: str) -> int:
        with self._lock:
            total = len(self._pending.get(routing_key, ()))
            return total + sum(len(q.items)
                               for q in self._group_queues(routing_key))

    def routing_key_depths(self) -> dict[str, int]:
        """Snapshot of every known routing key's depth (bound queues plus
        parked pre-bind messages) — the metrics/ops introspection surface,
        so callers never reach into broker internals."""
        with self._lock:
            keys = {rk for rk, _ in self._queues} | set(self._pending)
            return {rk: self.queue_depth(rk) for rk in sorted(keys)}

    def consumer_depths(self) -> dict[str, int]:
        """Work a LIVE consumer group is behind on: worst bound-queue
        depth per routing key, parked pre-bind retention EXCLUDED —
        parity with the durable broker's backpressure depth
        (``_QueueStore._depth_locked``). Counting parked rows here
        would make watermark pacing stall forever against keys nothing
        consumes by design (``report.published``, ``*.failed``)."""
        with self._lock:
            out: dict[str, int] = {}
            for (rk, _g), q in self._queues.items():
                out[rk] = max(out.get(rk, 0), len(q.items))
            return out

    def _pop_ready(self) -> tuple[_Queue, Mapping[str, Any], int, EventCallback] | None:
        with self._lock:
            for q in self._queues.values():
                if q.items and q.callbacks:
                    envelope, redeliveries = q.items.popleft()
                    cb = q.callbacks[q.rr_next % len(q.callbacks)]
                    q.rr_next += 1
                    return q, envelope, redeliveries, cb
        return None

    def _dispatch_one(self) -> bool:
        """Deliver one message; returns False when nothing is deliverable."""
        ready = self._pop_ready()
        if ready is None:
            return False
        q, envelope, redeliveries, cb = ready
        if redeliveries:
            from copilot_for_consensus_tpu_torch.obs import trace

            # requeued delivery: annotate the attempt so the stage
            # span records the retry (same parent, never an orphan)
            trace.annotate_delivery(envelope, redeliveries)
        try:
            cb(envelope)  # normal return = ack
        except PoisonEnvelope:
            # Deterministic failure (schema-invalid / non-retryable
            # handler error): redelivery cannot fix it — skip the
            # budget and dead-letter immediately (poison quarantine,
            # same contract as the durable broker's poison nack).
            # publish() takes the broker lock itself and the
            # dead-letter list append is GIL-atomic, so neither runs
            # inside the critical section.
            self.dead_lettered.append((q.name, envelope))
            self.publish(envelope, q.name + DLQ_SUFFIX)
        except Exception:
            if redeliveries + 1 >= self.max_redeliveries:
                self.dead_lettered.append((q.name, envelope))
                self.publish(envelope, q.name + DLQ_SUFFIX)
            else:
                with self._work:
                    q.items.append((envelope, redeliveries + 1))
                    self._work.notify_all()
        return True

    def drain(self, max_messages: int | None = None) -> int:
        """Dispatch until all bound queues are empty. Returns message count.

        Messages whose handlers publish more messages are processed too —
        this runs the whole event cascade to quiescence.
        """
        n = 0
        while max_messages is None or n < max_messages:
            if not self._dispatch_one():
                break
            n += 1
        return n

    def run_forever(self, stop_flag: threading.Event) -> None:
        while not stop_flag.is_set():
            if not self._dispatch_one():
                with self._work:
                    self._work.wait(timeout=0.1)


_BROKERS: dict[str, InProcBroker] = {}
_BROKERS_LOCK = threading.Lock()


def get_broker(name: str = DEFAULT_EXCHANGE) -> InProcBroker:
    with _BROKERS_LOCK:
        if name not in _BROKERS:
            _BROKERS[name] = InProcBroker(name)
        return _BROKERS[name]


def reset_broker(name: str = DEFAULT_EXCHANGE) -> None:
    with _BROKERS_LOCK:
        _BROKERS.pop(name, None)


class InProcPublisher(EventPublisher):
    def __init__(self, config: Any = None, broker: InProcBroker | None = None):
        cfg = dict(config or {})
        self.broker = broker or get_broker(cfg.get("exchange", DEFAULT_EXCHANGE))
        # Depth-watermark saturation surface (driver parity with
        # BrokerPublisher): in-proc consumption shares the publisher's
        # thread, so there is no pacing WAIT here — just the signal the
        # services' throttle hook and the ingestion pacer read.
        self.high_watermark = int(cfg.get("high_watermark", 0) or 0)

    def publish_envelope(self, envelope, routing_key=None):
        if routing_key is None:
            from copilot_for_consensus_tpu_torch.core.events import EVENT_TYPES

            cls = EVENT_TYPES.get(envelope.get("event_type", ""))
            routing_key = cls.routing_key if cls else "unrouted"
        from copilot_for_consensus_tpu_torch.obs import trace

        # trace-context stamp (first publish only — requeues keep it)
        self.broker.publish(trace.inject(envelope, routing_key),
                            routing_key)

    def saturation(self) -> dict[str, int]:
        if not self.high_watermark:
            return {}
        return {rk: d for rk, d in self.broker.consumer_depths().items()
                if d >= self.high_watermark}

    def pending_depths(self) -> dict[str, int]:
        # consumer_depths, not routing_key_depths: the pacing surface
        # must not count parked pre-bind retention (unconsumed terminal
        # keys would read saturated forever and stall ingestion).
        return self.broker.consumer_depths()


class InProcSubscriber(EventSubscriber):
    """``group`` (config key or kwarg) names this consumer's queue group:
    subscribers sharing a group compete for messages (service replicas);
    distinct groups each receive every message (distinct services)."""

    def __init__(self, config: Any = None, broker: InProcBroker | None = None,
                 group: str | None = None):
        cfg = dict(config or {})
        self.broker = broker or get_broker(cfg.get("exchange", DEFAULT_EXCHANGE))
        self.group = group or cfg.get("group") or f"sub-{id(self):x}"
        self._bound: list[tuple[str, EventCallback]] = []
        self._stop = threading.Event()

    def subscribe(self, routing_keys, callback):
        for rk in routing_keys:
            self.broker.bind(rk, callback, group=self.group)
            self._bound.append((rk, callback))

    def start_consuming(self):
        self._stop.clear()
        self.broker.run_forever(self._stop)

    def drain(self, max_messages: int | None = None) -> int:
        return self.broker.drain(max_messages)

    def stop(self):
        self._stop.set()

    def close(self):
        self.stop()
        for rk, cb in self._bound:
            self.broker.unbind(rk, cb, group=self.group)
        self._bound.clear()
