"""Message bus abstraction: event pub/sub with pluggable drivers.

Capability parity with the reference's ``copilot_message_bus`` package
(ABCs ``base.py:11,43``; RabbitMQ/AzureServiceBus/Noop drivers; validating
decorators — SURVEY.md §2.1). Drivers here:

* ``inproc`` — a process-local topic broker with durable-queue semantics
  (ack / nack-requeue / redelivery cap / dead-letter), the default for
  single-host runs and tests (the reference's fake-backend strategy, §4);
* ``broker`` (alias ``zmq``) — the inter-process tier: one ZMQ ROUTER
  broker with sqlite-durable queues, publisher confirms, ack/nack-requeue
  leases and dead-lettering (``bus/broker.py``);
* ``noop``  — drops everything.

On TPU pods this host bus is tier 2 of the two-tier comms design
(SURVEY.md §5 "Distributed communication backend"): XLA collectives move
tensors over ICI inside the slice; this bus moves *events* between host
services and the resident TPU engine.
"""

from copilot_for_consensus_tpu_torch.bus.base import (
    EventPublisher,
    EventSubscriber,
    PublishError,
)
from copilot_for_consensus_tpu_torch.bus.broker import (
    Broker,
    BrokerPublisher,
    BrokerSubscriber,
)
from copilot_for_consensus_tpu_torch.bus.inproc import InProcBroker, get_broker

__all__ = [
    "EventPublisher",
    "EventSubscriber",
    "PublishError",
    "Broker",
    "BrokerPublisher",
    "BrokerSubscriber",
    "InProcBroker",
    "get_broker",
]
