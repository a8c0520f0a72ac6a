"""Bus driver registration + create_publisher/create_subscriber helpers.

Parity with ``copilot_message_bus/factory.py:94-144``: construction is
config-driven, and validation wrapping is applied here so services never
instantiate raw drivers.
"""

from __future__ import annotations

from typing import Any

from copilot_for_consensus_tpu_torch.bus.base import NoopPublisher, NoopSubscriber
from copilot_for_consensus_tpu_torch.bus.inproc import InProcPublisher, InProcSubscriber
from copilot_for_consensus_tpu_torch.bus.validating import (
    ValidatingPublisher,
    ValidatingSubscriber,
)
from copilot_for_consensus_tpu_torch.core.factory import register_driver


def create_publisher(config: Any = None, validate: bool = True,
                     faults=None):
    """``faults`` (a ``bus/faults.py`` plan or FaultBoundary) is wired
    into drivers with a fault plane (the broker tier); drivers without
    one ignore it — the chaos harness targets the deployment topology
    it actually storms."""
    cfg = dict(config or {})
    driver = cfg.get("driver", "inproc")
    if driver == "inproc":
        pub = InProcPublisher(cfg)
    elif driver in ("broker", "zmq"):   # zmq kept as a config alias
        from copilot_for_consensus_tpu_torch.bus.broker import BrokerPublisher

        pub = BrokerPublisher(cfg, faults=faults)
    elif driver == "azure_servicebus":
        from copilot_for_consensus_tpu_torch.bus.azure_servicebus import (
            AzureServiceBusPublisher,
        )

        pub = AzureServiceBusPublisher(cfg)
    elif driver == "noop":
        pub = NoopPublisher()
    else:
        raise ValueError(f"unknown message_bus driver {driver!r}")
    return ValidatingPublisher(pub) if validate else pub


def create_subscriber(config: Any = None, validate: bool = True,
                      on_invalid=None, faults=None):
    cfg = dict(config or {})
    driver = cfg.get("driver", "inproc")
    if driver == "inproc":
        sub = InProcSubscriber(cfg)
    elif driver in ("broker", "zmq"):
        from copilot_for_consensus_tpu_torch.bus.broker import BrokerSubscriber

        sub = BrokerSubscriber(cfg, faults=faults)
    elif driver == "azure_servicebus":
        from copilot_for_consensus_tpu_torch.bus.azure_servicebus import (
            AzureServiceBusSubscriber,
        )

        sub = AzureServiceBusSubscriber(cfg)
    elif driver == "noop":
        sub = NoopSubscriber()
    else:
        raise ValueError(f"unknown message_bus driver {driver!r}")
    return ValidatingSubscriber(sub, on_invalid=on_invalid) if validate else sub


for _name in ("inproc", "broker", "zmq", "noop", "azure_servicebus"):
    register_driver("message_bus", _name, create_publisher)
