"""Startup requeue: forward progress after crashes.

Parity with the reference's ``copilot_startup/startup_requeue.py:19,44`` —
on service boot, scan the document store for documents stuck mid-pipeline
(status flag unset) and re-publish their trigger events so work lost to a
crash between DB-write and bus-publish is resumed.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

from copilot_for_consensus_tpu_torch.bus.base import EventPublisher
from copilot_for_consensus_tpu_torch.core.events import Event
from copilot_for_consensus_tpu_torch.obs.logging import Logger, get_logger
from copilot_for_consensus_tpu_torch.storage.base import DocumentStore


class StartupRequeue:
    def __init__(self, store: DocumentStore, publisher: EventPublisher,
                 logger: Logger | None = None):
        self.store = store
        self.publisher = publisher
        self.logger = logger or get_logger()

    def requeue_incomplete(
        self,
        collection: str,
        query: Mapping[str, Any],
        event_factory: Callable[[dict], Event],
        *,
        limit: int | None = None,
    ) -> int:
        """Re-publish the event for every document matching ``query``.

        ``event_factory`` maps a stuck document to its trigger event.
        Returns the number of events re-published.
        """
        stuck = self.store.query_documents(collection, query, limit=limit)
        for doc in stuck:
            self.publisher.publish(event_factory(doc))
        if stuck:
            self.logger.info(
                "startup requeue",
                collection=collection, requeued=len(stuck),
            )
        return len(stuck)
