"""Deterministic seeded fault-injection plane for the PIPELINE boundaries.

PR 7 gave the serving engines a fault plane (``engine/faults.py``) and
the machinery to survive what it injects. This module extends the same
vocabulary — :class:`FaultSpec` / :class:`FaultPlan` (kind, error|hang,
occurrence-window or seeded rate, JSON round-trip) driven by one
:class:`FaultInjector` — to the host-side pipeline's I/O boundaries, so
the pipeline chaos harness (``tests/test_bus_resilience.py``,
``BENCH_PRESET=pipeline_chaos``) can script broker outages, store
hiccups and poison traffic deterministically.

Boundaries (the :data:`PIPELINE_FAULT_KINDS`):

* ``publish`` / ``fetch`` / ``ack`` — the broker client boundaries.
  Wired directly into :class:`~.broker.BrokerPublisher` /
  :class:`~.broker.BrokerSubscriber` (attribute ``faults``): an
  injected ``publish`` fault is handled exactly like a broker outage
  (the envelope parks in the publish outbox and replays), an injected
  ``fetch`` fault surfaces as :class:`~.base.PublishError` (the
  consume loop backs off and reconnects), an injected ``ack`` fault
  suppresses the ack so the lease expires and the message redelivers —
  the at-least-once path a consumer crash takes.
* ``store_write`` / ``vector_upsert`` / ``archive_read`` — the storage
  boundaries, injected via the wrapper classes below
  (:class:`FaultingDocumentStore`, :class:`FaultingVectorStore`,
  :class:`FaultingArchiveStore`).

Transient vs terminal: storage faults default to **transient**
(:class:`TransientPipelineFault` is a :class:`RetryableError`, so the
service retry policy backs off and the lease/redelivery path applies);
kinds listed in ``terminal_kinds`` raise the non-retryable
:class:`PipelineFaultError` instead — which the subscriber classifies
as poison and quarantines straight to the broker dead-letter table
(``docs/RESILIENCE.md`` poison-vs-transient table).

Everything here is import-light host code (no jax, no zmq).
"""

from __future__ import annotations

from typing import Iterable

from copilot_for_consensus_tpu_torch.core.retry import RetryableError
from copilot_for_consensus_tpu_torch.engine.faults import (  # noqa: F401  (re-export)
    PERSISTENT,
    FaultInjector,
    FaultPlan,
    FaultSpec,
    InjectedFault,
    resolve_faults,
)

#: pipeline boundaries the bus/storage layers wire fault points for
#: (doc + test anchor; plans may name any kind — unknown kinds simply
#: never fire)
PIPELINE_FAULT_KINDS = ("publish", "fetch", "ack", "store_write",
                        "vector_upsert", "archive_read")


class PipelineFaultError(RuntimeError):
    """A scripted TERMINAL pipeline fault: redelivery cannot fix it, so
    the subscriber's classification sends the envelope straight to the
    dead-letter table (poison quarantine)."""

    def __init__(self, message: str, *, kind: str = "",
                 occurrence: int = 0):
        super().__init__(message)
        self.kind = kind
        self.occurrence = occurrence


class TransientPipelineFault(PipelineFaultError, RetryableError):
    """A scripted TRANSIENT pipeline fault: being a
    :class:`RetryableError` it rides the existing recovery spine —
    in-process retry with backoff, then lease/redelivery."""


class FaultBoundary:
    """One plan's runtime state over the pipeline boundaries.

    Thin adapter over :class:`engine.faults.FaultInjector`: ``check``
    counts the occurrence and translates an :class:`InjectedFault`
    into the pipeline's transient/terminal error classes, preserving
    kind and occurrence (hang mode is inherited unchanged — stop-aware
    ``Event.wait``, released by :meth:`release_hangs`)."""

    def __init__(self, faults, terminal_kinds: Iterable[str] = ()):
        self.injector = resolve_faults(faults)
        self.terminal_kinds = set(terminal_kinds)

    def check(self, kind: str) -> None:
        if self.injector is None:
            return
        try:
            self.injector.check(kind)
        except InjectedFault as exc:
            cls = (PipelineFaultError if kind in self.terminal_kinds
                   else TransientPipelineFault)
            raise cls(str(exc), kind=kind,
                      occurrence=exc.occurrence) from None

    def release_hangs(self) -> None:
        if self.injector is not None:
            self.injector.release_hangs()

    def stats(self) -> dict:
        return {} if self.injector is None else self.injector.stats()


def resolve_boundary(faults, terminal_kinds: Iterable[str] = ()
                     ) -> FaultBoundary | None:
    """``faults=`` argument semantics for the bus/storage wrappers:
    None/False disables; a :class:`FaultBoundary` is shared as-is (one
    plan across publisher + subscriber + stores — how the pipeline
    chaos preset faults every boundary together); anything else goes
    through :func:`engine.faults.resolve_faults`."""
    if faults is None or faults is False:
        return None
    if isinstance(faults, FaultBoundary):
        return faults
    return FaultBoundary(faults, terminal_kinds=terminal_kinds)


class _Wrapper:
    """Delegating base: everything not explicitly intercepted passes
    through to the wrapped object."""

    def __init__(self, inner, faults, terminal_kinds: Iterable[str] = ()):
        self.inner = inner
        self.faults = resolve_boundary(faults, terminal_kinds)

    def _check(self, kind: str) -> None:
        if self.faults is not None:
            self.faults.check(kind)

    def __getattr__(self, name):
        return getattr(self.inner, name)


class FaultingDocumentStore(_Wrapper):
    """Document-store wrapper firing ``store_write`` at every mutating
    call. Reads pass through untouched — a read fault would masquerade
    as the event-vs-DB visibility race the retry policy already
    covers, teaching the harness nothing new."""

    def upsert_document(self, collection, doc):
        self._check("store_write")
        return self.inner.upsert_document(collection, doc)

    def insert_document(self, collection, doc):
        self._check("store_write")
        return self.inner.insert_document(collection, doc)

    def insert_or_ignore(self, collection, doc):
        self._check("store_write")
        return self.inner.insert_or_ignore(collection, doc)

    def insert_many(self, collection, docs, ignore_duplicates=False):
        self._check("store_write")
        return self.inner.insert_many(collection, docs,
                                      ignore_duplicates)

    def update_document(self, collection, doc_id, fields):
        self._check("store_write")
        return self.inner.update_document(collection, doc_id, fields)

    def update_documents(self, collection, doc_ids, fields):
        # One boundary check per wave: the batched hot paths pay one
        # store round-trip, so they pay one fault-fire opportunity —
        # a chaos window lands on the whole wave, whose dispatch then
        # isolates per message.
        self._check("store_write")
        return self.inner.update_documents(collection, doc_ids, fields)

    def delete_document(self, collection, doc_id):
        self._check("store_write")
        return self.inner.delete_document(collection, doc_id)

    def delete_documents(self, collection, flt):
        self._check("store_write")
        return self.inner.delete_documents(collection, flt)


class FaultingVectorStore(_Wrapper):
    """Vector-store wrapper firing ``vector_upsert`` on ingest-path
    mutations."""

    def add_embeddings(self, items):
        self._check("vector_upsert")
        return self.inner.add_embeddings(items)

    def delete(self, ids):
        self._check("vector_upsert")
        return self.inner.delete(ids)

    def delete_by_filter(self, flt):
        self._check("vector_upsert")
        return self.inner.delete_by_filter(flt)


class FaultingArchiveStore(_Wrapper):
    """Archive-store wrapper firing ``archive_read`` where parsing
    loads raw bytes (the boundary a blob-store outage hits)."""

    def load(self, archive_id):
        self._check("archive_read")
        return self.inner.load(archive_id)
