"""Stage scale-out: N concurrent consumers per service, one broker group.

The reference scales stages horizontally as replica containers competing
on shared AMQP queues (``docs/architecture/overview.md:358-363``); the
durable broker already implements the competing-consumer contract
(``bus/broker.py``: one queue group per service, lease/ack/nack per
message), but the runner used to wire exactly ONE consume loop per
service — every stage single-threaded regardless of host cores. A
:class:`StageWorkerPool` is the in-process version of the replica set:
each worker owns a PRIVATE subscriber (its own DEALER connection, so
fetch/ack round-trips never serialize on a shared client lock) bound to
the SAME group, and the broker's per-message lease state machine makes
competition safe without any new coordination — the semantics the
PR-8 fault plane proved (poison quarantine, redelivery budgets,
depth-watermark backpressure) hold per message, per worker.

Lifecycle contract (racecheck ``race-thread-lifecycle``): worker loops
are stop-aware (``BrokerSubscriber.start_consuming`` polls its stop
Event between fetches) AND the owner joins them — ``stop()`` flips
every subscriber's stop flag, ``join()`` bounds the wait, so teardown
never races an in-flight dispatch.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Sequence

from copilot_for_consensus_tpu_torch.obs import trace


class StageWorkerPool:
    """Owns one service's worker threads; one subscriber per worker.

    ``subscribers`` share one broker queue group (= the service name),
    so the broker hands each leased message to exactly one worker.
    Worker threads stamp a thread-ambient label (``<service>-w<i>``)
    that rides every stage span they dispatch — tracepath can
    attribute residence per pool member.
    """

    def __init__(self, name: str, subscribers: Sequence[Any],
                 logger: Any = None):
        self.name = name
        self.subscribers = list(subscribers)
        self.logger = logger
        self._threads: list[threading.Thread] = []
        self._lock = threading.Lock()

    @property
    def workers(self) -> int:
        return len(self.subscribers)

    def start(self) -> None:
        """Spawn one consume thread per subscriber (idempotent: a live
        pool is not restarted)."""
        with self._lock:
            if any(t.is_alive() for t in self._threads):
                return
            self._threads = [
                threading.Thread(
                    target=self._run_worker, args=(i, sub),
                    name=f"{self.name}-w{i}", daemon=True)
                for i, sub in enumerate(self.subscribers)]
            threads = list(self._threads)
        for t in threads:
            t.start()

    def _run_worker(self, idx: int, sub: Any) -> None:
        trace.set_worker_label(f"{self.name}-w{idx}")
        try:
            sub.start_consuming()
        finally:
            trace.set_worker_label("")

    def stop(self, timeout: float = 5.0) -> bool:
        """Flip every worker's stop flag (the loops poll it between
        fetches) and JOIN them against one shared deadline. Returns
        True when every worker exited; False when one did not (a hung
        dispatch) — the stuck worker and its current dispatch state
        are logged and the daemon thread abandoned, never silently
        (the ``AsyncEngineRunner.stop()`` contract, and the racecheck
        race-thread-lifecycle discipline: a thread is joined or loudly
        accounted for)."""
        for sub in self.subscribers:
            sub.stop()
        if self.join(timeout=timeout):
            return True
        with self._lock:
            threads = list(self._threads)
        for t, sub in zip(threads, self.subscribers):
            if not t.is_alive():
                continue
            state_fn = getattr(sub, "current_dispatch", None)
            state = (state_fn() if callable(state_fn) else None) \
                or "unknown (no dispatch state on this driver)"
            self._log_stuck(t.name, state, timeout)
        return False

    def _log_stuck(self, worker: str, state: str,
                   timeout: float) -> None:
        log = self.logger
        if log is None:
            try:
                from copilot_for_consensus_tpu_torch.obs.logging import (
                    get_logger,
                )
                log = get_logger()
            except Exception:
                return
        try:
            log.error("stage worker failed to join on stop; daemon "
                      "thread abandoned", pool=self.name,
                      worker=worker, dispatch=state,
                      timeout_s=timeout)
        except Exception:
            pass   # logging must not mask the stuck worker

    def join(self, timeout: float = 5.0) -> bool:
        """Join every worker against ONE shared deadline; True when all
        exited."""
        deadline = time.monotonic() + timeout
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        return not any(t.is_alive() for t in threads)

    def close(self) -> None:
        """stop + join + release every subscriber's connection."""
        self.stop()
        for sub in self.subscribers:
            sub.close()
