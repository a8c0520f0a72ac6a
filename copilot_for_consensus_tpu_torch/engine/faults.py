"""Deterministic seeded fault-injection plane for the serving engines.

The reference pipeline gets crash isolation for free from its broker:
when an external inference container dies, RabbitMQ redelivers and
nothing is lost (SURVEY §0). Our in-process engine has no such safety
net — and, before this module, no way to even *exercise* its failure
paths: a device fault, a hung dispatch, or a poisoned step could only
be observed in production. This is the fault plane the chaos harness
(``tests/test_engine_chaos.py``, ``BENCH_PRESET=chaos``) scripts
against, and the supervisor (``engine/supervisor.py``) recovers from.

Design constraints:

* **Host-boundary only.** Faults fire at the engine's host-side
  dispatch boundaries (``GenerationEngine._dispatch_boundary``) —
  BEFORE the jitted program runs — never inside traced/compiled code.
  An :class:`InjectedFault` therefore guarantees
  ``device_state_intact=True``: the KV cache, block pool and params
  were never touched, which the supervisor's containment logic uses to
  skip the device-state-suspect repairs a real failure needs.
* **Deterministic and scriptable.** A :class:`FaultPlan` is a list of
  :class:`FaultSpec` entries keyed by dispatch kind and per-kind
  occurrence index (1-based), plus an optional seeded-random fire rate
  — the same plan and seed always fire the same faults in the same
  order, so a chaos run is reproducible and its surviving outputs can
  be asserted bit-identical against a fault-free run. Plans round-trip
  through ``to_dict``/``from_dict`` so the bench can take one from an
  env knob.
* **Stop-aware hangs.** ``mode="hang"`` blocks on an ``Event.wait``
  (never a bare ``time.sleep`` — the jaxlint ``blocking-call`` rule is
  the law here too) for ``hang_s`` and then raises, so the watchdog
  sees a genuinely stuck dispatch while tests and ``stop()`` can
  release the hang early via :meth:`FaultInjector.release_hangs`.

Kinds are free-form strings; the engines wire the dispatch kinds they
own (``prefill``/``prefill_seeded``/``prefill_chunk``/``decode``/
``verify``/``piggyback``/``embed``) plus the host boundaries
``tokenize`` and ``prefix_publish``. Everything here is import-light
host code (no jax).
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field

#: dispatch kinds the engines wire fault points for (doc + test anchor;
#: plans may name any kind — unknown kinds simply never fire)
FAULT_KINDS = ("prefill", "prefill_seeded", "prefill_chunk", "decode",
               "verify", "piggyback", "embed", "tokenize",
               "prefix_publish")

#: spec.count value meaning "every occurrence from `at` on, forever"
PERSISTENT = -1


class InjectedFault(RuntimeError):
    """A scripted fault fired by the injection plane.

    Raised at the HOST dispatch boundary, before any jitted program
    ran — ``device_state_intact`` tells the supervisor that the KV
    cache/pool survived and device-state-suspect repairs (prefix-pool
    flush) can be skipped."""

    #: class-level so classification works on the type alone
    device_state_intact = True

    def __init__(self, message: str, *, kind: str = "",
                 mode: str = "error", occurrence: int = 0):
        super().__init__(message)
        self.kind = kind
        self.mode = mode
        self.occurrence = occurrence


@dataclass(frozen=True)
class FaultSpec:
    """One scripted fault: fire on dispatch kind ``kind`` (``"*"`` =
    any kind) starting at the ``at``-th occurrence (1-based, counted
    per kind), for ``count`` consecutive occurrences (transient;
    ``PERSISTENT``/-1 = persistent until cleared). ``rate`` switches
    to seeded-random firing instead (probability per occurrence, drawn
    from the plan's seeded RNG — deterministic for a given seed)."""

    kind: str
    mode: str = "error"          # "error" | "hang"
    at: int = 1
    count: int = 1
    rate: float = 0.0
    hang_s: float = 0.0
    message: str = ""

    def __post_init__(self):
        if self.mode not in ("error", "hang"):
            raise ValueError(
                f"unknown fault mode {self.mode!r}; 'error' or 'hang'")
        if self.at < 1:
            raise ValueError(f"at must be >= 1 (1-based), got {self.at}")
        if self.count != PERSISTENT and self.count < 1:
            raise ValueError(
                f"count must be >= 1 or PERSISTENT (-1), got {self.count}")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")
        if self.mode == "hang" and self.hang_s <= 0.0:
            raise ValueError("hang faults need hang_s > 0")

    def fires_at(self, occurrence: int) -> bool:
        """Occurrence-indexed matching (rate-based specs are decided by
        the injector's seeded RNG instead)."""
        if self.rate > 0.0:
            return False
        if occurrence < self.at:
            return False
        return self.count == PERSISTENT \
            or occurrence < self.at + self.count

    def as_dict(self) -> dict:
        return {"kind": self.kind, "mode": self.mode, "at": self.at,
                "count": self.count, "rate": self.rate,
                "hang_s": self.hang_s, "message": self.message}


@dataclass
class FaultPlan:
    """A scriptable, seeded set of fault specs (JSON-able)."""

    specs: list[FaultSpec] = field(default_factory=list)
    seed: int = 0

    def to_dict(self) -> dict:
        return {"seed": self.seed,
                "specs": [s.as_dict() for s in self.specs]}

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        return cls(specs=[FaultSpec(**s) for s in d.get("specs", [])],
                   seed=int(d.get("seed", 0)))


class FaultInjector:
    """Runtime state of one plan: per-kind occurrence counters, the
    seeded RNG for rate-based specs, a fired log, and the hang-release
    event. Thread-safe (boundary checks come from whichever thread
    owns the engine; tests and ``stop()`` release hangs from others).
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._counts: dict[str, int] = {}
        self._rng = random.Random(plan.seed)
        self._lock = threading.Lock()
        #: set() to release any in-progress (and all future) hangs —
        #: stop()/teardown must never wait out a scripted hang
        self._release = threading.Event()
        #: cleared kinds no longer fire (the chaos harness clears the
        #: persistent verify fault to exercise the half-open probe)
        self._cleared: set[str] = set()
        #: fired log [(kind, occurrence, mode)] — the harness asserts
        #: the plan actually exercised what it scripted
        self.fired: list[tuple[str, int, str]] = []

    def occurrences(self, kind: str) -> int:
        with self._lock:
            return self._counts.get(kind, 0)

    def clear(self, kind: str | None = None) -> None:
        """Stop firing for ``kind`` (None = every kind): how a chaos
        script ends a persistent fault so recovery paths (breaker
        half-open probes) can be exercised."""
        with self._lock:
            if kind is None:
                self._cleared.update({s.kind for s in self.plan.specs})
                self._cleared.add("*")
            else:
                self._cleared.add(kind)

    def release_hangs(self) -> None:
        """Release any in-progress injected hang immediately (and turn
        every future hang into an instant fault). Called by
        ``AsyncEngineRunner.stop()`` so shutdown never waits out a
        scripted hang."""
        self._release.set()

    def check(self, kind: str) -> None:
        """The fault point: called by the engine at each host dispatch
        boundary. Counts the occurrence and raises / hangs per the
        plan; a no-match returns instantly (one dict op + a few
        compares — cheap enough to leave wired in production where the
        injector is simply ``None``)."""
        with self._lock:
            occ = self._counts.get(kind, 0) + 1
            self._counts[kind] = occ
            spec = self._match(kind, occ)
            if spec is not None:
                self.fired.append((kind, occ, spec.mode))
        if spec is None:
            return
        msg = spec.message or (f"injected {spec.mode} fault: kind="
                               f"{kind} occurrence={occ}")
        if spec.mode == "hang":
            # Stop-aware artificial hang: the dispatch boundary blocks
            # (the watchdog sees a stuck dispatch), then fails — a hang
            # that "resolved" into success would hide the zombie-work
            # path the supervisor must handle anyway.
            self._release.wait(spec.hang_s)
            raise InjectedFault(msg + f" (hung {spec.hang_s:.2f}s)",
                                kind=kind, mode="hang", occurrence=occ)
        raise InjectedFault(msg, kind=kind, mode="error", occurrence=occ)

    def _match(self, kind: str, occ: int) -> FaultSpec | None:
        for spec in self.plan.specs:
            if spec.kind not in (kind, "*"):
                continue
            if spec.kind in self._cleared or "*" in self._cleared:
                continue
            if spec.rate > 0.0:
                # Seeded-random firing: the RNG draw happens for every
                # matching occurrence so the decision sequence depends
                # only on (seed, call sequence) — deterministic replay.
                if self._rng.random() < spec.rate:
                    return spec
                continue
            if spec.fires_at(occ):
                return spec
        return None

    def stats(self) -> dict:
        with self._lock:
            return {
                "fired": len(self.fired),
                "by_kind": dict(self._counts),
                "log": [{"kind": k, "occurrence": o, "mode": m}
                        for k, o, m in self.fired],
            }


def resolve_faults(faults) -> FaultInjector | None:
    """Engine-side ``faults=`` argument semantics (mirrors
    ``telemetry.resolve_telemetry``): None/False disables, a
    :class:`FaultInjector` is shared as-is (one plan across engines —
    how the chaos preset faults generate and embed together), a
    :class:`FaultPlan` or a spec list builds an injector."""
    if faults is None or faults is False:
        return None
    if isinstance(faults, FaultInjector):
        return faults
    if isinstance(faults, FaultPlan):
        return FaultInjector(faults)
    if isinstance(faults, (list, tuple)):
        return FaultInjector(FaultPlan(specs=list(faults)))
    raise ValueError(
        f"faults must be None, FaultPlan, FaultInjector or a FaultSpec "
        f"list, got {type(faults).__name__}")
