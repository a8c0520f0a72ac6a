"""Metrics collection.

Parity with ``copilot_metrics`` (ABC increment/observe/gauge/safe_push +
Prometheus/Pushgateway/Noop drivers). The Prometheus driver here keeps
counters/histograms/gauges in-process and renders the standard text
exposition format, served by the health server (obs/health.py) — no client
library dependency.
"""

from __future__ import annotations

import abc
import threading
from typing import Any, Iterable

# Top bound must exceed every latency SLO threshold the alert pack uses
# (histogram_quantile caps at the largest finite bucket, so a threshold
# at/above it could never fire).
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                   10.0, 30.0, 60.0, 120.0, 300.0, 600.0)

# Labels the cross-process aggregator (obs/ship.py) stamps onto every
# merged series. A registry that declares them for its own use would be
# silently shadowed at merge time, so registration rejects them up front.
RESERVED_LABELS = ("proc", "role")


def check_registry_labels(registry: dict, owner: str = "") -> dict:
    """Validate a metric registry's declared labels at registration time.

    ``registry`` maps series name -> (type, labels-tuple, help). Raises
    ``ValueError`` if any series declares a label in ``RESERVED_LABELS``
    — the collision must be loud at import, not at scrape time when the
    aggregator stamps ``proc``/``role`` over it. Returns the registry so
    declarations can be wrapped in-place.
    """
    for name, (_typ, labels, _help) in registry.items():
        clash = [lb for lb in labels if lb in RESERVED_LABELS]
        if clash:
            raise ValueError(
                f"metric registry {owner or '<anonymous>'!s} declares "
                f"reserved label(s) {clash} on series {name!r}; "
                f"{RESERVED_LABELS} are stamped by the telemetry "
                f"aggregator and may not be declared by a registry")
    return registry


def _label_key(labels: dict[str, str] | None) -> tuple:
    return tuple(sorted((labels or {}).items()))


class MetricsCollector(abc.ABC):
    @abc.abstractmethod
    def increment(self, name: str, value: float = 1.0,
                  labels: dict[str, str] | None = None) -> None: ...

    @abc.abstractmethod
    def observe(self, name: str, value: float,
                labels: dict[str, str] | None = None) -> None: ...

    @abc.abstractmethod
    def gauge(self, name: str, value: float,
              labels: dict[str, str] | None = None) -> None: ...

    def safe_push(self) -> None:
        """Push to a gateway if this driver pushes; never raises."""


class NoopMetrics(MetricsCollector):
    def increment(self, name, value=1.0, labels=None): ...
    def observe(self, name, value, labels=None): ...
    def gauge(self, name, value, labels=None): ...


class InMemoryMetrics(MetricsCollector):
    """Thread-safe in-process metrics; also the Prometheus renderer."""

    def __init__(self, namespace: str = "copilot"):
        self.namespace = namespace
        self._lock = threading.Lock()
        self.counters: dict[str, dict[tuple, float]] = {}
        self.gauges: dict[str, dict[tuple, float]] = {}
        self.histograms: dict[str, dict[tuple, list]] = {}
        self.buckets = DEFAULT_BUCKETS

    def increment(self, name, value=1.0, labels=None):
        with self._lock:
            series = self.counters.setdefault(name, {})
            key = _label_key(labels)
            series[key] = series.get(key, 0.0) + value

    def gauge(self, name, value, labels=None):
        with self._lock:
            self.gauges.setdefault(name, {})[_label_key(labels)] = value

    def set_counter(self, name, value, labels=None):
        """Set a counter to an absolute value — for scrape-time totals
        read from an external monotonic source (e.g. /proc cpu
        seconds), which must render with counter TYPE metadata so
        ``rate()`` consumers and OpenMetrics linters see a counter."""
        with self._lock:
            self.counters.setdefault(name, {})[_label_key(labels)] = value

    def observe(self, name, value, labels=None):
        with self._lock:
            series = self.histograms.setdefault(name, {})
            key = _label_key(labels)
            if key not in series:
                series[key] = [0.0, 0, [0] * len(self.buckets)]  # sum, count, buckets
            entry = series[key]
            entry[0] += value
            entry[1] += 1
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    entry[2][i] += 1

    def merge_histogram(self, name, labels, dsum, dcount, dbuckets):
        """Merge a pre-bucketed histogram delta into this collector.

        Used by the cross-process aggregator: a shipped spool row carries
        ``(sum, count, cumulative-bucket-counts)`` deltas that must add
        element-wise rather than re-observe (the raw samples are gone).
        ``dbuckets`` must be cumulative counts over ``self.buckets``.
        """
        if len(dbuckets) != len(self.buckets):
            raise ValueError(
                f"histogram {name!r}: bucket layout mismatch "
                f"({len(dbuckets)} vs {len(self.buckets)} bounds)")
        with self._lock:
            series = self.histograms.setdefault(name, {})
            key = _label_key(labels)
            if key not in series:
                series[key] = [0.0, 0, [0] * len(self.buckets)]
            entry = series[key]
            entry[0] += dsum
            entry[1] += dcount
            for i, dc in enumerate(dbuckets):
                entry[2][i] += dc

    # -- accessors ---------------------------------------------------------

    def snapshot(self) -> dict:
        """Deep-copied, lock-consistent view of all series.

        The shipper diffs successive snapshots to build delta rows, so
        the copy must not alias live bucket lists.
        """
        with self._lock:
            return {
                "counters": {n: dict(s) for n, s in self.counters.items()},
                "gauges": {n: dict(s) for n, s in self.gauges.items()},
                "histograms": {
                    n: {k: [e[0], e[1], list(e[2])] for k, e in s.items()}
                    for n, s in self.histograms.items()
                },
            }

    def counter_value(self, name: str, labels: dict[str, str] | None = None) -> float:
        with self._lock:
            return self.counters.get(name, {}).get(_label_key(labels), 0.0)

    def gauge_value(self, name: str, labels: dict[str, str] | None = None) -> float:
        with self._lock:
            return self.gauges.get(name, {}).get(_label_key(labels), 0.0)

    def histogram_stats(self, name: str, labels: dict[str, str] | None = None):
        with self._lock:
            entry = self.histograms.get(name, {}).get(_label_key(labels))
            if entry is None:
                return None
            return {"sum": entry[0], "count": entry[1]}

    # -- Prometheus text exposition ---------------------------------------

    @staticmethod
    def _escape(value: Any) -> str:
        # Label-value escaping per the text exposition format: backslash
        # FIRST (or the escapes it introduces get double-escaped), then
        # quote and newline.
        return (str(value).replace("\\", "\\\\").replace('"', '\\"')
                .replace("\n", "\\n"))

    @staticmethod
    def _fmt_value(value: float) -> str:
        """Sample values per the text format: non-finite floats render
        as ``+Inf``/``-Inf``/``NaN`` — Python's ``str(float('inf'))``
        is ``inf``, which Prometheus rejects as unparsable and drops
        the whole scrape."""
        if value != value:                       # NaN
            return "NaN"
        if value == float("inf"):
            return "+Inf"
        if value == float("-inf"):
            return "-Inf"
        return str(value)

    def _fmt_labels(self, key: tuple, extra: Iterable[tuple] = ()) -> str:
        items = list(key) + list(extra)
        if not items:
            return ""
        body = ",".join(f'{k}="{self._escape(v)}"' for k, v in items)
        return "{" + body + "}"

    def render_prometheus(self) -> str:
        lines: list[str] = []
        ns = self.namespace
        with self._lock:
            for name, series in sorted(self.counters.items()):
                lines.append(f"# TYPE {ns}_{name} counter")
                for key, value in series.items():
                    lines.append(f"{ns}_{name}{self._fmt_labels(key)} "
                                 f"{self._fmt_value(value)}")
            for name, series in sorted(self.gauges.items()):
                lines.append(f"# TYPE {ns}_{name} gauge")
                for key, value in series.items():
                    lines.append(f"{ns}_{name}{self._fmt_labels(key)} "
                                 f"{self._fmt_value(value)}")
            for name, series in sorted(self.histograms.items()):
                lines.append(f"# TYPE {ns}_{name} histogram")
                for key, (total, count, buckets) in series.items():
                    # observe() increments every bucket with bound >= value,
                    # so the stored counts are already cumulative; the +Inf
                    # bucket must equal _count exactly.
                    for bound, bcount in zip(self.buckets, buckets):
                        lines.append(
                            f'{ns}_{name}_bucket{self._fmt_labels(key, [("le", bound)])} {bcount}'
                        )
                    lines.append(
                        f'{ns}_{name}_bucket{self._fmt_labels(key, [("le", "+Inf")])} {count}'
                    )
                    lines.append(f"{ns}_{name}_sum{self._fmt_labels(key)} "
                                 f"{self._fmt_value(total)}")
                    lines.append(f"{ns}_{name}_count{self._fmt_labels(key)} {count}")
        return "\n".join(lines) + "\n"


class PushgatewayMetrics(InMemoryMetrics):
    """In-memory metrics pushed to a Prometheus Pushgateway on safe_push().

    Pipeline services push after each event batch, mirroring the reference
    (``embedding/app/service.py:325-329``). Network errors are swallowed —
    metrics must never take the pipeline down.
    """

    def __init__(self, gateway_url: str, job: str, namespace: str = "copilot"):
        super().__init__(namespace=namespace)
        self.gateway_url = gateway_url.rstrip("/")
        self.job = job

    def safe_push(self) -> None:
        try:
            import urllib.request

            body = self.render_prometheus().encode()
            req = urllib.request.Request(
                f"{self.gateway_url}/metrics/job/{self.job}",
                data=body, method="PUT",
                headers={"Content-Type": "text/plain"},
            )
            urllib.request.urlopen(req, timeout=5).read()
        except Exception:
            pass


def create_metrics_collector(config: Any = None) -> MetricsCollector:
    cfg = dict(config or {})
    driver = cfg.get("driver", "noop")
    if driver == "noop":
        return NoopMetrics()
    if driver in ("inmemory", "prometheus"):
        return InMemoryMetrics(namespace=cfg.get("namespace", "copilot"))
    if driver == "pushgateway":
        return PushgatewayMetrics(
            gateway_url=cfg.get("gateway_url", "http://localhost:9091"),
            job=cfg.get("job", "copilot"),
            namespace=cfg.get("namespace", "copilot"),
        )
    if driver == "azure_monitor":
        from copilot_for_consensus_tpu_torch.obs.azure_monitor import (
            AzureMonitorMetrics,
        )

        return AzureMonitorMetrics(
            cfg.get("connection_string", ""),
            namespace=cfg.get("namespace", "copilot"),
            export_interval_s=float(cfg.get("export_interval_s", 60.0)),
            raise_on_error=bool(cfg.get("raise_on_error", False)),
        )
    raise ValueError(f"unknown metrics driver {driver!r}")
