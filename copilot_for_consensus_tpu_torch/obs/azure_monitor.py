"""Azure Monitor (Application Insights) metrics driver — raw REST.

Fills the role of the reference's
``copilot_metrics/azure_monitor_metrics.py:38``
(AzureMonitorMetricsCollector: OpenTelemetry SDK + Azure Monitor
exporter, periodic batched export, error counting, shutdown-flush).
This image has no Azure/OTel SDKs and no egress, so the driver speaks
the Application Insights ingestion wire protocol directly — the same
``POST {IngestionEndpoint}/v2.1/track`` envelope stream the exporter
emits — making it testable against an in-process mock
(``tests/test_azure_monitor_metrics.py``) and usable against real
Application Insights wherever the runtime has network access.

Semantics mirror the reference collector:

* ``increment`` → counter, exported as the DELTA since the last flush
  (the OTel exporter's delta temporality for counters);
* ``observe`` → pre-aggregated metric envelope (count/min/max/sum — the
  App Insights ``MetricData`` aggregate shape);
* ``gauge`` → latest value at flush time;
* labels ride as envelope ``properties`` (custom dimensions);
* export every ``export_interval_s`` on a background thread, plus on
  ``safe_push()`` and ``shutdown()``; errors are counted
  (``errors_count``) and never raised into the pipeline unless
  ``raise_on_error`` (the reference's testing knob).
"""

from __future__ import annotations

import json
import re
import threading
import time
import urllib.error
import urllib.request
from typing import Any

from copilot_for_consensus_tpu_torch.obs.metrics import InMemoryMetrics


def parse_connection_string(conn: str) -> tuple[str, str]:
    """``InstrumentationKey=...;IngestionEndpoint=https://...`` →
    (ikey, endpoint). A bare instrumentation key gets the public
    ingestion endpoint, like the SDK."""
    parts = dict(
        kv.split("=", 1) for kv in conn.split(";") if "=" in kv)
    ikey = parts.get("InstrumentationKey", "").strip()
    if not ikey and re.fullmatch(r"[0-9a-fA-F-]{8,}", conn.strip()):
        ikey = conn.strip()
    if not ikey:
        raise ValueError(
            "azure_monitor needs a connection string with an "
            "InstrumentationKey")
    endpoint = parts.get(
        "IngestionEndpoint",
        "https://dc.services.visualstudio.com").rstrip("/")
    return ikey, endpoint


class AzureMonitorMetrics(InMemoryMetrics):
    """In-memory aggregation + periodic App Insights envelope export."""

    def __init__(self, connection_string: str,
                 namespace: str = "copilot",
                 export_interval_s: float = 60.0,
                 timeout_s: float = 10.0,
                 raise_on_error: bool = False):
        super().__init__(namespace=namespace)
        self.ikey, self.endpoint = parse_connection_string(
            connection_string)
        self.export_interval_s = export_interval_s
        self.timeout_s = timeout_s
        self.raise_on_error = raise_on_error
        self.errors_count = 0
        self.exported_envelopes = 0
        # counters export deltas: remember what was already shipped
        self._shipped_counters: dict[str, dict[tuple, float]] = {}
        self._shipped_hists: dict[str, dict[tuple, tuple]] = {}
        self._flush_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if export_interval_s > 0:
            self._thread = threading.Thread(
                target=self._export_loop, daemon=True,
                name="azure-monitor-export")
            self._thread.start()

    # -- envelope construction -----------------------------------------

    def _metric_envelope(self, name: str, key: tuple, *, value: float,
                         count: int = 1, mn: float | None = None,
                         mx: float | None = None) -> dict[str, Any]:
        data_point: dict[str, Any] = {
            "name": f"{self.namespace}.{name}", "value": value,
            "count": count,
        }
        if mn is not None:
            data_point["min"] = mn
        if mx is not None:
            data_point["max"] = mx
        return {
            "name": "Microsoft.ApplicationInsights.Metric",
            "time": time.strftime("%Y-%m-%dT%H:%M:%S.000Z",
                                  time.gmtime()),
            "iKey": self.ikey,
            "tags": {"ai.cloud.role": self.namespace},
            "data": {
                "baseType": "MetricData",
                "baseData": {
                    "metrics": [data_point],
                    "properties": {k: str(v) for k, v in key},
                },
            },
        }

    def _collect_envelopes(self) -> list[dict[str, Any]]:
        out: list[dict[str, Any]] = []
        with self._lock:
            for name, series in self.counters.items():
                shipped = self._shipped_counters.setdefault(name, {})
                for key, total in series.items():
                    delta = total - shipped.get(key, 0.0)
                    if delta:
                        out.append(self._metric_envelope(
                            name, key, value=delta,
                            count=max(int(delta), 1)))
                        shipped[key] = total
            for name, series in self.gauges.items():
                for key, value in series.items():
                    out.append(self._metric_envelope(name, key,
                                                     value=value))
            for name, series in self.histograms.items():
                shipped_h = self._shipped_hists.setdefault(name, {})
                for key, (total, count, _) in series.items():
                    prev_sum, prev_n = shipped_h.get(key, (0.0, 0))
                    dn = count - prev_n
                    if dn > 0:
                        out.append(self._metric_envelope(
                            name, key, value=total - prev_sum,
                            count=dn))
                        shipped_h[key] = (total, count)
        return out

    # -- export ---------------------------------------------------------

    def _export_loop(self) -> None:
        while not self._stop.wait(self.export_interval_s):
            try:
                self.safe_push()
            except Exception:
                # raise_on_error is for foreground callers (tests); the
                # background exporter must outlive transient failures —
                # the error is already counted and the deltas rolled
                # back for the next attempt
                pass

    def safe_push(self) -> None:
        """Flush pending aggregates as one /v2.1/track batch. Network
        failures count and (by default) never raise — metrics must not
        take the pipeline down (same contract as PushgatewayMetrics)."""
        with self._flush_lock:
            # snapshot the shipped watermarks so a failed POST can roll
            # back to exactly this point (clearing them instead would
            # re-ship already-accepted totals as fresh deltas)
            with self._lock:
                saved_counters = {k: dict(v) for k, v in
                                  self._shipped_counters.items()}
                saved_hists = {k: dict(v) for k, v in
                               self._shipped_hists.items()}
            envelopes = self._collect_envelopes()
            if not envelopes:
                return
            body = "\n".join(
                json.dumps(e, separators=(",", ":"))
                for e in envelopes).encode()
            try:
                req = urllib.request.Request(
                    f"{self.endpoint}/v2.1/track", data=body,
                    method="POST",
                    headers={"Content-Type": "application/x-json-stream"})
                with urllib.request.urlopen(
                        req, timeout=self.timeout_s) as resp:
                    ack = json.loads(resp.read() or b"{}")
                rejected = (ack.get("itemsReceived", 0)
                            - ack.get("itemsAccepted", 0))
                self.errors_count += max(rejected, 0)
                self.exported_envelopes += ack.get(
                    "itemsAccepted", len(envelopes))
            except Exception as exc:
                self.errors_count += 1
                with self._lock:
                    self._shipped_counters = saved_counters
                    self._shipped_hists = saved_hists
                if self.raise_on_error:
                    raise RuntimeError(
                        f"azure monitor export failed: {exc}") from exc

    def shutdown(self) -> None:
        """Final flush + stop the exporter thread (reference
        ``azure_monitor_metrics.py:336``)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self.safe_push()

    # parity accessors (reference get_errors_count / get_gauge_value,
    # ``azure_monitor_metrics.py:307,328``); the latter is the
    # inherited accessor under the reference's name
    def get_errors_count(self) -> int:
        # GIL-atomic int read; taking _flush_lock here would block the
        # accessor behind an in-progress flush's network POST for a
        # stale-read-tolerant parity counter.
        # jaxlint: disable=race-unlocked-field
        return self.errors_count

    get_gauge_value = InMemoryMetrics.gauge_value
