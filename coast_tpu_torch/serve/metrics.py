"""Serving metrics: the campaign hub plus request-plane counters.

The port's copy of ``coast_tpu/serve/metrics.py``: the same ``serving``
block, ``/status`` document and ``coast_serve_*`` rows, over the port's
``obs`` hub.

The injection lanes of a serving dispatch ARE a campaign -- their
outcomes feed an ordinary :class:`~coast_tpu_torch.obs.metrics.CampaignMetrics`
hub (per-class Wilson rates, dispatch-latency histograms, live SLO
verdicts), so every existing surface (``/metrics``, ``/status``, the
SLO engine, ``json_parser``) reads the service's self-measurement with
zero new plumbing.  What IS new is the request plane: admission /
shed / rejection / retry / escalation counters, the per-strategy mix,
request end-to-end latency, and the lane-leak assertion tally.  Those
live here, lock-guarded, and export as a ``serving`` block in the
status document plus ``coast_serve_*`` Prometheus rows.

``ServeMetrics`` duck-types the ``prometheus()``/``snapshot()`` pair
:class:`~coast_tpu_torch.obs.serve.MetricsServer` expects, so the serve front
mounts it directly.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Mapping, Optional

from coast_tpu_torch.inject.classify import SDC_CLASSES as _SDC_CLASSES
from coast_tpu_torch.obs.convergence import wilson_interval
from coast_tpu_torch.obs.metrics import CampaignMetrics, Histogram, _esc

__all__ = ["ServeMetrics"]


class ServeMetrics:
    """Thread-safe serving hub: a CampaignMetrics plus request counters.

    Writers are the engine's dispatch loop (injection outcomes through
    ``self.hub``, request events through the ``note_*`` methods) and the
    HTTP handler threads (``note_admitted``); readers are the metrics
    server and the smoke drivers."""

    def __init__(self, slo=None,
                 slo_baseline: Optional[Mapping[str, float]] = None,
                 status_path: Optional[str] = None,
                 status_interval_s: float = 0.0,
                 z: float = 1.96):
        self.hub = CampaignMetrics(slo=slo, slo_baseline=slo_baseline,
                                   status_path=None, z=z)
        # The status file is written from the SERVING snapshot (hub doc
        # + serving block), so ServeMetrics owns the path, not the hub.
        self.status_path = status_path
        self.status_interval_s = float(status_interval_s)
        self._last_status_write = float("-inf")
        self.z = float(z)
        self._lock = threading.Lock()
        self._t_start = time.monotonic()
        self.admitted = 0
        self.served = 0
        self.rejected: Dict[str, int] = {}
        self.retries = 0
        self.escalations = 0
        self.strategy_mix: Dict[str, int] = {}
        self.shed_inject_lanes = 0
        self.saturated_dispatches = 0
        self.lane_leak_checks = 0
        self.lane_leak_violations = 0
        self.inject_lanes_done = 0
        self.request_latency = Histogram()

    # -- writer side (engine loop + HTTP handlers) ---------------------------
    def note_admitted(self, strategy: str) -> None:
        with self._lock:
            self.admitted += 1
            self.strategy_mix[strategy] = (
                self.strategy_mix.get(strategy, 0) + 1)

    def note_served(self, latency_s: float) -> None:
        with self._lock:
            self.served += 1
            self.request_latency.observe(latency_s)

    def note_rejected(self, reason: str) -> None:
        with self._lock:
            self.rejected[reason] = self.rejected.get(reason, 0) + 1

    def note_retry(self) -> None:
        with self._lock:
            self.retries += 1

    def note_escalation(self) -> None:
        """A DWC detection whose retry no longer fit the SLA moved the
        request to TMR; the mix counts the FINAL strategy, so shift one
        unit of the admission tally across."""
        with self._lock:
            self.escalations += 1
            self.strategy_mix["DWC"] = max(
                0, self.strategy_mix.get("DWC", 0) - 1)
            self.strategy_mix["TMR"] = (
                self.strategy_mix.get("TMR", 0) + 1)

    def note_dispatch(self, inject_lanes: int, shed_lanes: int,
                      saturated: bool) -> None:
        with self._lock:
            self.inject_lanes_done += int(inject_lanes)
            self.shed_inject_lanes += int(shed_lanes)
            if saturated:
                self.saturated_dispatches += 1

    def note_lane_leak_check(self, violated: bool = False) -> None:
        with self._lock:
            self.lane_leak_checks += 1
            if violated:
                self.lane_leak_violations += 1

    # -- reader side ---------------------------------------------------------
    def serving_block(self) -> Dict[str, object]:
        """The request-plane summary: the status document's ``serving``
        key and (via the run artifact) the json_parser block.  The live
        SDC CI is Wilson over the hub's cumulative injection-lane
        counts -- the number the service exists to measure."""
        with self._lock:
            elapsed = max(time.monotonic() - self._t_start, 1e-9)
            block: Dict[str, object] = {
                "requests": {
                    "admitted": self.admitted,
                    "served": self.served,
                    "rejected": dict(self.rejected),
                },
                "req_per_sec": round(self.served / elapsed, 3),
                "strategy_mix": dict(self.strategy_mix),
                "retries": self.retries,
                "escalations": self.escalations,
                "shed": {
                    "inject_lanes": self.shed_inject_lanes,
                    "saturated_dispatches": self.saturated_dispatches,
                },
                "lane_leak": {
                    "checks": self.lane_leak_checks,
                    "violations": self.lane_leak_violations,
                },
                "request_latency": self.request_latency.snapshot(),
            }
        with self.hub._lock:
            counts = dict(self.hub.counts)
        total = int(sum(counts.values()))
        sdc = int(sum(counts.get(k, 0.0) for k in _SDC_CLASSES))
        lo, hi = wilson_interval(sdc, total, self.z) if total else (0.0,
                                                                    0.0)
        shed_denom = self.inject_lanes_done + self.shed_inject_lanes
        block["shed"]["shed_rate"] = round(
            self.shed_inject_lanes / shed_denom, 6) if shed_denom else 0.0
        block["inject"] = {
            "lanes_done": total,
            "sdc": sdc,
            "sdc_rate": round(sdc / total, 8) if total else 0.0,
            "sdc_ci": {"lo": round(lo, 8), "hi": round(hi, 8),
                       "half_width": round((hi - lo) / 2.0, 8)},
        }
        return block

    def snapshot(self) -> Dict[str, object]:
        doc = self.hub.snapshot()
        doc["format"] = "coast-serve-status"
        doc["serving"] = self.serving_block()
        return doc

    def prometheus(self) -> str:
        text = self.hub.prometheus()
        with self._lock:
            lines = []

            def metric(name, mtype, help_text, samples):
                lines.append(f"# HELP {name} {help_text}")
                lines.append(f"# TYPE {name} {mtype}")
                for label_str, value in samples:
                    body = (f"{int(value)}"
                            if float(value).is_integer()
                            else f"{value:.17g}")
                    sep = f"{{{label_str}}}" if label_str else ""
                    lines.append(f"{name}{sep} {body}")

            metric("coast_serve_requests_total", "counter",
                   "Admitted requests by final strategy.",
                   [(f'strategy="{_esc(k)}"', float(v))
                    for k, v in sorted(self.strategy_mix.items())]
                   or [('strategy="DWC"', 0.0)])
            metric("coast_serve_served_total", "counter",
                   "Requests answered within their SLA.",
                   [("", float(self.served))])
            metric("coast_serve_rejected_total", "counter",
                   "Rejected requests by reason.",
                   [(f'reason="{_esc(k)}"', float(v))
                    for k, v in sorted(self.rejected.items())]
                   or [('reason="deadline_expired"', 0.0)])
            metric("coast_serve_retries_total", "counter",
                   "DWC detect-and-retry reruns.",
                   [("", float(self.retries))])
            metric("coast_serve_escalations_total", "counter",
                   "DWC requests escalated to TMR (retry would blow "
                   "the SLA).", [("", float(self.escalations))])
            metric("coast_serve_shed_inject_lanes_total", "counter",
                   "Injection lanes shed to make room for requests.",
                   [("", float(self.shed_inject_lanes))])
            metric("coast_serve_saturated_dispatches_total", "counter",
                   "Dispatches whose injection share shed to zero.",
                   [("", float(self.saturated_dispatches))])
            metric("coast_serve_lane_leak_checks_total", "counter",
                   "Runtime armed-lane / response-gather disjointness "
                   "checks.", [("", float(self.lane_leak_checks))])
            metric("coast_serve_lane_leak_violations_total", "counter",
                   "Lane-leak assertion failures (must stay 0).",
                   [("", float(self.lane_leak_violations))])
            hist = self.request_latency
            full = "coast_serve_request_latency_seconds"
            lines.append(f"# HELP {full} End-to-end request latency "
                         "(submit to response) histogram.")
            lines.append(f"# TYPE {full} histogram")
            for bound, cum in zip(hist.bounds, hist.bucket_counts):
                lines.append(f'{full}_bucket{{le="{bound:g}"}} {cum}')
            lines.append(f'{full}_bucket{{le="+Inf"}} {hist.count}')
            lines.append(f"{full}_sum {hist.sum:.17g}")
            lines.append(f"{full}_count {hist.count}")
        return text + "\n".join(lines) + "\n"

    # -- status file (serving snapshot, atomically replaced) -----------------
    def maybe_write_status(self, force: bool = False) -> None:
        if not self.status_path:
            return
        now = time.monotonic()
        if not force and (now - self._last_status_write
                          < self.status_interval_s):
            return
        self._last_status_write = now
        from coast_tpu_torch.obs.metrics import atomic_write_json
        atomic_write_json(self.status_path, self.snapshot())
