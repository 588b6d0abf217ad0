"""Merged fleet telemetry: one /metrics + /status over many workers.

The port's copy of ``coast_tpu/fleet/telemetry.py``, with its status
document and Prometheus names. Per-campaign observability already exists
(:mod:`coast_tpu_torch.obs.metrics` feeds one hub per runner); a fleet
needs the *sum*. The aggregation topology is deliberately file-based,
matching the queue: every worker mirrors an atomic worker-status doc
into ``<queue>/status/`` on each batch, and completed items live as
durable ``done`` records -- so the aggregator is a pure *reader* with no
RPC fabric, no worker registration, and no extra failure mode. A
SIGKILL'd worker simply goes stale (its last doc's age exceeds the
staleness window) and its completed work keeps counting, because
completed work is counted from ``done`` records, never from worker
memory.

:class:`FleetTelemetry` duck-types the hub interface
(:meth:`snapshot` / :meth:`prometheus`), so the stock
:class:`coast_tpu_torch.obs.serve.MetricsServer` serves the fleet aggregate
unchanged -- one ``/metrics`` endpoint a Prometheus scraper reads for
the whole fleet, one ``/status`` JSON for dashboards.

Double-count hygiene: fleet per-class totals = (sum of ``done`` record
counts) + (live ``running`` workers' current-campaign counts).  Workers
drop the campaign block from their status doc the moment an item's
``done`` record lands, so an item is never in both terms (modulo one
in-flight beat, which the next scrape corrects).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Tuple

from coast_tpu_torch.fleet.queue import CampaignQueue
from coast_tpu_torch.obs.convergence import interval_table
from coast_tpu_torch.obs.metrics import _esc

__all__ = ["FleetTelemetry", "merge_histogram"]

#: done-record summary profile key -> the canonical histogram name the
#: SLO engine's ``p<q>_<alias>`` objectives resolve to (the same
#: mapping obs/slo.evidence_from_summary applies to one campaign).
_SUMMARY_HISTS = (("device_seconds_histogram", "dispatch_device_seconds"),
                  ("host_gap_seconds_histogram",
                   "dispatch_host_gap_seconds"))


def merge_histogram(into: Dict[str, Dict[str, object]], name: str,
                    snap: Dict[str, object]) -> None:
    """Sum one histogram snapshot into the fleet accumulator under
    ``name``.  Snapshots with different bucket bounds are skipped --
    mixing bounds would corrupt every quantile read off the merge, and
    all shipped histograms share Histogram.DEFAULT_BOUNDS."""
    if not snap or not snap.get("count"):
        return
    acc = into.get(name)
    if acc is None:
        into[name] = {"le": list(snap.get("le") or ()),
                      "counts": [int(c) for c in snap.get("counts") or ()],
                      "count": int(snap["count"]),
                      "sum": float(snap.get("sum", 0.0))}
        return
    if list(snap.get("le") or ()) != acc["le"]:
        return
    acc["counts"] = [a + int(b) for a, b in
                     zip(acc["counts"], snap.get("counts") or ())]
    acc["count"] += int(snap["count"])
    acc["sum"] += float(snap.get("sum", 0.0))


class FleetTelemetry:
    """Read-side aggregate over one queue's workers + done records."""

    def __init__(self, queue: "CampaignQueue | str",
                 stale_s: float = 30.0, z: float = 1.96, slo=None):
        self.q = (queue if isinstance(queue, CampaignQueue)
                  else CampaignQueue(queue))
        self.stale_s = float(stale_s)
        self.z = float(z)
        if isinstance(slo, str):
            from coast_tpu_torch.obs.slo import SLOSet
            slo = SLOSet.parse(slo)
        self.slo_set = slo
        self._done_cache: Dict[str, Tuple[int, Dict[str, object]]] = {}

    # -- readers -------------------------------------------------------------
    def _worker_docs(self) -> List[Dict[str, object]]:
        status_dir = os.path.join(self.q.root, "status")
        out: List[Dict[str, object]] = []
        for name in sorted(os.listdir(status_dir)):
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(status_dir, name)) as fh:
                    out.append(json.load(fh))
            except (OSError, ValueError):
                continue                   # torn/unreadable: skip a beat
        return out

    def _done_docs(self) -> List[Dict[str, object]]:
        """Done records, parsed once each.  They are immutable once
        ``atomic_write_json`` lands them (an idempotent re-complete
        rewrites the identical bytes but bumps mtime, which just
        re-parses that one file), and the aggregate runs per /metrics
        scrape, per /status hit, AND per supervisor poll -- a long
        fleet accumulates thousands of done files, so re-reading all of
        them every half-second is the one unbounded cost here."""
        done_dir = os.path.join(self.q.root, "done")
        out: List[Dict[str, object]] = []
        for name in sorted(os.listdir(done_dir)):
            if not name.endswith(".json"):
                continue
            path = os.path.join(done_dir, name)
            try:
                mtime = os.stat(path).st_mtime_ns
            except FileNotFoundError:
                continue
            hit = self._done_cache.get(path)
            if hit is None or hit[0] != mtime:
                try:
                    with open(path) as fh:
                        hit = (mtime, json.load(fh))
                except (OSError, ValueError):
                    continue               # torn/unreadable: skip a beat
                self._done_cache[path] = hit
            out.append(hit[1])
        return out

    def _aggregate(self) -> Dict[str, object]:
        now = time.time()
        queue_stats = self.q.stats()
        done = self._done_docs()
        counts: Dict[str, float] = {}
        injections = 0
        physical = 0
        seconds = 0.0
        cache: Dict[str, int] = {}
        # Federated dispatch-latency histograms, canonical names: the
        # evidence the p99_dispatch-style fleet SLOs read.  Done records
        # carry them under the summary profile keys; live workers'
        # campaign blocks already use the canonical names.
        histograms: Dict[str, Dict[str, object]] = {}
        for rec in done:
            result = rec.get("result") or {}
            for k, v in (result.get("counts") or {}).items():
                counts[k] = counts.get(k, 0.0) + float(v)
            injections += int(result.get("injections", 0))
            physical += int(result.get("physical_injections",
                                       result.get("injections", 0)))
            seconds += float(result.get("seconds", 0.0))
            profile = ((result.get("summary") or {}).get("profile")
                       or {})
            for summary_key, canonical in _SUMMARY_HISTS:
                merge_histogram(histograms, canonical,
                                profile.get(summary_key) or {})
            event = result.get("cache_event")
            if event:
                cache[event] = cache.get(event, 0) + 1
        workers: List[Dict[str, object]] = []
        live = 0
        inj_per_sec = 0.0
        for doc in self._worker_docs():
            age = max(0.0, now - float(doc.get("updated_unix_s", 0.0)))
            stale = age > self.stale_s or doc.get("state") == "exited"
            if not stale:
                live += 1
            campaign = doc.get("campaign") if doc.get("state") == "running" \
                else None
            if campaign and not stale:
                for k, v in (campaign.get("counts") or {}).items():
                    counts[k] = counts.get(k, 0.0) + float(v)
                inj_per_sec += float(campaign.get("inj_per_sec", 0.0))
                for name, snap in ((campaign.get("profile") or {})
                                   .get("histograms") or {}).items():
                    merge_histogram(histograms, name, snap)
            for k, v in (doc.get("cache") or {}).items():
                if k in ("warm_hit", "persistent_hit", "miss"):
                    # Live view of in-flight workers' cache traffic;
                    # the done-record sum above is the durable one, so
                    # keep them in separate keys.
                    cache[f"live_{k}"] = cache.get(f"live_{k}", 0) + int(v)
            workers.append({
                "worker": doc.get("worker"),
                "pid": doc.get("pid"),
                "state": "stale" if stale else doc.get("state"),
                "item": doc.get("item"),
                "items_done": doc.get("items_done", 0),
                "items_failed": doc.get("items_failed", 0),
                "age_s": round(age, 3),
                "inj_per_sec": (float(campaign.get("inj_per_sec", 0.0))
                                if campaign and not stale else 0.0),
            })
        return {
            "now": now, "queue": queue_stats, "workers": workers,
            "workers_live": live, "counts": counts,
            "injections_done": injections, "physical_done": physical,
            "seconds": seconds, "cache": cache,
            "inj_per_sec": inj_per_sec,
            "histograms": histograms,
        }

    def _slo_report(self, agg: Dict[str, object]):
        """Evaluate the configured SLO set against the fleet aggregate:
        the union of done-record counts, live campaigns, and the
        federated dispatch-latency histograms -- so ``p99_dispatch``-
        style latency objectives get a fleet-scope verdict from the
        same evidence shape a single campaign's evaluation reads."""
        if self.slo_set is None:
            return None
        from coast_tpu_torch.obs.slo import evaluate
        rate = agg["inj_per_sec"] or None
        if rate is None and agg["seconds"] > 0:
            rate = agg["injections_done"] / agg["seconds"]
        return evaluate(self.slo_set, {
            "counts": {k: int(v) for k, v in agg["counts"].items()},
            "inj_per_sec": rate,
            "histograms": agg["histograms"],
        })

    # -- hub interface (MetricsServer duck-typing) ---------------------------
    def snapshot(self) -> Dict[str, object]:
        agg = self._aggregate()
        doc = {
            "format": "coast-fleet-status", "version": 1,
            "queue": agg["queue"],
            "workers": agg["workers"],
            "workers_live": agg["workers_live"],
            "counts": {k: v for k, v in sorted(agg["counts"].items())},
            "rates": interval_table(agg["counts"], self.z),
            "injections_done": agg["injections_done"],
            "physical_done": agg["physical_done"],
            "seconds": round(agg["seconds"], 6),
            "inj_per_sec": round(agg["inj_per_sec"], 3),
            "cache": agg["cache"],
            "updated_unix_s": round(agg["now"], 6),
        }
        if agg["histograms"]:
            # Same shape as a campaign snapshot's profile block, so the
            # evidence readers (and dashboards) share one vocabulary.
            doc["profile"] = {"histograms": agg["histograms"]}
        report = self._slo_report(agg)
        if report is not None:
            from coast_tpu_torch.obs.slo import summary_block
            doc["slo"] = summary_block(report)
        return doc

    def prometheus(self) -> str:
        """Prometheus 0.0.4 text of the fleet aggregate -- the
        reference's metric names."""
        agg = self._aggregate()
        lines: List[str] = []

        def metric(name: str, mtype: str, help_text: str,
                   samples: List[Tuple[str, float]]) -> None:
            lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {mtype}")
            for label_str, value in samples:
                text = (f"{int(value)}" if float(value).is_integer()
                        else f"{value:.17g}")
                body = f"{{{label_str}}}" if label_str else ""
                lines.append(f"{name}{body} {text}")

        metric("coast_fleet_queue_items", "gauge",
               "Queue items per state.",
               [(f'state="{s}"', float(n))
                for s, n in sorted(agg["queue"].items())])
        states: Dict[str, int] = {}
        for w in agg["workers"]:
            states[str(w["state"])] = states.get(str(w["state"]), 0) + 1
        metric("coast_fleet_workers", "gauge",
               "Workers per observed state (stale = no fresh status).",
               [(f'state="{_esc(s)}"', float(n))
                for s, n in sorted(states.items())] or [("", 0.0)])
        metric("coast_fleet_class_total", "gauge",
               "Fleet-wide weighted count per classification class "
               "(done records + live campaigns).",
               [(f'class="{_esc(k)}"', float(v))
                for k, v in sorted(agg["counts"].items())]
               or [('class="success"', 0.0)])
        rates = interval_table(agg["counts"], self.z)
        if rates:
            metric("coast_fleet_class_rate", "gauge",
                   "Fleet-wide weighted per-class rate.",
                   [(f'class="{_esc(k)}"', v["rate"])
                    for k, v in rates.items()])
            metric("coast_fleet_class_ci_half_width", "gauge",
                   "Wilson CI half-width of the fleet per-class rate.",
                   [(f'class="{_esc(k)}"', v["half_width"])
                    for k, v in rates.items()])
        metric("coast_fleet_injections_done_total", "counter",
               "Effective injections in completed items.",
               [("", float(agg["injections_done"]))])
        metric("coast_fleet_inj_per_sec", "gauge",
               "Summed instantaneous inj/s over live running workers.",
               [("", float(agg["inj_per_sec"]))])
        metric("coast_fleet_compile_cache_events_total", "counter",
               "Compile-cache outcomes (done records; live_* = in-flight "
               "worker counters).",
               [(f'kind="{_esc(k)}"', float(v))
                for k, v in sorted(agg["cache"].items())]
               or [('kind="miss"', 0.0)])
        for hname, hist in sorted(agg["histograms"].items()):
            # Federated dispatch-latency histograms (done records +
            # live campaigns): the fleet-scope evidence behind the
            # latency SLO rows below.
            full = f"coast_fleet_{hname}"
            lines.append(f"# HELP {full} Federated per-dispatch "
                         "latency histogram (seconds).")
            lines.append(f"# TYPE {full} histogram")
            for bound, cum in zip(hist["le"], hist["counts"]):
                lines.append(
                    f'{full}_bucket{{le="{float(bound):g}"}} {cum}')
            lines.append(
                f'{full}_bucket{{le="+Inf"}} {hist["count"]}')
            lines.append(f'{full}_sum {float(hist["sum"]):.17g}')
            lines.append(f'{full}_count {hist["count"]}')
        report = self._slo_report(agg)
        if report is not None:
            rows = report.get("objectives") or []
            metric("coast_fleet_slo_burn_rate", "gauge",
                   "Fleet error-budget burn rate per SLO objective "
                   "(1.0 = consuming budget exactly at the allowed "
                   "pace).",
                   [(f'objective="{_esc(r["objective"])}"',
                     float(r["burn"]["long"]))
                    for r in rows
                    if (r.get("burn") or {}).get("long") is not None])
            metric("coast_fleet_slo_budget_remaining_frac", "gauge",
                   "Unconsumed fleet error-budget fraction per SLO "
                   "objective (negative = overspent).",
                   [(f'objective="{_esc(r["objective"])}"',
                     float(r["budget"]["remaining_frac"]))
                    for r in rows
                    if (r.get("budget") or {}).get("remaining_frac")
                    is not None])
            metric("coast_fleet_slo_verdict", "gauge",
                   "Fleet per-objective verdict (0=ok, 1=warn, 2=page).",
                   [(f'objective="{_esc(r["objective"])}"',
                     float(("ok", "warn",
                            "page").index(r["verdict"])))
                    for r in rows])
        return "\n".join(lines) + "\n"
