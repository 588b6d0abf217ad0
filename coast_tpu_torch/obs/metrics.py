"""Live campaign metrics: per-batch time series behind a lock.

The spans/trace layer (:mod:`coast_tpu_torch.obs.spans`) answers "where did
the time go" *after* a campaign ends; this module answers "what is the
campaign doing *now*".  :class:`CampaignMetrics` is a small thread-safe
hub the campaign loop feeds once per collected batch
(``CampaignRunner(metrics=...)``); the HTTP endpoint
(:mod:`coast_tpu_torch.obs.serve`), the status-file export, and the TTY
console (:mod:`coast_tpu_torch.obs.console`) all read coherent snapshots from
it.  Keeping a long accelerator run efficient is a *host-side
monitoring* problem: throughput and failure counters have to be visible
while the run is still spending money.  (The port's copy of
``coast_tpu/obs/metrics.py``: the same snapshot keys, Prometheus names,
status file and live SLO verdicts.)

Everything is stdlib + numpy-free; the one accelerator touch (device
memory watermark) reads ``torch.cuda.memory_allocated`` of an
initialised card and degrades to ``None`` on the CPU.

Per batch the hub records into fixed-capacity ring buffers:

  * instantaneous and cumulative injections/sec (physical dispatches);
  * done / total progress (physical rows and weighted effective rows);
  * weighted per-class rates with Wilson confidence intervals
    (:mod:`coast_tpu_torch.obs.convergence`);
  * per-stage wall-clock totals and the streaming overlap fraction;
  * retry / OOM-degrade / watchdog counters
    (:mod:`coast_tpu_torch.inject.resilience`);
  * the device memory watermark (high-water ``bytes_in_use``).

Ring capacity bounds memory for arbitrarily long campaigns: the status
surfaces show the recent window, the scalar aggregates stay exact.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Deque, Dict, List, Mapping, Optional, Tuple

from coast_tpu_torch.inject.classify import SDC_CLASSES as _SDC_CLASSES
from coast_tpu_torch.obs.convergence import interval_table

__all__ = ["Ring", "Histogram", "CampaignMetrics", "device_memory_bytes",
           "atomic_write_json"]


def device_memory_bytes() -> Optional[int]:
    """Live allocated bytes of the current card, or None on the CPU (no
    card, or CUDA not initialised by this process)."""
    try:
        import torch
        if not torch.cuda.is_initialized():
            return None
        return int(torch.cuda.memory_allocated())
    except Exception:            # noqa: BLE001 - any backend gap -> None
        return None


def atomic_write_json(path: str, doc: Dict[str, object]) -> None:
    """Write ``doc`` to ``path`` atomically (tmp + rename): a reader --
    a fleet scraper polling ``--status-json`` -- never sees a torn
    file."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(doc, fh, separators=(",", ":"), sort_keys=True)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


class Ring:
    """Fixed-capacity (t, value) time series; oldest samples drop."""

    def __init__(self, capacity: int = 256):
        self.capacity = int(capacity)
        self._buf: Deque[Tuple[float, float]] = collections.deque(
            maxlen=self.capacity)

    def append(self, t: float, value: float) -> None:
        self._buf.append((float(t), float(value)))

    def last(self) -> Optional[float]:
        return self._buf[-1][1] if self._buf else None

    def points(self) -> List[Tuple[float, float]]:
        return list(self._buf)

    def __len__(self) -> int:
        return len(self._buf)


#: The ring series every campaign records, in export order.
_SERIES = ("inj_per_sec", "inj_per_sec_cumulative", "done_rows",
           "effective_done", "sdc_rate", "device_memory_bytes")


class Histogram:
    """Prometheus-style cumulative-bucket histogram (fixed bounds).

    The campaign profiler's per-dispatch device-seconds distribution
    needs more than a gauge: the fused-kernel A/B cares whether the
    dispatch population *shifted*, not just its mean.  This is the one
    histogram implementation behind both the profiler's recorded
    snapshots and the ``/metrics`` exposition -- the hub's one
    histogram-typed exporter (the rest are gauges and counters).

    ``le`` bounds are upper-inclusive seconds; observations above the
    last bound land only in the implicit ``+Inf`` bucket (``count``).
    """

    #: Log-spaced per-dispatch latency bounds: 0.5 ms (a warm tiny-batch
    #: CPU dispatch) through 30 s (a flagship batch behind a tunnel).
    DEFAULT_BOUNDS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                      0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

    def __init__(self, bounds: Optional[Tuple[float, ...]] = None):
        self.bounds = tuple(float(b) for b in (bounds or
                                               self.DEFAULT_BOUNDS))
        self.bucket_counts = [0] * len(self.bounds)
        self.count = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        for i, bound in enumerate(self.bounds):
            if v <= bound:
                self.bucket_counts[i] += 1

    def snapshot(self) -> Dict[str, object]:
        """JSON-able form: CUMULATIVE per-bucket counts (Prometheus
        ``le`` semantics -- bucket i counts observations <= bounds[i])
        plus the scalar sum/count."""
        return {"le": list(self.bounds),
                "counts": list(self.bucket_counts),
                "count": int(self.count),
                "sum": round(self.sum, 6)}


class CampaignMetrics:
    """Thread-safe live-metrics hub for one campaign at a time.

    The campaign loop (single writer) calls ``campaign_started`` /
    ``record_batch`` / ``campaign_finished``; any number of reader
    threads (HTTP handlers, the console) call ``snapshot`` /
    ``prometheus``.  ``status_path`` additionally mirrors every sample
    to an atomically-replaced JSON file for headless fleets (rate-
    limited by ``status_interval_s``; the terminal states always
    write).
    """

    def __init__(self, ring_capacity: int = 256,
                 status_path: Optional[str] = None,
                 status_interval_s: float = 0.0,
                 z: float = 1.96,
                 slo=None,
                 slo_baseline: Optional[Mapping[str, float]] = None,
                 clock=time.monotonic):
        self._lock = threading.Lock()
        self._clock = clock
        self.status_path = status_path
        self.status_interval_s = float(status_interval_s)
        self.z = float(z)
        # Reliability SLOs (obs/slo): a spec string or SLOSet; when set,
        # every record_batch re-evaluates the error budgets over the
        # cumulative evidence and snapshot()/prometheus()/the console
        # expose the live verdicts.  ``slo_baseline`` feeds the mwtf
        # objective ({"sdc_rate", "inj_per_sec"} of an unprotected run).
        if isinstance(slo, str):
            from coast_tpu_torch.obs.slo import SLOSet
            slo = SLOSet.parse(slo)
        self.slo_set = slo
        self.slo_baseline = (dict(slo_baseline) if slo_baseline
                             else None)
        self.slo_report: Optional[Dict[str, object]] = None
        self.rings: Dict[str, Ring] = {
            name: Ring(ring_capacity) for name in _SERIES}
        self.state = "idle"
        self.benchmark = ""
        self.strategy = ""
        self.total_rows = 0
        self.total_effective = 0
        self.done_rows = 0
        self.effective_done = 0
        self.counts: Dict[str, float] = {}
        self.stages: Dict[str, float] = {}
        self.resilience: Dict[str, int] = {}
        # Host<->device traffic bytes ({"up", "down"}), cumulative; the
        # sparse-collect campaign loop's headline counter.  Stage
        # attribution: up-bytes accrue in the pad/dispatch stages,
        # down-bytes in collect.
        self.transfer: Dict[str, int] = {}
        # Device-time attribution (CampaignRunner(profile=True)):
        # cumulative device-busy / host-gap seconds plus per-dispatch
        # latency histograms -- the hub's first histogram-typed
        # exporters.  Empty for unprofiled campaigns, so every existing
        # surface is unchanged.
        self.profile: Dict[str, float] = {}
        self.histograms: Dict[str, Histogram] = {}
        self.batches = 0
        self.replayed_batches = 0
        self.memory_watermark: Optional[int] = None
        self.error: Optional[str] = None
        self.convergence: Optional[Dict[str, object]] = None
        self._t_start = 0.0
        self._t_last_batch = 0.0
        self._last_status_write = float("-inf")
        self._updated_unix = time.time()

    # -- writer side (the campaign loop) -------------------------------------
    def campaign_started(self, benchmark: str, strategy: str,
                         total_rows: int, total_effective: int) -> None:
        with self._lock:
            self.state = "running"
            self.benchmark = benchmark
            self.strategy = strategy
            self.total_rows = int(total_rows)
            self.total_effective = int(total_effective)
            self.done_rows = 0
            self.effective_done = 0
            self.counts = {}
            self.stages = {}
            self.resilience = {}
            self.transfer = {}
            self.profile = {}
            self.histograms = {}
            self.batches = 0
            self.replayed_batches = 0
            self.error = None
            self.convergence = None
            now = self._clock()
            self._t_start = now
            self._t_last_batch = now
        self._maybe_write_status(force=True)

    def record_batch(self, done_rows: int, n_rows: int,
                     counts: Mapping[str, float],
                     stages: Mapping[str, float],
                     resilience: Mapping[str, int],
                     replayed: bool = False,
                     transfer: Optional[Mapping[str, int]] = None,
                     profile: Optional[Mapping[str, float]] = None
                     ) -> None:
        """One collected (or journal-replayed) batch: cumulative row
        progress, the cumulative weighted class histogram, stage
        totals, resilience counters, and (when the loop measures it)
        cumulative host<->device transfer bytes so far.  ``profile`` is
        the profiler's per-batch sample ({device_s, gap_s}) -- observed
        into the dispatch-latency histograms and summed into the
        cumulative attribution block."""
        now = self._clock()
        with self._lock:
            if profile is not None:
                self.profile["device_busy_s"] = (
                    self.profile.get("device_busy_s", 0.0)
                    + float(profile.get("device_s", 0.0)))
                self.profile["host_gap_s"] = (
                    self.profile.get("host_gap_s", 0.0)
                    + float(profile.get("gap_s", 0.0)))
                self.profile["dispatches"] = (
                    self.profile.get("dispatches", 0) + 1)
                for key, sample in (("dispatch_device_seconds",
                                     "device_s"),
                                    ("dispatch_host_gap_seconds",
                                     "gap_s")):
                    hist = self.histograms.get(key)
                    if hist is None:
                        hist = self.histograms[key] = Histogram()
                    hist.observe(float(profile.get(sample, 0.0)))
            dt = max(now - self._t_last_batch, 1e-9)
            elapsed = max(now - self._t_start, 1e-9)
            self._t_last_batch = now
            self.done_rows = int(done_rows)
            self.counts = {k: float(v) for k, v in counts.items()}
            self.effective_done = int(sum(self.counts.values()))
            self.stages = {k: float(v) for k, v in stages.items()}
            self.resilience = {k: int(v) for k, v in resilience.items()}
            if transfer is not None:
                self.transfer = {k: int(v) for k, v in transfer.items()}
            self.batches += 1
            if replayed:
                self.replayed_batches += 1
            mem = device_memory_bytes()
            if mem is not None:
                self.memory_watermark = max(self.memory_watermark or 0,
                                            mem)
            inst = n_rows / dt
            cum = self.done_rows / elapsed
            total_eff = float(sum(self.counts.values()))
            # classify.SDC_CLASSES: train regions refine the raw ``sdc``
            # bucket into ``train_sdc`` (persistent) + self-heal, so the
            # live rate must sum the persistent classes, not just "sdc".
            sdc = sum(self.counts.get(k, 0.0) for k in _SDC_CLASSES)
            sdc_rate = sdc / total_eff if total_eff else 0.0
            self.rings["inj_per_sec"].append(now, inst)
            self.rings["inj_per_sec_cumulative"].append(now, cum)
            self.rings["done_rows"].append(now, self.done_rows)
            self.rings["effective_done"].append(now, self.effective_done)
            self.rings["sdc_rate"].append(now, sdc_rate)
            if mem is not None:
                self.rings["device_memory_bytes"].append(now, mem)
            self._refresh_slo_locked()
            self._updated_unix = time.time()
        self._maybe_write_status()

    def campaign_finished(self, summary: Optional[Dict[str, object]] = None,
                          error: Optional[str] = None,
                          convergence: Optional[Dict[str, object]] = None
                          ) -> None:
        with self._lock:
            self.state = "failed" if error else "finished"
            self.error = error
            if convergence is not None:
                self.convergence = dict(convergence)
            if summary:
                stages = summary.get("stages")
                if isinstance(stages, dict):
                    self.stages = {k: float(v) for k, v in stages.items()}
            self._refresh_slo_locked()
            self._updated_unix = time.time()
        self._maybe_write_status(force=True)

    def _refresh_slo_locked(self) -> None:
        """Re-evaluate the attached SLO set over the cumulative evidence
        (caller holds the lock; pure arithmetic, one pass per batch)."""
        if self.slo_set is None:
            return
        from coast_tpu_torch.obs.slo import evaluate
        elapsed = max(self._t_last_batch - self._t_start, 1e-9)
        evidence = {
            "counts": dict(self.counts),
            "inj_per_sec": (self.done_rows / elapsed
                            if self.done_rows else None),
            "histograms": {k: h.snapshot()
                           for k, h in self.histograms.items()},
            "sdc_rate_recent": [v for _, v in
                                self.rings["sdc_rate"].points()],
        }
        self.slo_report = evaluate(self.slo_set, evidence,
                                   baseline=self.slo_baseline)

    def slo_status(self) -> Optional[Dict[str, object]]:
        """The latest live SLO evaluation (None when no SLO set is
        attached or nothing has been recorded yet) -- the console /
        heartbeat feed."""
        with self._lock:
            return self.slo_report

    # -- reader side ---------------------------------------------------------
    def _rates(self) -> Dict[str, Dict[str, float]]:
        """Per-class weighted rate + Wilson CI (caller holds the lock);
        the shared interval-table shape of obs/convergence."""
        return interval_table(self.counts, self.z)

    def snapshot(self) -> Dict[str, object]:
        """One coherent JSON-able status document (the /status body and
        the --status-json file)."""
        with self._lock:
            elapsed = (max(self._t_last_batch - self._t_start, 0.0)
                       if self.state != "idle" else 0.0)
            doc: Dict[str, object] = {
                "format": "coast-status",
                "version": 1,
                "state": self.state,
                "benchmark": self.benchmark,
                "strategy": self.strategy,
                "total_rows": self.total_rows,
                "total_effective": self.total_effective,
                "done_rows": self.done_rows,
                "effective_done": self.effective_done,
                "batches": self.batches,
                "replayed_batches": self.replayed_batches,
                "elapsed_s": round(elapsed, 6),
                "inj_per_sec": self.rings["inj_per_sec"].last() or 0.0,
                "inj_per_sec_cumulative":
                    self.rings["inj_per_sec_cumulative"].last() or 0.0,
                "counts": dict(self.counts),
                "rates": self._rates(),
                "stages": dict(self.stages),
                "resilience": dict(self.resilience),
                "transfer_bytes": dict(self.transfer),
                "device_memory_watermark_bytes": self.memory_watermark,
                "updated_unix_s": round(self._updated_unix, 6),
                "series": {
                    name: [[round(t, 4), v] for t, v in ring.points()]
                    for name, ring in self.rings.items()},
            }
            if self.profile:
                doc["profile"] = {
                    **{k: (round(v, 6) if isinstance(v, float) else v)
                       for k, v in self.profile.items()},
                    "histograms": {k: h.snapshot()
                                   for k, h in self.histograms.items()},
                }
            if self.error:
                doc["error"] = self.error
            if self.convergence is not None:
                doc["convergence"] = self.convergence
            if self.slo_report is not None:
                from coast_tpu_torch.obs.slo import summary_block
                doc["slo"] = summary_block(self.slo_report)
            return doc

    def prometheus(self) -> str:
        """Prometheus text exposition (format 0.0.4) of the scalar
        aggregates -- what a fleet scraper wants; the ring series stay
        JSON-only."""
        with self._lock:
            labels = (f'benchmark="{_esc(self.benchmark)}",'
                      f'strategy="{_esc(self.strategy)}"')
            lines: List[str] = []

            def metric(name: str, mtype: str, help_text: str,
                       samples: List[Tuple[str, float]]) -> None:
                lines.append(f"# HELP {name} {help_text}")
                lines.append(f"# TYPE {name} {mtype}")
                for label_str, value in samples:
                    # :.17g round-trips any float exactly; :g's 6
                    # significant digits would corrupt counters past
                    # 10^6 (a one-million-row campaign is the NORMAL
                    # case).
                    text = (f"{int(value)}" if float(value).is_integer()
                            else f"{value:.17g}")
                    lines.append(f"{name}{{{label_str}}} {text}")

            state_samples = [
                (f'{labels},state="{s}"',
                 1.0 if s == self.state else 0.0)
                for s in ("idle", "running", "finished", "failed")]
            metric("coast_campaign_state", "gauge",
                   "Campaign lifecycle state (one-hot).", state_samples)
            metric("coast_campaign_rows_total", "gauge",
                   "Physical schedule rows in this campaign.",
                   [(labels, float(self.total_rows))])
            metric("coast_campaign_rows_done", "gauge",
                   "Physical rows collected so far.",
                   [(labels, float(self.done_rows))])
            metric("coast_campaign_effective_done", "gauge",
                   "Weighted effective injections counted so far.",
                   [(labels, float(self.effective_done))])
            metric("coast_campaign_batches_total", "counter",
                   "Collected batches (journal-replayed included).",
                   [(labels, float(self.batches))])
            metric("coast_campaign_replayed_batches_total", "counter",
                   "Batches replayed from the journal on resume.",
                   [(labels, float(self.replayed_batches))])
            metric("coast_campaign_inj_per_sec", "gauge",
                   "Instantaneous physical injections per second.",
                   [(labels,
                     self.rings["inj_per_sec"].last() or 0.0)])
            metric("coast_campaign_class_total", "gauge",
                   "Weighted cumulative count per classification class.",
                   [(f'{labels},class="{_esc(k)}"', float(v))
                    for k, v in sorted(self.counts.items())]
                   or [(f'{labels},class="success"', 0.0)])
            rates = self._rates()
            if rates:
                metric("coast_campaign_class_rate", "gauge",
                       "Weighted per-class rate.",
                       [(f'{labels},class="{_esc(k)}"', v["rate"])
                        for k, v in rates.items()])
                metric("coast_campaign_class_ci_half_width", "gauge",
                       "Wilson CI half-width of the per-class rate.",
                       [(f'{labels},class="{_esc(k)}"', v["half_width"])
                        for k, v in rates.items()])
            metric("coast_campaign_stage_seconds_total", "counter",
                   "Wall-clock seconds per pipeline stage "
                   "(overlap is a fraction, exported separately).",
                   [(f'{labels},stage="{_esc(k)}"', float(v))
                    for k, v in sorted(self.stages.items())
                    if k != "overlap"]
                   or [(f'{labels},stage="dispatch"', 0.0)])
            metric("coast_campaign_serialize_overlap_ratio", "gauge",
                   "Fraction of serialization hidden under dispatch.",
                   [(labels, float(self.stages.get("overlap", 0.0)))])
            metric("coast_campaign_resilience_total", "counter",
                   "Retry / OOM-degrade / watchdog event counts.",
                   [(f'{labels},kind="{_esc(k)}"', float(v))
                    for k, v in sorted(self.resilience.items())]
                   or [(f'{labels},kind="retry_transient"', 0.0)])
            metric("coast_campaign_transfer_bytes_total", "counter",
                   "Measured host<->device traffic (up: schedule/fault "
                   "upload, billed under pad/dispatch; down: collected "
                   "results, billed under collect).",
                   [(f'{labels},direction="{_esc(k)}"', float(v))
                    for k, v in sorted(self.transfer.items())]
                   or [(f'{labels},direction="up"', 0.0)])
            if self.profile:
                metric("coast_campaign_device_busy_seconds_total",
                       "counter",
                       "Measured device-busy seconds "
                       "(per-dispatch blocking-marker attribution).",
                       [(labels,
                         float(self.profile.get("device_busy_s", 0.0)))])
                metric("coast_campaign_dispatch_gap_seconds_total",
                       "counter",
                       "Measured host-side gap seconds the device sat "
                       "idle between dispatches.",
                       [(labels,
                         float(self.profile.get("host_gap_s", 0.0)))])
            for hname, hist in sorted(self.histograms.items()):
                # The histogram exposition type: one
                # cumulative le-bucket series + _sum/_count per name.
                full = f"coast_campaign_{hname}"
                lines.append(f"# HELP {full} Per-dispatch latency "
                             "histogram (seconds).")
                lines.append(f"# TYPE {full} histogram")
                for bound, cum in zip(hist.bounds, hist.bucket_counts):
                    lines.append(
                        f'{full}_bucket{{{labels},le="{bound:g}"}} {cum}')
                lines.append(
                    f'{full}_bucket{{{labels},le="+Inf"}} {hist.count}')
                lines.append(f"{full}_sum{{{labels}}} {hist.sum:.17g}")
                lines.append(f"{full}_count{{{labels}}} {hist.count}")
            if self.memory_watermark is not None:
                metric("coast_campaign_device_memory_watermark_bytes",
                       "gauge",
                       "High-water device bytes_in_use seen.",
                       [(labels, float(self.memory_watermark))])
            if self.slo_report is not None:
                rows = self.slo_report.get("objectives") or []
                metric("coast_campaign_slo_burn_rate", "gauge",
                       "Error-budget burn rate per SLO objective "
                       "(1.0 = consuming budget exactly at the allowed "
                       "pace).",
                       [(f'{labels},objective="{_esc(r["objective"])}"',
                         float(r["burn"]["long"]))
                        for r in rows
                        if (r.get("burn") or {}).get("long")
                        is not None])
                metric("coast_campaign_slo_budget_remaining_frac",
                       "gauge",
                       "Unconsumed error-budget fraction per SLO "
                       "objective (negative = overspent).",
                       [(f'{labels},objective="{_esc(r["objective"])}"',
                         float(r["budget"]["remaining_frac"]))
                        for r in rows
                        if (r.get("budget") or {}).get("remaining_frac")
                        is not None])
                metric("coast_campaign_slo_verdict", "gauge",
                       "Per-objective verdict (0=ok, 1=warn, 2=page).",
                       [(f'{labels},objective="{_esc(r["objective"])}"',
                         float(("ok", "warn",
                                "page").index(r["verdict"])))
                        for r in rows])
            return "\n".join(lines) + "\n"

    # -- status file ---------------------------------------------------------
    def _maybe_write_status(self, force: bool = False) -> None:
        if not self.status_path:
            return
        now = self._clock()
        if not force and (now - self._last_status_write
                          < self.status_interval_s):
            return
        self._last_status_write = now
        atomic_write_json(self.status_path, self.snapshot())


def _esc(value: str) -> str:
    """Prometheus label-value escaping (backslash, quote, newline)."""
    return (str(value).replace("\\", r"\\").replace('"', r"\"")
            .replace("\n", r"\n"))
