"""Per-dispatch device-time attribution for the campaign loop.

The port's counterpart of ``coast_tpu/obs/profiler.py``: the same
lifecycle, identity, histograms and profile block.  Two things differ,
both from how the port's engine reaches the card: the marker is a
``torch.cuda.Event`` the campaign loop records after a batch's last
launch and synchronises on at the collect (on the CPU the collect's own
block), and the dispatch drives the step loop from the host (one host
sync a trip), so the card is busy from the dispatch's start, not from its
end (see ``ready``).

The span layer (:mod:`coast_tpu_torch.obs.spans`) times HOST stages;
:class:`CampaignProfiler` adds the device timeline:

  * per dispatch (one campaign batch), the **device-busy duration** and
    the **host-side gap** the device spent idle waiting for the host
    (journal fsync, stream feeds, padding, Python);
  * the whole-campaign identity ``wall = device_busy + host_gap +
    host_other`` (head before the first enqueue + tail after the last
    ready), exact by construction;
  * a per-dispatch device-seconds histogram (the Prometheus *histogram*
    exporter type in :mod:`coast_tpu_torch.obs.metrics`);
  * per protected-region-phase attribution: the training step's
    fwd/bwd/commit split each dispatch's busy window by their analytic
    work shares (:func:`coast_tpu_torch.obs.roofline.phase_split`);
    single-phase regions get one ``device:step`` span.

Measurement is the **blocking marker**: the collect path blocks on the
dispatched batch's ready event under timing, so

    busy_i = t_ready_i - max(t_enqueue_start_i, t_ready_{i-1})
    gap_i  = max(0, t_enqueue_start_i - t_ready_{i-1})

A ready that lands while the host was busy is observed late, so
``busy`` is an upper bound and ``gap`` a lower bound -- the
conservative direction for the "the gap is host-side bookkeeping"
claim.  Arm ``Telemetry(profiler=True)`` alongside to bracket the same
spans with ``torch.profiler.record_function`` for a captured device
trace; the numbers recorded here come from the markers either way, so
CPU tests can pin them.

The DISABLED path (``CampaignRunner(profile=False)``, the default) adds
one ``is not None`` test per batch to the campaign loop.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from coast_tpu_torch.obs import roofline
from coast_tpu_torch.obs.metrics import Histogram

__all__ = ["CampaignProfiler"]


class CampaignProfiler:
    """Single-writer per-dispatch timeline recorder for one runner.

    The campaign loop calls ``begin`` / ``dispatched`` / ``ready`` /
    ``finish``; ``finish`` returns the JSON-able profile block (and the
    roofline ``mfu`` sub-block) attached to ``CampaignResult.profile``.
    One profiler serves consecutive campaigns of one runner; state
    resets at every ``begin``.
    """

    def __init__(self, prog=None, telemetry=None,
                 peak_gflops: Optional[float] = None,
                 hbm_gbps: float = roofline.DEFAULT_HBM_GBPS):
        self.prog = prog
        self.telemetry = telemetry
        self.peak_gflops = peak_gflops
        self.hbm_gbps = float(hbm_gbps)
        self.phases: List[Tuple[str, float]] = (
            roofline.phase_split(prog.region) if prog is not None
            else [("step", 1.0)])
        self._ops: Optional[Dict[str, float]] = None   # cached op counts
        # The campaign loop is the single LOGICAL writer, but a watchdog
        # (retry.collect_timeout) runs the blocking fetch -- and thus
        # ``ready`` -- on a worker thread, and an abandoned (timed-out)
        # fetch thread can outlive its flight: the lock keeps a straggler
        # from corrupting the accumulators mid-update.  (The collect
        # wrapper additionally drops a straggler's ready once its flight
        # was re-dispatched -- see campaign.py.)
        self._lock = threading.Lock()
        self.begin(time.perf_counter())

    # -- per-campaign lifecycle ----------------------------------------------
    def begin(self, t0: float) -> None:
        self._t_begin = float(t0)
        self._disp: Dict[int, Tuple[float, float, int]] = {}
        self._prev_ready: Optional[float] = None
        self._busy_s = 0.0
        self._gap_s = 0.0
        self._rows = 0
        self._dispatches = 0
        self._per_phase = {name: 0.0 for name, _w in self.phases}
        self.hist_device = Histogram()
        self.hist_gap = Histogram()
        self._last_sample: Optional[Dict[str, float]] = None

    def dispatched(self, lo: int, n: int, t0: float, t1: float) -> None:
        """One batch's (re-)enqueue window; keyed by its schedule row so
        a retry's re-dispatch replaces the stale record."""
        with self._lock:
            self._disp[int(lo)] = (float(t0), float(t1), int(n))

    def ready(self, lo: int, n: int, t_ready: float) -> None:
        """The blocking marker came back for batch ``lo``: attribute the
        interval since the previous ready into device-busy vs host-gap,
        and emit the per-phase device spans into the telemetry."""
        with self._lock:
            rec = self._disp.pop(int(lo), None)
            if rec is None:       # ready without a dispatch record: skip
                return
            # The dispatch drives the step loop on the host, launching
            # as it goes: the card is busy from its start.
            enq0, _enq1, _n_rec = rec
            prev = (self._prev_ready if self._prev_ready is not None
                    else enq0)
            busy_start = max(enq0, prev)
            busy = max(0.0, float(t_ready) - busy_start)
            gap = max(0.0, enq0 - prev)
            self._busy_s += busy
            self._gap_s += gap
            self._rows += int(n)
            self._dispatches += 1
            self._prev_ready = float(t_ready)
            self.hist_device.observe(busy)
            self.hist_gap.observe(gap)
            self._last_sample = {"device_s": busy, "gap_s": gap}
            tel = self.telemetry
            if busy > 0.0:
                at = busy_start
                for name, w in self.phases:
                    dur = busy * w
                    self._per_phase[name] += dur
                    if tel is not None and tel.enabled:
                        tel.span_at(f"device:{name}", at, at + dur,
                                    device=True, lo=int(lo), n=int(n))
                    at += dur

    def batch_sample(self) -> Optional[Dict[str, float]]:
        """The most recent ready's {device_s, gap_s} -- what the live
        metrics hub observes into its histograms per batch."""
        return self._last_sample

    def finish(self, t_end: float, wall_s: Optional[float] = None
               ) -> Dict[str, object]:
        """Close the campaign window and return the profile block.

        ``host_other_s`` is the loop's head (before the first enqueue)
        plus its tail (after the last ready: final classify, result
        assembly), so ``device_busy + host_gap + host_other == wall``
        exactly -- a journal-replayed prefix (no live dispatches) lands
        in ``host_other`` like any other non-device time."""
        wall = float(wall_s) if wall_s is not None \
            else float(t_end) - self._t_begin
        other = max(0.0, wall - self._busy_s - self._gap_s)
        profile: Dict[str, object] = {
            "dispatches": self._dispatches,
            "rows": self._rows,
            "wall_s": round(wall, 6),
            "device_busy_s": round(self._busy_s, 6),
            "host_gap_s": round(self._gap_s, 6),
            "host_other_s": round(other, 6),
            "device_busy_fraction": round(self._busy_s / wall, 6)
            if wall > 0 else 0.0,
            "dispatch_gap_fraction": round(self._gap_s / wall, 6)
            if wall > 0 else 0.0,
            "per_phase_device_s": {name: round(s, 6)
                                   for name, s in self._per_phase.items()},
            "device_seconds_histogram": self.hist_device.snapshot(),
            "host_gap_seconds_histogram": self.hist_gap.snapshot(),
            "backend": roofline._backend(self.prog),
        }
        if self.prog is not None:
            if self._ops is None:
                self._ops = {
                    "useful": roofline.region_ops_per_run(self.prog.region),
                    "program": roofline.program_ops_per_run(self.prog)}
            profile["mfu"] = roofline.mfu_block(
                self.prog, runs=self._rows,
                device_busy_s=self._busy_s, wall_s=wall,
                dispatch_gap_fraction=profile["dispatch_gap_fraction"],
                peak_gflops=self.peak_gflops, hbm_gbps=self.hbm_gbps,
                ops=self._ops)
        return profile
