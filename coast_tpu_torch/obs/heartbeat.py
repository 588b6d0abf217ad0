"""Periodic progress heartbeat for long campaigns (the port's copy of
``coast_tpu/obs/heartbeat.py``, line for line in its output).

A 10^6-injection campaign on a dev box, or a flagship campaign at a few
hundred inj/s, runs minutes with nothing on the terminal between
chunks.  ``Heartbeat`` rate-limits a one-line progress report --

    # heartbeat: 300000/1000000 (30.0%) 45231 inj/s eta 15s sdc=28702 ...

-- emitted at most once per ``interval_s`` no matter how often
``update`` is called (call it per batch or per chunk; it is a no-op
until the interval elapses).  Each emission also drops an ``instant``
mark plus an ``inj_per_sec`` gauge into the ambient telemetry, so the
heartbeat cadence is visible in an exported Perfetto trace.

``clock`` and ``emit`` are injectable for tests (and for routing the
line somewhere other than stderr).
"""

from __future__ import annotations

import sys
import time
from typing import Callable, Dict, Optional

from coast_tpu_torch.obs import spans as _spans

# Classes worth a heartbeat column, in print order; zero-count classes
# are elided to keep the line short.
_COUNT_KEYS = ("success", "corrected", "sdc", "train_self_heal",
               "train_sdc", "due_abort", "due_timeout",
               "due_stack_overflow", "due_assert", "invalid",
               "cache_invalid")


def _stderr(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def format_rate(bytes_per_s: float) -> str:
    """Human bytes/s ('1.2 MB/s'), shared with the console dashboard."""
    v = float(bytes_per_s)
    for unit, scale in (("GB", 1e9), ("MB", 1e6), ("kB", 1e3)):
        if v >= scale:
            return f"{v / scale:.1f} {unit}/s"
    return f"{v:.0f} B/s"


class TransferRateWindow:
    """Cumulative up/down byte counters -> per-window rates.  The one
    windowing implementation behind both the heartbeat's ``up=/down=``
    fields and the console's link line (same ``_prev`` state shape,
    same dt clamp)."""

    def __init__(self, t0: float):
        self._prev = (float(t0), 0, 0)

    def rates(self, now: float, transfer) -> "Optional[tuple]":
        """(up_bytes_per_s, down_bytes_per_s, up_total, down_total) over
        the window since the previous call, or None before the first
        measured byte."""
        transfer = dict(transfer or {})
        if not transfer:
            return None
        up = int(transfer.get("up", 0))
        down = int(transfer.get("down", 0))
        t_prev, up_prev, down_prev = self._prev
        self._prev = (float(now), up, down)
        dt = max(float(now) - t_prev, 1e-9)
        return ((up - up_prev) / dt, (down - down_prev) / dt, up, down)


class Heartbeat:
    """Rate-limited progress reporter for a campaign of ``total`` runs.

    ``metrics`` (a :class:`coast_tpu_torch.obs.metrics.CampaignMetrics` hub
    the same campaign feeds) adds a live host<->device transfer rate to
    each beat: the summary's ``transfer_bytes``, visible while the
    campaign it describes is still running."""

    def __init__(self, total: int, interval_s: float = 5.0,
                 label: str = "heartbeat",
                 emit: Optional[Callable[[str], None]] = None,
                 metrics=None,
                 clock: Callable[[], float] = time.monotonic):
        self.total = int(total)
        self.interval_s = float(interval_s)
        self.label = label
        self.metrics = metrics
        self.emitted = 0
        self._emit = emit or _stderr
        self._clock = clock
        self._t0 = clock()
        self._transfer_window = TransferRateWindow(self._t0)
        # First update is eligible immediately: a long first batch should
        # not run silent for interval_s before the first report.
        self._last = self._t0 - self.interval_s

    def _transfer_parts(self, now: float) -> list:
        """Up/down rates over the window since the previous beat, from
        the hub's cumulative transfer counters; empty before the first
        measured byte."""
        if self.metrics is None:
            return []
        got = self._transfer_window.rates(
            now, getattr(self.metrics, "transfer", None))
        if got is None:
            return []
        up_rate, down_rate, _up, _down = got
        return [f"up={format_rate(up_rate)}",
                f"down={format_rate(down_rate)}"]

    def _slo_part(self) -> list:
        """Live SLO status from the hub (worst burning objective plus
        its remaining budget); empty when the hub carries no SLO set or
        nothing was evaluated yet."""
        status = getattr(self.metrics, "slo_status", None)
        if self.metrics is None or status is None:
            return []
        from coast_tpu_torch.obs.slo import status_line
        frag = status_line(status())
        return [frag] if frag else []

    def update(self, done: int, counts: Optional[Dict[str, int]] = None,
               force: bool = False) -> Optional[str]:
        """Report progress if the interval elapsed (or ``force``).

        Returns the emitted line, or None when rate-limited.  ``counts``
        is the cumulative class histogram so far (any subset of keys).
        """
        now = self._clock()
        if not force and now - self._last < self.interval_s:
            return None
        self._last = now
        elapsed = max(now - self._t0, 1e-9)
        rate = done / elapsed
        parts = [f"# {self.label}: {done}/{self.total}"]
        if self.total:
            parts.append(f"({100.0 * done / self.total:.1f}%)")
        parts.append(f"{rate:.0f} inj/s")
        if self.total and rate > 0 and done < self.total:
            parts.append(f"eta {(self.total - done) / rate:.0f}s")
        if counts:
            parts.extend(f"{k}={counts[k]}" for k in _COUNT_KEYS
                         if counts.get(k))
        parts.extend(self._transfer_parts(now))
        parts.extend(self._slo_part())
        line = " ".join(parts)
        self.emitted += 1
        self._emit(line)
        tel = _spans.current()
        tel.instant("heartbeat", done=done, total=self.total)
        tel.gauge("inj_per_sec", round(rate, 2))
        return line

    def final(self, done: int,
              counts: Optional[Dict[str, int]] = None) -> str:
        """Terminal flush: emit unconditionally, bypassing the rate
        limiter.  A campaign's last state -- completion, or the counts
        standing when a ``CampaignWedgedError`` killed it -- must reach
        the terminal even if the previous beat was milliseconds ago."""
        return self.update(done, counts, force=True)
