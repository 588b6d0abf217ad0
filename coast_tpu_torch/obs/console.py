"""Live TTY dashboard for a running campaign.

Replaces the bare one-line heartbeat with a repainted panel:

    campaign matrixMultiply/TMR  [##########........]  61.2%
      342016/559104 rows   48213 inj/s (avg 45102)   eta 4s
      success      334112  59.762% +-0.041%  |#########|
      sdc            1893   0.339% +-0.005%  |         |
      ...
      stages: dispatch 61.2%  collect 30.1%  pad 5.4%  (overlap 82%)
      resilience: retry_transient=1

Repainting uses plain ANSI (cursor-up + erase-line) and only when the
output stream is a TTY; redirected to a file (or handed an ``emit``
hook, as tests do) it degrades to one appended snapshot per interval --
the same information, log-friendly.  Rate limiting matches
:class:`coast_tpu_torch.obs.heartbeat.Heartbeat`; ``final`` bypasses it so a
campaign's last state is always painted (the terminal-flush guarantee).

Rates and Wilson CI bars come straight from the counts histogram the
campaign loop already maintains; the optional ``metrics`` hub adds the
stage/resilience/memory rows.  Pure stdlib, injectable clock and emit
for tests.
"""

from __future__ import annotations

import sys
import time
from typing import Callable, Dict, Mapping, Optional

from coast_tpu_torch.obs import spans as _spans
from coast_tpu_torch.obs.convergence import StopWhen, wilson_interval

__all__ = ["Console"]

#: Classes in display order (the classifier taxonomy + the invalid-draw
#: bucket); zero-count classes that are not stop targets are elided.
_CLASS_ORDER = ("success", "corrected", "sdc", "train_self_heal",
                "train_sdc", "due_abort", "due_timeout",
                "due_stack_overflow", "due_assert", "invalid",
                "cache_invalid")

_BAR_WIDTH = 18
_CI_BAR_WIDTH = 10


class Console:
    """Rate-limited live dashboard; API-compatible with ``Heartbeat``."""

    def __init__(self, total: int, interval_s: float = 1.0,
                 label: str = "campaign",
                 emit: Optional[Callable[[str], None]] = None,
                 stream=None,
                 metrics=None,
                 stop_when: Optional[StopWhen] = None,
                 z: float = 1.96,
                 clock: Callable[[], float] = time.monotonic):
        self.total = int(total)
        self.interval_s = float(interval_s)
        self.label = label
        self.metrics = metrics
        self.stop_when = stop_when
        self.z = stop_when.z if stop_when is not None else z
        self.emitted = 0
        self._stream = stream if stream is not None else sys.stderr
        self._emit = emit
        self._clock = clock
        self._t0 = clock()
        self._last = self._t0 - self.interval_s   # first update eligible
        self._painted_lines = 0
        from coast_tpu_torch.obs.heartbeat import TransferRateWindow
        self._transfer_window = TransferRateWindow(self._t0)

    # -- painting ------------------------------------------------------------
    def _tty(self) -> bool:
        if self._emit is not None:
            return False
        try:
            return bool(self._stream.isatty())
        except Exception:        # noqa: BLE001 - closed/odd streams
            return False

    def _write(self, text: str) -> None:
        if self._emit is not None:
            self._emit(text)
            return
        n_lines = text.count("\n") + 1
        if self._tty() and self._painted_lines:
            # Cursor up over the previous panel, erasing each line, so
            # the dashboard repaints in place instead of scrolling.
            self._stream.write(
                f"\x1b[{self._painted_lines}F" + "\x1b[J")
        self._stream.write(text + "\n")
        self._stream.flush()
        self._painted_lines = n_lines if self._tty() else 0

    def render(self, done: int, counts: Optional[Mapping[str, int]],
               final: bool = False) -> str:
        counts = dict(counts or {})
        now = self._clock()
        elapsed = max(now - self._t0, 1e-9)
        rate = done / elapsed
        frac = done / self.total if self.total else 0.0
        fill = int(_BAR_WIDTH * min(frac, 1.0))
        bar = "#" * fill + "." * (_BAR_WIDTH - fill)
        state = "done" if final else "live"
        lines = [f"{self.label}  [{bar}]  {100.0 * frac:5.1f}%  ({state})"]
        eta = ""
        if self.total and rate > 0 and done < self.total:
            eta = f"   eta {(self.total - done) / rate:.0f}s"
        lines.append(f"  {done}/{self.total} rows   {rate:.0f} inj/s{eta}")
        total_eff = float(sum(counts.values()))
        peak_hw = max((self._half_width(counts.get(k, 0), total_eff)
                       for k in counts), default=0.0) or 1.0
        for cls_name in _CLASS_ORDER:
            k = counts.get(cls_name, 0)
            is_target = (self.stop_when is not None
                         and cls_name in self.stop_when.targets)
            if not k and not is_target:
                continue
            p = (k / total_eff) if total_eff else 0.0
            hw = self._half_width(k, total_eff)
            # CI bar: wider interval = longer bar, so convergence is the
            # bars visibly draining toward empty.
            ci_fill = int(_CI_BAR_WIDTH * min(hw / peak_hw, 1.0))
            ci_bar = "#" * ci_fill + " " * (_CI_BAR_WIDTH - ci_fill)
            target = ""
            if is_target:
                threshold = self.stop_when.targets[cls_name]
                mark = "v" if hw <= threshold else ">"
                target = f"  {mark} {threshold:g}"
            lines.append(
                f"  {cls_name:<18} {int(k):>9}  {100.0 * p:7.3f}% "
                f"+-{100.0 * hw:6.3f}%  |{ci_bar}|{target}")
        stage_line = self._stage_line()
        if stage_line:
            lines.append(stage_line)
        transfer_line = self._transfer_line(now)
        if transfer_line:
            lines.append(transfer_line)
        res_line = self._resilience_line()
        if res_line:
            lines.append(res_line)
        slo_line = self._slo_line()
        if slo_line:
            lines.append(slo_line)
        return "\n".join(lines)

    def _half_width(self, k: float, n: float) -> float:
        lo, hi = wilson_interval(k, n, self.z)
        return (hi - lo) / 2.0

    def _stage_line(self) -> Optional[str]:
        if self.metrics is None:
            return None
        stages = _spans.top_stages(self.metrics.stages)
        overlap = stages.pop("overlap", None)
        seconds_total = sum(stages.values())
        if not seconds_total:
            return None
        parts = [f"{k} {100.0 * v / seconds_total:.1f}%"
                 for k, v in sorted(stages.items(), key=lambda kv: -kv[1])
                 if v > 0][:4]
        line = "  stages: " + "  ".join(parts)
        if overlap:
            line += f"  (overlap {100.0 * overlap:.0f}%)"
        mem = self.metrics.memory_watermark
        if mem:
            line += f"  mem {mem / 2**20:.0f}MiB"
        return line

    def _transfer_line(self, now: float) -> Optional[str]:
        """Live host<->device link rates from the hub's cumulative
        transfer counters (the summary's ``transfer_bytes``, live),
        plus the profiler's device-busy fraction when one is armed."""
        if self.metrics is None:
            return None
        profile = dict(getattr(self.metrics, "profile", None) or {})
        from coast_tpu_torch.obs.heartbeat import format_rate
        parts = []
        got = self._transfer_window.rates(
            now, getattr(self.metrics, "transfer", None))
        if got is not None:
            up_rate, down_rate, up, down = got
            parts.append(f"link up {format_rate(up_rate)}"
                         f" / down {format_rate(down_rate)}"
                         f"  (total {up + down} B)")
        busy = profile.get("device_busy_s")
        if busy is not None:
            # Same definition as every recorded surface
            # (device_busy_fraction = busy / wall): busy over the
            # campaign elapsed time, not over busy+gap.
            elapsed = max(now - self._t0, 1e-9)
            parts.append(
                f"device busy {100.0 * float(busy) / elapsed:.0f}%")
        return "  " + "  ".join(parts) if parts else None

    def _resilience_line(self) -> Optional[str]:
        if self.metrics is None:
            return None
        hot = {k: v for k, v in self.metrics.resilience.items() if v}
        if not hot:
            return None
        return "  resilience: " + " ".join(
            f"{k}={v}" for k, v in sorted(hot.items()))

    def _slo_line(self) -> Optional[str]:
        """Live reliability-SLO verdict (worst burning objective plus
        its remaining error budget) when the hub carries an SLO set."""
        status = getattr(self.metrics, "slo_status", None)
        if self.metrics is None or status is None:
            return None
        from coast_tpu_torch.obs.slo import status_line
        frag = status_line(status())
        return f"  {frag}" if frag else None

    # -- the Heartbeat-compatible surface ------------------------------------
    def update(self, done: int, counts: Optional[Mapping[str, int]] = None,
               force: bool = False) -> Optional[str]:
        """Repaint if the interval elapsed (or ``force``); returns the
        painted panel or None when rate-limited."""
        now = self._clock()
        if not force and now - self._last < self.interval_s:
            return None
        self._last = now
        panel = self.render(done, counts)
        self.emitted += 1
        self._write(panel)
        return panel

    def final(self, done: int,
              counts: Optional[Mapping[str, int]] = None) -> str:
        """Terminal flush: always paints (rate limiter bypassed) and, on
        a TTY, leaves the last panel in the scrollback instead of
        erasing it on the next repaint."""
        panel = self.render(done, counts, final=True)
        self.emitted += 1
        self._write(panel)
        self._painted_lines = 0      # never repaint over the final state
        return panel
