"""Lightweight campaign telemetry: nested wall-clock spans + counters.

The port's copy of ``coast_tpu/obs/spans.py``: the same recorder, names
and event shapes; ``profiler=True`` brackets each span with
``torch.profiler.record_function`` so a captured torch profile shows the
host stages around the card's kernels.

The reference platform logs one injection every few seconds, so "which
stage is slow" is answerable by watching the terminal.  A batched engine
at ~10^5..10^6 injections/sec needs the question answered by *recorded
data*: per-stage wall-clock attribution (schedule generation, host
padding, dispatch, device collect, classification, serialization) on
every campaign, cheap enough to stay on by default.

Design constraints, in order:

  * **Overhead**: one enabled span costs two ``time.perf_counter()``
    calls and one list append; a disabled span costs one attribute test.
    The acceptance bar is < 2% of campaign wall-clock at production
    batch sizes.
  * **No dependencies**: pure stdlib; ``torch.profiler`` is an
    *optional* bracket (``profiler=True``) so device-side traces can be
    correlated with these host-side spans, never a requirement.
  * **Single writer**: a campaign loop is single-threaded; the event
    list is append-only and unlocked.  The ambient-telemetry stack is a
    ``threading.local`` so concurrent runners in different threads do
    not cross-record.

Spans nest (depth is recorded, Perfetto renders containment), counters
are cumulative time series (``ph:"C"`` in the trace), instants mark
point events (heartbeats).  ``Telemetry.stage_totals`` aggregates
top-level span durations by name -- the ``stages`` block of
``CampaignResult.summary()`` -- and each nested span's inclusive seconds
under ``"<top-level stage>/<span>"``; ``top_stages`` picks the top-level
ones back out for anything that adds stages up.

Span times are ``perf_counter`` seconds.  Each recorder keeps clock
anchors, pairs of (``perf_counter_ns``, ``time_ns``) read together, and
``to_profiler_ns`` maps a span time onto the Unix-nanosecond clock that
``torch.profiler`` (kineto) stamps its events with, so the host spans and
a profile's device activity lie on one timeline.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

__all__ = ["Telemetry", "NULL", "current", "span", "count", "instant",
           "top_stages"]

#: Separator of a nested span's key in ``stage_totals``:
#: ``"dispatch/engine.halt_read"``.
NESTED = "/"


def top_stages(stages: Dict[str, float]) -> Dict[str, float]:
    """The top-level entries of a ``stages`` block alone, without the
    nested spans' keys (``"<stage>/<span>"``, whose seconds lie inside
    their stage's).  Whatever adds stages up or shares them out reads
    this (and leaves out ``overlap``, a fraction, on its own)."""
    return {k: v for k, v in stages.items() if NESTED not in k}


def _read_anchor() -> Tuple[int, int]:
    """One (perf_counter_ns, time_ns) pair: the wall read between two
    perf_counter reads, paired with their midpoint."""
    a = time.perf_counter_ns()
    wall = time.time_ns()
    b = time.perf_counter_ns()
    return (a + b) // 2, wall


def _env_enabled() -> bool:
    """Default on; COAST_TELEMETRY=0/off/false disables process-wide."""
    return os.environ.get("COAST_TELEMETRY", "1").lower() not in (
        "0", "off", "false", "no")


class Telemetry:
    """One recorder: an append-only event list plus counter/gauge state.

    Events are plain dicts (kind: "span" | "counter" | "gauge" |
    "instant"); timestamps are ``time.perf_counter()`` floats relative
    to nothing in particular -- ``origin`` anchors them for export, and
    ``epoch`` records the construction wall-clock for humans.
    ``anchors`` holds the clock anchors ``to_profiler_ns`` maps through:
    one read at construction, one at each ``anchor()`` call (every
    campaign's start), each also a ``clock_anchor`` instant event.
    """

    def __init__(self, enabled: Optional[bool] = None,
                 profiler: bool = False):
        self.enabled = _env_enabled() if enabled is None else bool(enabled)
        self.profiler = profiler
        self.events: List[Dict[str, object]] = []
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.origin = time.perf_counter()
        self.epoch = time.time()
        self._depth = 0
        self._trace_annotation = None     # resolved lazily, cached
        self.anchors: List[Tuple[int, int]] = []
        self.anchor()

    # -- the shared clock ----------------------------------------------------
    def anchor(self) -> None:
        """Read one clock anchor and record it as a ``clock_anchor``
        instant (none on a disabled recorder, past the construction
        anchor every recorder keeps)."""
        if self.anchors and not self.enabled:
            return
        perf_ns, unix_ns = _read_anchor()
        self.anchors.append((perf_ns, unix_ns))
        if self.enabled:
            self.events.append({"kind": "instant", "name": "clock_anchor",
                                "t": perf_ns / 1e9,
                                "args": {"perf_ns": perf_ns,
                                         "unix_ns": unix_ns}})

    def to_profiler_ns(self, t: float) -> int:
        """A span time (``perf_counter`` seconds) as Unix nanoseconds, the
        clock ``torch.profiler`` stamps host and device events with,
        through the newest anchor read at or before ``t`` (the first
        anchor for an earlier time)."""
        t_ns = int(round(t * 1e9))
        perf_ns, unix_ns = self.anchors[0]
        for a_perf, a_unix in reversed(self.anchors):
            if a_perf <= t_ns:
                perf_ns, unix_ns = a_perf, a_unix
                break
        return t_ns - perf_ns + unix_ns

    @property
    def depth(self) -> int:
        """The nesting level a span opened now would record."""
        return self._depth

    # -- spans ---------------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, **args: object) -> Iterator[None]:
        """Record one nested wall-clock span around the ``with`` body.

        The event is appended at *exit* (events are exit-ordered); the
        recorded ``depth`` is the entry nesting level, so
        ``stage_totals`` can pick top-level stages without a tree walk.
        """
        if not self.enabled:
            yield
            return
        bracket = self._profiler_bracket(name)
        if bracket is not None:
            bracket.__enter__()
        depth = self._depth
        self._depth = depth + 1
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            self._depth = depth
            self.events.append({"kind": "span", "name": name, "t0": t0,
                                "t1": t1, "depth": depth,
                                "args": args or None})
            if bracket is not None:
                bracket.__exit__(None, None, None)

    def span_at(self, name: str, t0: float, t1: float,
                depth: int = 0, **args: object) -> None:
        """Append a span with explicit ``perf_counter``-domain times.

        The journal-replay path uses this to re-materialise a crashed
        campaign's recorded batch spans into the resumed recorder, so
        one exported trace covers the whole campaign; ``t0``/``t1`` may
        precede ``origin`` (the export shifts to the earliest event).
        """
        if not self.enabled:
            return
        self.events.append({"kind": "span", "name": name,
                            "t0": float(t0), "t1": float(t1),
                            "depth": depth, "args": args or None})

    def _profiler_bracket(self, name: str):
        """Optional ``torch.profiler.record_function`` so these host spans
        show up inside a captured torch profile; None when off or
        unavailable."""
        if not self.profiler:
            return None
        if self._trace_annotation is None:
            try:
                from torch.profiler import record_function
                self._trace_annotation = record_function
            except Exception:          # profiler missing: stay host-only
                self.profiler = False
                return None
        return self._trace_annotation(name)

    # -- counters / gauges / instants ----------------------------------------
    def count(self, name: str, delta: float = 1, **args: object) -> None:
        """Cumulative counter: records the post-increment running total."""
        if not self.enabled:
            return
        value = self.counters.get(name, 0) + delta
        self.counters[name] = value
        self.events.append({"kind": "counter", "name": name,
                            "t": time.perf_counter(), "value": value,
                            "args": args or None})

    def gauge(self, name: str, value: float, **args: object) -> None:
        """Point-in-time level (last-write-wins in ``gauges``)."""
        if not self.enabled:
            return
        self.gauges[name] = value
        self.events.append({"kind": "gauge", "name": name,
                            "t": time.perf_counter(), "value": value,
                            "args": args or None})

    def instant(self, name: str, **args: object) -> None:
        """Zero-duration mark (heartbeats, chunk boundaries)."""
        if not self.enabled:
            return
        self.events.append({"kind": "instant", "name": name,
                            "t": time.perf_counter(), "args": args or None})

    # -- aggregation ---------------------------------------------------------
    def mark(self) -> int:
        """Checkpoint for ``stage_totals(since=...)`` windows."""
        return len(self.events)

    def stage_totals(self, since: int = 0) -> Dict[str, float]:
        """Wall-clock seconds per span name over events[since:].

        *Top-level* spans in the window (minimum recorded depth) count
        under their own names, so a nested helper span never double-bills
        its parent stage; every nested span's inclusive seconds count
        under ``"<top-level stage>/<span>"`` (``top_stages`` drops them
        again).  Multiple same-name spans (one per batch) sum.  Events
        are exit-ordered, so a nested span belongs to the next top-level
        span that closes after it; one whose stage has not closed in the
        window counts nowhere.

        Journal-replayed spans (``span_at(..., replayed=True)``) are
        excluded: they exist for trace continuity, but their seconds
        belong to the crashed run -- counting them would make a resumed
        campaign's stage totals exceed its own wall clock.  Device-
        attributed spans (``span_at(..., device=True)``, the campaign
        profiler's per-phase windows) are excluded for the dual reason:
        they re-time work already billed to the host-side
        dispatch/collect stages on another track -- counting them would
        double-bill the device seconds into the host stage table.
        """
        spans = [e for e in self.events[since:] if e["kind"] == "span"
                 and not (e.get("args") or {}).get("replayed")
                 and not (e.get("args") or {}).get("device")]
        if not spans:
            return {}
        top = min(e["depth"] for e in spans)     # type: ignore[type-var]
        totals: Dict[str, float] = {}
        nested: List[Tuple[str, float]] = []
        for e in spans:
            seconds = float(e["t1"]) - float(e["t0"])  # type: ignore[arg-type]
            if e["depth"] != top:
                nested.append((str(e["name"]), seconds))
                continue
            name = str(e["name"])
            totals[name] = totals.get(name, 0.0) + seconds
            for child, sec in nested:
                key = name + NESTED + child
                totals[key] = totals.get(key, 0.0) + sec
            nested.clear()
        return totals

    def reset(self) -> None:
        self.events.clear()
        self.counters.clear()
        self.gauges.clear()
        self._depth = 0

    # -- ambient activation --------------------------------------------------
    @contextlib.contextmanager
    def activate(self) -> Iterator["Telemetry"]:
        """Make this recorder the ambient one (``obs.current()``) for the
        ``with`` body, so free functions deep in the pipeline (schedule
        generation, log writers) record here without threading a handle
        through every signature."""
        stack = _ambient.__dict__.setdefault("stack", [])
        stack.append(self)
        try:
            yield self
        finally:
            stack.pop()


#: Shared no-op recorder: the ambient default, so ``current().span(...)``
#: is always safe and costs one attribute test when nothing is active.
NULL = Telemetry(enabled=False)

_ambient = threading.local()


def current() -> Telemetry:
    """The innermost activated Telemetry of this thread, else ``NULL``."""
    stack = getattr(_ambient, "stack", None)
    return stack[-1] if stack else NULL


def span(name: str, **args: object):
    """``current().span(...)`` -- the one-liner for instrumenting free
    functions."""
    return current().span(name, **args)


def count(name: str, delta: float = 1, **args: object) -> None:
    current().count(name, delta, **args)


def instant(name: str, **args: object) -> None:
    current().instant(name, **args)
