"""Chrome/Perfetto ``trace_event`` export of a Telemetry recording.

Emits the JSON Object Format of the Trace Event spec (the format both
``chrome://tracing`` and https://ui.perfetto.dev open directly): a
``traceEvents`` array of

  * ``ph:"X"`` complete events for spans (``ts``/``dur`` in
    microseconds; Perfetto infers nesting from containment on one
    track, matching the recorded span depths),
  * ``ph:"C"`` counter events for counters and gauges (one series per
    name, so pad-waste and heartbeat rates plot as graphs), and
  * ``ph:"i"`` instant events for point marks (heartbeats).

Timestamps are relative to the recorder's ``origin`` so a trace always
starts near t=0; the construction wall-clock is carried in
``otherData.epoch_unix_s`` for correlation with logs.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from coast_tpu_torch.obs.spans import Telemetry

# One synthetic process: the campaign loop is single-threaded and one
# host track renders the nested stage spans the way they ran.  The
# profiler's device-attributed spans (``span_at(..., device=True)``)
# land on their own track so Perfetto shows device-busy windows BESIDE
# the host stages instead of nested inside them.
_PID = 1
_TID = 1
_DEVICE_TID = 2


def _origin(telemetry: Telemetry) -> float:
    """Export time zero: the recorder's origin, or the earliest event if
    one precedes it.  Journal-replayed spans from a crashed campaign are
    re-materialised at their original (earlier) wall-clock offsets
    (``Telemetry.span_at``); shifting to the true minimum keeps every
    exported ``ts`` non-negative and the resumed trace one coherent
    timeline."""
    origin = telemetry.origin
    for e in telemetry.events:
        t = float(e["t0"]) if e["kind"] == "span" else float(e["t"])
        if t < origin:
            origin = t
    return origin


def to_trace_events(telemetry: Telemetry,
                    process_name: str = "coast_tpu campaign"
                    ) -> List[Dict[str, object]]:
    """The recorder's events as trace_event dicts, exit-order preserved."""
    origin = _origin(telemetry)

    def _us(t: float) -> float:
        return round((t - origin) * 1e6, 3)

    events: List[Dict[str, object]] = [{
        "name": "process_name", "ph": "M", "pid": _PID, "tid": _TID,
        "args": {"name": process_name},
    }, {
        "name": "thread_name", "ph": "M", "pid": _PID, "tid": _TID,
        "args": {"name": "host"},
    }, {
        "name": "thread_name", "ph": "M", "pid": _PID,
        "tid": _DEVICE_TID, "args": {"name": "device"},
    }]
    for e in telemetry.events:
        kind = e["kind"]
        args = e.get("args") or {}
        if kind == "span":
            events.append({
                "name": e["name"],
                "cat": ("device" if args.get("device") else
                        "replay" if args.get("replayed") else "stage"),
                "ph": "X",
                "pid": _PID,
                "tid": _DEVICE_TID if args.get("device") else _TID,
                "ts": _us(float(e["t0"])),                  # type: ignore
                "dur": round((float(e["t1"]) - float(e["t0"]))  # type: ignore
                             * 1e6, 3),
                "args": args,
            })
        elif kind in ("counter", "gauge"):
            events.append({
                "name": e["name"], "cat": kind, "ph": "C",
                "pid": _PID, "tid": _TID,
                "ts": _us(float(e["t"])),                   # type: ignore
                "args": {str(e["name"]): e["value"]},
            })
        elif kind == "instant":
            events.append({
                "name": e["name"], "cat": "mark", "ph": "i",
                "pid": _PID, "tid": _TID, "s": "t",
                "ts": _us(float(e["t"])),                   # type: ignore
                "args": args,
            })
    return events


def to_trace_doc(telemetry: Telemetry,
                 metadata: Optional[Dict[str, object]] = None,
                 process_name: str = "coast_tpu campaign"
                 ) -> Dict[str, object]:
    return {
        "traceEvents": to_trace_events(telemetry, process_name),
        "displayTimeUnit": "ms",
        "otherData": {"epoch_unix_s": round(telemetry.epoch, 6),
                      **(metadata or {})},
    }


def write_trace(telemetry: Telemetry, path: str,
                metadata: Optional[Dict[str, object]] = None,
                process_name: str = "coast_tpu campaign") -> str:
    """Write the Perfetto-loadable trace JSON; returns ``path``."""
    with open(path, "w") as f:
        json.dump(to_trace_doc(telemetry, metadata, process_name), f)
    return path
