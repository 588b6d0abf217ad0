"""The traced window, reduced: device intervals, busy time, idle gaps.

``record`` runs a function under ``torch.profiler`` (device activity
only: tracing host operators would slow the host loop it is meant to
show).  Right after the profiler starts, one marker kernel is launched on
an idle device at a known host time; its start in the trace aligns the
device's clock with the host's, so the window's bounds and the program's
host stage spans can be laid over the device timeline.  ``reduce`` then
works on plain ``(name, start_ns, end_ns)`` tuples, so it is testable
without a card.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from perfbench import kernels

Interval = Tuple[str, int, int]
OUTSIDE = "between campaigns (benchmark loop)"


@dataclasses.dataclass
class Reduced:
    """What the per-layer readers read of a traced window."""

    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]          # device seconds by kernel name
    kernel_count: Dict[str, int]        # launches by kernel name
    idle_by_stage: Dict[str, float]     # idle seconds by host stage

    def layer_s(self, layer: str) -> float:
        return sum(s for name, s in self.kernel_s.items()
                   if kernels.layer_of(name) == layer)

    @property
    def launches(self) -> int:
        return sum(c for name, c in self.kernel_count.items()
                   if not kernels.is_copy(name))

    def breakdown(self) -> Dict[str, List[List[object]]]:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_by_stage.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[name[:160], s] for name, s in ops],
                "idle_gaps": [[name, s] for name, s in gaps]}


def _union(starts: np.ndarray, ends: np.ndarray
           ) -> Tuple[np.ndarray, np.ndarray]:
    """Merged busy intervals of possibly overlapping ones."""
    if starts.size == 0:
        return starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(s.size, bool)
    new[1:] = s[1:] > reach[:-1]
    first = np.flatnonzero(new)
    last = np.r_[first[1:] - 1, s.size - 1]
    return s[first], reach[last]


def reduce(events: Sequence[Interval], window: Tuple[int, int],
           spans: Sequence[Tuple[str, int, int]]) -> Reduced:
    """``events``: device operations as ``(name, start_ns, end_ns)``;
    ``window``: the measured window in the same clock; ``spans``: the host
    stages, top level, in the same clock."""
    w0, w1 = window
    kernel_s: Dict[str, float] = {}
    kernel_count: Dict[str, int] = {}
    starts, ends = [], []
    for name, a, b in events:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        kernel_s[name] = kernel_s.get(name, 0.0) + (b - a) / 1e9
        kernel_count[name] = kernel_count.get(name, 0) + 1
        starts.append(a)
        ends.append(b)
    bs, be = _union(np.asarray(starts, np.int64), np.asarray(ends, np.int64))
    busy = int((be - bs).sum())
    # Idle gaps: the window's complement of the busy runs.
    gap_s = np.r_[w0, be]
    gap_e = np.r_[bs, w1]
    keep = gap_e > gap_s
    gap_s, gap_e = gap_s[keep], gap_e[keep]
    idle: Dict[str, float] = {}
    sp = sorted(spans, key=lambda x: x[1])
    sp_start = np.asarray([x[1] for x in sp], np.int64)
    for a, b in zip(gap_s.tolist(), gap_e.tolist()):
        # Split each gap over the host stages it overlaps.
        lo = max(int(np.searchsorted(sp_start, a, side="right")) - 1, 0)
        covered = 0
        for name, s0, s1 in sp[lo:]:
            if s0 >= b:
                break
            part = min(b, s1) - max(a, s0)
            if part > 0:
                idle[name] = idle.get(name, 0.0) + part / 1e9
                covered += part
        if b - a - covered > 0:
            idle[OUTSIDE] = idle.get(OUTSIDE, 0.0) + (b - a - covered) / 1e9
    return Reduced(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9,
                   kernel_s=kernel_s, kernel_count=kernel_count,
                   idle_by_stage=idle)


def _device_events(prof) -> List[Interval]:
    import torch
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        start = int(e.start_ns())
        out.append((e.name(), start, start + int(e.duration_ns())))
    return out


def record(fn: Callable[[], object], device) -> Tuple[object, Dict]:
    """Run ``fn`` (the measured window) under the profiler.  Returns its
    value and the raw trace: device events, the window and the clock
    offsets that map host ``perf_counter`` and wall times onto it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    marker = torch.empty(1024, dtype=torch.int32, device=device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(device)
        mark_ns = time.time_ns()
        marker.fill_(7)
        torch.cuda.synchronize(device)
        pc0, w0 = time.perf_counter(), time.time_ns()
        value = fn()
        torch.cuda.synchronize(device)
        w1 = time.time_ns()
    events = _device_events(prof)
    if not events:
        raise RuntimeError("the profiler recorded no device operation")
    first = min(events, key=lambda e: e[1])
    offset = first[1] - mark_ns           # device clock - host wall clock
    return value, {"events": events, "window": (w0 + offset, w1 + offset),
                   "perf_to_device": (w0 + offset) - int(pc0 * 1e9)}
