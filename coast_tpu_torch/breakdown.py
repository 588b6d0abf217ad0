"""Where the device time of a campaign goes, by kernel and by layer.

After one warm-up batch it runs one seeded campaign on the card twice:
once plain (its wall clock gives the rate) and once under ``torch.profiler``
(device activity only).  It prints the device time of every kernel,
grouped into the layers of the port: the region's product (cuBLAS), the
region's and the engine's elementwise tensor work (copies, selects, casts,
row indexing, the flip), and the K1 vote and K2 commit kernels
(``--fuse-step`` runs the fused engine), each kernel layer with its
launches a loop trip (one grouped launch per sync point that has sites).
The device's busy time is the union of its activity intervals (kernels on
several streams overlap), its share the busy time over the campaign's
wall clock.  The program's spans (the runner's ``Telemetry``) are laid
over the device's timeline through ``Telemetry.to_profiler_ns``, the
clock the profiler stamps device activity with, and every idle stretch of
the device is billed to the innermost span the host was in (``idle_s``;
"(no span)" where it was in none).  ``--fault-model SPEC`` draws flip
groups (``inject/schedule.FaultModel``); ``--collect sparse`` runs the
sparse collect and reads its own layers, the device generator's columns
and the device accounting, from the profiled campaign's spans
(``campaign.SPANS``, bracketed by ``Telemetry(profiler=True)`` in the
profiled run: their kernels are elementwise ones, counted in that layer
too).  A span's device time needs the host ops traced, so a sparse
profile records them, and its profiled wall is the longer for it; the rate
comes from the unprofiled run either way.  The JSON record goes to
``--out``.

    python3 -m coast_tpu_torch.breakdown --bench matrixMultiply1024 \\
        --strategy TMR --n 256 --batch-size 128 --out breakdown.json
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from coast_tpu_torch import device as device_mod
from coast_tpu_torch import obs
from coast_tpu_torch.inject import campaign as campaign_mod
from coast_tpu_torch.inject.campaign import CampaignRunner
from coast_tpu_torch.inject.schedule import FaultModel
from coast_tpu_torch.models import REGISTRY
from coast_tpu_torch.ops import hopper_commit, hopper_voters
from coast_tpu_torch.passes import strategies

_WRAPPERS = (("K1 vote", hopper_voters), ("K2 commit", hopper_commit))

# Kernel names: csrc/vote.cu ``vote_kernel<N>``, csrc/commit.cu
# ``commit_kernel<N>``; ``LAUNCHES`` is their wrappers' launch count.
LAYERS = (("K1 vote", ("vote_kernel",)),
          ("K2 commit", ("commit_kernel",)),
          ("product (cuBLAS)", ("gemm", "cutlass", "xmma", "cublas")),
          ("memcpy/memset", ("memcpy", "memset")))
SEED = 1   # the campaign seed chip_smoke.py uses
NO_SPAN = "(no span)"


def layer_of(kernel: str) -> str:
    low = kernel.lower()
    for layer, keys in LAYERS:
        if any(k in low for k in keys):
            return layer
    return "elementwise / indexing"


def _device_us(evt, own: bool = True) -> float:
    """An event's device microseconds: its own (a kernel), or those of
    every kernel launched inside it (a span)."""
    attrs = (("self_device_time_total", "self_cuda_time_total") if own
             else ("device_time_total", "cuda_time_total"))
    for attr in attrs:
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _on_device(evt) -> bool:
    return getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA


def _annotations(prof) -> set:
    """Names of the profile's user annotations (``record_function``
    brackets), whose device-side mirrors are not kernels."""
    return ({e.name for e in prof.events()
             if getattr(e, "is_user_annotation", False)}
            | set(campaign_mod.SPANS))


def kernel_times(prof) -> List[Dict[str, object]]:
    """Per-kernel device microseconds and counts, largest first (a span's
    device-side mirror is not a kernel)."""
    rows = []
    skip = _annotations(prof)
    for evt in prof.key_averages():
        if not _on_device(evt) or evt.key in skip:
            continue
        us = _device_us(evt)
        if us > 0:
            rows.append({"kernel": evt.key, "us": us, "count": evt.count,
                         "layer": layer_of(evt.key)})
    return sorted(rows, key=lambda r: -r["us"])


def span_times(prof) -> Dict[str, float]:
    """Device seconds of the kernels launched inside each of the
    campaign's spans, summed over its batches."""
    spans: Dict[str, float] = {}
    for evt in prof.key_averages():
        if evt.key in campaign_mod.SPANS and not _on_device(evt):
            spans[evt.key] = (spans.get(evt.key, 0.0)
                              + _device_us(evt, own=False) / 1e6)
    return spans


def device_intervals(prof, skip: Sequence[str] = ()
                     ) -> List[Tuple[int, int]]:
    """Every device activity of the profile (kernels, copies, fills) as
    ``(start_ns, end_ns)`` on the profiler's clock; annotations and the
    names in ``skip`` are left out."""
    drop = _annotations(prof) | set(skip)
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA \
                or e.name() in drop:
            continue
        start = int(e.start_ns())
        out.append((start, start + int(e.duration_ns())))
    return out


def union(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The disjoint busy runs of possibly overlapping intervals."""
    runs: List[List[int]] = []
    for a, b in sorted(intervals):
        if runs and a <= runs[-1][1]:
            runs[-1][1] = max(runs[-1][1], b)
        elif b > a:
            runs.append([a, b])
    return [(a, b) for a, b in runs]


def innermost_segments(spans: Sequence[Tuple[str, int, int]]
                       ) -> List[Tuple[int, int, str]]:
    """Nested spans ``(label, start, end)`` cut into disjoint segments,
    each labelled with the innermost span over it (the one opened last
    and not yet closed); stretches in no span get none."""
    segs: List[Tuple[int, int, str]] = []
    stack: List[Tuple[str, int, int]] = []
    cursor = 0

    def advance(t: int) -> None:
        nonlocal cursor
        while stack and stack[-1][2] <= t:
            label, _, end = stack.pop()
            if end > cursor:
                segs.append((cursor, end, label))
                cursor = end
        if stack and t > cursor:
            segs.append((cursor, t, stack[-1][0]))
        cursor = max(cursor, t)

    for label, a, b in sorted(spans, key=lambda s: (s[1], -s[2])):
        advance(a)
        stack.append((label, a, b))
    if stack:
        advance(max(b for _, _, b in stack))
    return segs


def idle_by_span(busy: Sequence[Tuple[int, int]], window: Tuple[int, int],
                 spans: Sequence[Tuple[str, int, int]]) -> Dict[str, float]:
    """Idle seconds of the device in ``window``, the complement of the
    disjoint sorted ``busy`` runs, each stretch billed to the innermost
    span over it (``NO_SPAN`` where none is), largest first; every time
    in ns on one clock."""
    w0, w1 = window
    gaps = [(max(a, w0), min(b, w1)) for a, b in
            zip([w0] + [b for _, b in busy], [a for a, _ in busy] + [w1])]
    segs = innermost_segments(spans)
    seg_start = np.asarray([s[0] for s in segs], np.int64)
    idle: Dict[str, float] = {}
    for a, b in gaps:
        if b <= a:
            continue
        covered = 0
        i = max(int(np.searchsorted(seg_start, a, side="right")) - 1, 0)
        for s0, s1, label in segs[i:]:
            if s0 >= b:
                break
            part = min(b, s1) - max(a, s0)
            if part > 0:
                idle[label] = idle.get(label, 0.0) + part / 1e9
                covered += part
        if b - a > covered:
            idle[NO_SPAN] = idle.get(NO_SPAN, 0.0) + (b - a - covered) / 1e9
    return dict(sorted(idle.items(), key=lambda kv: -kv[1]))


def span_intervals(tel: "obs.Telemetry", since: int = 0
                   ) -> List[Tuple[str, int, int]]:
    """The recorder's spans of ``events[since:]`` on the profiler's clock,
    labelled ``"<stage>"`` at the top level and ``"<stage>/<span>"``
    below it."""
    spans = [e for e in tel.events[since:] if e["kind"] == "span"
             and not (e.get("args") or {}).get("device")
             and not (e.get("args") or {}).get("replayed")]
    if not spans:
        return []
    top = min(int(e["depth"]) for e in spans)
    out: List[Tuple[str, int, int]] = []
    pending: List[Tuple[str, int, int]] = []
    for e in spans:             # exit order: children before their stage
        iv = (str(e["name"]), tel.to_profiler_ns(float(e["t0"])),
              tel.to_profiler_ns(float(e["t1"])))
        if int(e["depth"]) != top:
            pending.append(iv)
            continue
        out.append(iv)
        out.extend((iv[0] + obs.spans.NESTED + name, a, b)
                   for name, a, b in pending)
        pending.clear()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bench", default="matrixMultiply1024",
                    choices=sorted(REGISTRY))
    ap.add_argument("--strategy", default="TMR",
                    choices=("TMR", "DWC", "unprotected"))
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--fuse-step", action="store_true",
                    help="run the fused engine (fuse_step=True)")
    ap.add_argument("--collect", default="dense", choices=("dense", "sparse"),
                    help="result collection (CampaignRunner(collect=))")
    ap.add_argument("--fault-model", default="single",
                    help="fault model spec, e.g. multibit(k=3), "
                         "cluster(span=4,k=2), burst(window=8,rate=0.25)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    device_mod.resolve("cuda")
    card = device_mod.card_line()
    prog = getattr(strategies, args.strategy)(REGISTRY[args.bench](),
                                              fuse_step=args.fuse_step)
    tel = obs.Telemetry(enabled=True)
    runner = CampaignRunner(prog, strategy_name=args.strategy,
                            fault_model=FaultModel.parse(args.fault_model),
                            collect=args.collect, telemetry=tel)
    runner.run(args.batch_size, seed=0, batch_size=args.batch_size)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.run(args.n, seed=SEED, batch_size=args.batch_size)
    torch.cuda.synchronize()
    plain_wall_s = time.perf_counter() - t0
    # Device activity only: host-side op tracing would slow the host and
    # move the busy share it is meant to show.
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if args.collect == "sparse":
        acts.append(torch.profiler.ProfilerActivity.CPU)
    trips = [0]
    step = prog.step

    def counting(*a):
        trips[0] += 1
        return step(*a)

    prog.step = counting
    before = {layer: mod.LAUNCHES for layer, mod in _WRAPPERS}
    # The profiled run brackets every span with record_function.
    tel.profiler = True
    mark = tel.mark()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        res = runner.run(args.n, seed=SEED, batch_size=args.batch_size)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    tel.profiler = False
    wall_s = t1 - t0
    launches = {layer: mod.LAUNCHES - before[layer]
                for layer, mod in _WRAPPERS}
    spans = span_intervals(tel, mark)
    names = {name.split(obs.spans.NESTED)[-1] for name, _, _ in spans}
    kernels = [k for k in kernel_times(prof) if k["kernel"] not in names]
    window = (tel.to_profiler_ns(t0), tel.to_profiler_ns(t1))
    busy = union([(max(a, window[0]), min(b, window[1]))
                  for a, b in device_intervals(prof, names)])
    busy_us = sum(b - a for a, b in busy) / 1e3
    idle = idle_by_span(busy, window, spans)
    if busy_us <= 0:
        print("breakdown: the profiler recorded no device time",
              file=sys.stderr)
        return 1
    layers: Dict[str, float] = {}
    for k in kernels:
        layers[k["layer"]] = layers.get(k["layer"], 0.0) + k["us"]
    span_s = span_times(prof)
    record = {
        "bench": args.bench, "strategy": args.strategy,
        "fuse_step": args.fuse_step, "fused": prog._fuse_plan is not None,
        "collect": args.collect, "fault_model": args.fault_model,
        "transfer": res.transfer, "spans_s": span_s,
        "host_ops_traced": args.collect == "sparse",
        "n": res.n,
        "batch_size": args.batch_size, "seed": SEED, "card": card,
        "wall_s": wall_s, "unprofiled_wall_s": plain_wall_s,
        "injections_per_sec": res.n / plain_wall_s,
        "device_busy_s": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / wall_s,
        "layers_s": {k: v / 1e6 for k, v in sorted(
            layers.items(), key=lambda kv: -kv[1])},
        "idle_s": idle,
        "stages": res.stages,
        "kernels": kernels[:25],
        "counts": res.counts,
        "loop_trips": trips[0],
        "launches": launches,
    }
    print(f"{args.bench} {args.strategy} fused={record['fused']} "
          f"{args.collect} {args.fault_model} n={res.n} "
          f"batch={args.batch_size} "
          f"[{card}]: wall {wall_s:.4f} s profiled, {plain_wall_s:.4f} s "
          f"not; device busy {busy_us / 1e6:.4f} s "
          f"({record['device_busy_share']:.1%} of the profiled wall)")
    for layer, s in record["layers_s"].items():
        line = (f"  {layer:24s} {s:.4f} s  {s / (busy_us / 1e6):6.1%} of "
                "device time")
        if layer in launches:
            line += (f", {launches[layer]} launches, "
                     f"{launches[layer] / max(1, trips[0]):.2f} a loop "
                     f"trip ({trips[0]} trips)")
        print(line)
    for span, s in span_s.items():
        print(f"  of the elementwise layer, span {span}: {s:.4f} s  "
              f"{s / (busy_us / 1e6):6.1%} of device time")
    for span, s in list(idle.items())[:8]:
        print(f"  device idle in {span:36s} {s:.4f} s  "
              f"{s / wall_s:6.1%} of the profiled wall")
    print(f"  transfer up {res.transfer['up']} B, down "
          f"{res.transfer['down']} B")
    for k in kernels[:12]:
        print(f"    {k['us'] / 1e3:10.3f} ms  x{k['count']:<6d} "
              f"{k['kernel'][:90]}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
