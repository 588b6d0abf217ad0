"""Where the device time of a campaign goes, by kernel and by layer.

After one warm-up batch it runs one seeded campaign on the card twice:
once plain (its wall clock gives the rate) and once under ``torch.profiler``
(device activity only).  It prints the device time of every kernel,
grouped into the layers of the port: the region's product (cuBLAS), the
region's and the engine's elementwise tensor work (copies, selects, casts,
row indexing, the flip), and the K1 vote and K2 commit kernels
(``--fuse-step`` runs the fused engine), each kernel layer with its
launches a loop trip (one grouped launch per sync point that has sites).
The device's busy share is the summed kernel time over the campaign's
wall clock.  ``--fault-model SPEC`` draws flip groups
(``inject/schedule.FaultModel``); ``--collect sparse`` runs the sparse
collect and reads its own layers, the device generator's columns and the
device accounting, from the profiled campaign's spans
(``campaign.SPANS``: their kernels are elementwise ones, counted in that
layer too).  A span's device time needs the host ops traced, so a sparse
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
from typing import Dict, List

import torch

from coast_tpu_torch import device as device_mod
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


def kernel_times(prof) -> List[Dict[str, object]]:
    """Per-kernel device microseconds and counts, largest first (a span's
    device-side mirror is not a kernel)."""
    rows = []
    for evt in prof.key_averages():
        if not _on_device(evt) or evt.key in campaign_mod.SPANS:
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
    runner = CampaignRunner(prog, strategy_name=args.strategy,
                            fault_model=FaultModel.parse(args.fault_model),
                            collect=args.collect)
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
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        res = runner.run(args.n, seed=SEED, batch_size=args.batch_size)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    launches = {layer: mod.LAUNCHES - before[layer]
                for layer, mod in _WRAPPERS}
    kernels = kernel_times(prof)
    busy_us = sum(k["us"] for k in kernels)
    if busy_us <= 0:
        print("breakdown: the profiler recorded no device time",
              file=sys.stderr)
        return 1
    layers: Dict[str, float] = {}
    for k in kernels:
        layers[k["layer"]] = layers.get(k["layer"], 0.0) + k["us"]
    spans = span_times(prof)
    record = {
        "bench": args.bench, "strategy": args.strategy,
        "fuse_step": args.fuse_step, "fused": prog._fuse_plan is not None,
        "collect": args.collect, "fault_model": args.fault_model,
        "transfer": res.transfer, "spans_s": spans,
        "host_ops_traced": args.collect == "sparse",
        "n": res.n,
        "batch_size": args.batch_size, "seed": SEED, "card": card,
        "wall_s": wall_s, "unprofiled_wall_s": plain_wall_s,
        "injections_per_sec": res.n / plain_wall_s,
        "device_busy_s": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / wall_s,
        "layers_s": {k: v / 1e6 for k, v in sorted(
            layers.items(), key=lambda kv: -kv[1])},
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
    for span, s in spans.items():
        print(f"  of the elementwise layer, span {span}: {s:.4f} s  "
              f"{s / (busy_us / 1e6):6.1%} of device time")
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
