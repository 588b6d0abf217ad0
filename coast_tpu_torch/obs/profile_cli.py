"""``python -m coast_tpu_torch.obs.profile_cli`` -- the campaign
attribution report of the port.

Runs a short PROFILED campaign per target (a warm-up campaign first, so
the measured window is the steady-state loop, not the kernels' first
build and the allocator's growth), prints the device-time attribution,
and records the machine-readable artifact::

    python -m coast_tpu_torch.obs.profile_cli              # mm x TMR/DWC
    python -m coast_tpu_torch.obs.profile_cli --target crc16\\|-TMR -t 8192
    python -m coast_tpu_torch.obs.profile_cli --out profile_mm.json \\
        --trace-out profile.trace.json -d cpu

It runs on the card unless ``-d cpu`` is given.

Per target the report carries the exact wall-clock identity
``device_busy + host_gap + host_other == wall`` (checked here; a
violation is a profiler bug, exit 1), the per-dispatch device-seconds
histogram, the per-phase split, and the roofline/MFU block
(achieved vs predicted-ceiling MFU, voter-bytes share, generalized
flops overhead).  ``--peak-gflops`` pins the MFU denominator when the
card has no table entry (``peak_source: "explicit"``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

__all__ = ["main"]

#: The default target set: the seed benchmark the perf narrative is
#: anchored on, under both protection strategies.
DEFAULT_TARGETS = ("matrixMultiply|-TMR", "matrixMultiply|-DWC")

#: Attribution identity tolerance (absolute seconds + relative): the
#: three buckets are computed from the same perf_counter stream, so any
#: real gap is a profiler bug, not noise.
SUM_TOL_S = 0.005


def parse_command_line(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(
        prog="python -m coast_tpu_torch.obs.profile_cli",
        description="Per-dispatch device-time attribution + roofline/MFU "
                    "report over short profiled campaigns")
    parser.add_argument("--target", action="append", default=None,
                        metavar="SPEC",
                        help="benchmark|opt_passes (repeatable; default "
                        "matrixMultiply x -TMR/-DWC)")
    parser.add_argument("-t", type=int, default=4096, metavar="N",
                        help="injections per target (default 4096)")
    parser.add_argument("--batch-size", type=int, default=512)
    parser.add_argument("--seed", type=int, default=2026)
    parser.add_argument("--out", default=None, metavar="PATH",
                        help="write the JSON attribution artifact here")
    parser.add_argument("--trace-out", default=None, metavar="PATH",
                        help="write the (last target's) Perfetto trace "
                        "with the device track here")
    parser.add_argument("--peak-gflops", type=float, default=None,
                        help="MFU peak denominator in GFLOP/s (default: "
                        "the card table; unknown devices record ops/s "
                        "with MFU null)")
    parser.add_argument("--hbm-gbps", type=float, default=None,
                        help="roofline memory rate (default the H100 "
                        "SXM5's 3350 GB/s)")
    parser.add_argument("--device", "-d", choices=("gpu", "cpu"),
                        default="gpu",
                        help="run on the card (default) or the host")
    parser.add_argument("--fuse-step", action="store_true",
                        help="run every target TWICE at identical seeds "
                        "-- the unfused baseline and the -fuseStep "
                        "engine -- and record the A/B (achieved_mfu, "
                        "flops_overhead, overhead reduction) in the "
                        "artifact's fused_ab block")
    return parser.parse_args(argv)


def _fmt_pct(x) -> str:
    return f"{100.0 * x:.4g}%" if x is not None else "-"


def _report_lines(tid: str, summ: dict) -> List[str]:
    prof = summ["profile"]
    mfu = summ.get("mfu") or {}
    wall = prof["wall_s"]
    lines = [f"== {tid} =="]
    lines.append(
        f"  wall {wall:.3f}s = device {prof['device_busy_s']:.3f}s "
        f"({_fmt_pct(prof['device_busy_fraction'])}) "
        f"+ host-gap {prof['host_gap_s']:.3f}s "
        f"({_fmt_pct(prof['dispatch_gap_fraction'])}) "
        f"+ other {prof['host_other_s']:.3f}s")
    lines.append(f"  {prof['dispatches']} dispatches over "
                 f"{prof['rows']} rows  "
                 f"({summ['injections_per_sec']} inj/s)")
    phases = prof.get("per_phase_device_s") or {}
    if phases:
        lines.append("  per-phase device: " + "  ".join(
            f"{k} {v:.3f}s" for k, v in phases.items()))
    if mfu:
        lines.append(
            f"  ops/run {mfu['useful_ops_per_run']:.3g} useful / "
            f"{mfu['program_ops_per_run']:.3g} protected "
            f"(overhead {mfu['flops_overhead']}x)")
        lines.append(
            f"  achieved {mfu['achieved_ops_per_s'] / 1e9:.4g} Gops/s "
            f"on device  MFU {_fmt_pct(mfu['achieved_mfu'])} "
            f"(roofline ceiling {_fmt_pct(mfu['roofline_mfu'])}, "
            f"voter-bytes share {_fmt_pct(mfu['voter_bytes_share'])}; "
            f"peak {mfu['peak_gflops']} GFLOP/s, "
            f"{mfu['peak_source']})")
    return lines


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_command_line(argv)
    from coast_tpu_torch.inject.campaign import CampaignRunner
    from coast_tpu_torch.inject.supervisor import build_program
    from coast_tpu_torch.obs import write_trace
    from coast_tpu_torch.obs.profiler import CampaignProfiler
    from coast_tpu_torch.obs.roofline import DEFAULT_HBM_GBPS

    device = "cpu" if args.device == "cpu" else "cuda"
    targets = list(args.target or DEFAULT_TARGETS)
    doc = {"format": "coast-profile", "version": 1,
           "backend": "gpu" if device == "cuda" else "cpu",
           "n": int(args.t), "batch_size": int(args.batch_size),
           "seed": int(args.seed), "targets": {}}
    if args.fuse_step:
        doc["fused_ab"] = {}
    last_runner = None
    rc = 0
    for tid in targets:
        bench, _, opt = tid.partition("|")
        # --fuse-step: the baseline arm runs as-is, then the identical
        # campaign (same benchmark, seeds, batch geometry) under the
        # fused engine; the artifact keeps both target entries plus the
        # headline A/B block the perf docs quote.
        arms = ([(tid, opt or "-TMR")] if not args.fuse_step else
                [(tid, opt or "-TMR"),
                 (tid + "+fused", (opt or "-TMR") + " -fuseStep")])
        for arm_tid, arm_opt in arms:
            prog, strategy = build_program(bench, arm_opt, device)
            profiler = CampaignProfiler(
                prog, peak_gflops=args.peak_gflops,
                hbm_gbps=args.hbm_gbps or DEFAULT_HBM_GBPS)
            runner = CampaignRunner(prog, strategy_name=strategy or "TMR",
                                    profile=profiler)
            warm = min(args.batch_size, args.t)
            runner.run(warm, seed=1, batch_size=args.batch_size)  # warm
            res = runner.run(args.t, seed=args.seed,
                             batch_size=args.batch_size)
            summ = res.summary()
            prof = summ["profile"]
            gap = abs(prof["wall_s"] - prof["device_busy_s"]
                      - prof["host_gap_s"] - prof["host_other_s"])
            if gap > SUM_TOL_S + 0.01 * prof["wall_s"]:
                print(f"Error, {arm_tid}: attribution does not sum to "
                      f"wall clock (off by {gap:.4f}s of "
                      f"{prof['wall_s']:.4f}s)", file=sys.stderr)
                rc = 1
            print("\n".join(_report_lines(arm_tid, summ)))
            doc["targets"][arm_tid] = {
                "benchmark": res.benchmark, "strategy": res.strategy,
                "injections": int(res.n),
                "injections_per_sec": summ["injections_per_sec"],
                "counts": {k: int(v) for k, v in res.counts.items()},
                "profile": summ["profile"],
                "mfu": summ.get("mfu"),
                "stages": summ["stages"],
            }
            last_runner = runner
        if args.fuse_step:
            base = doc["targets"][tid]
            fused = doc["targets"][tid + "+fused"]
            ab = {"counts_identical": base["counts"] == fused["counts"]}
            for arm_name, arm in (("unfused", base), ("fused", fused)):
                m = arm.get("mfu") or {}
                ab[arm_name] = {
                    "flops_overhead": m.get("flops_overhead"),
                    "achieved_mfu": m.get("achieved_mfu"),
                    "program_ops_per_run": m.get("program_ops_per_run"),
                    "injections_per_sec": arm["injections_per_sec"]}
            bo = ab["unfused"]["flops_overhead"]
            fo = ab["fused"]["flops_overhead"]
            if bo and fo:
                ab["overhead_reduction_x"] = round(bo / fo, 3)
            doc["fused_ab"][tid] = ab
            print(f"  fused A/B: overhead {bo}x -> {fo}x "
                  f"({ab.get('overhead_reduction_x', '-')}x reduction), "
                  f"counts identical: {ab['counts_identical']}")
            if not ab["counts_identical"]:
                print(f"Error, {tid}: fused arm changed campaign counts",
                      file=sys.stderr)
                rc = 1
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(doc, fh, indent=1, sort_keys=True)
        print(f"wrote {args.out}")
    if args.trace_out and last_runner is not None:
        write_trace(last_runner.telemetry, args.trace_out,
                    metadata={"profile": True})
        print(f"wrote {args.trace_out}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
