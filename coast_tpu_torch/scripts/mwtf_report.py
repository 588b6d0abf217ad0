"""MWTF report: the reference's headline protection metric, measured.

The counterpart of the reference's ``scripts/mwtf_report.py``.
jsonParser.py's A-vs-B comparison is how COAST results are judged:
error-rate improvement divided by runtime cost (the MWTF ratio,
jsonParser.py:458-506, mwtf :473).  For each requested benchmark this
runs an unprotected baseline campaign and protected campaigns (TMR and
DWC; train regions add selective xMR), measures each program's runtime
on its device, and writes one comparison record.  Each campaign's stage
breakdown is printed to stderr and kept under
``benchmarks.<name>.stages``.

The runtime is the port's fault-free run, ``prog.run(noop_fault())``, a
host-driven loop of step launches, timed 20 times after a warm run with
the device synchronised before each clock read.  On a small region that
loop is bound by launches, so the runtime ratio follows the launches a
trip of each program more than its work.

``flops_overhead``: on train rows the analytic lanes-times table
(``flops_overhead_source: "analytic"``); on every other row, and on
every row under ``--fuse-step``, the useful-op count of the program that
ran, from the port's CPU capture of its step (``obs/roofline.py``),
normalised by the unprotected program's (``"measured-capture"``).

Usage: python -m coast_tpu_torch.scripts.mwtf_report [-n 20000]
       [--benchmarks mm,crc16] [--out build/studies/mwtf_report.json]
       [--cpu] [--fuse-step]

Model-sweep mode (``--model-sweep``) is the fault-model degradation
study: the same programs re-measured under harsher FaultModels (multibit
k, cluster span/k, burst rate; ``inject.schedule.FaultModel``), recording
how each strategy's uncorrected (SDC + DUE) rate degrades as the model
hardens, per family, with the classifier taxonomy unchanged.

Usage: python -m coast_tpu_torch.scripts.mwtf_report --model-sweep
       [--cpu] [-n 4096] [--benchmarks mm] [--models single,multibit:k=2]
       [--out build/studies/faultmodel_study.json]

Without ``--cpu`` every campaign runs on the card, and the script fails
where there is none.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import sys
import time

from coast_tpu_torch import device as device_mod
from coast_tpu_torch.scripts import common

BENCH_ALIASES = {"mm": "matrixMultiply", "mm256": "matrixMultiply256"}
#: Fault-free runs timed per program, after one warm run.
RUNTIME_REPS = 20


def _runtime_s(prog, reps: int = RUNTIME_REPS) -> float:
    """Seconds of one fault-free run of ``prog`` on its device."""
    import torch

    from coast_tpu_torch.ops.bitflip import noop_fault

    def sync():
        if prog.device.type == "cuda":
            torch.cuda.synchronize(prog.device)

    noop = noop_fault()
    prog.run(noop)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        prog.run(noop)
    sync()
    return (time.perf_counter() - t0) / reps


#: Default degradation grid: three families, each swept from mild to
#: harsh, plus the single-bit baseline every series is anchored on.
SWEEP_MODELS = ("single",
                "multibit:k=2", "multibit:k=4", "multibit:k=8",
                "cluster:span=4,k=2", "cluster:span=4,k=4",
                "cluster:span=4,k=8",
                "burst:window=8,rate=0.25", "burst:window=8,rate=0.5",
                "burst:window=8,rate=1.0")

#: Severity order within a family = more simultaneous upsets.  The
#: monotonicity check runs over [single] + the family's models in this
#: order.
_FAMILY_SEVERITY = {"multibit": lambda m: m.k,
                    "cluster": lambda m: m.k,
                    "burst": lambda m: m.sites}


def _wilson_half(p: float, n: int, z: float = 1.96) -> float:
    """Wilson score half-interval for a binomial rate: unlike the Wald
    width it stays non-degenerate at p ~ 0, where the degradation series
    lives (small uncorrected rates)."""
    if not n:
        return 0.0
    denom = 1 + z * z / n
    return (z / denom) * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n))


def model_sweep(args, dev) -> int:
    """--model-sweep: the strategy-degradation study."""
    from coast_tpu_torch import DWC, TMR, unprotected
    from coast_tpu_torch.inject import classify as cls
    from coast_tpu_torch.inject.campaign import CampaignRunner
    from coast_tpu_torch.inject.schedule import FaultModel
    from coast_tpu_torch.models import REGISTRY

    first = args.benchmarks.split(",")[0].strip()
    bench = BENCH_ALIASES.get(first, first)
    region = REGISTRY[bench]()
    # Specs contain commas (cluster:span=4,k=8), so the list separator is
    # ';' or whitespace, never ','.
    specs = ([s for s in re.split(r"[;\s]+", args.models.strip()) if s]
             if args.models else SWEEP_MODELS)
    try:
        models = [FaultModel.parse(s) for s in specs]
    except ValueError as e:
        print(f"ERROR: bad --models entry: {e}", file=sys.stderr)
        return 2
    progs = {"unprotected": unprotected(region, device=dev),
             "DWC": DWC(region, device=dev), "TMR": TMR(region, device=dev)}
    report = {
        "metric": "faultmodel_study",
        "device": common.device_block(dev),
        "benchmark": bench,
        "n_per_campaign": args.n,
        "seed": args.seed,
        # The taxonomy is pinned: a fault model changes what an injection
        # IS, never what an outcome is called.
        "classes": list(cls.CLASS_NAMES),
        "models": [],
    }
    cells = {}
    for model in models:
        row = {"model": model.spec(), "kind": model.kind,
               "sites": model.sites, "strategies": {}}
        for strat, prog in progs.items():
            runner = CampaignRunner(prog, strategy_name=strat,
                                    fault_model=model)
            res = runner.run(args.n, seed=args.seed, batch_size=args.batch)
            unc = (res.sdc_total + res.due) / res.n
            cell = {
                "counts": dict(res.counts),
                "rates": {
                    "sdc": round(res.sdc_total / res.n, 6),
                    "due": round(res.due / res.n, 6),
                    "corrected": round(res.counts["corrected"] / res.n, 6),
                    "uncorrected": round(unc, 6),
                },
                "injections_per_sec": round(res.injections_per_sec, 2),
            }
            row["strategies"][strat] = cell
            cells[(model.spec(), strat)] = cell
            print(f"# {bench} {strat:<12} {model.spec():<26} "
                  f"uncorrected={unc:.4f} sdc={cell['rates']['sdc']:.4f} "
                  f"due={cell['rates']['due']:.4f}",
                  file=sys.stderr, flush=True)
        report["models"].append(row)

    # Degradation series: per strategy x family, anchored on single.
    single_spec = FaultModel.single().spec()
    degradation = {}
    for strat in progs:
        strat_block = {}
        for family, sev in _FAMILY_SEVERITY.items():
            fam = sorted((m for m in models if m.kind == family), key=sev)
            if not fam or (single_spec, strat) not in cells:
                continue
            series = [{"model": single_spec, "sites": 1,
                       **cells[(single_spec, strat)]["rates"]}]
            series += [{"model": m.spec(), "sites": m.sites,
                        **cells[(m.spec(), strat)]["rates"]}
                       for m in fam]
            uncs = [s["uncorrected"] for s in series]
            # Monotone within sampling noise: a step may dip by at most
            # one Wilson half-interval of the larger neighbour.
            tol = [_wilson_half(max(a, b), args.n)
                   for a, b in zip(uncs, uncs[1:])]
            strat_block[family] = {
                "series": series,
                "monotone_uncorrected": all(
                    b >= a - t for a, b, t in zip(uncs, uncs[1:], tol)),
                "strictly_nondecreasing": all(
                    b >= a for a, b in zip(uncs, uncs[1:])),
                "degradation_x": round(uncs[-1] / uncs[0], 3)
                if uncs[0] > 0 else None,
            }
        degradation[strat] = strat_block
    report["degradation"] = degradation

    common.write_record(args.out, report)
    print(json.dumps({s: {f: {"monotone": d["monotone_uncorrected"],
                              "degradation_x": d["degradation_x"]}
                          for f, d in fams.items()}
                      for s, fams in degradation.items()}))
    return 0


def _j(v):
    """Strict-JSON-safe: infinities (zero protected SDCs) as "inf",
    undefined ratios (no completed runs) as "nan"."""
    if isinstance(v, float):
        if math.isnan(v):
            return "nan"
        return round(v, 4) if math.isfinite(v) else "inf"
    return v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", type=int, default=None,
                    help="injections per campaign (default 20000; 4096 "
                    "under --model-sweep)")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--benchmarks", default="mm,crc16,quicksort")
    ap.add_argument("--out", default=None,
                    help="record path (default build/studies/"
                    "mwtf_report.json; build/studies/faultmodel_study.json "
                    "under --model-sweep)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host (default: the card)")
    ap.add_argument("--fuse-step", action="store_true",
                    help="build the protected programs under the fused "
                    "engine (-fuseStep); the flops_overhead column then "
                    "reads the measured op count of the program that ran "
                    "(flops_overhead_source: measured-capture)")
    ap.add_argument("--model-sweep", action="store_true",
                    help="fault-model degradation study instead of the "
                    "MWTF table: sweep --models over the FIRST benchmark "
                    "of --benchmarks x {unprotected, DWC, TMR}")
    ap.add_argument("--models", default=None,
                    help="semicolon- or space-separated FaultModel specs "
                    "for --model-sweep, e.g. 'single;cluster:span=4,k=8' "
                    "(specs contain commas; default: the three-family "
                    "grid)")
    ap.add_argument("--seed", type=int, default=2026)
    args = ap.parse_args(argv)
    dev = device_mod.resolve("cpu" if args.cpu else "cuda")

    if args.model_sweep:
        args.out = args.out or common.default_out("faultmodel_study.json")
        args.n = args.n or 4096
        return model_sweep(args, dev)
    args.out = args.out or common.default_out("mwtf_report.json")
    args.n = args.n or 20_000

    from coast_tpu_torch import DWC, TMR, unprotected
    from coast_tpu_torch.analysis.json_parser import (Summary, compare_runs,
                                                      mean_steps_or_nan)
    from coast_tpu_torch.inject import classify as cls
    from coast_tpu_torch.inject.campaign import CampaignRunner
    from coast_tpu_torch.models import REGISTRY

    report = {"device": common.device_block(dev), "n_per_campaign": args.n,
              "benchmarks": {}}
    for name in args.benchmarks.split(","):
        name = BENCH_ALIASES.get(name.strip(), name.strip())
        region = REGISTRY[name]()
        # Under --fuse-step every arm (the unprotected normaliser too)
        # runs the fused engine, so the overhead column compares like
        # schedules.
        progs = {"unprotected": unprotected(region, device=dev,
                                            fuse_step=args.fuse_step),
                 "DWC": DWC(region, device=dev, fuse_step=args.fuse_step),
                 "TMR": TMR(region, device=dev, fuse_step=args.fuse_step)}
        # Training rows add the selective-xMR strategy and the analytic
        # per-iteration FLOPs-overhead column beside the runtime ratio.
        train = region.train_probe is not None
        flops_cols = {}
        if train:
            from coast_tpu_torch.train import flops_overhead, selective_xmr
            progs["selective-xMR"] = selective_xmr(region, device=dev)
        if train and not args.fuse_step:
            flops_cols = {
                "unprotected": flops_overhead(region, 1),
                "DWC": flops_overhead(region, 2),
                "TMR": flops_overhead(region, 3),
                "selective-xMR": flops_overhead(region, 3, selective=True),
            }
        summaries, runtimes, stage_blocks = {}, {}, {}
        mfu_cols = {}
        for strat, prog in progs.items():
            runtimes[strat] = _runtime_s(prog)
            # profile=True: the campaigns double as the MFU measurement;
            # each strategy row gets the roofline block beside its MWTF
            # ratios.
            runner = CampaignRunner(prog, strategy_name=strat,
                                    profile=True)
            batch = min(args.batch, args.n)
            runner.run(batch, seed=1, batch_size=batch)       # warm
            res = runner.run(args.n, seed=2026, batch_size=batch)
            mfu = (res.profile or {}).get("mfu") or {}
            mfu_cols[strat] = {
                k: mfu.get(k)
                for k in ("achieved_mfu", "roofline_mfu",
                          "dispatch_gap_fraction", "flops_overhead",
                          "achieved_ops_per_s", "peak_source")}
            mfu_cols[strat]["device_busy_fraction"] = (
                (res.profile or {}).get("device_busy_fraction"))
            stage_blocks[strat] = {k: round(v, 6)
                                   for k, v in res.stages.items()}
            # Mean guest runtime over completed runs (success/corrected/
            # sdc), NaN with a warning where none completed.
            completed = cls.completed_mask(res.codes)
            mean_steps = mean_steps_or_nan(
                float(res.steps[completed].sum()), int(completed.sum()),
                res.n, f"{name}-{strat}")
            summaries[strat] = Summary(
                name=f"{name}-{strat}", n=res.n, counts=res.counts,
                # MWTF's runtime ratio is the guest runtime, not the
                # campaign's wall clock: the device seconds of a
                # fault-free run.
                seconds=runtimes[strat] * res.n,
                mean_steps=mean_steps,
                stages=res.stages or None)
            # 'overlap' is a fraction, not a seconds bucket: keep it out
            # of the dominant-stage ranking.
            stage_s = {k: v for k, v in res.stages.items()
                       if k != "overlap"}
            dominant = max(stage_s, key=stage_s.get) if stage_s else "?"
            print(f"#   {name}-{strat} stages: " + " ".join(
                f"{k}={v:.3f}s" for k, v in sorted(
                    stage_s.items(), key=lambda kv: -kv[1]))
                + f"  (dominant: {dominant})",
                file=sys.stderr, flush=True)
        row = {"campaigns": {s: summaries[s].counts for s in summaries},
               "seconds_per_run": {s: round(runtimes[s], 6)
                                   for s in runtimes},
               "stages": stage_blocks,
               "injections_per_sec": {}}
        if not flops_cols:
            # Non-train rows, and every row under --fuse-step: the
            # captured op count of the program that ran, normalised by
            # the unprotected program's so the column reads like the
            # train table (unprotected = 1.0).
            base_oh = (mfu_cols.get("unprotected") or {}).get(
                "flops_overhead")
            flops_cols = {
                s: (mfu_cols[s]["flops_overhead"] / base_oh
                    if base_oh else mfu_cols[s]["flops_overhead"])
                for s in mfu_cols
                if mfu_cols[s].get("flops_overhead")}
            row["flops_overhead_source"] = "measured-capture"
        else:
            row["flops_overhead_source"] = "analytic"
        if flops_cols:
            row["flops_overhead"] = {s: round(v, 4)
                                     for s, v in flops_cols.items()}
        row["mfu"] = {s: {k: v for k, v in cols.items()
                          if v is not None}
                      for s, cols in mfu_cols.items()}
        for strat in [s for s in progs if s != "unprotected"]:
            cmp_ = compare_runs(summaries["unprotected"], summaries[strat])
            row[f"vs_unprotected_{strat}"] = {k: _j(v)
                                              for k, v in cmp_.items()}
        report["benchmarks"][name] = row
        print(f"# {name}: TMR mwtf={row['vs_unprotected_TMR']['mwtf']} "
              f"DWC mwtf={row['vs_unprotected_DWC']['mwtf']}",
              file=sys.stderr, flush=True)

    common.write_record(args.out, report)
    print(json.dumps({k: {s: v for s, v in row.items()
                          if s.startswith("vs_")}
                      for k, row in report["benchmarks"].items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
