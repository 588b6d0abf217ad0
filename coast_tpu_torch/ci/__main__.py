"""``python -m coast_tpu_torch ci`` -- the protection-regression CI CLI.

The port's copy of ``coast_tpu/ci/__main__.py``, with its verbs and
flags, plus ``--device/-d``: every build and campaign runs on the card
unless given ``-d cpu``.

    # record ground truth once (and commit the artifact)
    python -m coast_tpu_torch ci baseline --baseline artifacts/ci_baseline.json

    # per-commit gate: exit 0 pass, 1 drift, 2 infra failure
    python -m coast_tpu_torch ci check --baseline artifacts/ci_baseline.json

    # check, then overwrite the baseline on pass
    python -m coast_tpu_torch ci refresh --baseline artifacts/ci_baseline.json

    # the same gate on the host (--baseline defaults to the repo's own)
    python -m coast_tpu_torch ci check -d cpu

See docs/ci.md for the artifact format, verdict semantics, and exit
codes.  ``python -m coast_tpu_torch.ci`` works too; the package dispatcher
(coast_tpu_torch/__main__.py) routes the ``ci`` verb here.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from coast_tpu_torch.ci import engine
from coast_tpu_torch.ci.baseline import BaselineError, load_baseline, \
    write_baseline
from coast_tpu_torch.inject.spec import CampaignSpec


def _parse_target(text: str, default_seed: int) -> CampaignSpec:
    """``benchmark|opt_passes|section|seed`` (later fields optional,
    ``s``-prefixed seed tolerated): the target_id grammar.  A target
    without its own seed field takes the CLI-wide ``--seed``."""
    parts = text.split("|")
    if not parts or not parts[0]:
        raise ValueError(f"bad --target {text!r}: want "
                         "benchmark|opt_passes[|section[|seed]]")
    seed = int(default_seed)
    if len(parts) > 3 and parts[3]:
        seed = int(parts[3].lstrip("s"))
    return CampaignSpec(
        benchmark=parts[0],
        n=1,                              # resized by -t below
        opt_passes=parts[1] if len(parts) > 1 and parts[1] else "-TMR",
        section=parts[2] if len(parts) > 2 and parts[2] else "memory",
        seed=seed, equiv=True)


def parse_command_line(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(
        prog="python -m coast_tpu_torch ci",
        description="Protection-regression CI: diff section dataflow "
                    "fingerprints against a committed baseline, delta-"
                    "re-inject only what changed through the fleet, and "
                    "gate on classification-distribution drift "
                    "(per-class Wilson intervals + new/vanished "
                    "classes).  Exit codes: 0 pass, 1 drift, 2 infra")
    sub = parser.add_subparsers(dest="cmd", required=True)

    def _common(p, with_check_knobs: bool) -> None:
        p.add_argument("--baseline", default="artifacts/ci_baseline.json",
                       metavar="PATH", help="baseline artifact path")
        p.add_argument("--workers", type=int, default=1, metavar="N",
                       help="fleet workers (1 = in-process; more spawn "
                       "`python -m coast_tpu_torch.fleet worker` "
                       "processes, each on --device)")
        p.add_argument("--device", "-d", default="cuda",
                       help="cuda (the card, default) or cpu: where every "
                       "build and campaign runs")
        p.add_argument("--queue", default=None, metavar="DIR",
                       help="working directory for the fleet queue and "
                       "materialized journals (default: a temp dir; "
                       "pass one to inspect journals afterwards)")
        if with_check_knobs:
            p.add_argument("--stop-when", default=engine.DEFAULT_STOP_WHEN,
                           metavar="SPEC",
                           help="convergence bound applied to EACH "
                           "re-injected section (StopWhen grammar; "
                           "'none' disables; default "
                           f"{engine.DEFAULT_STOP_WHEN!r})")
            p.add_argument("--no-isolation-gate", action="store_true",
                           help="skip the static lane-isolation "
                           "noninterference pre-gate that runs over "
                           "every target's current build before any "
                           "delta campaign is enqueued (a refuted "
                           "proof is an immediate drift verdict with "
                           "counterexample paths)")
            p.add_argument("--no-static-budget", action="store_true",
                           help="do not allocate the per-section "
                           "convergence budget by the static "
                           "vulnerability map (sdc-possible sections "
                           "first, relaxed min floor on statically-"
                           "proven sections)")
            p.add_argument("--z", type=float, default=1.96,
                           help="Wilson quantile for the drift verdict")
            p.add_argument("--report-json", default=None, metavar="PATH",
                           help="write the machine-readable per-target "
                           "report here")

    p = sub.add_parser("baseline", help="run the target campaigns in "
                       "full and write the baseline artifact")
    _common(p, with_check_knobs=False)
    p.add_argument("--target", action="append", default=None,
                   metavar="SPEC",
                   help="benchmark|opt_passes[|section[|seed]]; "
                   "repeatable.  Default: mm + crc16 x DWC/TMR")
    p.add_argument("-t", type=int, default=2048, metavar="N",
                   help="effective injections per target")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--batch-size", type=int, default=512)

    p = sub.add_parser("check", help="delta-check the current tree "
                       "against the baseline (exit 0/1/2)")
    _common(p, with_check_knobs=True)
    p.add_argument("--out", default=None, metavar="PATH",
                   help="write the refreshed baseline here ON PASS "
                   "(default: <baseline>.refreshed.json)")

    p = sub.add_parser("refresh", help="check, then overwrite the "
                       "baseline with the refreshed artifact on pass")
    _common(p, with_check_knobs=True)

    return parser.parse_args(argv)


def cmd_baseline(args) -> int:
    import dataclasses
    if args.target:
        try:
            specs = [dataclasses.replace(
                         _parse_target(t, args.seed), n=args.t,
                         batch_size=args.batch_size).validate()
                     for t in args.target]
        except ValueError as e:
            print(f"Error, {e}", file=sys.stderr)
            return engine.EXIT_INFRA
    else:
        specs = engine.default_specs(n=args.t, seed=args.seed,
                                     batch_size=args.batch_size)
    doc = engine.build_baseline(
        specs, queue_dir=args.queue, workers=args.workers,
        log=lambda s: print(s, file=sys.stderr, flush=True),
        device=args.device)
    write_baseline(doc, args.baseline)
    print(f"wrote {args.baseline} ({len(doc['targets'])} targets)")
    return engine.EXIT_PASS


def _run_check(args):
    doc = load_baseline(args.baseline)
    stop = args.stop_when
    if stop in ("none", ""):
        stop = None
    report = engine.check_baseline(
        doc, workdir=args.queue, stop_when=stop,
        workers=args.workers, z=args.z,
        static_budget=not args.no_static_budget,
        isolation_gate=not args.no_isolation_gate,
        log=lambda s: print(s, file=sys.stderr, flush=True),
        device=args.device)
    print(report.format())
    if args.report_json:
        with open(args.report_json, "w") as fh:
            json.dump(report.to_json(), fh, indent=1, sort_keys=True)
        print(f"# wrote {args.report_json}", file=sys.stderr)
    return report


def cmd_check(args) -> int:
    report = _run_check(args)
    if report.exit_code == engine.EXIT_PASS:
        out = args.out or f"{args.baseline}.refreshed.json"
        write_baseline(report.refreshed, out)
        print(f"wrote refreshed baseline {out}")
    return report.exit_code


def cmd_refresh(args) -> int:
    report = _run_check(args)
    if report.exit_code == engine.EXIT_PASS:
        write_baseline(report.refreshed, args.baseline)
        print(f"refreshed {args.baseline}")
    else:
        print("baseline NOT refreshed (check did not pass)",
              file=sys.stderr)
    return report.exit_code


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_command_line(argv)
    from coast_tpu_torch import device as device_mod
    try:
        device_mod.resolve(args.device)
    except RuntimeError as e:
        print(f"Error, {e}", file=sys.stderr)
        return engine.EXIT_INFRA
    try:
        return {"baseline": cmd_baseline, "check": cmd_check,
                "refresh": cmd_refresh}[args.cmd](args)
    except (BaselineError, engine.CiInfraError) as e:
        print(f"Error, {e}", file=sys.stderr)
        return engine.EXIT_INFRA


if __name__ == "__main__":
    sys.exit(main())
