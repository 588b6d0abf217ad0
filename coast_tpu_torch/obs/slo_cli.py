"""``python -m coast_tpu_torch slo`` -- reliability SLO check/report.

Evaluates a declarative SLO set (:mod:`coast_tpu_torch.obs.slo`) against
RECORDED campaign evidence -- a ``--status-json`` file, a run doc with
a ``summary`` block, a bare summary JSON, or an NDJSON campaign log --
so CI can gate on reliability regressions.  The evidence files of
either package are read the same way (one recorded format)::

    python -m coast_tpu_torch slo check --spec "sdc_rate<=0.01;min=256" \\
        --input artifacts/status.json
    python -m coast_tpu_torch slo report --spec "availability>=0.95" \\
        --input runs/mm_tmr.ndjson --baseline runs/mm_none.ndjson \\
        --out artifacts/slo.json

``check`` exits 1 unless every objective's verdict is ``ok`` (a
burning error budget is a failed gate); ``report`` always exits 0 and
just prints/records the evaluation.  ``--baseline`` points at an
unprotected run's evidence and feeds the MWTF objective its
improvement denominator; without it, ``mwtf`` objectives report no
data (and cannot gate).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from coast_tpu_torch.obs import slo as slo_mod

__all__ = ["main"]

#: The default objective set: the reference's service targets at CI
#: scale -- an SDC ceiling and an availability floor over whatever
#: evidence the caller points at.
DEFAULT_SPEC = "sdc_rate<=0.01,availability>=0.9;min=64"


def parse_command_line(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(
        prog="python -m coast_tpu_torch slo",
        description="Reliability SLO evaluation over recorded campaign "
                    "evidence (error budgets, burn rates, page/warn/ok)")
    parser.add_argument("mode", choices=("check", "report"),
                        help="check: exit 1 on any non-ok objective; "
                        "report: print the evaluation, exit 0")
    parser.add_argument("--spec", default=DEFAULT_SPEC, metavar="SLO",
                        help="objective set, e.g. "
                        "'sdc_rate<=0.002,availability>=0.99;z=2.576;"
                        "min=4096' (default: %(default)s)")
    parser.add_argument("--input", required=True, metavar="PATH",
                        help="recorded evidence: status JSON, run doc "
                        "with summary, summary JSON, or NDJSON log")
    parser.add_argument("--baseline", default=None, metavar="PATH",
                        help="unprotected run's evidence for the mwtf "
                        "objective's improvement denominator")
    parser.add_argument("--out", default=None, metavar="PATH",
                        help="write the full JSON evaluation here")
    return parser.parse_args(argv)


def _fmt(value, digits: int = 4) -> str:
    if value is None:
        return "-"
    if isinstance(value, bool):
        return "yes" if value else "no"
    if isinstance(value, float):
        return f"{value:.{digits}g}"
    return str(value)


def report_lines(report: dict) -> List[str]:
    lines = [f"SLO verdict: {report['verdict']}"
             + (f"  (burning: {', '.join(report['burning'])})"
                if report.get("burning") else "")]
    for row in report["objectives"]:
        budget = row.get("budget") or {}
        burn = row.get("burn") or {}
        wilson = row.get("wilson")
        detail = (f"  {row['objective']} {row['op']} "
                  f"{_fmt(row['target'])}: observed "
                  f"{_fmt(row.get('observed'))}"
                  f"  attained={_fmt(row.get('attained'))}"
                  f"  burn={_fmt(burn.get('long'))}"
                  + (f"/{_fmt(burn.get('short'))}"
                     if burn.get("short") is not None else "")
                  + f"  budget-left={_fmt(budget.get('remaining_frac'))}"
                  + (f"  wilson=[{_fmt(wilson['lo'])}, "
                     f"{_fmt(wilson['hi'])}]" if wilson else "")
                  + f"  -> {row['verdict']}")
        lines.append(detail)
    return lines


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_command_line(argv)
    try:
        slo_set = slo_mod.SLOSet.parse(args.spec)
    except slo_mod.SLOError as e:
        print(f"Error, bad --spec: {e}", file=sys.stderr)
        return 2
    try:
        evidence = slo_mod.load_evidence(args.input)
    except (OSError, ValueError) as e:
        print(f"Error, cannot load evidence from {args.input}: {e}",
              file=sys.stderr)
        return 2
    baseline = None
    if args.baseline:
        try:
            baseline = slo_mod.baseline_from(args.baseline)
        except (OSError, ValueError) as e:
            print(f"Error, cannot load baseline from {args.baseline}: "
                  f"{e}", file=sys.stderr)
            return 2

    report = slo_mod.evaluate(slo_set, evidence, baseline=baseline)
    report["input"] = args.input
    if args.baseline:
        report["baseline"] = {"path": args.baseline, **(baseline or {})}
    print("\n".join(report_lines(report)))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"format": "coast-slo", "version": 1, **report},
                      fh, indent=1, sort_keys=True)
        print(f"wrote {args.out}")
    if args.mode == "check" and report["verdict"] != "ok":
        print(f"Error, SLO gate failed: {report['verdict']} on "
              f"{', '.join(report['burning'])}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
