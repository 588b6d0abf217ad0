"""``python -m coast_tpu_torch.analysis.lint``: the replication-integrity
linter CLI.

Takes the same single-dash protection flags as ``python -m
coast_tpu_torch.opt`` (one parser -- opt's -- so the semantics cannot
drift) plus linter options::

    python -m coast_tpu_torch.analysis.lint -TMR matrixMultiply crc16
    python -m coast_tpu_torch.analysis.lint -DWC -s sha256
    python -m coast_tpu_torch.analysis.lint -TMR --all --json lint.json
    python -m coast_tpu_torch.analysis.lint -TMR crc16 --no-survival
    python -m coast_tpu_torch.analysis.lint -TMR crc16 --baseline b.json
    python -m coast_tpu_torch.analysis.lint -TMR crc16 --write-baseline b.json
    python -m coast_tpu_torch.analysis.lint -TMR crc16 --device cpu
    python -m coast_tpu_torch.analysis.lint -TMR crc16 --propagation

The programs are built on the card (``--device cuda``, the default), where
the survival pass runs its trips through K1 and K2; ``--device cpu`` lints
on the host.  The capture of the provenance pass always runs on the CPU.
``--propagation`` adds the third static pass: the lane-isolation prover
gates alongside the other rules (leaks are ``isolation-leak`` error
findings with counterexample paths), and each target's static
vulnerability map is printed and recorded under the ``propagation`` key
of the ``--json`` export (the map runs one fault-free run on the device
to bound the live flip window).

Exit status: 0 when every report is error-free (after baseline
suppression), 1 otherwise, 2 on usage errors.
"""

from __future__ import annotations

import json
import os
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None, device: str = "cuda") -> int:
    argv = sys.argv[1:] if argv is None else argv

    json_out = None
    baseline_path = None
    write_baseline = None
    survival = True
    propagation = False
    sweep_all = False
    rest: List[str] = []
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg in ("--json", "--baseline", "--write-baseline", "--device"):
            i += 1
            if i >= len(argv):
                print(f"ERROR: {arg} needs a "
                      f"{'device' if arg == '--device' else 'path'}",
                      file=sys.stderr)
                return 2
            if arg == "--json":
                json_out = argv[i]
            elif arg == "--baseline":
                baseline_path = argv[i]
            elif arg == "--device":
                device = argv[i]
            else:
                write_baseline = argv[i]
        elif arg == "--no-survival":
            survival = False
        elif arg == "--propagation":
            propagation = True
        elif arg == "--all":
            sweep_all = True
        elif arg.startswith("--"):
            print(f"ERROR: unknown flag {arg}", file=sys.stderr)
            return 2
        else:
            rest.append(arg)
        i += 1

    from coast_tpu_torch.opt import UsageError, build_overrides, parse_argv
    try:
        flags, positional = parse_argv(rest)
        overrides = build_overrides(flags)
    except UsageError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 2

    from coast_tpu_torch.analysis import lint
    from coast_tpu_torch.models import REGISTRY, resolve_region
    from coast_tpu_torch.passes.strategies import DWC, TMR
    from coast_tpu_torch.passes.verification import SoRViolation

    strategies = [s for s in ("TMR", "DWC") if flags.get(s)]
    if len(strategies) > 1:
        print("ERROR: choose one of -TMR/-DWC", file=sys.stderr)
        return 2
    strategy = strategies[0] if strategies else "TMR"
    make = {"TMR": TMR, "DWC": DWC}[strategy]

    benches = sorted(REGISTRY) if sweep_all else positional
    if not benches:
        print(__doc__, file=sys.stderr)
        print(f"benchmarks: {', '.join(sorted(REGISTRY))}", file=sys.stderr)
        return 2
    unknown = [b for b in benches
               if b not in REGISTRY and not b.endswith(".c")]
    if unknown:
        print(f"ERROR: unknown benchmark(s): {', '.join(unknown)}",
              file=sys.stderr)
        return 2

    base = None
    if baseline_path is not None:
        try:
            base = lint.load_baseline(baseline_path)
        except (OSError, ValueError) as e:
            print(f"ERROR: {e}", file=sys.stderr)
            return 2

    reports = []
    prop_maps = {}
    for bench in benches:
        try:
            prog = make(resolve_region(bench, device=device), device=device,
                        **overrides)
        except SoRViolation as e:
            print(str(e), file=sys.stderr)
            return 1
        facts = None
        if propagation:
            from coast_tpu_torch.analysis.propagation import analyze_step
            facts = analyze_step(prog, closed=lint.trace_step(prog))
        rep = lint.lint_program(prog, survival=survival, strategy=strategy,
                                baseline=base, propagation=propagation,
                                facts=facts)
        reports.append(rep)
        print(rep.format())
        if propagation:
            from coast_tpu_torch.analysis.propagation import (
                analyze_propagation)
            vmap = analyze_propagation(prog, facts=facts)
            prop_maps[f"{bench}:{strategy}"] = vmap.summary()
            print(vmap.format())

    if write_baseline is not None:
        from coast_tpu_torch.analysis.lint.findings import write_baseline_set
        write_baseline_set(reports, write_baseline)
        print(f"baseline written: {write_baseline}", file=sys.stderr)
    if json_out is not None:
        doc = {"strategy": strategy,
               "survival": survival,
               "reports": [r.to_dict() for r in reports]}
        if propagation:
            doc["propagation"] = prop_maps
        os.makedirs(os.path.dirname(json_out) or ".", exist_ok=True)
        with open(json_out, "w") as fh:
            json.dump(doc, fh, indent=1)
            fh.write("\n")

    return 0 if all(r.ok for r in reports) else 1


if __name__ == "__main__":
    sys.exit(main())
