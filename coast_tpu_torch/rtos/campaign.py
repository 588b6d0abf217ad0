"""Seeded RTOS kernel campaign: the DUE sub-buckets and the per-category
attribution, under the canonical production config.

The counterpart of ``scripts/rtos_campaign.py``.  It builds an ``rtos_*``
target under ``rtos/Makefile``'s lists plus ``rtos/kernel.config``
(``-TMR -countErrors``, or DWC), runs a seeded campaign on the card, and
reports the counts with the DUE sub-buckets (aborts, stack overflows,
assert fails, timeouts) and the classes rolled up into the kernel's
stack / TCB / task-data categories (``region.meta["rtos_sections"]``).
It exits 1 when the campaign recorded no stack-overflow or no assert DUE.

    python -m coast_tpu_torch.rtos.campaign [-n 2048] [--seed 42]
        [--batch 256] [--benchmark rtos_mm] [--strategy TMR]
        [--device cuda] [--out record.json]

``--out`` writes the record there and a columnar campaign log beside it
(``<out>_log.json``), and prints the log's summary and per-symbol table,
which the record keeps as ``per_symbol``: the port's log parser
(``coast_tpu_torch/analysis/json_parser.py``), as the reference's script
reads its log with its own.  The campaign starts behind the lint's static
pre-flight (``preflight="static"``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# rtos/Makefile's command-line half of the canonical config, per target.
CL_LISTS = {
    "rtos_mm": {"cloneFns": ["task_mm", "task_crc", "task_idle"],
                "protectedLibFn": ["queue_send"],
                "cloneGlbls": ["qbuf", "stacks"]},
    "rtos_kUser": {"cloneFns": ["push_frame", "pop_frame", "pick_next",
                                "task_prod", "task_cons", "task_wdg"],
                   "protectedLibFn": ["queue_send"],
                   "cloneGlbls": ["qbuf", "stacks"]},
}


def canonical_overrides(benchmark: str) -> Dict[str, object]:
    """The scope lists of ``rtos/kernel.config`` merged with the target's
    command-line lists, as ProtectionConfig overrides."""
    from coast_tpu_torch.interface.config import parse_config_file
    scope = parse_config_file(os.path.join(ROOT, "rtos", "kernel.config"),
                              required=True)
    scope.merge_cl({k: list(v) for k, v in CL_LISTS[benchmark].items()})
    return dict(scope.protection_overrides())


def canonical_prog(benchmark: str, num_clones: int = 3, device="cuda",
                   **overrides):
    """The canonical ``-TMR -countErrors`` (or DWC) build of a target."""
    from coast_tpu_torch.models import REGISTRY
    from coast_tpu_torch.passes.strategies import DWC, TMR
    make = TMR if num_clones == 3 else DWC
    return make(REGISTRY[benchmark](), device=device, count_errors=True,
                **canonical_overrides(benchmark), **overrides)


def category_table(res, mmap, categories) -> Dict[str, Dict[str, int]]:
    """Per-section class counts rolled up into the categories the kernel's
    meta declares (a leaf outside them counts as task data)."""
    from coast_tpu_torch.inject import classify as cls
    cat_of = {leaf: cat for cat, leaves in categories.items()
              for leaf in leaves}
    lid = np.asarray(res.schedule.leaf_id)
    codes = np.asarray(res.codes)
    out: Dict[str, Dict[str, int]] = {}
    for s in mmap.sections:
        row = out.setdefault(cat_of.get(s.name, "task_data"),
                             {name: 0 for name in cls.CLASS_NAMES})
        row.setdefault("injections", 0)
        mask = lid == s.leaf_id
        binc = np.bincount(codes[mask], minlength=cls.NUM_CLASSES)
        row["injections"] += int(mask.sum())
        for i, name in enumerate(cls.CLASS_NAMES):
            row[name] += int(binc[i])
    for row in out.values():
        row["due"] = sum(row[k] for k in cls.DUE_CLASSES)
    return out


def due_sub_buckets(counts: Dict[str, int]) -> Dict[str, int]:
    return {"aborts": counts["due_abort"],
            "stack_overflows": counts["due_stack_overflow"],
            "assert_fails": counts["due_assert"],
            "timeouts": counts["due_timeout"]}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="seeded RTOS kernel campaign (canonical config)")
    ap.add_argument("-n", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--benchmark", default="rtos_mm", choices=sorted(CL_LISTS))
    ap.add_argument("--strategy", default="TMR", choices=["TMR", "DWC"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None,
                    help="write the record here (and <out>_log.json)")
    args = ap.parse_args(argv)

    from coast_tpu_torch.inject.campaign import CampaignRunner
    prog = canonical_prog(args.benchmark,
                          3 if args.strategy == "TMR" else 2, args.device)
    runner = CampaignRunner(prog, strategy_name=args.strategy,
                            preflight="static")
    res = runner.run(args.n, seed=args.seed, batch_size=args.batch)
    record = {
        "metric": "rtos_campaign",
        "benchmark": args.benchmark,
        "strategy": f"{args.strategy} -countErrors (canonical rtos/Makefile "
                    "config)",
        "device": args.device,
        "seed": args.seed,
        "injections": res.n,
        "counts": res.counts,
        "due_total": res.due,
        "due_sub_buckets": due_sub_buckets(res.counts),
        "injections_per_sec": round(res.injections_per_sec, 2),
        "section_attribution": category_table(
            res, runner.mmap, prog.region.meta["rtos_sections"]),
    }
    if args.out:
        from coast_tpu_torch.inject.logs import write_columnar
        log_path = os.path.splitext(args.out)[0] + "_log.json"
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        write_columnar(res, runner.mmap, log_path)
        from coast_tpu_torch.analysis import json_parser as jp
        print(jp.summarize_path(log_path).format())
        table = jp.section_stats([jp.read_json_file(log_path)])
        print(jp.format_section_stats(table))
        record["per_symbol"] = table
        record["log"] = os.path.basename(log_path)
        with open(args.out, "w") as fh:
            json.dump(record, fh, indent=1, sort_keys=True)
    print(json.dumps(record, sort_keys=True))
    if not (res.counts["due_stack_overflow"] and res.counts["due_assert"]):
        print("ERROR: campaign recorded no stack-overflow or no assert "
              "DUEs", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
