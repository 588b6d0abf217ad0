"""The check's two readings: the program's and the control's.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3

For each seed it draws the cell's first campaign as a run does and
re-executes it with the plain reference at the configuration's stated
precision.  It runs that campaign through the program, as the window
does, and compares (the lower reading: sound runs); then it puts the
reference in the program's place, computed in the nearest precision
below the stated one (``control_precision`` of the configuration), and
compares the same way (the upper reading).  One JSON line a seed.  The
benchmark's runs never run this; its numbers set the check's limits
(``PERF.md``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Dict, Optional

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import harness, traffic as traffic_mod  # noqa: E402
from perfbench.reference import engine  # noqa: E402


@dataclasses.dataclass
class Records:
    """A reference's records in the shape of a campaign result, as the
    program's ``collect`` mode returns them."""

    n: int
    counts: Dict[str, int]
    codes: np.ndarray
    errors: np.ndarray
    corrected: np.ndarray
    steps: np.ndarray
    interesting_rows: Optional[np.ndarray]


def as_result(rec: Dict[str, np.ndarray], collect: str) -> Records:
    hist = engine.histogram(rec["code"])
    counts = {name: int(hist[i]) for i, name in
              enumerate(engine.CLASS_NAMES[:8])}
    counts["cache_invalid"] = 0
    rows = None
    cols = {k: rec[k] for k in engine.COLUMNS}
    if collect == "sparse":
        rows = np.flatnonzero(rec["code"] > engine.CORRECTED)
        cols = {k: v[rows] for k, v in cols.items()}
    return Records(n=len(rec["code"]), counts=counts, codes=cols["code"],
                   errors=cols["errors"], corrected=cols["corrected"],
                   steps=cols["steps"], interesting_rows=rows)


def readings(bench, workload: str, seeds, device, overrides=None,
             log=print):
    cell = harness.load_cell(bench, workload, overrides)
    cfg, tr = cell.config, cell.traffic
    region = harness.reference_region(cfg)
    low = harness.reference_region(cfg, precision=cfg["control_precision"])
    layout = engine.layout(region)
    block = int(cfg["reference_block_rows"])
    _, runner = harness.build_program(cfg, tr, device)
    out = []
    for seed in seeds:
        cols = traffic_mod.draw_pool(seed, layout, region.nominal_steps,
                                     dataclasses.replace(tr, schedules=1))[0]
        faults = {k: cols[k].astype(np.int64) for k in engine.FAULT_KEYS}
        truth = engine.Reference(region, device).run_blocks(faults, block)
        row = {"seed": seed, "rows": int(len(cols["t"]))}
        t0 = time.perf_counter()
        res = runner.run_schedule(harness.to_schedule(cols, tr, seed),
                                  batch_size=tr.batch)
        row["program_s"] = time.perf_counter() - t0
        row["program"] = harness.compare(res, truth)
        rec = engine.Reference(low, device).run_blocks(faults, block)
        row["control"] = harness.compare(as_result(rec, tr.collect), truth)
        log(json.dumps(row))
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    import torch
    from pathlib import Path

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    readings(Path(ROOT) / "BENCHMARK.json", args.workload,
             [int(s) for s in args.seeds.split(",")], torch.device("cuda:0"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
