"""Distribution-level classification-fidelity study.

The counterpart of the reference's ``scripts/fidelity_study.py``.
BASELINE.md's fidelity gate asks for identical SDC/DUE classification
against the reference's QEMU/ARM loop on matrixMultiply under TMR; that
toolchain is not part of this repo, so the study checks the next
strongest thing: that the distribution of outcomes matches the masking
behaviour the reference's voter placement implies (dataflowProtection's
synchronisation logic; the outcome taxonomy of jsonParser.py:148-201):

  C1  Single-lane flips into REPLICATED state under TMR are never SDC:
      every store is preceded by a majority vote.
  C2  Flips into SHARED leaves (outside the sphere of replication) are
      invisible to the voter: their SDC rate under TMR matches
      unprotected within sampling error (95% Wilson intervals overlap).
  C3  The size-weighted harm rate (SDC + DUE + INVALID) under TMR is far
      below unprotected, and MWTF = (harm-rate ratio) / (runtime ratio)
      > 1 (jsonParser.py:458-506, mwtf at :473).
  C4  Replicated-state flips under plain TMR never raise DUE on mm.

Writes the per-section outcome tables of unprotected and TMR and the
check verdicts, and exits nonzero if any check fails.  The budget per
program is ``COAST_FIDELITY_BUDGET`` (default 14000), as in the
reference.  It runs on the card unless given ``-d cpu``.

Usage: python -m coast_tpu_torch.scripts.fidelity_study [-d cpu]
       [--out build/studies/fidelity_study.json]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np

from coast_tpu_torch import device as device_mod
from coast_tpu_torch.scripts import common


def wilson95(k: int, n: int):
    if not n:
        return (0.0, 1.0)
    z = 1.959963984540054
    phat = k / n
    denom = 1 + z * z / n
    centre = phat + z * z / (2 * n)
    half = z * math.sqrt(phat * (1 - phat) / n + z * z / (4 * n * n))
    return (max(0.0, (centre - half) / denom),
            min(1.0, (centre + half) / denom))


def section_table(res, mmap):
    """Outcome counts per section, from the per-run codes."""
    from coast_tpu_torch.inject import classify as cls
    table = {}
    lid = np.asarray(res.schedule.leaf_id)
    codes = np.asarray(res.codes)
    for s in mmap.sections:
        mask = lid == s.leaf_id
        binc = np.bincount(codes[mask], minlength=cls.NUM_CLASSES)
        table[s.name] = {
            "kind": s.kind, "replicated": s.lanes > 1,
            "lanes": s.lanes, "words": s.words,
            "n": int(mask.sum()),
            **{name: int(binc[i])
               for i, name in enumerate(cls.CLASS_NAMES)},
        }
    return table


def harm(row):
    return (row["sdc"] + row["due_abort"] + row["due_timeout"]
            + row.get("due_stack_overflow", 0) + row.get("due_assert", 0)
            + row["invalid"])


def population_harm_rate(table):
    """Size-weighted (post-stratified) harm rate over all sections."""
    total_bits = sum(r["lanes"] * r["words"] for r in table.values())
    rate = 0.0
    for r in table.values():
        if r["n"]:
            rate += (harm(r) / r["n"]) * (r["lanes"] * r["words"] / total_bits)
    return rate


def run_study(budget: int, seed: int = 7, device: str = "cuda"):
    from coast_tpu_torch import TMR, unprotected
    from coast_tpu_torch.inject.campaign import CampaignRunner
    from coast_tpu_torch.inject.schedule import generate_stratified_total
    from coast_tpu_torch.models import mm

    dev = device_mod.resolve(device)
    region = mm.make_region()
    out = {"metric": "classification_fidelity_study",
           "device": common.device_block(dev),
           "benchmark": "matrixMultiply", "budget_per_program": budget,
           "seed": seed}
    tables = {}
    runtimes = {}
    for name, make in (("unprotected", unprotected), ("TMR", TMR)):
        prog = make(region, device=dev)
        runner = CampaignRunner(prog, strategy_name=name)
        sched = generate_stratified_total(runner.mmap, budget, seed,
                                          region.nominal_steps)
        bs = min(4096, len(sched))
        runner.run_schedule(sched, batch_size=bs)      # warm
        res = runner.run_schedule(sched, batch_size=bs)
        tables[name] = section_table(res, runner.mmap)
        # MWTF's runtime denominator: warmed campaign seconds over the
        # same schedule size for both programs, the amortised cost a
        # protected run (a single run of a 9x9 kernel is bound by its
        # launches, not its work).
        runtimes[name] = res.seconds
    out["sections"] = tables
    out["campaign_seconds_same_n"] = {k: round(v, 4)
                                      for k, v in runtimes.items()}

    checks = []

    # C1: replicated TMR flips never SDC.
    repl_sdc = sum(r["sdc"] for r in tables["TMR"].values()
                   if r["replicated"])
    repl_n = sum(r["n"] for r in tables["TMR"].values() if r["replicated"])
    checks.append({
        "name": "C1_replicated_flips_never_sdc",
        "pass": repl_sdc == 0,
        "detail": f"{repl_sdc} SDC in {repl_n} replicated-state injections",
    })

    # C2: shared-leaf SDC rate unchanged by TMR (CI overlap).
    shared = [n for n, r in tables["TMR"].items() if not r["replicated"]]
    c2_pass, c2_detail = True, []
    for name in shared:
        rt, ru = tables["TMR"][name], tables["unprotected"][name]
        lo_t, hi_t = wilson95(rt["sdc"], rt["n"])
        lo_u, hi_u = wilson95(ru["sdc"], ru["n"])
        overlap = not (hi_t < lo_u or hi_u < lo_t)
        c2_pass &= overlap
        c2_detail.append(
            f"{name}: TMR {rt['sdc']}/{rt['n']} "
            f"[{lo_t:.3f},{hi_t:.3f}] vs unprot {ru['sdc']}/{ru['n']} "
            f"[{lo_u:.3f},{hi_u:.3f}] overlap={overlap}")
    checks.append({"name": "C2_shared_leaf_sdc_rate_unchanged",
                   "pass": bool(c2_pass), "detail": "; ".join(c2_detail)})

    # C3: population harm drops; MWTF > 1.
    h_u = population_harm_rate(tables["unprotected"])
    h_t = population_harm_rate(tables["TMR"])
    rt_ratio = runtimes["TMR"] / runtimes["unprotected"]
    mwtf = (h_u / h_t) / rt_ratio if h_t > 0 else float("inf")
    checks.append({
        "name": "C3_population_harm_drop_and_mwtf",
        "pass": bool(h_t < h_u / 2 and mwtf > 1.0),
        "detail": (f"harm rate unprot={h_u:.4f} TMR={h_t:.4f}, runtime "
                   f"x{rt_ratio:.2f}, MWTF={mwtf:.1f}"),
        "mwtf": None if math.isinf(mwtf) else round(mwtf, 2),
    })

    # C4: replicated TMR flips never DUE on mm.
    repl_due = sum(r["due_abort"] + r["due_timeout"]
                   for r in tables["TMR"].values() if r["replicated"])
    checks.append({
        "name": "C4_replicated_flips_never_due",
        "pass": repl_due == 0,
        "detail": f"{repl_due} DUE in {repl_n} replicated-state injections",
    })

    out["checks"] = checks
    out["all_pass"] = all(c["pass"] for c in checks)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("-d", "--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the campaigns run (default the card)")
    ap.add_argument("--out", default=common.default_out(
        "fidelity_study.json"))
    args = ap.parse_args(argv)
    budget = int(os.environ.get("COAST_FIDELITY_BUDGET", "14000"))
    out = run_study(budget, device=args.device)
    common.write_record(args.out, out)
    print(json.dumps({k: out[k] for k in
                      ("metric", "device", "budget_per_program",
                       "checks", "all_pass")}))
    return 0 if out["all_pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
