"""Static fault-propagation smoke driver (unittest/cfg/fast.yml row).

The counterpart of ``coast_tpu/testing/propagation_smoke.py``:

  1. **Vulnerability-map verdicts** -- mm under TMR: the check oracle
     (``golden``) and the value-fed predicate word (``phase``) are
     ``sdc-possible`` with witness paths, every structurally-routed
     replicated leaf is ``detected-bounded``, and a seeded campaign
     confirms the soundness direction live.
  2. **Isolation prover** -- noninterference HOLDS on the clean TMR and
     DWC builds (with discharged voted-commit obligations), and the seeded
     voter bypass is refuted with a non-empty counterexample path.
  3. **Static budget** -- a delta campaign under a stop condition with
     ``static_budget=True`` spends no MORE physical injections than the
     unseeded delta at the same stop condition.

Prints ``Success!``.
"""

from __future__ import annotations

import os
import sys
import tempfile
from typing import List, Optional

import numpy as np

from coast_tpu_torch.testing import device_arg


def main(argv: Optional[List[str]] = None) -> int:
    device = device_arg(argv, "static fault-propagation smoke")
    from coast_tpu_torch import DWC, TMR
    from coast_tpu_torch.analysis.propagation import (VERDICT_DETECTED,
                                                      VERDICT_SDC,
                                                      analyze_propagation,
                                                      crossvalidate_counts,
                                                      prove_isolation,
                                                      seeded_voter_bypass)
    from coast_tpu_torch.inject import classify as cls
    from coast_tpu_torch.inject.campaign import CampaignRunner
    from coast_tpu_torch.models import crc16, mm
    from coast_tpu_torch.obs.convergence import StopWhen

    # 1. vulnerability-map verdicts + live soundness spot-check
    prog = TMR(mm.make_region(), device=device)
    vmap = analyze_propagation(prog)
    verdicts = vmap.section_verdicts()
    want_sdc = {"golden", "phase"}
    got_sdc = {n for n, v in verdicts.items() if v == VERDICT_SDC}
    if got_sdc != want_sdc:
        print(f"mm TMR sdc-possible set {sorted(got_sdc)} != "
              f"{sorted(want_sdc)}")
        return 1
    if any(v != VERDICT_DETECTED for n, v in verdicts.items()
           if n not in want_sdc):
        print(f"mm TMR non-sdc sections not detected-bounded: {verdicts}")
        return 1
    if not any(r.witness for r in vmap.rows["phase"]):
        print("sdc-possible verdict for 'phase' carries no witness path")
        return 1
    runner = CampaignRunner(prog, strategy_name="TMR")
    res = runner.run(1500, seed=23, batch_size=500)
    lids = np.asarray(res.schedule.leaf_id)
    section_counts = {}
    for sec in runner.mmap.sections:
        binc = np.bincount(res.codes[lids == sec.leaf_id],
                           minlength=cls.NUM_CLASSES)
        section_counts[sec.name] = {
            k: int(c) for k, c in zip(cls.CLASS_NAMES, binc) if c}
    violations = crossvalidate_counts(vmap, section_counts)
    if violations:
        print("soundness violations:", violations)
        return 1
    print(f"mm TMR map: {vmap.counts()} -- no detected-bounded section "
          "shows SDC in a live 1500-injection campaign")

    # 2. isolation prover: clean holds, seeded bypass refuted
    for maker, strat in ((TMR, "TMR"), (DWC, "DWC")):
        proof = prove_isolation(maker(mm.make_region(), device=device),
                                strategy=strat)
        if not proof.holds or proof.vacuous or not proof.voted_commits:
            print(f"clean {strat} isolation proof broken: "
                  f"{proof.format()}")
            return 1
        with seeded_voter_bypass():
            bad = maker(crc16.make_region(), device=device)
            leak = prove_isolation(bad, strategy=strat)
        if leak.holds or not leak.leaks or not leak.leaks[0].path:
            print(f"seeded voter bypass NOT caught under {strat}")
            return 1
        print(f"{strat}: clean proof holds "
              f"({len(proof.voted_commits)} voted commits); seeded "
              f"bypass refuted with a {len(leak.leaks[0].path)}-step "
              "counterexample path")

    # 3. static-budget delta: sdc-possible first, no extra spend
    eq = CampaignRunner(prog, strategy_name="TMR", equiv=True)
    with tempfile.TemporaryDirectory() as d:
        base = eq.run(1500, seed=23, batch_size=500)
        jpath = os.path.join(d, "base.journal")
        eq.journal_result(base, jpath, n=1500, batch_size=500)
        sw = StopWhen.parse("sdc:0.05;min=128")
        plain = eq.run_delta(1500, jpath, seed=23, batch_size=500,
                             stop_when=sw)
        seeded = eq.run_delta(1500, jpath, seed=23, batch_size=500,
                              stop_when=sw, static_budget=True)
        sb = (seeded.delta or {}).get("static_budget") or {}
        if sb.get("verdicts", {}).get("golden") != VERDICT_SDC:
            print(f"static_budget verdicts missing/wrong: {sb}")
            return 1
        if seeded.physical_n > plain.physical_n:
            print(f"static budget spent MORE physical injections "
                  f"({seeded.physical_n} > {plain.physical_n})")
            return 1
        print(f"static-budget delta: verdicts recorded, physical spend "
              f"{seeded.physical_n} <= plain {plain.physical_n}")

    print("Success!")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
