"""Equivalence-reduction smoke driver (unittest/cfg/fast.yml row).

The counterpart of ``coast_tpu/testing/equiv_smoke.py``:

  1. **Differential parity** -- the equivalence-reduced campaign's
     weighted classification distribution EXACTLY equals the exhaustive
     one on a seeded TMR and a seeded DWC target, while physically
     dispatching strictly fewer runs.
  2. **Journal identity** -- an interrupted equiv campaign resumes
     bit-for-bit, and resuming its journal without the partition is
     refused with the typed JournalMismatchError.
  3. **Delta campaigns** -- a no-op rebuild re-injects zero rows; a
     pre-equiv journal (no fingerprint block) is refused with the typed
     DeltaMismatchError.

Prints ``Success!``.
"""

from __future__ import annotations

import os
import sys
import tempfile
from typing import List, Optional

import numpy as np

from coast_tpu_torch.testing import Kill, device_arg, kill_after


def main(argv: Optional[List[str]] = None) -> int:
    device = device_arg(argv, "equivalence-reduction smoke")
    from coast_tpu_torch import DWC, TMR
    from coast_tpu_torch.analysis.equiv import DeltaMismatchError
    from coast_tpu_torch.inject.campaign import CampaignRunner
    from coast_tpu_torch.inject.journal import JournalMismatchError
    from coast_tpu_torch.models import crc16, mm

    # 1. differential parity on two strategies / two targets
    checks = ((TMR, "TMR", mm.make_region()),
              (DWC, "DWC", crc16.make_region()))
    for maker, strat, region in checks:
        prog = maker(region, device=device)
        exhaustive = CampaignRunner(prog, strategy_name=strat)
        reduced = CampaignRunner(prog, strategy_name=strat, equiv=True)
        a = exhaustive.run(1500, seed=23, batch_size=500)
        b = reduced.run(1500, seed=23, batch_size=500)
        if a.counts != b.counts:
            print(f"differential parity FAILED on {region.name} {strat}: "
                  f"{a.counts} != {b.counts}")
            return 1
        if b.physical_n is None or b.physical_n >= a.n:
            print(f"no reduction on {region.name} {strat}: "
                  f"physical={b.physical_n}")
            return 1
        print(f"{region.name} {strat}: distribution identical at "
              f"{b.physical_n}/{a.n} physical injections "
              f"({a.n / b.physical_n:.1f}x)")

    # 2. journaled equiv campaign: interrupt, resume, identity checks
    prog = TMR(mm.make_region(), device=device)
    runner = CampaignRunner(prog, strategy_name="TMR", equiv=True)
    baseline = runner.run(1200, seed=23, batch_size=300)
    with tempfile.TemporaryDirectory() as d:
        jpath = os.path.join(d, "equiv.journal")
        beats = {"n": 0}
        try:
            runner.run(1200, seed=23, batch_size=300, journal=jpath,
                       progress=kill_after(beats))
            print("campaign was not interrupted; smoke setup broken")
            return 1
        except Kill:
            pass
        resumed = runner.run(1200, seed=23, batch_size=300, journal=jpath)
        if not np.array_equal(resumed.codes, baseline.codes) \
                or resumed.counts != baseline.counts:
            print("equiv resume parity FAILED")
            return 1
        try:
            CampaignRunner(prog, strategy_name="TMR").run(
                1200, seed=23, batch_size=300, journal=jpath)
            print("partition mismatch was NOT refused")
            return 1
        except JournalMismatchError:
            pass
        print("equiv campaign interrupted, resumed bit-for-bit; "
              "partitionless resume refused")

        # 3. delta: no-op rebuild reuses everything; pre-equiv refused
        base_j = os.path.join(d, "delta_base.journal")
        runner.run(1200, seed=23, batch_size=300, journal=base_j)
        rebuilt = CampaignRunner(TMR(mm.make_region(), device=device),
                                 strategy_name="TMR", equiv=True)
        delta = rebuilt.run_delta(1200, base_j, seed=23, batch_size=300)
        if delta.delta["reinjected_rows"] != 0 \
                or delta.delta["changed_sections"]:
            print(f"no-op delta re-injected: {delta.delta}")
            return 1
        if delta.counts != baseline.counts:
            print("delta splice distribution FAILED")
            return 1
        plain_j = os.path.join(d, "plain.journal")
        CampaignRunner(prog, strategy_name="TMR").run(
            600, seed=23, batch_size=300, journal=plain_j)
        try:
            rebuilt.run_delta(600, plain_j, seed=23, batch_size=300)
            print("pre-equiv delta base was NOT refused")
            return 1
        except DeltaMismatchError:
            pass
        print("no-op delta re-injected 0 rows; pre-equiv base refused")
    print("Success!")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
