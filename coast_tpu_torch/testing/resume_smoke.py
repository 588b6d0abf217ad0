"""Interrupt-and-resume smoke driver (unittest/cfg/fast.yml row).

The counterpart of ``coast_tpu/testing/resume_smoke.py``: a campaign
killed after k collected batches and relaunched against its journal
completes with ``codes`` and ``counts`` bit-for-bit identical to the
uninterrupted run.  Prints ``Success!`` for the harness driver oracle.
"""

from __future__ import annotations

import os
import sys
import tempfile
from typing import List, Optional

import numpy as np

from coast_tpu_torch.testing import Kill, device_arg, kill_after


def main(argv: Optional[List[str]] = None) -> int:
    device = device_arg(argv, "interrupt-and-resume smoke")
    from coast_tpu_torch import TMR
    from coast_tpu_torch.inject.campaign import CampaignRunner
    from coast_tpu_torch.models import mm

    runner = CampaignRunner(TMR(mm.make_region(), device=device),
                            strategy_name="TMR")
    baseline = runner.run(120, seed=17, batch_size=40)

    with tempfile.TemporaryDirectory() as d:
        jpath = os.path.join(d, "smoke.journal")
        beats = {"n": 0}
        try:
            runner.run(120, seed=17, batch_size=40, journal=jpath,
                       progress=kill_after(beats))
            print("campaign was not interrupted; smoke setup broken")
            return 1
        except Kill:
            pass
        resumed = runner.run(120, seed=17, batch_size=40, journal=jpath)

    if not np.array_equal(resumed.codes, baseline.codes):
        print("resume parity FAILED: codes differ")
        return 1
    if resumed.counts != baseline.counts:
        print(f"resume parity FAILED: counts differ "
              f"({resumed.counts} vs {baseline.counts})")
        return 1
    print(f"interrupted after {beats['n']} batches, resumed to "
          f"{resumed.n} injections, codes bit-for-bit identical")
    print("Success!")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
