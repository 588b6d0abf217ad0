"""Fault-model smoke driver (unittest/cfg/fast.yml row).

The counterpart of ``coast_tpu/testing/faultmodel_smoke.py``:

  1. **Legacy parity** -- a ``FaultModel.single`` campaign classifies
     bit-for-bit identically to the default (model-less) runner, and its
     log summary carries no fault-model key.
  2. **Expansion** -- the port expands flip groups on one path
     (``native.fault_expand``, numpy; the reference's native/numpy parity
     check has one side here), so the check is that every model kind's
     expansion is deterministic per seed.
  3. **Model identity** -- a journaled multi-site campaign interrupted
     after k batches resumes bit-for-bit, and resume under a DIFFERENT
     model is refused with the typed FaultModelMismatchError.

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
    device = device_arg(argv, "fault-model smoke")
    from coast_tpu_torch import TMR, native
    from coast_tpu_torch.inject.campaign import CampaignRunner
    from coast_tpu_torch.inject.journal import FaultModelMismatchError
    from coast_tpu_torch.inject.schedule import FaultModel, generate
    from coast_tpu_torch.models import mm

    region = mm.make_region()
    prog = TMR(region, device=device)

    # 1. legacy parity: explicit single == default, no summary key
    default = CampaignRunner(prog, strategy_name="TMR")
    single = CampaignRunner(prog, strategy_name="TMR",
                            fault_model=FaultModel.single())
    a = default.run(120, seed=17, batch_size=40)
    b = single.run(120, seed=17, batch_size=40)
    if not np.array_equal(a.codes, b.codes) or "fault_model" in b.summary():
        print("single-model parity FAILED")
        return 1
    print("single-model campaign identical to the legacy path")

    # 2. expansion: one path, deterministic per seed for every kind
    models = [FaultModel.multibit(k=4), FaultModel.cluster(span=4, k=3),
              FaultModel.burst(window=8, rate=0.5)]
    mmap = default.mmap
    base_sched = generate(mmap, 200, 17, region.nominal_steps)
    base = {k: getattr(base_sched, k)
            for k in ("leaf_id", "lane", "word", "bit", "t", "section_idx")}
    tables = mmap.section_tables()
    for m in models:
        args = (17, m.kind, m.sites, m.span, m.window,
                region.nominal_steps, base, tables)
        one, two = native.fault_expand(*args), native.fault_expand(*args)
        if not all(np.array_equal(x, y) for x, y in zip(one, two)):
            print(f"expansion determinism FAILED for {m.spec()}")
            return 1
    print("native core unavailable; numpy expansion is the only path "
          f"(deterministic over {len(models)} kinds)")

    # 3. journaled multi-site resume + typed model-mismatch refusal
    model = FaultModel.cluster(span=4, k=3)
    runner = CampaignRunner(prog, strategy_name="TMR", fault_model=model)
    baseline = runner.run(120, seed=17, batch_size=40)
    with tempfile.TemporaryDirectory() as d:
        jpath = os.path.join(d, "fm.journal")
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
            print("multi-site resume parity FAILED: codes differ")
            return 1
        try:
            CampaignRunner(prog, strategy_name="TMR",
                           fault_model=FaultModel.multibit(k=4)).run(
                120, seed=17, batch_size=40, journal=jpath)
            print("model mismatch was NOT refused")
            return 1
        except FaultModelMismatchError:
            pass
    print(f"{model.spec()} campaign interrupted after {beats['n']} "
          "batches, resumed bit-for-bit; mismatched model refused")
    print("Success!")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
