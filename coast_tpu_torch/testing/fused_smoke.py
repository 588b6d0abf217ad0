"""Fused protected-step smoke driver (unittest/cfg/fast.yml row).

The counterpart of ``coast_tpu/testing/fused_smoke.py``, with its three
oracles, on the card (or the host with ``-d cpu``):

  * **Byte parity**: a dense mm x TMR campaign at one seed produces the
    IDENTICAL classification counts and a byte-identical dense ndjson
    log (sha256 over the file with the wall-clock timestamp normalized
    -- the one legitimately time-varying token) whether the program runs
    the unfused interpreter loop or the fused engine.  Fusion is a
    schedule change, never a semantics change.
  * **It actually wins**: the fused program's op count
    (``obs/roofline.py`` over the captured graph, the fused commit's
    plain version counted element for element) cuts ``flops_overhead``
    by >= 2x for TMR and by >= 1.5x for DWC.
  * **Campaign identity**: a journal written under one engine refuses
    the other with the typed FuseStepMismatchError, both directions.

Every oracle runs and reports; ``Success!`` (the harness driver oracle,
``coast_tpu_torch.testing.harness.run_drivers``) is printed only when all
three hold.  The overhead's numerator is the port's engine (its captured
trips), its denominator the region's useful work by the reference's
rules.  The reference's 2x cut comes from dropping its unfused engine's
dense full-state flip masks; the port's unfused engine never had them
(its flip is already one sparse write at the fire step), and what the
fused engine does prune (done-cone votes, freeze pruning, packed
latches) is under 1 % of a trip's ops.  So on the port the cut cannot
show: the driver prints both overheads and exits 1 (ROADMAP Queue C,
C5 (ii)); the floors stay the reference's.
"""

from __future__ import annotations

import hashlib
import os
import re
import sys
import tempfile
from typing import List, Optional

from coast_tpu_torch.testing import device_arg


def _norm_sha(path: str) -> str:
    """sha256 of an ndjson log with the campaign timestamp normalized:
    every line embeds the ONE per-campaign wall-clock string (logs.py
    write_ndjson), which two sequential writes legitimately differ on."""
    with open(path, "rb") as f:
        text = f.read().decode()
    text = re.sub(r'"timestamp": "[^"]*"', '"timestamp": "TS"', text)
    # The summary line's wall-clock measurements (seconds, rate, stage
    # timings) describe THIS run's scheduling, not campaign semantics.
    text = re.sub(r'"stages": \{[^}]*\}(, )?', '', text)
    text = re.sub(r'"(seconds|injections_per_sec)": [0-9.eE+-]+(, )?',
                  '', text)
    return hashlib.sha256(text.encode()).hexdigest()


def main(argv: Optional[List[str]] = None) -> int:
    device = device_arg(argv, "fused protected-step smoke")
    from coast_tpu_torch import DWC, TMR
    from coast_tpu_torch.inject.campaign import CampaignRunner
    from coast_tpu_torch.inject.journal import FuseStepMismatchError
    from coast_tpu_torch.inject.logs import write_ndjson
    from coast_tpu_torch.models import resolve_region
    from coast_tpu_torch.obs import roofline

    region = resolve_region("matrixMultiply")
    n, seed, batch = 512, 2026, 256
    failed = 0

    # -- byte parity: fused vs unfused dense ndjson at one seed ----------
    shas, counts = {}, {}
    with tempfile.TemporaryDirectory() as d:
        for mode, fused in (("unfused", False), ("fused", True)):
            prog = TMR(region, device=device, fuse_step=fused)
            runner = CampaignRunner(prog, strategy_name="TMR")
            res = runner.run(n, seed=seed, batch_size=batch)
            path = os.path.join(d, f"{mode}.ndjson")
            write_ndjson(res, runner.mmap, path)
            shas[mode] = _norm_sha(path)
            counts[mode] = dict(res.counts)
        if counts["fused"] != counts["unfused"]:
            print(f"Error, fused campaign changed classification counts: "
                  f"{counts['unfused']} -> {counts['fused']}")
            return 1
        if shas["fused"] != shas["unfused"]:
            print(f"Error, fused dense ndjson is not byte-identical "
                  f"(sha {shas['unfused'][:16]} vs {shas['fused'][:16]})")
            return 1
        print(f"byte parity: dense ndjson sha {shas['fused'][:16]} "
              f"identical across engines ({counts['fused']})")

        # -- the fused engine must WIN: measured op-count overhead -------
        for name, make, floor in (("TMR", TMR, 2.0), ("DWC", DWC, 1.5)):
            base = roofline.flops_overhead(make(region, device=device))
            fused = roofline.flops_overhead(make(region, device=device,
                                                 fuse_step=True))
            red = base / fused
            print(f"{name}: flops_overhead {base:.3f}x -> {fused:.3f}x "
                  f"({red:.2f}x reduction)")
            if red < floor:
                print(f"Error, {name} fused overhead reduction "
                      f"{red:.2f}x below the {floor}x floor")
                failed += 1

        # -- journal fuse identity: typed refusal, both directions -------
        for first, second in ((False, True), (True, False)):
            jpath = os.path.join(d, f"j_{int(first)}.ndjson")
            CampaignRunner(TMR(region, device=device, fuse_step=first),
                           strategy_name="TMR").run(
                16, seed=1, batch_size=16, journal=jpath)
            try:
                CampaignRunner(TMR(region, device=device,
                                   fuse_step=second),
                               strategy_name="TMR").run(
                    16, seed=1, batch_size=16, journal=jpath)
                print(f"Error, fuse={second} runner resumed a "
                      f"fuse={first} journal")
                return 1
            except FuseStepMismatchError:
                pass
        print("journal identity: cross-engine resume refused typed "
              "(both directions)")

    if failed:
        return 1
    print("Success!")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
