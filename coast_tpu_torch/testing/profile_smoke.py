"""Campaign-profiler smoke driver (unittest/cfg/fast.yml row).

The counterpart of ``coast_tpu/testing/profile_smoke.py``, with its
oracles, on the card (or the host with ``-d cpu``): the device-time
attribution layer's contract.

  * a profiled campaign's attribution sums exactly: device_busy +
    host_gap + host_other == wall clock (the profile_mm.json
    acceptance identity), with one histogram observation per dispatch;
  * campaign OUTPUTS are byte-identical with the profiler on or off
    (codes, counts) -- the profiler only observes timing;
  * the ``python -m coast_tpu_torch profile`` verb produces the attribution
    artifact (profile + mfu blocks per target) and exits 0;
  * the roofline accounting is sane: the protected program's analytic
    op count exceeds the unprotected region's (flops overhead > lanes
    is expected for bookkeeping-heavy toy kernels);
  * fleet trace federation merges a journaled campaign's span timeline
    with the queue's claim/complete events, exactly once per batch.

Prints ``Success!`` for the harness driver oracle
(``coast_tpu_torch.testing.harness.run_drivers``).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import List, Optional

import numpy as np

from coast_tpu_torch.testing import device_arg


def main(argv: Optional[List[str]] = None) -> int:
    device = device_arg(argv, "campaign-profiler smoke")
    from coast_tpu_torch import TMR
    from coast_tpu_torch.inject.campaign import CampaignRunner
    from coast_tpu_torch.models import mm

    region = mm.make_region()
    plain = CampaignRunner(TMR(region, device=device),
                           strategy_name="TMR")
    profiled = CampaignRunner(TMR(region, device=device),
                              strategy_name="TMR", profile=True)

    a = plain.run(240, seed=17, batch_size=48)
    profiled.run(48, seed=1, batch_size=48)            # warm-up
    b = profiled.run(240, seed=17, batch_size=48)
    assert a.counts == b.counts, (a.counts, b.counts)
    assert np.array_equal(a.codes, b.codes), \
        "profiler changed campaign outputs"
    prof = b.profile
    assert prof is not None and prof["dispatches"] == 5, prof
    total = (prof["device_busy_s"] + prof["host_gap_s"]
             + prof["host_other_s"])
    assert abs(total - prof["wall_s"]) < 1e-3, (total, prof["wall_s"])
    hist = prof["device_seconds_histogram"]
    assert hist["count"] == prof["dispatches"], hist
    mfu = prof["mfu"]
    assert mfu["program_ops_per_run"] > mfu["useful_ops_per_run"], mfu
    assert mfu["flops_overhead"] > 2.0, mfu  # 3 lanes + bookkeeping
    print(f"# attribution: device {prof['device_busy_s']:.4f}s + gap "
          f"{prof['host_gap_s']:.4f}s + other {prof['host_other_s']:.4f}s"
          f" == wall {prof['wall_s']:.4f}s; overhead "
          f"{mfu['flops_overhead']}x")

    with tempfile.TemporaryDirectory() as tmp:
        # The CLI verb end-to-end: artifact with profile+mfu per target.
        from coast_tpu_torch.__main__ import main as coast_main
        out = os.path.join(tmp, "profile.json")
        trace = os.path.join(tmp, "profile.trace.json")
        rc = coast_main(["profile", "--target", "matrixMultiply|-TMR",
                         "-t", "512", "--batch-size", "128",
                         "--out", out, "--trace-out", trace,
                         "-d", "cpu" if device == "cpu" else "gpu"])
        assert rc == 0, rc
        with open(out) as fh:
            doc = json.load(fh)
        blk = doc["targets"]["matrixMultiply|-TMR"]
        assert blk["profile"]["dispatches"] == 4, blk["profile"]
        assert blk["mfu"]["flops_overhead"] > 2.0
        with open(trace) as fh:
            tdoc = json.load(fh)
        assert any(e.get("cat") == "device"
                   for e in tdoc["traceEvents"]), \
            "no device-track spans in the exported trace"

        # Fleet federation over a journaled campaign: every batch's
        # spans exactly once, queue claim/complete events present.
        from coast_tpu_torch.fleet.queue import CampaignQueue, item_spec
        from coast_tpu_torch.obs.federate import merge_traces
        q = CampaignQueue(os.path.join(tmp, "queue"))
        item_id = q.enqueue(item_spec("matrixMultiply", 240, seed=17,
                                      batch_size=48))
        item = q.claim("w0", lease_s=60.0)
        assert item is not None and item.id == item_id
        res = plain.run(240, seed=17, batch_size=48,
                        journal=q.journal_path(item_id))
        q.complete(item_id, "w0", {"benchmark": res.benchmark,
                                   "strategy": res.strategy,
                                   "counts": dict(res.counts),
                                   "worker": "w0"})
        doc = merge_traces(q)
        spans = [e for e in doc["traceEvents"]
                 if e.get("cat") == "journal"]
        los = sorted(e["args"]["lo"] for e in spans
                     if e["name"] == "dispatch")
        assert los == [0, 48, 96, 144, 192], los
        marks = {e["name"].split(" ", 1)[0]
                 for e in doc["traceEvents"] if e.get("cat") == "queue"}
        assert {"enqueue", "claim", "complete"} <= marks, marks
    print("Success!")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main(sys.argv[1:]))
