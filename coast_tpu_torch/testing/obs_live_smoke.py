"""Live-observability smoke driver (unittest/cfg/fast.yml row).

The counterpart of ``coast_tpu/testing/obs_live_smoke.py``, with its
oracles, on the card (or the host with ``-d cpu``):

  1. **Live surfaces track a running campaign**: while batches are
     still dispatching, the HTTP endpoint's /status JSON and /metrics
     Prometheus text (and the atomic --status-json file) report the
     exact cumulative progress the campaign loop has reached.
  2. **Statistical early stop is sound**: a loose ``stop_when``
     condition stops the campaign mid-schedule, and the stopped
     campaign's per-class rates agree with the exhaustive run's within
     the reported Wilson intervals (the FastFlip stop-when-converged
     contract).
  3. **The stop is a first-class journal record**: rerunning the same
     journaled call replays the prefix and stops at the same batch
     bit-for-bit without growing the journal; resuming under a
     different (or no) condition refuses with the typed error.

Prints ``Success!`` for the harness driver oracle
(``coast_tpu_torch.testing.harness.run_drivers``).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import urllib.request
from typing import List, Optional

import numpy as np

from coast_tpu_torch.testing import device_arg


def _get(url: str):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.read().decode("utf-8")


def main(argv: Optional[List[str]] = None) -> int:
    device = device_arg(argv, "live-observability smoke")
    from coast_tpu_torch import TMR, obs
    from coast_tpu_torch.inject.campaign import CampaignRunner
    from coast_tpu_torch.inject.journal import JournalMismatchError
    from coast_tpu_torch.models import mm

    with tempfile.TemporaryDirectory() as d:
        status_path = os.path.join(d, "status.json")
        metrics = obs.CampaignMetrics(status_path=status_path)
        server = obs.MetricsServer(metrics, port=0)
        port = server.start()
        runner = CampaignRunner(TMR(mm.make_region(), device=device),
                                strategy_name="TMR", metrics=metrics)

        # 1. Live tracking: probe the HTTP surfaces from the progress
        # callback, i.e. strictly WHILE the campaign is running.
        live_ok = []

        def probe(done, counts):
            doc = json.loads(_get(f"http://127.0.0.1:{port}/status"))
            file_doc = json.loads(open(status_path).read())
            live_ok.append(
                doc["state"] == "running"
                and doc["done_rows"] == done
                and file_doc["done_rows"] == done
                and doc["counts"].get("sdc", 0) == counts.get("sdc", 0))

        full = runner.run(1500, seed=11, batch_size=128, progress=probe)
        prom = _get(f"http://127.0.0.1:{port}/metrics")
        server.stop()
        if not (live_ok and all(live_ok)):
            print(f"live tracking FAILED: probes {live_ok}")
            return 1
        if "coast_campaign_class_total" not in prom \
                or 'strategy="TMR"' not in prom:
            print("prometheus exposition FAILED: expected metrics missing")
            return 1
        final_doc = json.loads(open(status_path).read())
        if final_doc["state"] != "finished" \
                or final_doc["done_rows"] != 1500:
            print(f"status file FAILED: terminal state {final_doc['state']}"
                  f" done {final_doc['done_rows']}")
            return 1

        # 2. Early stop: loose target, must trip before the full 1500.
        stop = obs.StopWhen.parse("sdc:0.05;min=256")
        jpath = os.path.join(d, "stop.journal")
        stopped = runner.run(1500, seed=11, batch_size=128,
                             stop_when=stop, journal=jpath)
        conv = stopped.convergence
        if not conv["stopped"] or stopped.n >= full.n:
            print(f"early stop FAILED: {conv}")
            return 1
        for cls_name in ("sdc", "corrected", "success"):
            ci = conv["intervals"][cls_name]
            exact = full.counts[cls_name] / full.n
            if not (ci["lo"] <= exact <= ci["hi"]):
                print(f"convergence soundness FAILED: exhaustive "
                      f"{cls_name} rate {exact:.4f} outside the stopped "
                      f"campaign's CI [{ci['lo']:.4f}, {ci['hi']:.4f}]")
                return 1

        # 3. First-class terminal record: resume replays and stops at
        # the same batch, bit-for-bit, appending nothing.
        size_before = os.path.getsize(jpath)
        resumed = runner.run(1500, seed=11, batch_size=128,
                             stop_when=stop, journal=jpath)
        if not np.array_equal(resumed.codes, stopped.codes) \
                or os.path.getsize(jpath) != size_before:
            print("early-stop resume FAILED: codes or journal changed")
            return 1
        try:
            runner.run(1500, seed=11, batch_size=128, journal=jpath)
            print("early-stop identity FAILED: resume without stop_when "
                  "was not refused")
            return 1
        except JournalMismatchError:
            pass

    print(f"live surfaces tracked {len(live_ok)} batches; early stop at "
          f"{stopped.n}/{full.n} with exhaustive rates inside every CI; "
          "journaled stop resumed bit-for-bit and refused a mismatched "
          "condition")
    print("Success!")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
