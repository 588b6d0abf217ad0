"""Campaign-fleet smoke driver (unittest/cfg/fast.yml row).

The counterpart of ``coast_tpu/testing/fleet_smoke.py``, with its
oracles, on the card (both workers share it) or the host with ``-d cpu``:

  1. **Fleet drains a queue across worker processes**: 2 workers x 2
     tiny queued campaigns (same protection config, distinct seeds).
  2. **Kill/resume convergence**: one worker is SIGKILL'd mid-campaign;
     its item is requeued and a replacement worker resumes the claimed
     journal -- the fleet still converges, and the merged
     parity-checked result's per-item codes AND counts are
     bit-identical to the same campaigns run sequentially in one
     process.
  3. **Compile cache pays off**: the replacement's rebuild of the
     killed config is recorded as a cache hit (>=1 hit fleet-wide).
  4. **Live fleet telemetry**: the aggregate /metrics endpoint serves
     fleet-wide per-class rates over HTTP while workers are still
     running.

Prints ``Success!`` for the harness driver oracle
(``coast_tpu_torch.testing.harness.run_drivers``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.request
from typing import List, Optional

from coast_tpu_torch.testing import device_arg


def _get(url: str) -> str:
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.read().decode("utf-8")


def _spawn_worker(queue_root: str, worker_id: str,
                  device: str) -> subprocess.Popen:
    import coast_tpu_torch
    env = dict(os.environ)
    pkg_root = os.path.dirname(os.path.dirname(
        os.path.abspath(coast_tpu_torch.__file__)))
    env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, "-m", "coast_tpu_torch.fleet", "worker",
         "--queue", queue_root, "--worker-id", worker_id,
         "--lease", "60", "--device", device],
        env=env)


def main(argv: Optional[List[str]] = None) -> int:
    device = device_arg(argv, "campaign-fleet smoke")
    from coast_tpu_torch.fleet import (CampaignQueue, CompileCache,
                                       FleetTelemetry, codes_sha256,
                                       item_spec, merge_fleet)
    from coast_tpu_torch.obs.serve import MetricsServer

    with tempfile.TemporaryDirectory() as d:
        q = CampaignQueue(os.path.join(d, "q"))
        # Throttled batches make "mid-campaign" a wide, deterministic
        # window: 300 rows / 50-row batches x 0.2 s.
        specs = [item_spec("matrixMultiply", 300, seed=3, batch_size=50,
                           throttle_s=0.2),
                 item_spec("matrixMultiply", 300, seed=4, batch_size=50,
                           throttle_s=0.2)]
        ids = [q.enqueue(spec) for spec in specs]

        server = MetricsServer(FleetTelemetry(q, stale_s=120.0), port=0)
        port = server.start()

        procs = {wid: _spawn_worker(q.root, wid, device)
                 for wid in ("w0", "w1")}
        live_rates_seen = False
        victim_id = None
        victim_item = None
        deadline = time.time() + 240
        try:
            # Wait until some item's journal has collected batches but
            # is still far from its last (so the kill really lands
            # mid-campaign, not in a complete() race), probing the live
            # aggregate endpoint only until it has answered -- the HTTP
            # round-trip must not widen the selection-to-kill gap.
            while time.time() < deadline and victim_item is None:
                if not live_rates_seen:
                    prom = _get(f"http://127.0.0.1:{port}/metrics")
                    if "coast_fleet_class_rate" in prom \
                            and not q.drained():
                        live_rates_seen = True
                for rec in q.items("claimed"):
                    jpath = q.journal_path(str(rec["id"]))
                    if not os.path.exists(jpath):
                        continue
                    batches = sum(1 for line in open(jpath, "rb")
                                  if b'"kind":"batch"' in line)
                    if 1 <= batches <= 4:          # of 6: >=2 to go
                        victim_item = str(rec["id"])
                        victim_id = str(rec["worker"])
                        break
                time.sleep(0.05)
            if victim_item is None:
                print("no worker journaled a batch in time")
                return 1
            # SIGKILL the worker mid-campaign; requeue what it held and
            # start a replacement -- the fleet must converge anyway.
            victim = procs.pop(victim_id)
            victim.kill()
            victim.wait(timeout=30)
            requeued = q.requeue_worker(victim_id)
            size_at_kill = os.path.getsize(q.journal_path(victim_item))
            procs[f"{victim_id}r"] = _spawn_worker(q.root,
                                                   f"{victim_id}r", device)
            while time.time() < deadline and not q.drained():
                if not live_rates_seen:
                    prom = _get(f"http://127.0.0.1:{port}/metrics")
                    if "coast_fleet_class_rate" in prom \
                            and not q.drained():
                        live_rates_seen = True
                time.sleep(0.05)
            for proc in procs.values():
                proc.wait(timeout=60)
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.terminate()
            server.stop()

        if not q.drained() or q.stats()["done"] != 2:
            print(f"fleet never converged: {q.stats()}")
            return 1
        if victim_item not in requeued:
            print(f"kill/requeue FAILED: {victim_item} not in {requeued}")
            return 1
        if os.path.getsize(q.journal_path(victim_item)) <= size_at_kill:
            print("resume FAILED: the killed item's journal never grew "
                  "(item was redone, not resumed?)")
            return 1
        if not live_rates_seen:
            print("live telemetry FAILED: /metrics never served fleet "
                  "per-class rates while workers ran")
            return 1

        result = merge_fleet(q)         # raises FleetParityError itself
        by_id = {item["id"]: item for item in result["items"]}
        if by_id[victim_item]["attempts"] != 2:
            print(f"expected 2 attempts on the killed item, got "
                  f"{by_id[victim_item]['attempts']}")
            return 1
        hits = result["cache"]["hits"]
        if hits < 1:
            print(f"compile cache FAILED: {result['cache']} (want >=1 "
                  "hit from the replacement worker's rebuild)")
            return 1

        # Merged-parity pin: fleet == the same campaigns sequentially
        # in ONE process (codes AND counts, per item and in total).
        ref_cache = CompileCache(os.path.join(d, "refcache"),
                                 device=device)
        ref_totals = {}
        for item_id, spec in zip(ids, specs):
            runner, _, _, _ = ref_cache.runner(spec)
            ref = runner.run(spec["n"], seed=spec["seed"],
                             batch_size=spec["batch_size"])
            if by_id[item_id]["codes_sha256"] != codes_sha256(ref.codes):
                print(f"parity FAILED: item {item_id} codes differ from "
                      "the sequential run")
                return 1
            if by_id[item_id]["counts"] != {k: int(v) for k, v
                                            in ref.counts.items()}:
                print(f"parity FAILED: item {item_id} counts "
                      f"{by_id[item_id]['counts']} != sequential "
                      f"{ref.counts}")
                return 1
            for k, v in ref.counts.items():
                ref_totals[k] = ref_totals.get(k, 0) + int(v)
        if result["totals"] != ref_totals:
            print(f"parity FAILED: merged totals {result['totals']} != "
                  f"sequential {ref_totals}")
            return 1

    print(f"fleet drained 2 campaigns over 2 workers with {victim_id} "
          f"SIGKILL'd mid-campaign and resumed by a replacement; merged "
          f"counts bit-identical to the sequential run; cache hits="
          f"{hits}; live /metrics served fleet rates")
    print("Success!")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
