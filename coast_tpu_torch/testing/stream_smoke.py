"""Interrupt-and-resume STREAMING smoke driver (unittest/cfg/fast.yml row).

The counterpart of ``coast_tpu/testing/stream_smoke.py``: a journaled
campaign with a streaming log writer, killed after k collected batches
and relaunched, produces a final log whose rows are bit-for-bit the
uninterrupted streamed run's, which are in turn the one-shot
``write_ndjson`` rows (the summary header carries wall-clock seconds, so
its counts are compared).  Prints ``Success!``.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
from typing import List, Optional

from coast_tpu_torch.testing import Kill, device_arg, kill_after


def _read_lines(path: str) -> List[bytes]:
    with open(path, "rb") as f:
        return f.read().splitlines()


def main(argv: Optional[List[str]] = None) -> int:
    device = device_arg(argv, "streaming resume smoke")
    from coast_tpu_torch import TMR
    from coast_tpu_torch.inject import logs
    from coast_tpu_torch.inject.campaign import CampaignRunner
    from coast_tpu_torch.models import mm

    # Every writer stamps rows with its own wall-clock timestamp; pin it
    # so the comparison sees serialization differences, not clock ones.
    saved = logs._timestamp
    logs._timestamp = lambda: "2026-01-01 00:00:00.000000"
    try:
        return _run(device, logs, TMR, CampaignRunner, mm)
    finally:
        logs._timestamp = saved


def _run(device, logs, TMR, CampaignRunner, mm) -> int:
    runner = CampaignRunner(TMR(mm.make_region(), device=device),
                            strategy_name="TMR")
    with tempfile.TemporaryDirectory() as d:
        base = runner.run(120, seed=17, batch_size=40)
        logs.write_ndjson(base, runner.mmap, os.path.join(d, "oneshot.json"))
        w = logs.StreamLogWriter(os.path.join(d, "stream.json"),
                                 runner.mmap, fmt="ndjson")
        full = runner.run(120, seed=17, batch_size=40, stream=w)
        w.finish(full)

        jpath = os.path.join(d, "smoke.journal")
        beats = {"n": 0}
        w2 = logs.StreamLogWriter(os.path.join(d, "resumed.json"),
                                  runner.mmap, fmt="ndjson")
        try:
            runner.run(120, seed=17, batch_size=40, journal=jpath,
                       progress=kill_after(beats), stream=w2)
            print("campaign was not interrupted; smoke setup broken")
            return 1
        except Kill:
            w2.abort()            # the kill also takes the temp stream
        w3 = logs.StreamLogWriter(os.path.join(d, "resumed.json"),
                                  runner.mmap, fmt="ndjson")
        resumed = runner.run(120, seed=17, batch_size=40, journal=jpath,
                             stream=w3)
        w3.finish(resumed)

        files = {name: _read_lines(os.path.join(d, f"{name}.json"))
                 for name in ("oneshot", "stream", "resumed")}
        rows = {name: lines[1:] for name, lines in files.items()}
        if not (rows["oneshot"] == rows["stream"] == rows["resumed"]):
            print("stream parity FAILED: rows differ between one-shot, "
                  "streamed, and resumed-streamed logs")
            return 1
        counts = {name: json.loads(lines[0])["summary"]["sdc"]
                  for name, lines in files.items()}
        if len(set(counts.values())) != 1:
            print(f"stream parity FAILED: summary sdc counts differ "
                  f"({counts})")
            return 1
        if "overlap" not in full.stages:
            print("stream accounting FAILED: no overlap fraction recorded")
            return 1

    print(f"interrupted after {beats['n']} batches; resumed streamed log "
          f"== uninterrupted streamed log == one-shot log "
          f"({len(rows['oneshot'])} rows); overlap="
          f"{full.stages['overlap']:.2f}")
    print("Success!")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
