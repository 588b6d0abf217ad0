"""Reliability-SLO + flight-recorder smoke driver (fast.yml row).

The counterpart of ``coast_tpu/testing/slo_smoke.py``, with its oracles,
on the card (or the host with ``-d cpu``):

  * a live campaign with an attached SLO set lands verdicts in
    ``CampaignResult.slo`` / ``summary()["slo"]``, the hub snapshot,
    and the heartbeat/console status line;
  * the SLO engine's Wilson math is the one in ``obs/convergence``
    (same interval, same z) -- no second implementation to drift;
  * ``python -m coast_tpu_torch slo check`` reproduces the live verdicts
    from the RECORDED run artifact and exits 1 on a seeded budget
    burn, 0 on an attained spec (a CI gate's shape);
  * the flight recorder dumps a parseable forensic bundle on watchdog
    wedge (``CampaignWedgedError``) and on SIGUSR1, with all-thread
    stacks and the event ring; the disabled path records nothing and
    costs one attribute test;
  * ``json_parser`` renders the recorded ``slo`` block alongside
    convergence.

Prints ``Success!`` for the harness driver oracle
(``coast_tpu_torch.testing.harness.run_drivers``).
"""

from __future__ import annotations

import json
import os
import signal
import tempfile
from typing import List, Optional

from coast_tpu_torch.testing import device_arg


def _check_live_slo(tmp: str, device: str) -> dict:
    """Live campaign with an SLO set: verdicts on every surface."""
    from coast_tpu_torch import TMR
    from coast_tpu_torch.inject.campaign import CampaignRunner
    from coast_tpu_torch.models import mm
    from coast_tpu_torch.obs.slo import status_line

    region = mm.make_region()
    # Generous ceiling: the toy TMR campaign's SDC rate is far below
    # 90%, so the budget must read as attained/ok.
    runner = CampaignRunner(TMR(region, device=device),
                            strategy_name="TMR",
                            slo="sdc_rate<=0.9;min=8")
    res = runner.run(240, seed=17, batch_size=48)
    assert res.slo is not None, "no slo block on the result"
    assert res.slo["verdict"] == "ok", res.slo
    row = res.slo["objectives"]["sdc_rate"]
    assert row["attained"] is True, row
    assert res.summary()["slo"]["verdict"] == "ok"

    # The hub carries the same report, and the live status fragment
    # reads ok.
    report = runner.metrics.slo_status()
    assert report is not None and report["verdict"] == "ok"
    assert status_line(report) == "slo ok"
    snap = runner.metrics.snapshot()
    assert snap["slo"]["verdict"] == "ok", snap.get("slo")

    # Wilson consistency: the engine's interval IS obs/convergence's.
    from coast_tpu_torch.obs.convergence import wilson_interval
    live_row = next(r for r in report["objectives"]
                    if r["objective"] == "sdc_rate")
    lo, hi = wilson_interval(live_row["bad"], live_row["effective_n"],
                             1.96)
    assert abs(live_row["wilson"]["lo"] - lo) < 1e-12
    assert abs(live_row["wilson"]["hi"] - hi) < 1e-12

    # Heartbeat + console each carry one SLO status line.
    from coast_tpu_torch.obs.console import Console
    from coast_tpu_torch.obs.heartbeat import Heartbeat
    beats: List[str] = []
    hb = Heartbeat(240, interval_s=0.0, metrics=runner.metrics,
                   emit=beats.append)
    hb.update(240, res.counts)
    assert beats and "slo ok" in beats[0], beats
    panels: List[str] = []
    con = Console(240, interval_s=0.0, metrics=runner.metrics,
                  emit=panels.append)
    con.final(240, res.counts)
    assert "slo ok" in panels[-1], panels[-1]

    # Record the run artifact the CLI gate will replay.
    artifact = os.path.join(tmp, "run.json")
    with open(artifact, "w") as fh:
        # The campaign-log doc shape (summary head + runs) so both the
        # slo CLI and json_parser accept the same recorded artifact.
        json.dump({"summary": res.summary(), "runs": []}, fh)
    print(f"# live slo: {status_line(report)} "
          f"(observed sdc_rate {live_row['observed']:.4g})")
    return {"artifact": artifact, "counts": dict(res.counts),
            "n": res.n}


def _check_slo_gate(tmp: str, live: dict) -> None:
    """``python -m coast_tpu_torch slo`` reproduces the pinned verdicts from
    the recorded artifact: generous spec passes, seeded burn exits 1."""
    from coast_tpu_torch.__main__ import main as coast_main
    from coast_tpu_torch.inject.classify import SDC_CLASSES

    artifact = live["artifact"]
    out = os.path.join(tmp, "slo_report.json")
    rc = coast_main(["slo", "check", "--spec", "sdc_rate<=0.9;min=8",
                     "--input", artifact, "--out", out])
    assert rc == 0, f"attained spec gated: rc={rc}"
    with open(out) as fh:
        doc = json.load(fh)
    assert doc["format"] == "coast-slo" and doc["verdict"] == "ok", doc

    # The recorded evidence must re-derive the live counts exactly.
    row = next(r for r in doc["objectives"]
               if r["objective"] == "sdc_rate")
    bad = sum(live["counts"].get(k, 0) for k in SDC_CLASSES)
    assert row["bad"] == bad and row["effective_n"] == live["n"], \
        (row, bad, live["n"])

    # Seeded budget burn: a ceiling below the observed rate must page
    # the gate (nonzero exit) -- unless the campaign truly saw zero
    # SDCs, in which case availability against an impossible floor
    # burns instead.
    burn_spec = ("sdc_rate<=0.000001;min=8" if bad
                 else "availability>=0.999999;z=0.1;min=8")
    if not bad:
        # With zero SDCs the sdc ceiling cannot burn; force a DUE-based
        # burn only if the campaign saw DUEs.  The mm-TMR seed 17
        # campaign reliably produces SDC+DUE outcomes, so reaching here
        # means the seed's distribution changed -- fail loudly.
        raise AssertionError(
            f"seed 17 campaign produced no SDCs: {live['counts']}")
    rc = coast_main(["slo", "check", "--spec", burn_spec,
                     "--input", artifact])
    assert rc == 1, f"burning budget passed the gate: rc={rc}"
    print(f"# slo gate: attained rc=0, seeded burn rc=1 ({bad} sdc)")


def _check_json_parser(live: dict) -> None:
    """The recorded slo block renders alongside convergence."""
    from coast_tpu_torch.analysis.json_parser import summarize_path
    summary = summarize_path(live["artifact"])
    assert summary.slo is not None and summary.slo["verdict"] == "ok"
    text = summary.format()
    assert "--- slo ---" in text and "sdc_rate" in text, text


def _check_flightrec(tmp: str) -> None:
    """Forensic bundles: watchdog wedge, SIGUSR1, disabled path."""
    from coast_tpu_torch.inject.resilience import (CampaignWedgedError,
                                             watchdog_collect)
    from coast_tpu_torch.obs import flightrec

    dump_dir = os.path.join(tmp, "flightrec")
    with flightrec.activate(dump_dir=dump_dir, source="slo_smoke") as rec:
        rec.record("dispatch", lo=0, n=48)
        rec.record("retry", lo=0, attempt=1, kind="transient")

        # Watchdog wedge: the hung collect dumps a bundle BEFORE the
        # CampaignWedgedError propagates, stacks included.
        import threading
        hang = threading.Event()
        try:
            try:
                watchdog_collect(lambda: hang.wait(30.0), timeout=0.2)
                raise AssertionError("watchdog did not fire")
            except CampaignWedgedError:
                pass
        finally:
            hang.set()
        assert rec.dumps, "watchdog wedge wrote no bundle"
        doc = flightrec.read_bundle(rec.dumps[-1])
        assert doc["reason"] == "watchdog_wedge", doc["reason"]
        assert doc["extra"]["timeout_s"] == 0.2, doc["extra"]
        events = {e["event"] for e in doc["events"]}
        assert {"dispatch", "retry", "watchdog_fired"} <= events, events
        assert "coast-collect-watchdog" in doc["stacks"], \
            "hung collect thread missing from the stack dump"

        # SIGUSR1: the bench parent's "give me your blackbox" channel.
        n_before = len(rec.dumps)
        assert rec.install_signal_handler()
        os.kill(os.getpid(), signal.SIGUSR1)
        signal.signal(signal.SIGUSR1, signal.SIG_DFL)
        assert len(rec.dumps) == n_before + 1, "SIGUSR1 wrote no bundle"
        doc = flightrec.read_bundle(rec.dumps[-1])
        assert doc["reason"].startswith("signal:"), doc["reason"]
        assert flightrec.newest_bundle(dump_dir) == rec.dumps[-1]

    # Disabled path: nothing installed -> the NULL recorder absorbs
    # both records and dumps without touching the filesystem.
    assert flightrec.current() is flightrec.NULL
    flightrec.record("orphan_event", x=1)
    assert flightrec.current().dump("nothing") is None
    assert not flightrec.NULL.events and not flightrec.NULL.dumps
    print(f"# flightrec: watchdog + SIGUSR1 bundles parse "
          f"({len(doc['events'])} ring events)")


def main(argv: Optional[List[str]] = None) -> int:
    device = device_arg(argv, "reliability-SLO smoke")
    with tempfile.TemporaryDirectory() as tmp:
        live = _check_live_slo(tmp, device)
        _check_slo_gate(tmp, live)
        _check_json_parser(live)
        _check_flightrec(tmp)
    print("Success!")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main(sys.argv[1:]))
