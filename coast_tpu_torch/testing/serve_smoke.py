"""Continuous-protection serving smoke driver (fast.yml row).

The counterpart of ``coast_tpu/testing/serve_smoke.py``, with its
oracles, on the card (or the host with ``-d cpu``):

  * the lane-isolation prover gates construction: both strategy
    programs HOLD, and a seeded voter bypass makes ``ServeEngine``
    refuse to serve (``IsolationRefusedError``) instead of running an
    unproved program under live traffic;
  * a request burst over the live engine is served within SLA while
    injection lanes run in the same compiled dispatches, the runtime
    lane-leak assert stays at zero violations, and the ``serving``
    block carries a live Wilson-CI'd SDC rate next to the campaign
    hub's SLO verdicts;
  * the differential contract: the same request stream serialises
    byte-identically with the injection lanes on and off -- the
    measurement arm must not perturb responses;
  * the HTTP front answers ``POST /v1/infer`` deterministically and
    exports ``/status`` (``coast-serve-status``) + ``/metrics``
    (``coast_serve_*`` rows);
  * ``json_parser`` renders the recorded ``serving`` block from the
    run artifact.

Prints ``Success!`` for the harness driver oracle
(``coast_tpu_torch.testing.harness.run_drivers``).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import List, Optional

from coast_tpu_torch.testing import device_arg

_BENCH = "matrixMultiply"
_BATCH = 16
_INJECT_N = 64


def _serve_burst(engine, n_requests: int) -> List[dict]:
    """Submit a burst, wait each request out, return the responses."""
    reqs = [engine.submit(f"req-{i:03d}", sla_s=30.0)
            for i in range(n_requests)]
    responses = []
    for req in reqs:
        assert req.done.wait(60.0), f"request {req.rid} never completed"
        assert req.response is not None, (req.rid, req.error)
        responses.append(req.response)
    return responses


def _check_live_engine(tmp: str, device: str) -> dict:
    """Prover-gated engine serves a burst while self-measuring."""
    from coast_tpu_torch.serve import ServeEngine, ServeMetrics

    metrics = ServeMetrics(slo="sdc_rate<=0.9;min=8")
    with ServeEngine(_BENCH, batch_size=_BATCH, inject_share=0.5,
                     seed=11, inject_n=_INJECT_N, metrics=metrics,
                     journal_dir=tmp, device=device) as engine:
        for lane in engine._lanes.values():
            assert lane.proof.holds and not lane.proof.vacuous, \
                lane.proof.summary()
        responses = _serve_burst(engine, 12)
        assert engine.drain_injection(timeout_s=120.0), \
            f"standing injection never drained: {engine.error}"
        doc = engine.summary()
    assert all(r["class"] == "success" for r in responses), responses
    srv = doc["serving"]
    assert srv["requests"]["served"] == 12, srv["requests"]
    assert srv["lane_leak"]["violations"] == 0, srv["lane_leak"]
    assert srv["lane_leak"]["checks"] > 0, "lane-leak assert never ran"
    inj = srv["inject"]
    # Both standing campaigns fully injected; the CI is live Wilson.
    assert inj["lanes_done"] == 2 * _INJECT_N, inj
    ci = inj["sdc_ci"]
    assert 0.0 <= ci["lo"] <= inj["sdc_rate"] <= ci["hi"] <= 1.0, inj
    assert doc["slo"]["verdict"] == "ok", doc.get("slo")
    # Wilson consistency: the serving CI is obs/convergence's interval.
    from coast_tpu_torch.obs.convergence import wilson_interval
    lo, hi = wilson_interval(inj["sdc"], inj["lanes_done"], 1.96)
    assert abs(ci["lo"] - round(lo, 8)) < 1e-9, (ci, lo)
    assert abs(ci["hi"] - round(hi, 8)) < 1e-9, (ci, hi)
    print(f"# live serve: 12 served, {inj['lanes_done']} injection "
          f"lanes, sdc {inj['sdc_rate']:.4g} "
          f"[{ci['lo']:.4g}, {ci['hi']:.4g}], slo "
          f"{doc['slo']['verdict']}")
    return doc


def _check_byte_identity(device: str) -> None:
    """Responses byte-identical with injection lanes on and off."""
    from coast_tpu_torch.serve import ServeEngine

    streams = []
    for share in (0.5, 0.0):
        with ServeEngine(_BENCH, batch_size=_BATCH,
                         inject_share=share, seed=11,
                         inject_n=_INJECT_N, device=device) as engine:
            responses = _serve_burst(engine, 10)
        streams.append(json.dumps(responses, sort_keys=True))
    assert streams[0] == streams[1], \
        "injection lanes perturbed the response stream"
    print("# differential: 10-request stream byte-identical, "
          "inject_share 0.5 vs 0.0")


def _check_prover_refusal(device: str) -> None:
    """A seeded voter bypass must refuse to serve, not serve unproved."""
    from coast_tpu_torch.analysis.propagation import seeded_voter_bypass
    from coast_tpu_torch.serve import IsolationRefusedError, ServeEngine

    try:
        with seeded_voter_bypass():
            ServeEngine(_BENCH, batch_size=_BATCH, inject_share=0.0,
                        inject_n=0, strategies=("TMR",), device=device)
        raise AssertionError("bypassed voter served anyway")
    except IsolationRefusedError as e:
        assert "REFUTED" in str(e), str(e)
    print("# prover gate: seeded voter bypass refused at construction")


def _check_http_front(device: str) -> dict:
    """The HTTP plane: infer + status + metrics off one live front."""
    import urllib.request

    from coast_tpu_torch.serve import ServeEngine, ServeFront, ServeMetrics

    metrics = ServeMetrics(slo="sdc_rate<=0.9;min=8")
    engine = ServeEngine(_BENCH, batch_size=_BATCH, inject_share=0.5,
                         seed=11, inject_n=_INJECT_N, metrics=metrics,
                         device=device)
    with ServeFront(engine, port=0) as front:
        body = json.dumps({"payload": "http-req", "sla_s": 30.0})
        req = urllib.request.Request(
            front.url + "/v1/infer", data=body.encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60.0) as resp:
            assert resp.status == 200, resp.status
            answer = json.loads(resp.read())
        assert answer["payload"] == "http-req", answer
        assert answer["class"] == "success", answer
        with urllib.request.urlopen(front.url + "/status",
                                    timeout=10.0) as resp:
            status = json.loads(resp.read())
        assert status["format"] == "coast-serve-status", \
            status.get("format")
        assert status["serving"]["requests"]["served"] >= 1, \
            status["serving"]
        with urllib.request.urlopen(front.url + "/metrics",
                                    timeout=10.0) as resp:
            prom = resp.read().decode()
        for row in ("coast_serve_served_total",
                    "coast_serve_lane_leak_violations_total 0",
                    "coast_serve_request_latency_seconds_count"):
            assert row in prom, f"missing metrics row: {row}"
    print(f"# http front: infer 200 ({answer['strategy']}), status + "
          "metrics export")
    return answer


def _check_json_parser(tmp: str, doc: dict) -> None:
    """The recorded serving block renders in the analysis CLI."""
    from coast_tpu_torch.analysis.json_parser import summarize_path

    artifact = os.path.join(tmp, "serve_run.json")
    with open(artifact, "w") as fh:
        head = {"format": "ndjson", "injections": 0,
                "benchmark": doc["benchmark"], "counts": doc["counts"],
                "serving": doc["serving"], "slo": doc.get("slo")}
        json.dump({"summary": head, "runs": []}, fh)
    summary = summarize_path(artifact)
    assert summary.serving is not None, "serving block dropped"
    text = summary.format()
    assert "--- serving ---" in text and "live sdc" in text, text
    print("# json_parser: serving block renders "
          f"({summary.serving['requests']['served']} served)")


def main(argv: Optional[List[str]] = None) -> int:
    device = device_arg(argv, "continuous-protection serving smoke")
    with tempfile.TemporaryDirectory() as tmp:
        doc = _check_live_engine(tmp, device)
        _check_byte_identity(device)
        _check_prover_refusal(device)
        _check_http_front(device)
        _check_json_parser(tmp, doc)
    print("Success!")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main(sys.argv[1:]))
