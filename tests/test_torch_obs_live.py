"""The port's live metrics (``coast_tpu_torch/obs/metrics.py``,
``obs/serve.py``) against the reference's.

Both hubs take the same feed under a fixed clock, as the reference's own
tests fix it: their snapshots and Prometheus texts are equal outside the
wall-clock stamp.  A campaign feeds the port's hub as the reference's
runner feeds its own; the stdlib server answers on the loopback; the
supervisor's ``--status-json`` and ``--metrics-port`` work.  Everything
runs on the CPU.
"""

import json
import urllib.error
import urllib.request

import pytest
import torch

from coast_tpu_torch import TMR, obs
from coast_tpu_torch.inject.campaign import CampaignRunner
from coast_tpu_torch.models import mm

torch.set_num_threads(1)

VOLATILE = ("updated_unix_s", "device_memory_watermark_bytes")


def _ref():
    from coast_tpu import obs as jobs
    return jobs


def feed(o):
    """One campaign's feed, replayed batch included, with the clock
    fixed."""
    t = {"now": 100.0}
    hub = o.CampaignMetrics(ring_capacity=4, clock=lambda: t["now"])
    hub.campaign_started("matrixMultiply", "TMR", 1000, 1000)
    counts = {"success": 0, "corrected": 0, "sdc": 0}
    for i, (step, sdc) in enumerate(((200, 3), (200, 5), (300, 2),
                                     (300, 4))):
        t["now"] += 0.5
        counts = {"success": counts["success"] + 10,
                  "corrected": counts["corrected"] + step - 10 - sdc,
                  "sdc": counts["sdc"] + sdc}
        done = sum(counts.values())
        hub.record_batch(done, step, dict(counts),
                         {"dispatch": 0.1 * (i + 1), "collect": 0.01},
                         {"retry_transient": i // 2},
                         replayed=(i == 0),
                         transfer={"up": 800 * (i + 1),
                                   "down": 640 * (i + 1)},
                         profile={"device_s": 0.004, "gap_s": 0.0005})
    t["now"] += 0.5
    hub.campaign_finished({"stages": {"dispatch": 0.4, "collect": 0.04}})
    return hub


def steady(doc):
    return {k: v for k, v in doc.items() if k not in VOLATILE}


def test_snapshot_equals_the_reference_under_a_fixed_clock():
    got, want = feed(obs), feed(_ref())
    a, b = steady(got.snapshot()), steady(want.snapshot())
    assert a == b
    assert a["state"] == "finished" and a["done_rows"] == 1000
    assert len(a["series"]["done_rows"]) == 4          # ring bound


def test_prometheus_text_equals_the_reference():
    got, want = feed(obs).prometheus(), feed(_ref()).prometheus()
    drop = "coast_campaign_device_memory"
    assert [ln for ln in got.splitlines() if drop not in ln] \
        == [ln for ln in want.splitlines() if drop not in ln]
    assert 'coast_campaign_rows_done{benchmark="matrixMultiply",' \
        'strategy="TMR"} 1000' in got


def test_histogram_and_ring_equal_the_reference():
    jobs = _ref()
    for o in (obs, jobs):
        h = o.Histogram()
        for v in (0.0001, 0.003, 0.02, 7.0):
            h.observe(v)
        r = o.Ring(2)
        for i in range(5):
            r.append(float(i), float(i * i))
        o._got = (h.snapshot(), r.points())
    assert obs._got == jobs._got
    del obs._got, jobs._got


def test_atomic_write_json(tmp_path):
    path = str(tmp_path / "s.json")
    obs.atomic_write_json(path, {"b": 1, "a": [2]})
    assert json.loads(open(path).read()) == {"a": [2], "b": 1}
    assert [p.name for p in tmp_path.iterdir()] == ["s.json"]


def test_failure_state_and_slo_refusal():
    hub = obs.CampaignMetrics()
    hub.campaign_started("mm", "TMR", 10, 10)
    hub.campaign_finished(error="Boom: x")
    snap = hub.snapshot()
    assert snap["state"] == "failed" and "Boom" in snap["error"]
    # Item 19a landed: a malformed spec is refused as the reference
    # refuses it, and a well-formed one evaluates on every batch.
    from coast_tpu.obs import CampaignMetrics as JMetrics
    for cls in (obs.CampaignMetrics, JMetrics):
        with pytest.raises(ValueError, match="bad SLO objective"):
            cls(slo="sdc<0.1")
    hub = obs.CampaignMetrics(slo="sdc_rate<=0.1",
                              slo_baseline={"sdc_rate": 0.1})
    assert hub.slo_baseline == {"sdc_rate": 0.1}
    assert hub.slo_status() is None


def test_runner_feeds_the_hub_as_the_reference_does():
    from coast_tpu import TMR as JTMR
    from coast_tpu import obs as jobs
    from coast_tpu.inject.campaign import CampaignRunner as JRunner
    from coast_tpu.models import mm as jmm
    jhub, hub = jobs.CampaignMetrics(), obs.CampaignMetrics()
    want = JRunner(JTMR(jmm.make_region()), strategy_name="TMR",
                   metrics=jhub).run(300, seed=3, batch_size=64)
    got = CampaignRunner(TMR(mm.make_region(), device="cpu"),
                         strategy_name="TMR", metrics=hub).run(
        300, seed=3, batch_size=64)
    assert got.counts == want.counts
    a, b = hub.snapshot(), jhub.snapshot()
    for key in ("state", "benchmark", "strategy", "total_rows",
                "done_rows", "effective_done", "batches", "counts",
                "rates", "resilience"):
        assert a[key] == b[key], key
    assert sorted(a) == sorted(b)
    assert sorted(a["stages"]) == sorted(b["stages"])


def test_failed_campaign_marks_the_hub():
    hub = obs.CampaignMetrics()
    runner = CampaignRunner(TMR(mm.make_region(), device="cpu"),
                            metrics=hub)

    class Boom(Exception):
        pass

    def die(done, counts):
        raise Boom

    with pytest.raises(Boom):
        runner.run(128, seed=1, batch_size=64, progress=die)
    assert hub.snapshot()["state"] == "failed"


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, resp.read().decode()


def test_server_on_the_loopback():
    hub = feed(obs)
    server = obs.MetricsServer(hub, port=0)
    port = server.start()
    try:
        code, text = _get(f"http://127.0.0.1:{port}/metrics")
        assert code == 200 and text == hub.prometheus()
        code, body = _get(f"http://127.0.0.1:{port}/status")
        assert code == 200 and json.loads(body)["done_rows"] == 1000
        assert _get(f"http://127.0.0.1:{port}/")[0] == 200
        with pytest.raises(urllib.error.HTTPError):
            _get(f"http://127.0.0.1:{port}/nothing")
    finally:
        server.stop()


def test_server_live_during_a_campaign():
    hub = obs.CampaignMetrics()
    server = obs.MetricsServer(hub, port=0)
    port = server.start()
    seen = []

    def probe(done, counts):
        doc = json.loads(_get(f"http://127.0.0.1:{port}/status")[1])
        seen.append(doc["state"] == "running" and doc["done_rows"] == done)

    try:
        CampaignRunner(TMR(mm.make_region(), device="cpu"),
                       metrics=hub).run(256, seed=2, batch_size=64,
                                        progress=probe)
    finally:
        server.stop()
    assert seen == [True] * 4


def test_supervisor_status_json_and_metrics_port(tmp_path, capsys):
    from coast_tpu_torch.inject import supervisor
    status = tmp_path / "status.json"
    argv = ["-f", "matrixMultiply", "-O", "-TMR", "-t", "300",
            "--batch-size", "100", "-d", "cpu", "-q", "--status-json",
            str(status), "--metrics-port", "0"]
    assert supervisor.main(argv) == 0
    doc = json.loads(status.read_text())
    assert doc["state"] == "finished" and doc["done_rows"] == 300
    assert doc["benchmark"] == "matrixMultiply" and doc["strategy"] == "TMR"
    assert "# metrics: http://127.0.0.1:" in capsys.readouterr().err


def test_supervisor_status_json_chunked(tmp_path):
    # -e runs several campaigns: the hub is fed across chunks.
    from coast_tpu_torch.inject import supervisor
    status = tmp_path / "status.json"
    assert supervisor.main(["-f", "matrixMultiply", "-O", "-TMR", "-e", "3",
                            "--batch-size", "500", "-d", "cpu", "-q",
                            "--status-json", str(status)]) == 0
    doc = json.loads(status.read_text())
    assert doc["state"] == "finished" and doc["done_rows"] >= 1000
