"""The port's reliability SLOs (``coast_tpu_torch/obs/slo.py``,
``obs/slo_cli.py``) against the reference's.

The spec grammar and its round trip, the refusals, attainment, budgets,
burn rates and verdicts are held equal to ``coast_tpu.obs.slo`` on the
same evidence (fixed counts and histograms: the port's dispatch histogram
is a busy window, so live latency values are not compared).  A seeded mm
campaign with an SLO set gives the reference runner's ``summary()["slo"]``,
the hub, heartbeat and console carry the same verdict line, the CLI gates
the same way on the same artifact, and a log carrying the block is
rendered the same by both parsers.
"""

import json

import pytest
import torch

from coast_tpu_torch import TMR
from coast_tpu_torch import obs
from coast_tpu_torch.inject.campaign import CampaignRunner
from coast_tpu_torch.models import mm
from coast_tpu_torch.obs import slo

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jslo():
    from coast_tpu.obs import slo as ref
    return ref


def _ev(counts, **kw):
    ev = {"counts": dict(counts), "inj_per_sec": None, "histograms": {},
          "sdc_rate_recent": []}
    ev.update(kw)
    return ev


def _hist(counts, le=(0.001, 0.01, 0.1, 1.0)):
    cum, run = [], 0
    for c in counts:
        run += c
        cum.append(run)
    return {"le": list(le), "counts": cum, "count": run, "sum": 0.5}


SPECS = ["sdc_rate<=0.002",
         "sdc_rate<=0.01,availability>=0.99;z=2.576;min=4096;page=14",
         "mwtf>=10;min=256", "p99_dispatch<=0.5,p95_gap<=0.1",
         "sdc_rate<=0.05,availability>=0.9,mwtf>=2,p99_dispatch<=0.01"]


@pytest.mark.parametrize("text", SPECS)
def test_grammar_and_round_trip_equal_the_reference(text, jslo):
    got, want = slo.SLOSet.parse(text), jslo.SLOSet.parse(text)
    assert got.spec() == want.spec()
    assert slo.SLOSet.parse(got.spec()).spec() == got.spec()
    assert [(o.objective, o.op, o.target, o.z, o.min_n, o.page_burn,
             o.kind()) for o in got.objectives] == \
        [(o.objective, o.op, o.target, o.z, o.min_n, o.page_burn,
          o.kind()) for o in want.objectives]


@pytest.mark.parametrize("bad", [
    "", "sdc_rate<0.01", "sdc_rate>=0.01", "availability<=0.9",
    "sdc_rate<=1.5", "sdc_rate<=0", "mwtf>=-1", "nonsense<=0.5",
    "sdc_rate<=0.01;page=0.5", "sdc_rate<=0.01;frob=3",
    "sdc_rate<=0.01,sdc_rate<=0.02", "p0_dispatch<=1",
    "sdc_rate<=0.01;z=abc"])
def test_refusals_equal_the_reference(bad, jslo):
    with pytest.raises(slo.SLOError) as got:
        slo.SLOSet.parse(bad)
    with pytest.raises(jslo.SLOError) as want:
        jslo.SLOSet.parse(bad)
    assert str(got.value) == str(want.value)


# (spec, evidence, baseline): every verdict path of the engine.
CASES = [
    ("sdc_rate<=0.05", _ev({"success": 980, "sdc": 20}), None),
    ("sdc_rate<=0.05", _ev({"success": 800, "sdc": 200}), None),
    ("sdc_rate<=0.05", _ev({"success": 47, "sdc": 3}), None),
    ("sdc_rate<=0.05;min=4096", _ev({"success": 800, "sdc": 200}), None),
    ("sdc_rate<=0.05", _ev({}), None),
    ("availability>=0.9", _ev({"success": 900, "due_abort": 60,
                               "due_timeout": 40, "sdc": 3}), None),
    ("mwtf>=5", _ev({"success": 990, "sdc": 10}, inj_per_sec=500.0),
     {"sdc_rate": 0.2, "inj_per_sec": 1000.0}),
    ("mwtf>=5", _ev({"success": 990, "sdc": 10}), None),
    ("mwtf>=5;min=16", _ev({"success": 1000}, inj_per_sec=100.0),
     {"sdc_rate": 0.1, "inj_per_sec": 100.0}),
    ("p99_dispatch<=0.1", _ev({"success": 10}, histograms={
        "dispatch_device_seconds": _hist([90, 9, 1, 0])}), None),
    ("p50_dispatch<=0.001,p95_gap<=0.01", _ev({"success": 10}, histograms={
        "dispatch_device_seconds": _hist([10, 50, 40, 0]),
        "dispatch_host_gap_seconds": _hist([100, 0, 0, 0])}), None),
    ("p99_dispatch<=0.1", _ev({"success": 10}), None),
    ("sdc_rate<=0.01", _ev({"success": 900, "sdc": 100},
                           sdc_rate_recent=[0.0] * 40), None),
    ("sdc_rate<=0.01", _ev({"success": 900, "sdc": 100},
                           sdc_rate_recent=[0.1] * 40), None),
    ("sdc_rate<=0.1;page=3", _ev({"success": 780, "sdc": 220},
                                 sdc_rate_recent=[0.2] * 8), None),
]


@pytest.mark.parametrize("spec,ev,base", CASES,
                         ids=[f"{i}:{c[0]}" for i, c in enumerate(CASES)])
def test_evaluation_equals_the_reference(spec, ev, base, jslo):
    got = slo.evaluate(slo.SLOSet.parse(spec), ev, baseline=base)
    want = jslo.evaluate(jslo.SLOSet.parse(spec), ev, baseline=base)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert slo.summary_block(got) == jslo.summary_block(want)
    assert slo.status_line(got) == jslo.status_line(want)
    assert slo.worst_verdict(r["verdict"] for r in got["objectives"]) \
        == got["verdict"]


def test_evidence_extractors_equal_the_reference(tmp_path, jslo):
    status = {"format": "coast-status", "counts": {"success": 90, "sdc": 10},
              "elapsed_s": 2.0, "done_rows": 100,
              "profile": {"histograms": {
                  "dispatch_device_seconds": _hist([1, 2, 3, 4])}},
              "series": {"sdc_rate": [[0.1, 0.05], [0.2, 0.1]]}}
    flat = {"injections": 100, "seconds": 4.0, "success": 90, "sdc": 7,
            "due_abort": 3, "profile": {
                "device_seconds_histogram": _hist([5, 0, 0, 0]),
                "host_gap_seconds_histogram": _hist([0, 5, 0, 0])}}
    nested = {"counts": {"success": 8, "corrected": 2}, "n": 10,
              "seconds": 1.0}
    assert slo.evidence_from_status(status) \
        == jslo.evidence_from_status(status)
    for doc in (flat, nested):
        assert slo.evidence_from_summary(doc) \
            == jslo.evidence_from_summary(doc)
    files = {"status.json": json.dumps(status),
             "run.json": json.dumps({"summary": flat, "runs": []}),
             "bare.json": json.dumps(nested),
             "log.ndjson": json.dumps({"format": "coast-ndjson",
                                       "summary": flat}) + "\n{}\n"}
    for name, text in files.items():
        path = tmp_path / name
        path.write_text(text)
        assert slo.load_evidence(str(path)) == jslo.load_evidence(str(path))
        assert slo.baseline_from(str(path)) == jslo.baseline_from(str(path))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"hello": 1}))
    with pytest.raises(slo.SLOError, match="no SLO evidence"):
        slo.load_evidence(str(bad))


@pytest.fixture(scope="module")
def campaigns():
    """The same seeded mm TMR campaign with an SLO set, in both packages."""
    from coast_tpu import TMR as JTMR
    from coast_tpu.inject.campaign import CampaignRunner as JRunner
    from coast_tpu.models import mm as jmm
    spec = "sdc_rate<=0.2,availability>=0.5;min=64"
    got = CampaignRunner(TMR(mm.make_region(), device="cpu"),
                         strategy_name="TMR", slo=spec)
    want = JRunner(JTMR(jmm.make_region()), strategy_name="TMR", slo=spec)
    return (got, got.run(480, seed=17, batch_size=96),
            want, want.run(480, seed=17, batch_size=96))


def test_summary_slo_equals_the_reference_runner(campaigns):
    got_runner, got, want_runner, want = campaigns
    assert got.counts == want.counts
    assert got.summary()["slo"] == want.summary()["slo"]
    assert got.slo["verdict"] == "ok"
    # The hub's snapshot and its Prometheus text carry the same report.
    assert got_runner.metrics.snapshot()["slo"] \
        == want_runner.metrics.snapshot()["slo"]
    prom = got_runner.metrics.prometheus()
    assert 'coast_campaign_slo_verdict{benchmark="matrixMultiply",' \
        'strategy="TMR",objective="sdc_rate"} 0' in prom


def test_heartbeat_and_console_lines_equal_the_reference(campaigns):
    from coast_tpu.obs import Console as JConsole, Heartbeat as JHeartbeat
    got_runner, got, want_runner, want = campaigns
    lines = {}
    for key, hb_cls, con_cls, runner in (
            ("port", obs.Heartbeat, obs.Console, got_runner),
            ("ref", JHeartbeat, JConsole, want_runner)):
        beats, panels = [], []
        clock = iter(float(x) for x in range(100)).__next__
        hb_cls(480, interval_s=0.0, metrics=runner.metrics,
               emit=beats.append, clock=clock).update(480, got.counts)
        con_cls(480, interval_s=0.0, metrics=runner.metrics,
                emit=panels.append, clock=clock).final(480, got.counts)
        lines[key] = (beats[-1].split(" slo ")[-1],
                      [ln for ln in panels[-1].splitlines()
                       if ln.lstrip().startswith("slo")])
    assert lines["port"] == lines["ref"]
    assert lines["port"][0] == "ok" and lines["port"][1] == ["  slo ok"]


@pytest.mark.parametrize("spec,rc", [("sdc_rate<=0.9;min=8", 0),
                                     ("sdc_rate<=0.000001;min=8", 1),
                                     ("sdc<0.1", 2)])
def test_cli_gates_as_the_reference(campaigns, tmp_path, spec, rc, capsys):
    from coast_tpu.__main__ import main as jmain
    from coast_tpu_torch.__main__ import main
    _, got, _, _ = campaigns
    art = tmp_path / "run.json"
    art.write_text(json.dumps({"summary": got.summary(), "runs": []}))
    outs = {}
    for key, fn in (("port", main), ("ref", jmain)):
        out = tmp_path / f"{key}.json"
        assert fn(["slo", "check", "--spec", spec, "--input", str(art),
                   "--out", str(out)]) == rc
        outs[key] = capsys.readouterr()
        if rc != 2:
            doc = json.loads(out.read_text())
            doc.pop("input")
            outs[key] = (outs[key].out.replace(str(out), "OUT"), doc)
    if rc == 2:
        assert outs["port"].err == outs["ref"].err
    else:
        assert outs["port"] == outs["ref"]


def test_log_with_the_block_parses_the_same(campaigns, tmp_path, capsys):
    from coast_tpu.analysis.json_parser import main as jparse
    from coast_tpu_torch.analysis.json_parser import main as parse
    _, got, _, _ = campaigns
    log = tmp_path / "run.json"
    log.write_text(json.dumps({"summary": got.summary(), "runs": []}))
    assert parse([str(log)]) == 0
    port = capsys.readouterr().out
    assert jparse([str(log)]) == 0
    ref = capsys.readouterr().out
    assert port == ref and "--- slo ---" in port


def test_supervisor_slo_flag_lands_the_block(capsys):
    from coast_tpu_torch.inject import supervisor
    assert supervisor.main(["-f", "matrixMultiply", "-O", "-TMR", "-t",
                            "200", "--batch-size", "100", "-d", "cpu",
                            "-q", "--slo", "sdc_rate<=0.5;min=8"]) == 0
    out = capsys.readouterr().out
    assert "'slo': {'spec': 'sdc_rate<=0.5;min=8', 'verdict': 'ok'" in out
