"""The port's span recorder, trace export, heartbeat and console
(``coast_tpu_torch/obs``) against the reference's (``coast_tpu/obs``).

The same call sequence goes through both packages: event kinds, names,
depths, arguments, counter values and trace-event phases and tracks are
equal outside timestamps; the heartbeat and the console print the same
lines under a fixed clock.  The campaign runner records the reference's
stage keys, and a supervisor run with ``--trace-out`` writes a trace with
the reference's span names and tracks through both packages.  Everything
runs on the CPU.
"""

import json

import pytest
import torch

from coast_tpu_torch import TMR, obs
from coast_tpu_torch.inject.campaign import CampaignRunner
from coast_tpu_torch.models import mm
from coast_tpu_torch.obs import spans as tspans

torch.set_num_threads(1)


def _ref():
    from coast_tpu import obs as jobs
    return jobs


def drive(o, tel):
    """One call sequence: nested spans, counters, a gauge, instants, an
    explicit span, and the module-level helpers under activate()."""
    with tel.span("outer", n=3):
        with tel.span("inner"):
            tel.count("rows", 5, lo=0)
        tel.count("rows", 2)
        tel.gauge("inj_per_sec", 12.5)
    tel.instant("mark", done=1)
    tel.span_at("replayed", 0.5, 0.75, replayed=True)
    tel.span_at("device:step", 1.0, 1.5, device=True, lo=0, n=4)
    with tel.activate():
        assert o.current() is tel
        with o.span("schedule", n=8):
            o.count("pad_waste_rows", 3)
        o.instant("heartbeat", done=8, total=8)
    assert o.current() is o.NULL
    with tel.span("classify"):
        pass


def shape(events):
    out = []
    for e in events:
        row = {k: v for k, v in e.items() if k not in ("t", "t0", "t1")}
        out.append(row)
    return out


def both():
    jobs = _ref()
    a, b = jobs.Telemetry(enabled=True), obs.Telemetry(enabled=True)
    drive(jobs, a)
    drive(obs, b)
    return a, b


def test_span_events_equal_outside_timestamps():
    a, b = both()
    assert shape(b.events) == shape(a.events)
    assert b.counters == a.counters and b.gauges == a.gauges
    assert sorted(b.stage_totals()) == sorted(a.stage_totals()) \
        == ["classify", "outer", "schedule"]
    assert b.mark() == a.mark() == len(a.events)
    assert b.stage_totals(since=b.mark()) == {}


def test_disabled_recorders_record_nothing(monkeypatch):
    jobs = _ref()
    monkeypatch.setenv("COAST_TELEMETRY", "0")
    a, b = jobs.Telemetry(), obs.Telemetry()
    assert not a.enabled and not b.enabled
    drive(jobs, a)
    drive(obs, b)
    assert a.events == b.events == []
    assert not obs.NULL.enabled
    with obs.NULL.span("x"):
        obs.NULL.count("y")
    assert obs.NULL.events == []
    b.reset()
    assert b.counters == {}


def test_profiler_bracket_is_record_function():
    tel = obs.Telemetry(enabled=True, profiler=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tel.span("bracketed_stage"):
            torch.ones(4).sum()
    assert "bracketed_stage" in {e.key for e in prof.key_averages()}
    assert [e["name"] for e in tel.events] == ["bracketed_stage"]


def trace_shape(events):
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
            for e in events]


def test_trace_events_equal_outside_timestamps():
    jobs = _ref()
    a, b = both()
    want = jobs.to_trace_events(a, process_name="p")
    got = obs.to_trace_events(b, process_name="p")
    assert trace_shape(got) == trace_shape(want)
    assert {e["tid"] for e in got if e.get("cat") == "device"} == {2}
    assert [e["ph"] for e in got] == [e["ph"] for e in want]
    assert all(e["ts"] >= 0 for e in got if "ts" in e)
    doc_a = jobs.to_trace_doc(a, {"benchmark": "mm"})
    doc_b = obs.to_trace_doc(b, {"benchmark": "mm"})
    assert sorted(doc_b) == sorted(doc_a)
    assert sorted(doc_b["otherData"]) == sorted(doc_a["otherData"])


def test_write_trace_round_trips(tmp_path):
    _, b = both()
    path = obs.write_trace(b, str(tmp_path / "t.json"),
                           metadata={"k": 1}, process_name="q")
    doc = json.loads(open(path).read())
    assert doc["otherData"]["k"] == 1 and doc["displayTimeUnit"] == "ms"
    assert doc["traceEvents"][0]["args"]["name"] == "q"


def heartbeat_lines(o, metrics=None):
    lines = []
    t = {"now": 0.0}
    hb = o.Heartbeat(1000, interval_s=2.0, emit=lines.append,
                     metrics=metrics, clock=lambda: t["now"])
    tel = o.Telemetry(enabled=True)
    with tel.activate():
        for done, now in ((100, 0.5), (300, 1.0), (500, 2.5), (900, 3.0)):
            t["now"] = now
            hb.update(done, {"success": done - 10, "sdc": 10,
                             "corrected": 0})
        hb.final(1000, {"success": 985, "sdc": 15})
    return lines, [(e["kind"], e["name"]) for e in tel.events], hb.emitted


class _Transfer:
    def __init__(self):
        self.transfer = {}


def test_heartbeat_lines_equal_the_reference():
    got = heartbeat_lines(obs)
    assert got == heartbeat_lines(_ref())
    lines, events, emitted = got
    assert emitted == 3 and lines[-1].startswith("# heartbeat: 1000/1000")
    assert events.count(("instant", "heartbeat")) == 3
    # A hub's transfer counters add the link rates.
    hub = _Transfer()
    hub.transfer = {"up": 4096, "down": 8192}
    assert heartbeat_lines(obs, hub)[0] == heartbeat_lines(_ref(), hub)[0]
    assert "up=" in heartbeat_lines(obs, hub)[0][0]


def console_lines(o):
    lines = []
    t = {"now": 0.0}
    con = o.Console(1000, interval_s=1000.0, emit=lines.append,
                    label="mm/TMR", stop_when=o.StopWhen.parse("sdc:0.01"),
                    clock=lambda: t["now"])
    t["now"] = 1.0
    con.update(500, {"success": 400, "sdc": 100})
    con.update(600, {"success": 480, "sdc": 120})
    t["now"] = 2.0
    con.final(1000, {"success": 800, "sdc": 200})
    return lines


def test_console_panels_equal_the_reference():
    got = console_lines(obs)
    assert got == console_lines(_ref())
    assert len(got) == 2 and "(done)" in got[-1] and "> 0.01" in got[-1]


def test_campaign_stage_keys_equal_the_reference():
    from coast_tpu import TMR as JTMR
    from coast_tpu.inject.campaign import CampaignRunner as JRunner
    from coast_tpu.models import mm as jmm
    for collect in ("dense", "sparse"):
        want = JRunner(JTMR(jmm.make_region()), collect=collect).run(
            256, seed=2, batch_size=64)
        runner = CampaignRunner(TMR(mm.make_region(), device="cpu"),
                                collect=collect)
        got = runner.run(256, seed=2, batch_size=64)
        assert sorted(got.stages) == sorted(want.stages)
        assert got.counts == want.counts
        names = [e["name"] for e in runner.telemetry.events
                 if e["kind"] == "span"]
        assert names.count("dispatch") == names.count("collect") == 4
    off = CampaignRunner(TMR(mm.make_region(), device="cpu"),
                         telemetry=obs.NULL).run(256, seed=2, batch_size=64)
    assert off.stages == {} and off.counts == got.counts


def test_campaign_marks_resilience_and_pad_waste():
    from coast_tpu_torch.inject.resilience import RetryPolicy
    runner = CampaignRunner(TMR(mm.make_region(), device="cpu"),
                            retry=RetryPolicy(max_attempts=2))
    runner.run(100, seed=1, batch_size=64)
    assert runner.telemetry.counters["pad_waste_rows"] == 28
    tel = runner.telemetry
    with tel.activate():
        assert tspans.current() is tel


def trace_spans(path):
    doc = json.loads(open(path).read())
    return sorted((e["name"], e["cat"], e["ph"], e["tid"])
                  for e in doc["traceEvents"] if e["ph"] == "X"), doc


def test_supervisor_trace_out_through_both_packages(tmp_path):
    from coast_tpu.inject import supervisor as jsup
    from coast_tpu_torch.inject import supervisor
    argv = ["-f", "matrixMultiply", "-O", "-TMR", "-t", "300",
            "--batch-size", "100", "-d", "cpu", "-q"]
    assert jsup.main([*argv, "--trace-out", str(tmp_path / "j.json")]) == 0
    assert supervisor.main([*argv, "--trace-out",
                            str(tmp_path / "t.json")]) == 0
    want, jdoc = trace_spans(tmp_path / "j.json")
    got, doc = trace_spans(tmp_path / "t.json")
    assert got == want
    assert doc["otherData"]["benchmark"] == "matrixMultiply"
    assert doc["traceEvents"][0]["args"]["name"] \
        == jdoc["traceEvents"][0]["args"]["name"]


@pytest.mark.parametrize("flag", ["--heartbeat", "--console"])
def test_supervisor_progress_surfaces(flag, capsys):
    from coast_tpu_torch.inject import supervisor
    argv = ["-f", "matrixMultiply", "-O", "-TMR", "-t", "200",
            "--batch-size", "100", "-d", "cpu", "-q", flag]
    if flag == "--heartbeat":
        argv.append("0.001")
    assert supervisor.main(argv) == 0
    err = capsys.readouterr().err
    assert "200/200" in err or "100.0%" in err
