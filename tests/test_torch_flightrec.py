"""The port's flight recorder (``coast_tpu_torch/obs/flightrec.py``)
against the reference's (``coast_tpu/obs/flightrec.py``).

The ring, the ambient recorder, the bundle's format and the env knobs
behave as the reference's; the bundle's metadata names torch and its CUDA
build (and, on the card, the card and its power limit) where the
reference names jax.  The watchdog, the journal and a crashing campaign
record and dump as the reference's do, with the reference's event names
and fields for the same campaign.  Everything runs on the CPU.
"""

import json
import os
import signal
import threading

import pytest
import torch

from coast_tpu_torch import TMR
from coast_tpu_torch.inject.campaign import CampaignRunner
from coast_tpu_torch.models import mm
from coast_tpu_torch.obs import flightrec

torch.set_num_threads(1)


def _ref():
    from coast_tpu.obs import flightrec as jflightrec
    return jflightrec


def fields(rows):
    """Events without their clock, sequence and thread fields."""
    return [{k: v for k, v in r.items()
             if k not in ("t_unix_s", "t_mono_s", "seq", "thread")}
            for r in rows]


@pytest.mark.parametrize("cap", [1, 4, 16])
def test_ring_equals_the_reference(cap):
    got, want = (m.FlightRecorder(capacity=cap, enabled=True)
                 for m in (flightrec, _ref()))
    for rec in (got, want):
        for i in range(10):
            rec.record("dispatch", lo=i * 64, n=64)
    assert fields(got.tail()) == fields(want.tail())
    assert [r["seq"] for r in got.tail()] == [r["seq"] for r in want.tail()]
    assert fields(got.tail(2)) == fields(want.tail(2))


def test_ring_is_thread_safe_and_tags_threads():
    rec = flightrec.FlightRecorder(capacity=1000, enabled=True)

    def work(k):
        for i in range(50):
            rec.record("w", k=k, i=i)

    threads = [threading.Thread(target=work, args=(k,), name=f"t{k}")
               for k in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    rows = rec.tail()
    assert len(rows) == 200 and sorted(r["seq"] for r in rows) == list(
        range(200))
    assert {r["thread"] for r in rows} == {"t0", "t1", "t2", "t3"}


def test_disabled_and_null_absorb_everything(tmp_path, monkeypatch):
    assert flightrec.current() is flightrec.NULL
    flightrec.record("nothing")
    assert flightrec.NULL.dump("x") is None
    monkeypatch.setenv("COAST_FLIGHTREC", "0")
    rec = flightrec.FlightRecorder(dump_dir=str(tmp_path))
    rec.record("x")
    assert not rec.enabled and rec.tail() == [] and rec.dump("r") is None
    monkeypatch.setenv("COAST_FLIGHTREC", "1")
    monkeypatch.setenv("COAST_FLIGHTREC_CAP", "3")
    monkeypatch.setenv("COAST_FLIGHTREC_DIR", str(tmp_path / "env"))
    rec = flightrec.FlightRecorder()
    assert rec.enabled and rec.capacity == 3
    path = rec.dump("env dir")
    assert os.path.dirname(path) == str(tmp_path / "env")
    assert os.path.basename(path).endswith("_env-dir.json")


def test_activate_install_uninstall():
    with flightrec.activate(enabled=True, source="outer") as outer:
        assert flightrec.current() is outer
        inner = flightrec.install(enabled=True, source="inner")
        flightrec.record("to_inner")
        flightrec.uninstall(inner)
        flightrec.record("to_outer")
        assert [r["event"] for r in inner.tail()] == ["to_inner"]
        assert [r["event"] for r in outer.tail()] == ["to_outer"]
    assert flightrec.current() is flightrec.NULL


def test_bundle_format_equals_the_reference(tmp_path):
    docs = []
    for m, sub in ((flightrec, "t"), (_ref(), "j")):
        rec = m.FlightRecorder(enabled=True, dump_dir=str(tmp_path / sub),
                               source="unit")
        rec.record("dispatch", lo=0, n=64)
        rec.record("retry", lo=0, attempt=1)
        path = rec.dump("unit reason", extra={"answer": 42})
        assert rec.dumps == [path] and m.newest_bundle(
            str(tmp_path / sub)) == path
        assert not [n for n in os.listdir(tmp_path / sub) if ".tmp." in n]
        docs.append(m.read_bundle(path))
    got, want = docs
    assert sorted(got) == sorted(set(want) - {"jax"} | {"torch"})
    for key in ("format", "version", "reason", "source", "extra",
                "events_recorded_total"):
        assert got[key] == want[key], key
    assert fields(got["events"]) == fields(want["events"])
    assert sorted(got["process"]) == sorted(want["process"])
    assert "MainThread" in got["stacks"]
    meta = got["torch"]
    assert meta["torch_version"] == torch.__version__
    assert meta["cuda_version"] == torch.version.cuda
    assert meta["backend"] == "cpu"        # no card initialised here


def test_read_bundle_rejects_non_bundles(tmp_path):
    p = tmp_path / "flightrec_x.json"
    p.write_text(json.dumps({"format": "something-else"}))
    with pytest.raises(ValueError):
        flightrec.read_bundle(str(p))
    assert flightrec.newest_bundle(str(tmp_path / "missing")) is None


def test_sigusr1_dumps_a_bundle(tmp_path):
    rec = flightrec.FlightRecorder(enabled=True, dump_dir=str(tmp_path))
    rec.record("before_signal")
    try:
        assert rec.install_signal_handler()
        os.kill(os.getpid(), signal.SIGUSR1)
    finally:
        signal.signal(signal.SIGUSR1, signal.SIG_DFL)
    doc = flightrec.read_bundle(rec.dumps[0])
    assert doc["reason"] == f"signal:{int(signal.SIGUSR1)}"
    assert [e["event"] for e in doc["events"]] == ["before_signal",
                                                   "signal_dump"]


def test_watchdog_wedge_dumps_forensics_before_raising(tmp_path):
    from coast_tpu_torch.inject.resilience import (CampaignWedgedError,
                                                   watchdog_collect)
    from coast_tpu_torch import obs
    hang = threading.Event()
    tel = obs.Telemetry(enabled=True)
    with flightrec.activate(enabled=True, dump_dir=str(tmp_path)) as rec, \
            tel.activate():
        rec.record("dispatch", lo=0, n=64)
        try:
            with pytest.raises(CampaignWedgedError):
                watchdog_collect(lambda: hang.wait(30.0), timeout=0.2)
        finally:
            hang.set()
    doc = flightrec.read_bundle(rec.dumps[-1])
    assert doc["reason"] == "watchdog_wedge"
    assert doc["extra"]["timeout_s"] == 0.2
    assert [e["event"] for e in doc["events"]] == ["dispatch",
                                                   "watchdog_fired"]
    assert "coast-collect-watchdog" in doc["stacks"]
    assert tel.counters["watchdog_fired"] == 1


def campaign_events(package, tmp_path):
    if package == "port":
        runner = CampaignRunner(TMR(mm.make_region(), device="cpu"))
        m = flightrec
    else:
        from coast_tpu import TMR as JTMR
        from coast_tpu.inject.campaign import CampaignRunner as JRunner
        from coast_tpu.models import mm as jmm
        runner, m = JRunner(JTMR(jmm.make_region())), _ref()
    jpath = str(tmp_path / f"{package}.ndjson")
    with m.activate(enabled=True, dump_dir=str(tmp_path)) as rec:
        runner.run(120, seed=3, batch_size=40, journal=jpath)
        runner.run(120, seed=3, batch_size=40, journal=jpath)  # resumed
    rows = fields(rec.tail())
    for r in rows:
        if "path" in r:
            r["path"] = os.path.basename(r["path"]).split(".")[-1]
    return rows


def test_campaign_events_equal_the_reference(tmp_path):
    got = campaign_events("port", tmp_path)
    assert got == campaign_events("reference", tmp_path)
    events = [r["event"] for r in got]
    assert events.count("dispatch") == 3
    assert events.count("journal_open") == 2 and "journal_resume" in events


def test_crashing_campaign_dumps_a_bundle(tmp_path):
    runner = CampaignRunner(TMR(mm.make_region(), device="cpu"))

    class Boom(Exception):
        pass

    def die(done, counts):
        raise Boom("stop")

    with flightrec.activate(enabled=True, dump_dir=str(tmp_path)) as rec:
        with pytest.raises(Boom):
            runner.run(128, seed=1, batch_size=64, progress=die)
    doc = flightrec.read_bundle(rec.dumps[-1])
    assert doc["reason"] == "campaign_crash:Boom"
    assert doc["extra"] == {"error": "Boom: stop", "done_rows": 64}
    assert [e["event"] for e in doc["events"]][-2:] == ["dispatch",
                                                        "campaign_crash"]
