"""Campaign logs of the PyTorch port against the reference's.

With the timestamp fixed in both packages and the summary's volatile
telemetry (seconds, stages, transfer bytes) set equal, the port's
``write_json``, ``write_ndjson`` and ``write_columnar`` files equal the
reference's byte for byte for the same campaign, dense and sparse;
``write_reference_json`` equals it after line 1 (which names each
package's own model module).  The port's streamed files equal its one-shot
files (gzip included, uneven batches), a stream resumed from a journal
equals the uninterrupted one, and the reference's
``coast_tpu.analysis.json_parser`` reads the port's logs to the same
summary counts as the reference's.
"""

import dataclasses
import gzip
import json
import os

import numpy as np
import pytest
import torch

import coast_tpu_torch as ct
from coast_tpu_torch.inject import logs
from coast_tpu_torch.inject.campaign import CampaignRunner
from coast_tpu_torch.inject.schedule import FaultModel
from coast_tpu_torch.models import crc16, mm

torch.set_num_threads(1)

FIXED_TS = "2026-01-01 00:00:00.000000"
ONESHOT = {"json": "write_json", "ndjson": "write_ndjson",
           "columnar": "write_columnar", "reference": "write_reference_json"}
# name -> (region, strategy, fused, fault model, collect)
CAMPAIGNS = {
    "mm_tmr": ("mm", "TMR", False, "single", "dense"),
    "crc16_dwc_fused_sparse": ("crc16", "DWC", True, "multibit(k=4)",
                               "sparse"),
}


@pytest.fixture(autouse=True)
def fixed_timestamps(monkeypatch):
    from coast_tpu.inject import logs as jlogs
    monkeypatch.setattr(logs, "_timestamp", lambda: FIXED_TS)
    monkeypatch.setattr(jlogs, "_timestamp", lambda: FIXED_TS)


def port_runner(name):
    region, strategy, fused, spec, collect = CAMPAIGNS[name]
    make = {"mm": mm.make_region, "crc16": crc16.make_region}[region]
    prog = getattr(ct, strategy)(make(), device="cpu", fuse_step=fused)
    return CampaignRunner(prog, strategy_name=strategy,
                          fault_model=FaultModel.parse(spec), collect=collect)


@pytest.fixture(scope="module")
def campaigns():
    """name -> (port runner, port result, reference runner, reference
    result): 120 rows at batch 40, seed 17."""
    import coast_tpu
    from coast_tpu.inject.campaign import CampaignRunner as JRunner
    from coast_tpu.inject.schedule import FaultModel as JFaultModel
    from coast_tpu.models import crc16 as jcrc16
    from coast_tpu.models import mm as jmm
    out = {}
    for name, (region, strategy, fused, spec, collect) in CAMPAIGNS.items():
        make = {"mm": jmm.make_region, "crc16": jcrc16.make_region}[region]
        jr = JRunner(getattr(coast_tpu, strategy)(make(), fuse_step=fused),
                     strategy_name=strategy,
                     fault_model=JFaultModel.parse(spec), collect=collect)
        r = port_runner(name)
        out[name] = (r, r.run(120, seed=17, batch_size=40),
                     jr, jr.run(120, seed=17, batch_size=40))
    return out


def norm(res):
    """The result with its volatile telemetry fixed, so two files written
    from it differ only where the campaign does."""
    return dataclasses.replace(res, seconds=1.0, stages={}, transfer={})


def oneshot(fmt, res, mmap, path, pkg=logs):
    getattr(pkg, ONESHOT[fmt])(norm(res), mmap, path)


CASES = [(n, f) for n in CAMPAIGNS for f in ONESHOT
         if not (f == "reference" and CAMPAIGNS[n][4] == "sparse")]


@pytest.mark.parametrize("name,fmt", CASES)
def test_oneshot_files_equal_the_reference(name, fmt, campaigns, tmp_path):
    from coast_tpu.inject import logs as jlogs
    r, res, jr, ref = campaigns[name]
    np.testing.assert_array_equal(res.codes, ref.codes)
    a, b = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    oneshot(fmt, res, r.mmap, a)
    oneshot(fmt, ref, jr.mmap, b, pkg=jlogs)
    got, want = open(a, "rb").read(), open(b, "rb").read()
    if fmt == "reference":
        first, rest = got.split(b"\n", 1)
        assert first.decode().endswith(os.path.join("coast_tpu_torch",
                                                    "models", "mm.py"))
        assert rest == want.split(b"\n", 1)[1]
    else:
        assert got == want
    if fmt == "ndjson":
        assert len(got.splitlines()) == 1 + len(res.codes)


def test_summary_equal_outside_volatile_keys(campaigns):
    for r, res, jr, ref in campaigns.values():
        drop = ("seconds", "injections_per_sec", "stages", "transfer_bytes")
        a = {k: v for k, v in res.summary().items() if k not in drop}
        b = {k: v for k, v in ref.summary().items() if k not in drop}
        assert json.dumps(a) == json.dumps(b)
        assert set(res.summary()["stages"]) <= {
            "schedule", "sparse_setup", "pad", "dispatch", "collect",
            "classify", "serialize", "overlap"}


def feed_all(w, res, bs):
    for lo in range(0, res.n, bs):
        hi = min(lo + bs, res.n)
        w.feed(lo, res.schedule.slice(lo, hi),
               {"code": res.codes[lo:hi], "errors": res.errors[lo:hi],
                "corrected": res.corrected[lo:hi],
                "steps": res.steps[lo:hi]})


@pytest.mark.parametrize("fmt", ["ndjson", "columnar", "reference"])
@pytest.mark.parametrize("suffix", ["", ".gz"])
def test_stream_equals_oneshot(fmt, suffix, campaigns, tmp_path):
    r, res, _, _ = campaigns["mm_tmr"]
    a = str(tmp_path / f"a.json{suffix}")
    b = str(tmp_path / f"b.json{suffix}")
    oneshot(fmt, res, r.mmap, a)
    w = logs.StreamLogWriter(b, r.mmap, fmt=fmt)
    feed_all(w, res, bs=7)                       # uneven batches
    w.finish(norm(res))
    assert open(a, "rb").read() == open(b, "rb").read()
    if suffix:
        plain = str(tmp_path / "plain.json")
        oneshot(fmt, res, r.mmap, plain)
        assert gzip.decompress(open(a, "rb").read()) == open(plain,
                                                             "rb").read()


def test_sparse_stream_equals_oneshot(campaigns, tmp_path):
    r, res, _, _ = campaigns["crc16_dwc_fused_sparse"]
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    oneshot("ndjson", res, r.mmap, a)
    w = logs.StreamLogWriter(b, r.mmap, fmt="ndjson")
    got = r.run_schedule(res.schedule, batch_size=40, stream=w)
    w.finish(got)
    head_a, rows_a = open(a, "rb").read().split(b"\n", 1)
    head_b, rows_b = open(b, "rb").read().split(b"\n", 1)
    assert rows_a == rows_b
    drop = ("seconds", "injections_per_sec", "stages", "transfer_bytes")
    assert ({k: v for k, v in json.loads(head_a)["summary"].items()
             if k not in drop}
            == {k: v for k, v in json.loads(head_b)["summary"].items()
                if k not in drop})
    assert "serialize" in got.stages and 0.0 <= got.stages["overlap"] <= 1.0


@pytest.mark.parametrize("name", sorted(CAMPAIGNS))
def test_resumed_stream_equals_uninterrupted(name, campaigns, tmp_path):
    r = campaigns[name][0]
    a, b = str(tmp_path / "full.json"), str(tmp_path / "resumed.json")
    w = logs.StreamLogWriter(a, r.mmap, fmt="ndjson")
    full = r.run(120, seed=17, batch_size=40, stream=w)
    w.finish(norm(full))

    class Kill(Exception):
        pass

    def kill_on_second(done, counts, beats=[0]):
        beats[0] += 1
        if beats[0] >= 2:
            raise Kill

    jpath = str(tmp_path / "j.ndjson")
    w2 = logs.StreamLogWriter(b, r.mmap, fmt="ndjson")
    with pytest.raises(Kill):
        r.run(120, seed=17, batch_size=40, journal=jpath,
              progress=kill_on_second, stream=w2)
    w2.abort()
    assert not os.path.exists(b)
    w3 = logs.StreamLogWriter(b, r.mmap, fmt="ndjson")
    resumed = r.run(120, seed=17, batch_size=40, journal=jpath, stream=w3)
    w3.finish(norm(resumed))
    assert open(a, "rb").read() == open(b, "rb").read()
    np.testing.assert_array_equal(full.codes, resumed.codes)


@pytest.mark.parametrize("name,fmt", [(n, f) for n, f in CASES
                                      if f != "reference"])
def test_reference_parser_reads_port_logs(name, fmt, campaigns, tmp_path):
    from coast_tpu.analysis import json_parser
    from coast_tpu.inject import logs as jlogs
    r, res, jr, ref = campaigns[name]
    a, b = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    getattr(logs, ONESHOT[fmt])(res, r.mmap, a)
    getattr(jlogs, ONESHOT[fmt])(ref, jr.mmap, b)
    got, want = json_parser.summarize_path(a), json_parser.summarize_path(b)
    assert got.n == want.n == res.n
    assert got.counts == want.counts
    # The port's own parser reads both packages' logs the same way.
    from coast_tpu_torch.analysis import json_parser as port_parser
    for path in (a, b):
        mine = port_parser.summarize_path(path)
        assert (mine.n, mine.counts) == (want.n, want.counts)


def test_atomic_writers_never_truncate(campaigns, tmp_path, monkeypatch):
    r, res, _, _ = campaigns["mm_tmr"]
    path = str(tmp_path / "log.json")
    logs.write_json(res, r.mmap, path)
    good = open(path).read()

    def boom(*a, **k):
        raise RuntimeError("crash mid-serialize")
    monkeypatch.setattr(logs, "to_injection_logs", boom)
    with pytest.raises(RuntimeError):
        logs.write_json(res, r.mmap, path)
    monkeypatch.setattr(logs, "_columns", boom)
    with pytest.raises(RuntimeError):
        logs.write_columnar(res, r.mmap, path)
    # A dense ndjson log's rows come from the native encoder, after the
    # summary line is already in the temp file.
    monkeypatch.setattr(logs.native, "ndjson_stream_rows", boom)
    with pytest.raises(RuntimeError):
        logs.write_ndjson(res, r.mmap, path)
    assert open(path).read() == good
    assert [f for f in os.listdir(tmp_path) if ".tmp." in f] == []


def test_stream_misuse_refused(campaigns, tmp_path):
    r, res, _, _ = campaigns["mm_tmr"]
    w = logs.StreamLogWriter(str(tmp_path / "x.json"), r.mmap)
    part = res.schedule.slice(0, 40)
    out = {"code": res.codes[:40], "errors": res.errors[:40],
           "corrected": res.corrected[:40], "steps": res.steps[:40]}
    with pytest.raises(ValueError, match="out of order"):
        w.feed(40, part, out)
    w.feed(0, part, out)
    with pytest.raises(ValueError, match="out of order"):
        w.feed(80, part, out)
    with pytest.raises(ValueError, match="does not match"):
        w.finish(norm(res))
    w.abort()
    with pytest.raises(ValueError, match="unknown stream log format"):
        logs.StreamLogWriter(str(tmp_path / "y.json"), r.mmap, fmt="json")
    with pytest.raises(ValueError, match="ndjson format only"):
        logs.StreamLogWriter(str(tmp_path / "z.json"), r.mmap,
                             fmt="columnar").feed_sparse([], part, out)


@pytest.mark.parametrize("fmt", ["ndjson", "columnar", "reference"])
def test_empty_campaign_stream(fmt, campaigns, tmp_path):
    r = campaigns["mm_tmr"][0]
    empty = r.run(0, seed=3)
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    oneshot(fmt, empty, r.mmap, a)
    w = logs.StreamLogWriter(b, r.mmap, fmt=fmt)
    w.finish(norm(empty))
    assert open(a, "rb").read() == open(b, "rb").read()


def test_sparse_reference_container_refused(campaigns, tmp_path):
    r, res, _, _ = campaigns["crc16_dwc_fused_sparse"]
    with pytest.raises(ValueError, match="dense result"):
        logs.write_reference_json(res, r.mmap, str(tmp_path / "x.json"))
