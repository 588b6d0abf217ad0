"""The campaign journal, resume and retry of the PyTorch port.

The port's journal must be the reference's, record for record: the same
campaign writes the same header (every key outside ``_VOLATILE_KEYS``,
byte for byte as JSON) and the same batch, chunk and early-stop records
(outside stage timings), so a journal written by one package resumes under
the other on integer regions.  A float region (the mm256 family) is not
held to that: its ``order_sensitive`` rows may differ between the packages.
Then the port's own resume and retry behaviour, mirroring
``tests/test_resilience.py`` with the port's runner: torn tails, corrupt
lines, typed refusals, fake transient/OOM/wedged batches, and the
classification of real torch and CUDA errors.
"""

import json
import time

import numpy as np
import pytest
import torch

import coast_tpu_torch as ct
from coast_tpu_torch.inject.campaign import CampaignRunner, _merge_results
from coast_tpu_torch.inject.journal import (_VOLATILE_KEYS, CampaignJournal,
                                            FaultModelMismatchError,
                                            FuseStepMismatchError,
                                            JournalError, JournalExistsError,
                                            JournalMismatchError,
                                            schedule_fingerprint)
from coast_tpu_torch.inject.resilience import (CampaignWedgedError,
                                               RetryPolicy, watchdog_collect)
from coast_tpu_torch.inject.schedule import FaultModel, generate
from coast_tpu_torch.models import crc16, mm
from coast_tpu_torch.obs.convergence import StopWhen

torch.set_num_threads(1)

REGIONS = {"mm": mm.make_region, "crc16": crc16.make_region}
COLUMNS = ("codes", "errors", "corrected", "steps")
# Record keys that are timings, not campaign data.
TIMING_KEYS = ("stage_seconds", "spans", "seconds")

# name -> (region, strategy, opt overrides, fault model, collect, stop_when)
CASES = {
    "mm_tmr": ("mm", "TMR", {}, "single", "dense", None),
    "mm_dwc": ("mm", "DWC", {}, "single", "dense", None),
    "crc16_tmr_fused": ("crc16", "TMR", {"fuse_step": True}, "single",
                        "dense", None),
    "mm_unprotected": ("mm", "unprotected", {}, "single", "dense", None),
    "mm_multibit": ("mm", "TMR", {}, "multibit(k=3)", "dense", None),
    "mm_cluster": ("mm", "TMR", {}, "cluster(span=4,k=2)", "dense", None),
    "mm_burst": ("mm", "TMR", {}, "burst(window=8,rate=0.5)", "dense", None),
    "mm_sparse": ("mm", "TMR", {}, "single", "sparse", None),
    "crc16_dwc_fused_sparse": ("crc16", "DWC", {"fuse_step": True},
                               "multibit(k=4)", "sparse", None),
    "mm_stop_when": ("mm", "TMR", {}, "single", "dense",
                     "corrected:0.2;min=40"),
}


def port_runner(case, **kw):
    region, strategy, over, spec, collect, _ = CASES[case]
    prog = getattr(ct, strategy)(REGIONS[region](), device="cpu", **over)
    return CampaignRunner(prog, strategy_name=strategy,
                          fault_model=FaultModel.parse(spec),
                          collect=collect, **kw)


def ref_runner(case, **kw):
    import coast_tpu
    from coast_tpu.inject.campaign import CampaignRunner as JRunner
    from coast_tpu.inject.schedule import FaultModel as JFaultModel
    from coast_tpu.models import crc16 as jcrc16
    from coast_tpu.models import mm as jmm
    region, strategy, over, spec, collect, _ = CASES[case]
    make = {"mm": jmm.make_region, "crc16": jcrc16.make_region}[region]
    prog = getattr(coast_tpu, strategy)(make(), **over)
    return JRunner(prog, strategy_name=strategy,
                   fault_model=JFaultModel.parse(spec), collect=collect, **kw)


def stop_of(case, ref=False):
    spec = CASES[case][5]
    if spec is None:
        return None
    if ref:
        from coast_tpu.obs.convergence import StopWhen as JStopWhen
        return JStopWhen.parse(spec)
    return StopWhen.parse(spec)


def records(path):
    return [json.loads(line) for line in open(path)]


def strip_timing(rec):
    return {k: v for k, v in rec.items() if k not in TIMING_KEYS}


@pytest.fixture(scope="module")
def journals(tmp_path_factory):
    """case -> (port records, reference records, port result, reference
    result): one 200-row campaign at batch 40, seed 7, journaled by each
    package."""
    cache = {}

    def get(case):
        if case not in cache:
            d = tmp_path_factory.mktemp(case)
            got = port_runner(case).run(200, seed=7, batch_size=40,
                                        journal=str(d / "port.ndjson"),
                                        stop_when=stop_of(case))
            ref = ref_runner(case).run(200, seed=7, batch_size=40,
                                       journal=str(d / "ref.ndjson"),
                                       stop_when=stop_of(case, ref=True))
            cache[case] = (records(d / "port.ndjson"),
                           records(d / "ref.ndjson"), got, ref)
        return cache[case]
    return get


@pytest.mark.parametrize("case", sorted(CASES))
def test_header_parity(case, journals):
    port, ref, _, _ = journals(case)
    strip = lambda h: json.dumps(  # noqa: E731
        {k: v for k, v in h.items() if k not in _VOLATILE_KEYS},
        separators=(",", ":"))
    assert port[0]["kind"] == "header"
    assert strip(port[0]) == strip(ref[0])
    assert list(port[0]) == list(ref[0])        # same keys, same order


@pytest.mark.parametrize("case", sorted(CASES))
def test_record_parity(case, journals):
    port, ref, got, want = journals(case)
    assert len(port) == len(ref)
    for a, b in zip(port[1:], ref[1:]):
        assert strip_timing(a) == strip_timing(b)
    assert got.counts == want.counts
    for col in COLUMNS:
        np.testing.assert_array_equal(getattr(got, col), getattr(want, col))
    if CASES[case][5] is not None:
        assert port[-1]["kind"] == "early_stop"
        assert got.convergence["stopped"] and got.n < 200
        assert (json.dumps(got.convergence, sort_keys=True)
                == json.dumps(want.convergence, sort_keys=True))


def test_chunk_record_parity(tmp_path):
    """run_until_errors writes the reference's header and chunk records."""
    kw = dict(min_errors=5, seed=1, batch_size=100, round_to=300)
    got = port_runner("mm_unprotected").run_until_errors(
        journal=str(tmp_path / "p.ndjson"), **kw)
    want = ref_runner("mm_unprotected").run_until_errors(
        journal=str(tmp_path / "r.ndjson"), **kw)
    port, ref = records(tmp_path / "p.ndjson"), records(tmp_path / "r.ndjson")
    assert [strip_timing(r) for r in port] == [strip_timing(r) for r in ref]
    assert got.chunks == want.chunks
    assert got.counts == want.counts
    np.testing.assert_array_equal(got.codes, want.codes)


class Kill(Exception):
    """Stands in for SIGKILL: raised from a progress callback after the
    batch's journal record is fsync'd."""


def kill_after(n_beats):
    state = {"n": 0}

    def cb(done, counts):
        state["n"] += 1
        if state["n"] >= n_beats:
            raise Kill
    return cb


@pytest.mark.parametrize("case", ["mm_tmr", "crc16_dwc_fused_sparse"])
@pytest.mark.parametrize("killed_by", ["reference", "port"])
def test_cross_resume(case, killed_by, journals, tmp_path):
    """A campaign killed after 2 batches by one package resumes under the
    other with the uninterrupted codes and counts."""
    _, _, whole, ref_whole = journals(case)
    path = str(tmp_path / "j.ndjson")
    first, second = ((ref_runner, port_runner) if killed_by == "reference"
                     else (port_runner, ref_runner))
    with pytest.raises(Kill):
        first(case).run(200, seed=7, batch_size=40, journal=path,
                        progress=kill_after(2))
    assert sum(r["kind"] == "batch" for r in records(path)) == 2
    res = second(case).run(200, seed=7, batch_size=40, journal=path)
    assert res.counts == whole.counts == ref_whole.counts
    for col in COLUMNS:
        np.testing.assert_array_equal(getattr(res, col), getattr(whole, col))
    if whole.collect == "sparse":
        np.testing.assert_array_equal(res.interesting_rows,
                                      whole.interesting_rows)
    assert sum(r["kind"] == "batch" for r in records(path)) == 5


# -- the port's own resume behaviour ------------------------------------------

@pytest.fixture(scope="module")
def runner():
    return port_runner("mm_tmr")


@pytest.fixture(scope="module")
def baseline(runner):
    return runner.run(200, seed=9, batch_size=50)


def test_resume_parity_after_kill(runner, baseline, tmp_path):
    path = str(tmp_path / "c.ndjson")
    with pytest.raises(Kill):
        runner.run(200, seed=9, batch_size=50, journal=path,
                   progress=kill_after(2))
    assert sum(r["kind"] == "batch" for r in records(path)) == 2
    res = runner.run(200, seed=9, batch_size=50, journal=path)
    for col in COLUMNS:
        np.testing.assert_array_equal(getattr(res, col),
                                      getattr(baseline, col))
    assert res.counts == baseline.counts


def test_torn_tail_dropped_and_truncated_before_reappend(runner, baseline,
                                                         tmp_path):
    path = str(tmp_path / "torn.ndjson")
    with pytest.raises(Kill):
        runner.run(200, seed=9, batch_size=50, journal=path,
                   progress=kill_after(1))
    with open(path, "a") as f:
        f.write('{"kind": "batch", "lo": 50, "n": 50, "codes": [1, 2')
    with pytest.raises(Kill):           # resume, then die again
        runner.run(200, seed=9, batch_size=50, journal=path,
                   progress=kill_after(3))
    for line in open(path):             # every surviving line is valid
        json.loads(line)
    res = runner.run(200, seed=9, batch_size=50, journal=path)
    np.testing.assert_array_equal(res.codes, baseline.codes)
    assert res.counts == baseline.counts


def test_corrupt_middle_is_hard_error(runner, tmp_path):
    path = str(tmp_path / "corrupt.ndjson")
    with pytest.raises(Kill):
        runner.run(200, seed=9, batch_size=50, journal=path,
                   progress=kill_after(2))
    lines = open(path).readlines()
    lines[1] = "NOT JSON\n"
    with open(path, "w") as f:
        f.writelines(lines)
    with pytest.raises(JournalError, match="corrupt at line 2"):
        runner.run(200, seed=9, batch_size=50, journal=path)


def test_complete_journal_resumes_without_dispatch(runner, baseline,
                                                   tmp_path):
    path = str(tmp_path / "full.ndjson")
    runner.run(200, seed=9, batch_size=50, journal=path)
    fresh = CampaignRunner(runner.prog, strategy_name="TMR")

    def boom(fault):
        raise AssertionError("a complete journal must not dispatch")
    fresh._dispatch = boom
    res = fresh.run(200, seed=9, batch_size=50, journal=path)
    np.testing.assert_array_equal(res.codes, baseline.codes)
    assert res.counts == baseline.counts


def test_header_mismatch_refused(runner, tmp_path):
    path = str(tmp_path / "m.ndjson")
    runner.run(100, seed=9, batch_size=50, journal=path)
    for kw in ({"seed": 10}, {"n": 150}, {"start_num": 7}):
        args = {"n": 100, "seed": 9, "batch_size": 50, **kw}
        with pytest.raises(JournalMismatchError):
            runner.run(journal=path, **args)
    other = port_runner("mm_unprotected")
    with pytest.raises(JournalMismatchError):
        other.run(100, seed=9, batch_size=50, journal=path)


def test_journal_exists_refusal(tmp_path):
    path = str(tmp_path / "exists.ndjson")
    CampaignJournal.open(path, {"mode": "run", "seed": 1}).close()
    with pytest.raises(JournalExistsError):
        CampaignJournal.open(path, {"mode": "run", "seed": 1}, resume=False)


def test_resume_is_batch_size_independent(runner, baseline, tmp_path):
    path = str(tmp_path / "bs.ndjson")
    with pytest.raises(Kill):
        runner.run(200, seed=9, batch_size=50, journal=path,
                   progress=kill_after(2))
    res = runner.run(200, seed=9, batch_size=30, journal=path)
    np.testing.assert_array_equal(res.codes, baseline.codes)
    assert res.counts == baseline.counts


def test_journal_base_chunks(runner, tmp_path):
    """One seed stream sliced into chunks journaled into one file at
    ``journal_base``; a kill inside chunk 2 resumes at its first missing
    batch."""
    sched = generate(runner.mmap, 300, 5, runner.prog.region.nominal_steps)
    base = _merge_results([runner.run_schedule(sched.slice(lo, lo + 150),
                                               batch_size=50)
                           for lo in (0, 150)], 5)
    path = str(tmp_path / "stream.ndjson")
    header = {"mode": "schedule", "seed": 5, "n": 300,
              "schedule_sha": schedule_fingerprint(sched)}
    j = CampaignJournal.open(path, header)
    runner.run_schedule(sched.slice(0, 150), batch_size=50, journal=j)
    with pytest.raises(Kill):
        runner.run_schedule(sched.slice(150, 300), batch_size=50, journal=j,
                            journal_base=150, progress=kill_after(2))
    j.close()
    j2 = CampaignJournal.open(path, header)
    parts = [runner.run_schedule(sched.slice(lo, lo + 150), batch_size=50,
                                 journal=j2, journal_base=lo)
             for lo in (0, 150)]
    j2.close()
    res = _merge_results(parts, 5)
    np.testing.assert_array_equal(res.codes, base.codes)
    assert res.counts == base.counts


@pytest.mark.parametrize("mismatch", ["fault_model", "fuse", "collect"])
def test_typed_identity_refusals(mismatch, tmp_path):
    path = str(tmp_path / "id.ndjson")
    port_runner("mm_tmr").run(100, seed=2, batch_size=50, journal=path)
    if mismatch == "fault_model":
        other, error = port_runner("mm_multibit"), FaultModelMismatchError
    elif mismatch == "fuse":
        prog = ct.TMR(mm.make_region(), device="cpu", fuse_step=True)
        other = CampaignRunner(prog, strategy_name="TMR")
        error = FuseStepMismatchError
    else:
        other, error = port_runner("mm_sparse"), JournalMismatchError
    with pytest.raises(error):
        other.run(100, seed=2, batch_size=50, journal=path)


def test_stop_when_is_identity_and_resumes_to_the_same_stop(tmp_path):
    r = port_runner("mm_stop_when")
    stop = stop_of("mm_stop_when")
    whole = r.run(200, seed=7, batch_size=20, stop_when=stop)
    assert whole.convergence["stopped"]
    path = str(tmp_path / "s.ndjson")
    with pytest.raises(Kill):
        r.run(200, seed=7, batch_size=20, journal=path, stop_when=stop,
              progress=kill_after(1))
    with pytest.raises(JournalMismatchError, match="stop_when"):
        r.run(200, seed=7, batch_size=20, journal=path)
    res = r.run(200, seed=7, batch_size=20, journal=path, stop_when=stop)
    assert res.n == whole.n and res.counts == whole.counts
    assert records(path)[-1]["kind"] == "early_stop"


def test_until_errors_resume_and_replay(tmp_path):
    r = port_runner("mm_unprotected")
    kw = dict(min_errors=5, seed=1, batch_size=100, round_to=300)
    whole = r.run_until_errors(**kw)
    path = str(tmp_path / "e.ndjson")
    with pytest.raises(Kill):
        r.run_until_errors(journal=path, progress=kill_after(2), **kw)
    res = r.run_until_errors(journal=path, **kw)
    np.testing.assert_array_equal(res.codes, whole.codes)
    assert res.counts == whole.counts and res.chunks == whole.chunks
    rpath = str(tmp_path / "r.ndjson")
    rep = r.replay_chunks(whole.chunks, batch_size=100, journal=rpath)
    np.testing.assert_array_equal(rep.codes, whole.codes)
    fresh = CampaignRunner(r.prog, strategy_name="unprotected")
    fresh._dispatch = lambda fault: (_ for _ in ()).throw(
        AssertionError("should replay from the journal"))
    again = fresh.replay_chunks(whole.chunks, batch_size=100, journal=rpath)
    np.testing.assert_array_equal(again.codes, whole.codes)


def test_journal_result_matches_a_live_journal(runner, baseline, tmp_path):
    live = str(tmp_path / "live.ndjson")
    runner.run(200, seed=9, batch_size=50, journal=live)
    made = str(tmp_path / "made.ndjson")
    runner.journal_result(baseline, made, batch_size=50)
    assert ([strip_timing(r) for r in records(made)]
            == [strip_timing(r) for r in records(live)])
    with pytest.raises(JournalExistsError):
        runner.journal_result(baseline, made, batch_size=50)


# -- retry and degradation ------------------------------------------------------

class FakeTransient(Exception):
    pass


class FakeOOM(Exception):
    pass


def test_transient_collect_failure_retried(baseline, tmp_path):
    pol = RetryPolicy(base_delay=0.0, jitter=0.0,
                      transient_types=(FakeTransient,))
    r = port_runner("mm_tmr", retry=pol)
    orig, state = CampaignRunner._collect, {"n": 0}

    def flaky(pending):
        state["n"] += 1
        if state["n"] == 2:
            raise FakeTransient("injected")
        return orig(pending)
    r._collect = flaky
    path = str(tmp_path / "t.ndjson")
    res = r.run(200, seed=9, batch_size=50, journal=path)
    np.testing.assert_array_equal(res.codes, baseline.codes)
    assert res.resilience == {"retry_transient": 1, "retry_wedged": 0,
                              "oom_degrade": 0}
    assert res.summary()["resilience"]["retry_transient"] == 1
    retries = [r for r in records(path) if r["kind"] == "retry"]
    assert retries == [{"kind": "retry", "lo": 50, "attempt": 1,
                        "class": "transient", "error": "FakeTransient"}]


def test_transient_retries_exhausted_raise():
    pol = RetryPolicy(max_attempts=2, base_delay=0.0, jitter=0.0,
                      transient_types=(FakeTransient,))
    r = port_runner("mm_tmr", retry=pol)
    r._collect = lambda pending: (_ for _ in ()).throw(FakeTransient("x"))
    with pytest.raises(FakeTransient):
        r.run(100, seed=9, batch_size=50)


def test_fatal_errors_not_retried():
    pol = RetryPolicy(base_delay=0.0, jitter=0.0,
                      transient_types=(FakeTransient,))
    r = port_runner("mm_tmr", retry=pol)
    state = {"n": 0}

    def fatal(pending):
        state["n"] += 1
        raise KeyError("a bug, not a device hiccup")
    r._collect = fatal
    with pytest.raises(KeyError):
        r.run(100, seed=9, batch_size=50)
    assert state["n"] == 1


@pytest.mark.parametrize("collect", ["dense", "sparse"])
@pytest.mark.parametrize("error", ["fake", "torch"])
def test_oom_degrades_batch_size(collect, error, baseline, tmp_path):
    """Any dispatch above 25 rows runs out of memory: the runner halves
    100 -> 50 -> 25, journals the geometry and completes with the
    undegraded records -- through a fake OOM type, and through a real
    ``torch.OutOfMemoryError`` with the default policy."""
    pol = (RetryPolicy(base_delay=0.0, jitter=0.0, oom_types=(FakeOOM,))
           if error == "fake" else RetryPolicy())
    r = port_runner("mm_sparse" if collect == "sparse" else "mm_tmr",
                    retry=pol)
    orig = CampaignRunner._dispatch

    def oom_above_25(fault):
        if len(fault["bit"]) > 25:
            if error == "fake":
                raise FakeOOM("RESOURCE_EXHAUSTED (fake)")
            raise torch.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 2.00 GiB (GPU 0; "
                "79.10 GiB total capacity)")
        return orig(r, fault)
    r._dispatch = oom_above_25
    path = str(tmp_path / "oom.ndjson")
    res = r.run(200, seed=9, batch_size=100, journal=path)
    assert res.counts == baseline.counts
    if collect == "dense":
        np.testing.assert_array_equal(res.codes, baseline.codes)
    else:
        rows = np.flatnonzero(baseline.codes > 1)
        np.testing.assert_array_equal(res.interesting_rows, rows)
        np.testing.assert_array_equal(res.codes, baseline.codes[rows])
    assert res.resilience["oom_degrade"] == 2
    geoms = [g for g in records(path) if g["kind"] == "geometry"]
    assert [(g["batch_size"], g["lo"]) for g in geoms] == [(50, 0), (25, 0)]


def test_oom_at_floor_is_fatal():
    pol = RetryPolicy(base_delay=0.0, jitter=0.0, oom_types=(FakeOOM,),
                      min_batch_size=50)
    r = port_runner("mm_tmr", retry=pol)
    r._dispatch = lambda fault: (_ for _ in ()).throw(FakeOOM("fake"))
    with pytest.raises(FakeOOM):
        r.run(100, seed=9, batch_size=50)


def test_oom_without_policy_is_fatal():
    r = port_runner("mm_tmr")
    r._dispatch = lambda fault: (_ for _ in ()).throw(
        torch.OutOfMemoryError("CUDA out of memory."))
    with pytest.raises(torch.OutOfMemoryError):
        r.run(100, seed=9, batch_size=50)


def test_collect_watchdog_redispatches(baseline):
    pol = RetryPolicy(base_delay=0.0, jitter=0.0, collect_timeout=0.2)
    r = port_runner("mm_tmr", retry=pol)
    orig, state = CampaignRunner._collect, {"n": 0}

    def hang_once(pending):
        state["n"] += 1
        if state["n"] == 1:
            time.sleep(1.0)
        return orig(pending)
    r._collect = hang_once
    res = r.run(200, seed=9, batch_size=50)
    np.testing.assert_array_equal(res.codes, baseline.codes)
    assert res.resilience["retry_wedged"] == 1


def test_watchdog_exhausted_raises_wedged_and_journal_resumes(baseline,
                                                              tmp_path):
    pol = RetryPolicy(max_attempts=2, base_delay=0.0, jitter=0.0,
                      collect_timeout=0.05)
    r = port_runner("mm_tmr", retry=pol)
    orig, state = CampaignRunner._collect, {"n": 0}

    def hang_late(pending):
        state["n"] += 1
        if state["n"] > 2:
            time.sleep(0.5)
        return orig(pending)
    r._collect = hang_late
    path = str(tmp_path / "w.ndjson")
    with pytest.raises(CampaignWedgedError):
        r.run(200, seed=9, batch_size=50, journal=path)
    assert sum(x["kind"] == "batch" for x in records(path)) == 2
    res = port_runner("mm_tmr").run(200, seed=9, batch_size=50, journal=path)
    np.testing.assert_array_equal(res.codes, baseline.codes)
    with pytest.raises(CampaignWedgedError):
        watchdog_collect(lambda: time.sleep(1.0), timeout=0.05)
    assert watchdog_collect(lambda: 42, timeout=1.0) == 42
    assert watchdog_collect(lambda: 42, timeout=None) == 42


@pytest.mark.parametrize("exc,kind", [
    (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB "
                            "(GPU 0; 79.10 GiB total capacity)"), "oom"),
    (RuntimeError("CUDA out of memory. Tried to allocate 20.00 MiB"), "oom"),
    (RuntimeError("RESOURCE_EXHAUSTED: boom"), "oom"),
    (RuntimeError("UNAVAILABLE: socket"), "transient"),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     "fatal"),
    (RuntimeError("CUDA error: misaligned address"), "fatal"),
    (RuntimeError("CUDA error: device-side assert triggered"), "fatal"),
    (RuntimeError("CUDA error: unspecified launch failure"), "fatal"),
    (RuntimeError("CUDA error: an illegal instruction was encountered"),
     "fatal"),
    (RuntimeError("CUBLAS_STATUS_INTERNAL_ERROR when calling cublasSgemm"),
     "fatal"),
    (RuntimeError("CUDA error: CUBLAS_STATUS_ALLOC_FAILED when calling "
                  "cublasCreate(handle)"), "oom"),
    (RuntimeError("K1 vote launch failed: cudaError 700 for sites "
                  "[(4096, 3, 81)]"), "fatal"),
    (RuntimeError("K2 commit launch failed: cudaError 2 for sites []"),
     "fatal"),
    (ValueError("UNAVAILABLE"), "fatal"),
    (KeyError("x"), "fatal"),
    (CampaignWedgedError("hung"), "wedged"),
])
def test_retry_policy_classification(exc, kind):
    assert RetryPolicy().classify(exc) == kind
    # A sticky CUDA error stays fatal even where the caller lists its type
    # as transient.
    if kind == "fatal" and "CUDA error" in str(exc):
        assert RetryPolicy(transient_types=(RuntimeError,)).classify(
            exc) == "fatal"


def test_retry_policy_knobs_match_the_reference():
    from coast_tpu.inject import resilience as jres
    from coast_tpu_torch.inject import resilience as res
    assert res.OOM_PATTERNS == jres.OOM_PATTERNS
    assert res.TRANSIENT_PATTERNS == jres.TRANSIENT_PATTERNS
    flat = RetryPolicy(base_delay=1.0, max_delay=4.0, jitter=0.0)
    assert [flat.backoff(k) for k in (1, 2, 3, 4)] == [1.0, 2.0, 4.0, 4.0]
    assert RetryPolicy(oom_degrade=False).degraded_batch(100) is None
    assert RetryPolicy().degraded_batch(100) == 50
    assert RetryPolicy(min_batch_size=80).degraded_batch(100) == 80
    assert RetryPolicy().degraded_batch(1) is None
    for field in ("max_attempts", "base_delay", "max_delay", "jitter",
                  "collect_timeout", "oom_degrade", "min_batch_size"):
        assert getattr(RetryPolicy(), field) == getattr(jres.RetryPolicy(),
                                                        field)


@pytest.mark.parametrize("kw", [{"mesh": object()},
                                {"metrics": True}, {"profile": True},
                                {"slo": "sdc_rate<=0.1"}])
def test_unported_runner_features_name_their_item(kw):
    prog = ct.TMR(mm.make_region(), device="cpu")
    if "mesh" in kw:
        # Item 16 landed: mesh= promotes to the sharded runner, which
        # refuses anything but a Mesh, as the reference's refuses anything
        # but a jax Mesh.
        with pytest.raises(TypeError, match="Mesh"):
            CampaignRunner(prog, **kw)
    elif "metrics" in kw or "profile" in kw:
        # Item 18 landed: the live hub and the profiler are runner
        # options, fed by every collected batch.
        from coast_tpu_torch.obs import CampaignMetrics
        hub = CampaignMetrics()
        runner = CampaignRunner(prog, metrics=hub,
                                profile=kw.get("profile", False))
        res = runner.run(32, seed=0, batch_size=16)
        assert hub.snapshot()["done_rows"] == 32
        assert (res.profile is not None) == ("profile" in kw)
    else:
        # Item 19a landed: slo= attaches an SLO set to a hub the runner
        # makes, and the campaign lands the verdicts in its summary.
        runner = CampaignRunner(prog, **kw)
        res = runner.run(32, seed=0, batch_size=16)
        assert runner.metrics.slo_set.spec() == "sdc_rate<=0.1"
        assert res.summary()["slo"]["spec"] == "sdc_rate<=0.1"
    # Items 17b and 17c landed: run_delta with its static budget reaches
    # run_delta's own checks (an equivalence partition is needed).
    with pytest.raises(ValueError, match="equiv=True"):
        CampaignRunner(prog).run_delta(100, "base.ndjson",
                                       static_budget=True)


def test_spec_matches_the_reference():
    """CampaignSpec: the same fields and defaults, and the same header and
    queue-item encodings, as the reference's."""
    import dataclasses
    from coast_tpu.inject import spec as jspec
    from coast_tpu_torch.inject import spec
    fields = lambda c: [(f.name, f.default)  # noqa: E731
                        for f in dataclasses.fields(c)]
    assert fields(spec.CampaignSpec) == fields(jspec.CampaignSpec)
    for kw in ({}, {"fault_model": "multibit(k=3)", "collect": "sparse",
                    "stop_when": "sdc:0.01;min=64", "seed": 4},
               {"delta_from": "j.ndjson", "equiv": True, "batch_size": 7}):
        a = spec.CampaignSpec("mm", 100, **kw).validate()
        b = jspec.CampaignSpec("mm", 100, **kw).validate()
        assert json.dumps(a.to_item()) == json.dumps(b.to_item())
        assert a.run_header_fields() == b.run_header_fields()
        assert spec.CampaignSpec.from_item(a.to_item()) == a
        header = {"benchmark": "mm", **a.run_header_fields(),
                  "collect": a.collect}
        assert (dataclasses.asdict(spec.CampaignSpec.from_header(header))
                == dataclasses.asdict(jspec.CampaignSpec.from_header(header)))
    with pytest.raises(spec.SpecError):
        spec.CampaignSpec("mm", 0).validate()
