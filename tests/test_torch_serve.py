"""The port's continuous-protection serving (``coast_tpu_torch/serve``)
against the reference's (``coast_tpu/serve``), on the CPU.

Parity is on codes, digests and counts, never on rates or the measured
strategy choice (requests pin their strategy, or a test drives the DWC
path through ``detect_hook``): the admission queue orders and requeues as
the reference's; the response digest equals a numpy model of the
reference's formula (words at and above 2^31, lengths that are not powers
of two) and the reference's own ``jnp`` on int32 and float32 words; the
same request stream gives the reference engine's responses, and each
strategy's injection-lane codes equal the reference's; a serve journal
written by the reference resumes under the port; a SIGKILL'd ``python -m
coast_tpu_torch serve`` resumes bit for bit; the summary's ``serving``
block has the reference's keys and renders in both parsers; and the HTTP
front answers.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from coast_tpu_torch.serve import (AdmissionQueue, IsolationRefusedError,
                                   ServeEngine, ServeFront, ServeMetrics,
                                   ServeRequest)
from coast_tpu_torch.serve.admission import REJECT_DEADLINE, REJECT_SLA
from coast_tpu_torch.serve.engine import response_digest

torch.set_num_threads(1)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = "matrixMultiply"


def _engine(**kw):
    kw.setdefault("batch_size", 16)
    kw.setdefault("inject_share", 0.5)
    kw.setdefault("inject_n", 64)
    kw.setdefault("seed", 5)
    kw.setdefault("device", "cpu")
    return ServeEngine(BENCH, **kw)


def _ref_engine(**kw):
    from coast_tpu.serve import ServeEngine as JEngine
    kw.setdefault("batch_size", 16)
    kw.setdefault("inject_share", 0.5)
    kw.setdefault("inject_n", 64)
    kw.setdefault("seed", 5)
    return JEngine(BENCH, **kw)


def _wait(reqs, timeout_s=60.0):
    for req in reqs:
        assert req.done.wait(timeout_s), f"request {req.rid} hung"
    return reqs


def _stream(engine, n=8):
    """n requests, strategies pinned alternately; returns responses."""
    reqs = [engine.submit(f"req-{i:02d}", sla_s=60.0,
                          strategy=("DWC", "TMR")[i % 2])
            for i in range(n)]
    return [r.response for r in _wait(reqs)]


# -- admission ----------------------------------------------------------------

def _drive_queue(queue_cls, req_cls, deadlines, now):
    """Submit, take in chunks, requeue every third admitted request once:
    the rid sequence every take returns."""
    q = queue_cls(("DWC", "TMR"))
    for rid, (dl, strat) in enumerate(deadlines):
        q.submit(req_cls(rid=rid, payload=str(rid), sla_s=dl - now,
                         deadline=dl, t_submit=now, strategy=strat))
    seq, requeued = [], set()
    t = now
    while q.pending():
        for strat in ("DWC", "TMR"):
            admitted, expired = q.take(strat, 3, t)
            seq.append((strat, [r.rid for r in admitted],
                        [r.rid for r in expired]))
            for r in admitted:
                if r.rid % 3 == 0 and r.rid not in requeued:
                    requeued.add(r.rid)
                    q.requeue(r)
        t += 0.5
    return seq


def test_admission_order_and_requeue_equal_the_reference():
    from coast_tpu.serve.admission import AdmissionQueue as JQueue
    from coast_tpu.serve.admission import ServeRequest as JRequest
    rng = np.random.default_rng(3)
    now = 1000.0
    deadlines = [(now + float(rng.uniform(0.0, 6.0)),
                  ("DWC", "TMR")[int(rng.integers(2))]) for _ in range(40)]
    mine = _drive_queue(AdmissionQueue, ServeRequest, deadlines, now)
    assert mine == _drive_queue(JQueue, JRequest, deadlines, now)
    assert any(exp for _, _, exp in mine)       # some expire on the way


def test_admission_queue_refuses_an_unknown_strategy():
    q = AdmissionQueue(("DWC",))
    with pytest.raises(ValueError, match="unknown strategy"):
        q.submit(ServeRequest(rid=1, payload="x", sla_s=1.0, deadline=1.0,
                              t_submit=0.0, strategy="TMR"))


def test_deadline_expired_request_is_rejected():
    with _engine(inject_share=0.0, inject_n=0) as engine:
        req = engine.submit("too-late", sla_s=1e-9)
        assert req.done.wait(30.0)
        assert req.response is None and req.error == REJECT_DEADLINE
        assert engine.metrics.rejected.get(REJECT_DEADLINE, 0) == 1
        ok = engine.submit("in-time", sla_s=30.0)
        assert ok.done.wait(60.0) and ok.response is not None
        assert ok.response["class"] == "success"


def test_saturation_sheds_injection_never_requests():
    with _engine(batch_size=8, inject_n=1_000_000) as engine:
        reqs = _wait([engine.submit(f"sat-{i}", sla_s=60.0)
                      for i in range(48)], timeout_s=120.0)
        m = engine.metrics
        assert all(r.response is not None for r in reqs), \
            [(r.rid, r.error) for r in reqs if r.response is None]
        assert m.served == 48
        assert m.shed_inject_lanes > 0 and m.saturated_dispatches > 0
        assert m.lane_leak_violations == 0 and m.lane_leak_checks > 0


# -- DWC detect-and-retry, escalation, rejection (detect_hook) ---------------

def test_dwc_detection_retries_when_rerun_fits_sla():
    seen = set()

    def hook(req, code):
        if req.rid in seen:
            return False
        seen.add(req.rid)
        return True

    with _engine() as engine:
        engine.detect_hook = hook
        req = engine.submit("flaky", sla_s=60.0, strategy="DWC")
        assert req.done.wait(60.0) and req.response is not None
        assert req.response["strategy"] == "DWC"
        assert req.retries == 1 and engine.metrics.retries == 1
        assert engine.metrics.escalations == 0


def test_dwc_detection_escalates_to_tmr_when_retry_blows_sla():
    with _engine(retry_factor=1e6) as engine:
        engine.detect_hook = lambda req, code: True
        req = engine.submit("hot", sla_s=30.0, strategy="DWC")
        assert req.done.wait(60.0) and req.response is not None, req.error
        assert req.response["strategy"] == "TMR"
        assert req.escalated and req.retries == 0
        assert engine.metrics.escalations == 1
        assert engine.metrics.strategy_mix.get("TMR", 0) == 1


def test_detection_rejects_when_nothing_fits():
    with _engine(retry_factor=1e6, strategies=("DWC",)) as engine:
        engine.detect_hook = lambda req, code: True
        req = engine.submit("doomed", sla_s=0.2, strategy="DWC")
        assert req.done.wait(60.0)
        assert req.response is None
        assert req.error in (REJECT_SLA, REJECT_DEADLINE)


def test_detection_retry_is_journaled(tmp_path):
    seen = set()

    def hook(req, code):
        first = req.rid not in seen
        seen.add(req.rid)
        return first

    with _engine(journal_dir=str(tmp_path)) as engine:
        engine.detect_hook = hook
        req = engine.submit("flaky", sla_s=60.0, strategy="DWC")
        assert req.done.wait(60.0) and req.response is not None
        assert engine.drain_injection(timeout_s=120.0), engine.error
    recs = [json.loads(ln) for ln in
            open(tmp_path / "serve-DWC.journal") if ln.strip()]
    assert {"kind": "serve_retry", "rid": req.rid, "attempt": 1,
            "strategy": "DWC"} in recs


# -- construction gate --------------------------------------------------------

def test_prover_refusal_gates_construction():
    from coast_tpu_torch.analysis.propagation import seeded_voter_bypass
    with pytest.raises(IsolationRefusedError, match="REFUTED"):
        with seeded_voter_bypass():
            ServeEngine(BENCH, batch_size=16, inject_share=0.0,
                        inject_n=0, strategies=("TMR",), device="cpu")


@pytest.mark.parametrize("share", [1.5, -0.1])
def test_bad_inject_share_rejected(share):
    with pytest.raises(ValueError, match="inject_share"):
        ServeEngine(BENCH, inject_share=share, device="cpu")


def test_cuda_engine_refused_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device would run")
    with pytest.raises(RuntimeError):
        ServeEngine(BENCH, inject_share=0.0, inject_n=0)


# -- the response digest ------------------------------------------------------

def _np_digest(words: np.ndarray) -> np.ndarray:
    """The reference's formula in numpy uint64: XOR over i of
    (word_i * ((i * 2654435761) | 1)) mod 2^32, words read as uint32."""
    w = words.astype(np.uint32).astype(np.uint64)
    idx = np.arange(w.shape[1], dtype=np.uint64)
    mult = ((idx * np.uint64(2654435761)) & np.uint64(0xFFFFFFFF)) \
        | np.uint64(1)
    mixed = (w * mult) & np.uint64(0xFFFFFFFF)
    return np.bitwise_xor.reduce(mixed, axis=1) if w.shape[1] \
        else np.zeros(w.shape[0], np.uint64)


@pytest.mark.parametrize("width", [0, 1, 2, 7, 81, 1000, 1025])
def test_digest_equals_the_numpy_model(width):
    rng = np.random.default_rng(width)
    words = rng.integers(-2**31, 2**31, size=(5, width), dtype=np.int64
                         ).astype(np.int32)
    if width:
        words[0, :] = -1                      # 0xFFFFFFFF everywhere
        words[1, 0] = np.int32(-2**31)        # 0x80000000
    got = response_digest(torch.from_numpy(words)).numpy()
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got.astype(np.uint64), _np_digest(words))
    assert (got >= 0).all() and (got < 2**32).all()
    if width:
        assert (words.astype(np.int64) < 0).any()   # words >= 2^31


@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_digest_equals_the_reference_jnp(dtype):
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(7)
    if dtype == "int32":
        out = rng.integers(-2**31, 2**31, size=(4, 81), dtype=np.int64
                           ).astype(np.int32)
    else:
        out = (rng.standard_normal((4, 81)) * 3e9).astype(np.float32)
        out[0, :4] = [np.nan, -np.inf, np.inf, -0.5]

    def ref(o):                              # coast_tpu/serve/engine.py
        o = o.astype(jnp.uint32)
        idx = jnp.arange(o.shape[0], dtype=jnp.uint32)
        mixed = o * ((idx * jnp.uint32(2654435761)) | jnp.uint32(1))
        return jax.lax.reduce(mixed, jnp.uint32(0), jnp.bitwise_xor, (0,))

    want = np.asarray(jax.vmap(ref)(jnp.asarray(out))).astype(np.int64)
    np.testing.assert_array_equal(
        response_digest(torch.from_numpy(out)).numpy(), want)


# -- parity with the reference engine -----------------------------------------

def test_same_stream_equals_the_reference_engine(tmp_path):
    with _engine(journal_dir=str(tmp_path / "port")) as engine:
        mine = _stream(engine)
        assert engine.drain_injection(timeout_s=120.0), engine.error
        codes = {s: engine.lane_codes(s) for s in ("DWC", "TMR")}
        summary = engine.summary()
    with _ref_engine(journal_dir=str(tmp_path / "ref")) as jengine:
        theirs = _stream(jengine)
        assert jengine.drain_injection(timeout_s=120.0), jengine.error
        jcodes = {s: jengine.lane_codes(s) for s in ("DWC", "TMR")}
        jsummary = jengine.summary()
    assert json.dumps(mine, sort_keys=True) \
        == json.dumps(theirs, sort_keys=True)
    assert {r["class"] for r in mine} == {"success"}
    for s in ("DWC", "TMR"):
        assert len(codes[s]) == 64
        np.testing.assert_array_equal(codes[s], jcodes[s])
    assert summary["counts"] == jsummary["counts"]
    assert summary["proofs"].keys() == jsummary["proofs"].keys()
    assert all(p["holds"] for p in summary["proofs"].values())


def test_digest_is_the_fault_free_outputs(tmp_path):
    """Every served digest is the digest of a fault-free run's output."""
    from coast_tpu_torch.inject.supervisor import build_program
    with _engine(inject_share=0.0, inject_n=0) as engine:
        responses = _stream(engine, n=4)
    for resp in responses:
        prog, _ = build_program(BENCH, f"-{resp['strategy']}", "cpu")
        rec = prog.run_batch(batch=1)
        assert resp["digest"] == int(response_digest(rec["output"])[0])


def test_responses_byte_identical_with_injection_on_and_off():
    streams = []
    for share in (0.5, 0.0):
        with _engine(inject_share=share) as engine:
            streams.append(json.dumps(_stream(engine, 10), sort_keys=True))
    assert streams[0] == streams[1]


def _truncate_to_batches(path, keep):
    lines = open(path).read().splitlines()
    kept, batches = [], 0
    for ln in lines:
        if json.loads(ln).get("kind") == "batch":
            if batches == keep:
                break
            batches += 1
        kept.append(ln)
    with open(path, "w") as fh:
        fh.write("\n".join(kept) + "\n")
    return batches


def test_reference_serve_journal_resumes_under_the_port(tmp_path):
    jdir = str(tmp_path / "j")
    with _ref_engine(journal_dir=jdir) as jengine:
        assert jengine.drain_injection(timeout_s=120.0), jengine.error
        want = {s: jengine.lane_codes(s) for s in ("DWC", "TMR")}
    for s in ("DWC", "TMR"):
        assert _truncate_to_batches(
            os.path.join(jdir, f"serve-{s}.journal"), 3) == 3
    with _engine(journal_dir=jdir) as engine:
        lane = engine._lanes["DWC"]
        assert 0 < lane.cursor < 64          # replayed a prefix
        assert engine.drain_injection(timeout_s=120.0), engine.error
        got = {s: engine.lane_codes(s) for s in ("DWC", "TMR")}
    for s in ("DWC", "TMR"):
        np.testing.assert_array_equal(got[s], want[s])


def test_sigkilled_server_resumes_journal_bit_for_bit(tmp_path):
    inject_n, batch, seed = 512, 16, 5
    jdir = str(tmp_path / "journals")
    proc = subprocess.Popen(
        [sys.executable, "-m", "coast_tpu_torch", "serve", BENCH,
         "--port", "0", "--batch-size", str(batch),
         "--inject-share", "0.5", "--seed", str(seed),
         "--inject-n", str(inject_n), "--journal-dir", jdir,
         "--idle-throttle", "0.05", "--duration", "300", "-d", "cpu"],
        cwd=REPO_ROOT, env={**os.environ, "PYTHONPATH": REPO_ROOT},
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    path = os.path.join(jdir, "serve-DWC.journal")
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            if os.path.exists(path) and sum(
                    1 for _ in open(path, "rb")) >= 2:
                break                   # header + at least one batch
            assert proc.poll() is None, "serve process died early"
            time.sleep(0.02)
        else:
            raise AssertionError("standing journal never appeared")
    finally:
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(30)
    assert proc.returncode == -signal.SIGKILL

    def codes_after_full_run(journal_dir):
        with _engine(batch_size=batch, seed=seed, inject_n=inject_n,
                     journal_dir=journal_dir) as engine:
            resumed = engine._lanes["DWC"].cursor
            assert engine.drain_injection(timeout_s=120.0), engine.error
            return resumed, {s: engine.lane_codes(s)
                             for s in ("DWC", "TMR")}

    resumed_at, resumed = codes_after_full_run(jdir)
    assert 0 < resumed_at < inject_n        # killed mid-campaign
    _, fresh = codes_after_full_run(str(tmp_path / "fresh"))
    for s in ("DWC", "TMR"):
        assert len(resumed[s]) == inject_n
        np.testing.assert_array_equal(resumed[s], fresh[s])


# -- artifact shape -----------------------------------------------------------

def _key_tree(doc):
    if isinstance(doc, dict):
        return {k: _key_tree(v) for k, v in doc.items()}
    return type(doc).__name__ if isinstance(doc, (list, str, bool)) \
        else "number"


def test_summary_serving_block_has_the_reference_keys(tmp_path):
    from coast_tpu.analysis.json_parser import summarize_path as jsummarize
    from coast_tpu.serve import ServeMetrics as JMetrics
    from coast_tpu_torch.analysis.json_parser import summarize_path
    with _engine(metrics=ServeMetrics(slo="sdc_rate<=0.9;min=8")) as engine:
        _stream(engine, 2)
        assert engine.drain_injection(timeout_s=120.0), engine.error
        doc = engine.summary()
        status = engine.metrics.snapshot()
    with _ref_engine(metrics=JMetrics(slo="sdc_rate<=0.9;min=8")) as je:
        _stream(je, 2)
        assert je.drain_injection(timeout_s=120.0), je.error
        jdoc = je.summary()
        jstatus = je.metrics.snapshot()
    assert _key_tree(doc["serving"]) == _key_tree(jdoc["serving"])
    assert doc["serving"]["inject"] == jdoc["serving"]["inject"]
    assert doc["serving"]["requests"] == jdoc["serving"]["requests"]
    assert sorted(doc) == sorted(jdoc)
    assert doc["slo"]["verdict"] == jdoc["slo"]["verdict"] == "ok"
    assert status["format"] == jstatus["format"] == "coast-serve-status"
    assert sorted(status) == sorted(jstatus)
    # Each package's parser renders each package's recorded block.
    for i, d in enumerate((doc, jdoc)):
        path = tmp_path / f"run{i}.json"
        path.write_text(json.dumps({"summary": {
            "format": "ndjson", "injections": 0,
            "benchmark": d["benchmark"], "counts": d["counts"],
            "serving": d["serving"], "slo": d.get("slo")}, "runs": []}))
        for summarize in (summarize_path, jsummarize):
            s = summarize(str(path))
            assert s.serving == d["serving"]
            text = s.format()
            assert "--- serving ---" in text and "live sdc" in text


def test_metrics_text_has_the_reference_rows():
    from coast_tpu.serve import ServeMetrics as JMetrics
    rows = []
    for metrics in (ServeMetrics(), JMetrics()):
        metrics.note_admitted("DWC")
        metrics.note_served(0.01)
        metrics.note_rejected(REJECT_SLA)
        metrics.note_escalation()
        metrics.note_dispatch(4, 2, True)
        metrics.note_lane_leak_check()
        rows.append([ln.split(" ")[0] for ln in
                     metrics.prometheus().splitlines()
                     if ln.startswith("coast_serve_")])
    assert rows[0] == rows[1] and rows[0]


def test_http_front_answers():
    metrics = ServeMetrics(slo="sdc_rate<=0.9;min=8")
    engine = _engine(metrics=metrics)
    with ServeFront(engine, port=0) as front:
        body = json.dumps({"payload": "http-req", "sla_s": 30.0,
                           "strategy": "TMR"}).encode()
        req = urllib.request.Request(
            front.url + "/v1/infer", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60.0) as resp:
            assert resp.status == 200
            answer = json.loads(resp.read())
        assert answer["payload"] == "http-req"
        assert answer["class"] == "success" and answer["strategy"] == "TMR"
        with urllib.request.urlopen(front.url + "/status",
                                    timeout=10.0) as resp:
            status = json.loads(resp.read())
        assert status["format"] == "coast-serve-status"
        assert status["serving"]["requests"]["served"] >= 1
        with urllib.request.urlopen(front.url + "/metrics",
                                    timeout=10.0) as resp:
            prom = resp.read().decode()
        for row in ("coast_serve_served_total",
                    "coast_serve_lane_leak_violations_total 0",
                    "coast_serve_request_latency_seconds_count"):
            assert row in prom
        with urllib.request.urlopen(front.url + "/healthz",
                                    timeout=10.0) as resp:
            assert b"POST /v1/infer" in resp.read()
        bad = urllib.request.Request(
            front.url + "/v1/infer",
            data=json.dumps({"payload": "x", "strategy": "NMR"}).encode())
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad, timeout=10.0)
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(front.url + "/nope", timeout=10.0)
        assert e.value.code == 404
