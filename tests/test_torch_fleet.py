"""The port's campaign fleet (``coast_tpu_torch/fleet``) against the
reference's (``coast_tpu/fleet``).

The queue's files are the reference's, byte for byte where they are JSON:
an item either package enqueues, the other drains, and the done record's
``codes_sha256`` and counts are the same.  Claims are atomic under
concurrent claimants, the lease matrix (expiry, an observed death, a lost
renewal, an idempotent completion) behaves as the reference's, the compile
cache walks miss -> warm_hit -> persistent_hit without changing a record,
``merge_fleet`` re-derives every count from the journals and refuses a
tampered done record, the fleet telemetry equals the reference's reading
of the same queue, and a worker process SIGKILL'd mid-item is resumed by
a replacement to the sequential run's codes and counts.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from coast_tpu_torch.fleet import (CampaignQueue, CompileCache,
                                   FleetParityError, FleetTelemetry,
                                   LostLeaseError, QueueError, Worker,
                                   codes_sha256, item_spec, merge_fleet)

torch.set_num_threads(1)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mm_spec(n=200, seed=3, **kw):
    kw.setdefault("batch_size", 50)
    return item_spec("matrixMultiply", n, seed=seed, **kw)


def _worker(q, wid, **kw):
    return Worker(q, wid, max_retries=0, device="cpu", **kw)


def _sequential(spec, root):
    runner, _, _, _ = CompileCache(root, device="cpu").runner(spec)
    return runner.run(spec["n"], seed=spec["seed"],
                      batch_size=spec["batch_size"])


# -- item specs and the on-disk format ---------------------------------------

@pytest.mark.parametrize("kw", [{}, {"opt_passes": "-DWC", "seed": 9},
                                {"fault_model": "multibit(k=2)"},
                                {"equiv": True, "stop_when": "sdc:0.01"},
                                {"collect": "sparse", "throttle_s": 0.5}])
def test_item_spec_and_enqueue_bytes_equal_the_reference(kw, tmp_path):
    from coast_tpu.fleet import CampaignQueue as JQueue
    from coast_tpu.fleet import item_spec as jitem_spec
    spec = item_spec("crc16", 64, **kw)
    assert spec == jitem_spec("crc16", 64, **kw)
    q, jq = CampaignQueue(str(tmp_path / "t")), JQueue(str(tmp_path / "j"))
    ids = (q.enqueue(spec), jq.enqueue(spec))
    assert ids[0] == ids[1]
    docs = []
    for root in (q.root, jq.root):
        with open(os.path.join(root, "pending", f"{ids[0]}.json")) as fh:
            doc = json.load(fh)
        doc.pop("enqueued_unix")
        docs.append(json.dumps(doc, separators=(",", ":"), sort_keys=True))
    assert docs[0] == docs[1]
    assert sorted(os.listdir(q.root)) == sorted(os.listdir(jq.root))


def test_item_spec_validation():
    with pytest.raises(QueueError):
        item_spec("mm", 0)
    with pytest.raises(ValueError):
        item_spec("mm", 10, fault_model="nonsense(k=2)")
    with pytest.raises(QueueError):
        item_spec("mm", 10, fault_model="multibit(k=2)", equiv=True)


# -- queue semantics ---------------------------------------------------------

def test_claim_atomicity_under_concurrent_claimants(tmp_path):
    """Many claimants race over one pending set: every item is claimed
    exactly once (the rename arbitrates), none vanish, FIFO per thread."""
    q = CampaignQueue(str(tmp_path / "q"))
    ids = [q.enqueue(_mm_spec(seed=s)) for s in range(24)]
    got = {w: [] for w in range(8)}
    barrier = threading.Barrier(8)

    def claimant(w):
        barrier.wait()
        while True:
            item = q.claim(f"w{w}", lease_s=60)
            if item is None:
                return
            got[w].append(item.id)

    threads = [threading.Thread(target=claimant, args=(w,))
               for w in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    claimed = [iid for claims in got.values() for iid in claims]
    assert sorted(claimed) == sorted(ids) and len(claimed) == 24
    assert all(c == sorted(c) for c in got.values())
    assert q.stats() == {"pending": 0, "claimed": 24, "done": 0,
                         "failed": 0}


def _lease_trace(mod, root):
    """One walk through the lease matrix; returns what each step saw."""
    q = mod.CampaignQueue(root)
    spec = {"benchmark": "matrixMultiply", "n": 10}
    a, b = q.enqueue({**spec, "seed": 1}), q.enqueue({**spec, "seed": 2})
    out = [q.claim("w0", lease_s=30).id == a]
    with open(q.journal_path(a), "w") as fh:
        fh.write("{}\n")
    out.append(q.requeue_expired())                    # lease live
    out.append(q.requeue_expired(now=time.time() + 60) == [a])
    q.claim("w1", lease_s=-100)                        # expired at once
    out.append(q.requeue_expired())                    # the claim grace
    out.append(q.requeue_expired(now=time.time() + 60) == [a])
    item = q.claim("w1", lease_s=3600)
    out.append((item.id == a, item.attempts,
                os.path.exists(q.journal_path(a))))
    q.renew(a, "w1", lease_s=30)
    with pytest.raises(mod.LostLeaseError):
        q.renew(a, "w0")                               # someone else's
    q.claim("dead", lease_s=3600)
    out.append(q.requeue_worker("dead") == [b])
    out.append(q.requeue_worker("dead"))
    q.requeue_worker("w1")                             # observed death
    with pytest.raises(mod.LostLeaseError):
        q.renew(a, "w1")                               # claim vanished
    q.complete(a, "w1", {"counts": {"success": 2}})    # a slow finisher
    out.append(q.stats())
    out.append([q.claim("w2").id == b, q.claim("w3")])
    q.fail(b, "w2", "boom")
    out.append((q.stats(), q.drained(), q.items("failed")[0]["error"]))
    return out


def test_lease_matrix_equals_the_reference(tmp_path):
    import coast_tpu.fleet as jfleet
    import coast_tpu_torch.fleet as fleet
    got = _lease_trace(fleet, str(tmp_path / "t"))
    assert got == _lease_trace(jfleet, str(tmp_path / "j"))
    assert got[-1] == ({"pending": 0, "claimed": 0, "done": 1,
                        "failed": 1}, True, "boom")


def test_journal_lock_refused_while_held(tmp_path):
    from coast_tpu_torch.inject.journal import (CampaignJournal,
                                                JournalLockedError)
    jpath = str(tmp_path / "locked.journal")
    j = CampaignJournal.open(jpath, {"mode": "run", "seed": 1})
    with pytest.raises(JournalLockedError):
        CampaignJournal.open(jpath, {"mode": "run", "seed": 1})
    j.close()
    CampaignJournal.open(jpath, {"mode": "run", "seed": 1}).close()


# -- compile cache -----------------------------------------------------------

def test_compile_cache_hit_paths_equivalent(tmp_path):
    """miss -> warm_hit -> persistent_hit, the same records every time;
    the key holds the torch version and the device, never the jax ones."""
    root = str(tmp_path / "cache")
    spec = _mm_spec(n=120, seed=5)
    cache = CompileCache(root, device="cpu")
    r1, strategy, key, ev1 = cache.runner(spec)
    assert (ev1, strategy) == ("miss", "TMR")
    cold = r1.run(120, seed=5, batch_size=50)
    cache.mark_compiled(key, spec)
    r2, _, key2, ev2 = cache.runner(spec)
    assert ev2 == "warm_hit" and key2 == key and r2 is r1
    warm = r2.run(120, seed=5, batch_size=50)
    cache2 = CompileCache(root, device="cpu")
    r3, _, key3, ev3 = cache2.runner(spec)
    assert ev3 == "persistent_hit" and key3 == key and r3 is not r1
    persist = r3.run(120, seed=5, batch_size=50)
    for res in (warm, persist):
        np.testing.assert_array_equal(cold.codes, res.codes)
        assert cold.counts == res.counts
    assert cache.snapshot()["hits"] == 1 and cache.snapshot()["misses"] == 1
    assert cache2.counters == {"warm_hit": 0, "persistent_hit": 1,
                               "miss": 0}
    ledger = json.load(open(os.path.join(root, "keys", f"{key}.json")))
    assert ledger["format"] == "coast-fleet-compile-key"
    r_dwc, s_dwc, k_dwc, ev_dwc = cache.runner(_mm_spec(opt_passes="-DWC"))
    assert (s_dwc, ev_dwc) == ("DWC", "miss") and k_dwc != key


# -- worker, merge, telemetry ------------------------------------------------

@pytest.fixture(scope="module")
def drained(tmp_path_factory):
    """Two mm items drained in process by one port worker."""
    root = tmp_path_factory.mktemp("fleet")
    q = CampaignQueue(str(root / "q"))
    specs = [_mm_spec(n=150, seed=s) for s in (3, 4)]
    ids = [q.enqueue(spec) for spec in specs]
    w = _worker(q, "w0")
    assert w.drain() == 2
    return q, specs, ids, w, root


def test_worker_drains_and_merge_parity(drained):
    q, specs, ids, w, root = drained
    assert q.drained() and w.cache.counters["warm_hit"] == 1
    result = merge_fleet(q)
    assert result["parity"] == "ok" and len(result["items"]) == 2
    for item, spec in zip(result["items"], specs):
        ref = _sequential(spec, str(root / "refcache"))
        assert item["codes_sha256"] == codes_sha256(ref.codes)
        assert item["counts"] == {k: int(v) for k, v in ref.counts.items()}
    from coast_tpu.fleet import merge_fleet as jmerge
    want = jmerge(q.root)
    assert json.dumps(result, sort_keys=True) == json.dumps(
        want, sort_keys=True)


def test_fleet_telemetry_equals_the_reference(drained):
    from coast_tpu.fleet import FleetTelemetry as JTelemetry
    q = drained[0]
    spec = "sdc_rate<=0.5,availability>=0.5;min=8"
    got = FleetTelemetry(q, slo=spec).snapshot()
    want = JTelemetry(q.root, slo=spec).snapshot()
    for doc in (got, want):
        doc.pop("updated_unix_s")
        for w in doc["workers"]:
            w.pop("age_s")
    assert got == want and got["slo"]["verdict"] == "ok"
    prom = FleetTelemetry(q, slo=spec).prometheus()
    jprom = JTelemetry(q.root, slo=spec).prometheus()
    assert prom == jprom and "coast_fleet_slo_verdict" in prom


def test_merge_refuses_a_tampered_done_record(drained, tmp_path):
    import shutil
    q = drained[0]
    copy = CampaignQueue(shutil.copytree(q.root, str(tmp_path / "q")))
    iid = drained[2][0]
    path = os.path.join(copy.root, "done", f"{iid}.json")
    doc = json.load(open(path))
    doc["result"]["counts"]["success"] += 1
    json.dump(doc, open(path, "w"))
    with pytest.raises(FleetParityError, match="cumulative counts"):
        merge_fleet(copy)
    doc["result"]["codes_sha256"] = "0" * 64
    json.dump(doc, open(path, "w"))
    with pytest.raises(FleetParityError, match="codes sha"):
        merge_fleet(copy)
    from coast_tpu_torch.fleet.supervisor import main
    assert main(["merge", "--queue", copy.root]) == 1


def test_worker_fails_an_unbuildable_item(tmp_path):
    q = CampaignQueue(str(tmp_path / "q"))
    q.enqueue(item_spec("noSuchBenchmark", 10))
    assert _worker(q, "w0").drain() == 0
    assert q.stats()["failed"] == 1 and q.drained()
    assert "build" in q.items("failed")[0]["error"]


@pytest.mark.parametrize("direction", ["reference_enqueues",
                                       "port_enqueues"])
def test_cross_package_item_drains_to_the_same_record(direction, tmp_path):
    """An item one package enqueues, the other drains in process: the
    done record's codes sha and counts are those of the enqueuer's own
    drain of the same item."""
    from coast_tpu.fleet import CampaignQueue as JQueue
    from coast_tpu.fleet import Worker as JWorker
    from coast_tpu.fleet import item_spec as jitem_spec
    make = jitem_spec if direction == "reference_enqueues" else item_spec
    spec = make("crc16", 96, seed=11, batch_size=48, opt_passes="-DWC")
    records = {}
    for who, queue_cls, drain in (
            ("port", JQueue if direction == "reference_enqueues"
             else CampaignQueue,
             lambda q: _worker(CampaignQueue(q.root), "w").drain()),
            ("ref", CampaignQueue if direction == "reference_enqueues"
             else JQueue,
             lambda q: JWorker(q.root, "w", max_retries=0).drain())):
        q = queue_cls(str(tmp_path / who))
        iid = q.enqueue(spec)
        assert drain(q) == 1
        with open(os.path.join(q.root, "done", f"{iid}.json")) as fh:
            records[who] = json.load(fh)["result"]
    for key in ("codes_sha256", "counts", "injections", "benchmark",
                "strategy"):
        assert records["port"][key] == records["ref"][key], key


# -- a worker process SIGKILL'd mid-item -------------------------------------

def _spawn_worker(queue_root, worker_id):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, "-m", "coast_tpu_torch.fleet", "worker",
         "--queue", queue_root, "--worker-id", worker_id, "--lease", "60",
         "--device", "cpu"], env=env, cwd=REPO_ROOT,
        stderr=subprocess.PIPE, text=True)


def test_sigkill_resume_parity(tmp_path):
    q = CampaignQueue(str(tmp_path / "q"))
    spec_killed = _mm_spec(n=300, seed=7, throttle_s=0.25)
    spec_other = _mm_spec(n=150, seed=8)
    iid = q.enqueue(spec_killed)
    other = q.enqueue(spec_other)
    victim = _spawn_worker(q.root, "victim")
    jpath = q.journal_path(iid)
    deadline = time.time() + 100
    try:
        while time.time() < deadline:
            if os.path.exists(jpath) and sum(
                    1 for line in open(jpath, "rb")
                    if b'"kind":"batch"' in line) >= 2:
                break
            time.sleep(0.05)
        else:
            pytest.fail("the victim worker never journaled two batches")
        victim.kill()
    finally:
        victim.wait(timeout=30)
    assert q.requeue_worker("victim") == [iid]
    size_at_kill = os.path.getsize(jpath)
    rescuer = _worker(q, "rescuer")
    rescuer.drain()
    assert q.drained() and q.stats()["done"] == 2
    assert rescuer.cache.hits >= 1          # the victim recorded the key
    assert os.path.getsize(jpath) > size_at_kill     # resumed, not redone
    result = merge_fleet(q)
    by_id = {item["id"]: item for item in result["items"]}
    assert by_id[iid]["attempts"] == 2
    for item_id, spec in ((iid, spec_killed), (other, spec_other)):
        ref = _sequential(spec, str(tmp_path / "refcache"))
        assert by_id[item_id]["codes_sha256"] == codes_sha256(ref.codes)
        assert by_id[item_id]["counts"] == {
            k: int(v) for k, v in ref.counts.items()}


# -- the CLI -----------------------------------------------------------------

def test_cli_enqueue_run_status_merge(tmp_path, capfd):
    from coast_tpu_torch.fleet.supervisor import main
    qroot = str(tmp_path / "q")
    assert main(["run", "--queue", qroot, "--workers", "1"]) == 1
    assert main(["enqueue", "--queue", qroot, "-f", "crc16", "-O", "-TMR",
                 "-t", "64", "--seed", "2", "--batch-size", "32",
                 "--count", "2"]) == 0
    assert len(capfd.readouterr().out.split()) == 2
    assert main(["enqueue", "--queue", qroot, "-f", "crc16", "-t", "8",
                 "--delta-from", "j", "--count", "2"]) == 1
    trace = str(tmp_path / "fleet.trace.json")
    assert main(["run", "--queue", qroot, "--workers", "1", "--lease", "20",
                 "--poll", "0.2", "-d", "cpu", "--slo", "sdc_rate<=0.9",
                 "--status-json", str(tmp_path / "s.json"),
                 "--trace-out", trace]) == 0
    out = capfd.readouterr()
    assert "parity ok" in out.out and "kernel launches K1 0, K2 0" in out.err
    artifact = json.load(open(os.path.join(qroot, "fleet_result.json")))
    assert artifact["parity"] == "ok" and artifact["injections"] == 128
    assert artifact["cache"] == {"miss": 1, "warm_hit": 1, "hits": 1,
                                 "misses": 1}
    status = json.load(open(tmp_path / "s.json"))
    assert status["queue"]["done"] == 2 and status["slo"]["verdict"] == "ok"
    names = {e["name"].split(" ")[0]
             for e in json.load(open(trace))["traceEvents"]}
    assert {"enqueue", "claim", "complete", "dispatch"} <= names
    assert main(["status", "--queue", qroot]) == 0
    assert json.loads(capfd.readouterr().out)["injections_done"] == 128
    assert main(["merge", "--queue", qroot]) == 0
