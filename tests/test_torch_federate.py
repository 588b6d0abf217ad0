"""Fleet trace federation of the port (``coast_tpu_torch/obs/federate.py``)
against the reference's (``coast_tpu/obs/federate.py``).

On the same queue directory the two give the same trace document, event
for event; a journaled campaign each package runs through its own queue
gives the same event names and counts; a resumed journal's replayed
batches appear once, and a segment written by a clock behind the previous
one is re-anchored as the reference re-anchors it.
"""

import json
import os

import pytest
import torch

from coast_tpu_torch import TMR, obs
from coast_tpu_torch.fleet import CampaignQueue, item_spec
from coast_tpu_torch.inject.campaign import CampaignRunner
from coast_tpu_torch.models import mm
from coast_tpu_torch.obs import federate

torch.set_num_threads(1)


def _names(doc):
    counts = {}
    for e in doc["traceEvents"]:
        key = (e["ph"], e.get("cat"), e["name"].split(" ")[0])
        counts[key] = counts.get(key, 0) + 1
    return counts


@pytest.fixture(scope="module")
def queue(tmp_path_factory):
    """One journaled campaign of the port through its own queue."""
    root = tmp_path_factory.mktemp("fed")
    q = CampaignQueue(str(root / "q"))
    iid = q.enqueue(item_spec("matrixMultiply", 240, seed=17,
                              batch_size=48))
    assert q.claim("w0", lease_s=60).id == iid
    runner = CampaignRunner(TMR(mm.make_region(), device="cpu"),
                            strategy_name="TMR")
    res = runner.run(240, seed=17, batch_size=48,
                     journal=q.journal_path(iid))
    q.complete(iid, "w0", {"benchmark": res.benchmark,
                           "strategy": res.strategy,
                           "counts": dict(res.counts), "worker": "w0"})
    q.enqueue(item_spec("crc16", 16, seed=1))      # pending, no journal
    return q, iid


def test_merge_traces_equals_the_reference_on_one_queue(queue, tmp_path):
    from coast_tpu.obs import federate as jfederate
    q, iid = queue
    got = federate.merge_traces(q)
    assert json.dumps(got, sort_keys=True) == json.dumps(
        jfederate.merge_traces(q.root), sort_keys=True)
    spans = [e for e in got["traceEvents"] if e.get("cat") == "journal"]
    assert sorted({e["args"]["lo"] for e in spans
                   if e["name"] == "dispatch"}) == [0, 48, 96, 144, 192]
    marks = {e["name"].split(" ", 1)[0] for e in got["traceEvents"]
             if e.get("cat") == "queue"}
    assert marks == {"enqueue", "claim", "complete"}
    assert got["otherData"]["items"] == 2
    path = obs.write_merged_trace(q.root, str(tmp_path / "t.json"))
    assert json.load(open(path)) == got


def test_event_names_and_counts_equal_the_reference_run(queue, tmp_path):
    from coast_tpu import TMR as JTMR
    from coast_tpu.fleet import CampaignQueue as JQueue
    from coast_tpu.inject.campaign import CampaignRunner as JRunner
    from coast_tpu.models import mm as jmm
    from coast_tpu.obs import federate as jfederate
    jq = JQueue(str(tmp_path / "jq"))
    iid = jq.enqueue(item_spec("matrixMultiply", 240, seed=17,
                               batch_size=48))
    jq.claim("w0", lease_s=60)
    res = JRunner(JTMR(jmm.make_region()), strategy_name="TMR").run(
        240, seed=17, batch_size=48, journal=jq.journal_path(iid))
    jq.complete(iid, "w0", {"benchmark": res.benchmark,
                            "strategy": res.strategy,
                            "counts": dict(res.counts), "worker": "w0"})
    jq.enqueue(item_spec("crc16", 16, seed=1))
    assert _names(federate.merge_traces(queue[0])) \
        == _names(jfederate.merge_traces(jq.root))


def test_resumed_and_skewed_journal_timeline(tmp_path):
    """A journal whose second segment was written by a clock 50 s behind
    the first, with a replayed batch record: re-anchored and deduped as
    the reference does."""
    from coast_tpu.obs import federate as jfederate
    q = CampaignQueue(str(tmp_path / "q"))
    iid = q.enqueue(item_spec("matrixMultiply", 96, seed=2, batch_size=48))
    lines = [{"kind": "header", "mode": "run"}]
    for lo, t in ((0, 1000.0), (0, 1000.5), (48, 951.0)):
        lines.append({"kind": "batch", "lo": lo, "n": 48, "codes": [0] * 48,
                      "counts": {"success": lo + 48},
                      "spans": [["dispatch", t, 0.25], ["collect",
                                                        t + 0.25, 0.1]]})
    with open(q.journal_path(iid), "w") as fh:
        for rec in lines:
            fh.write(json.dumps(rec) + "\n")
    got_spans, got_off = federate.item_timeline(q.journal_path(iid))
    want = jfederate.item_timeline(q.journal_path(iid))
    assert (got_spans, got_off) == want
    assert [s[3] for s in got_spans] == [0, 0, 48, 48]
    assert got_off == pytest.approx(49.35)
    doc = federate.merge_traces(q)
    assert doc["otherData"]["clock_offsets"] == {iid: 49.35}
    assert federate.item_timeline(str(tmp_path / "missing")) == ([], 0.0)
    assert not os.path.exists(os.path.join(q.root, "done", f"{iid}.json"))
