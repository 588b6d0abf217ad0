"""Fleet trace federation: one Perfetto timeline for a whole fleet run.

The port's copy of ``coast_tpu/obs/federate.py``: the same event names,
tracks and ``otherData`` keys, from the same durable records.

A fleet campaign's timing evidence is scattered: every worker records
its own spans into its own process, a SIGKILL'd worker's recorder dies
with it, and the queue's claim/complete timestamps live in the item
documents.  :func:`merge_traces` rebuilds ONE coherent timeline from
the **durable** records only -- the per-item campaign journals (whose
batch records carry ``(name, unix_start, duration)`` span triples) and
the queue item docs -- so the merged trace needs no cooperation
from the workers and survives any of them dying:

  * one Perfetto process per queue item (``item <id>
    benchmark/strategy``), its batch spans on a ``journal`` track;
  * the fleet queue as process 0: enqueue / claim / complete / fail
    instants per item plus one ``item <id>`` lease span from the last
    claim to completion (``lease_expires_unix`` in args);
  * **journal-anchored clock offsets**: span times inside one journal
    come from whichever worker's clock wrote each segment.  The journal
    record ORDER is the ground truth (batch ``lo`` is monotone within a
    campaign), so a resumed segment whose skewed clock would start
    *before* the previous segment's end is shifted forward to abut it
    -- the journal's one-coherent-timeline guarantee extended across
    workers.  Forward skew (a gap) is preserved: real requeue waits
    look exactly like that.  Applied offsets are recorded in
    ``otherData.clock_offsets``.
  * **exactly-once**: batch records are deduped by row offset (first
    record wins), so a SIGKILL'd+resumed worker's replayed batches --
    which resume deliberately does NOT re-append -- appear once no
    matter how many claims the item went through.

The output is the same trace_event JSON Object Format as
:mod:`coast_tpu_torch.obs.trace_export`; the fleet supervisor's
``--trace-out`` writes it after the merge.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

__all__ = ["merge_traces", "item_timeline", "write_merged_trace"]

#: Spans closer than this to the previous segment's end are treated as
#: in-order (journal fsync granularity), not a clock violation.
_SKEW_EPSILON_S = 1e-4


def item_timeline(journal_path: str
                  ) -> Tuple[List[Tuple[str, float, float, int]],
                             float]:
    """One item's aligned span timeline from its journal.

    Returns ``(spans, max_offset)``: spans as ``(name, unix_t0,
    duration_s, lo)`` with journal-anchored clock correction applied,
    and the largest forward offset any segment needed (0.0 for a
    skew-free journal).  Journals without batch records -- or without
    recorded span triples (telemetry off) -- yield an empty list.
    """
    from coast_tpu_torch.inject.journal import CampaignJournal, JournalError
    try:
        _header, records, _valid = CampaignJournal._load(journal_path)
    except (JournalError, OSError):
        return [], 0.0
    batches: Dict[int, List] = {}
    for rec in records:
        if rec.get("kind") != "batch":
            continue
        lo = int(rec.get("lo", 0))
        if lo in batches:
            continue               # exactly-once: first record wins
        spans = rec.get("spans") or []
        if spans:
            batches[lo] = spans
    out: List[Tuple[str, float, float, int]] = []
    offset = 0.0
    max_offset = 0.0
    prev_end: Optional[float] = None
    for lo in sorted(batches):
        spans = batches[lo]
        start = min(float(t) for _n, t, _d in spans)
        # A batch that begins before the previous batch ended (beyond
        # fsync jitter) was written by a clock behind the previous
        # segment's: re-anchor this segment to abut the journal order.
        if prev_end is not None and start + offset \
                < prev_end - _SKEW_EPSILON_S:
            offset = prev_end - start
            max_offset = max(max_offset, offset)
        end = prev_end if prev_end is not None else float("-inf")
        for name, t, dur in spans:
            t_adj = float(t) + offset
            out.append((str(name), t_adj, float(dur), lo))
            end = max(end, t_adj + float(dur))
        prev_end = end
    return out, max_offset


def merge_traces(queue) -> Dict[str, object]:
    """Merge every queue item's journal timeline plus the queue's own
    claim/lease/complete events into one trace_event document.

    ``queue`` is a :class:`~coast_tpu_torch.fleet.queue.CampaignQueue` or its
    root path.  Items in every state contribute (a claimed item's
    journal shows its progress so far); items without a readable
    journal contribute their queue events only.
    """
    from coast_tpu_torch.fleet.queue import CampaignQueue
    q = queue if not isinstance(queue, str) else CampaignQueue(queue)
    items: List[Dict[str, object]] = []
    for state in ("done", "failed", "claimed", "pending"):
        for rec in q.items(state):
            items.append({"state": state, **rec})
    items.sort(key=lambda r: str(r.get("id")))

    events: List[Dict[str, object]] = [{
        "name": "process_name", "ph": "M", "pid": 0, "tid": 1,
        "args": {"name": "fleet queue"},
    }]
    clock_offsets: Dict[str, float] = {}
    timelines: Dict[str, List[Tuple[str, float, float, int]]] = {}
    t_min = float("inf")
    for rec in items:
        item_id = str(rec.get("id"))
        spans, off = item_timeline(q.journal_path(item_id))
        timelines[item_id] = spans
        if off:
            clock_offsets[item_id] = round(off, 6)
        for _name, t, _dur, _lo in spans:
            t_min = min(t_min, t)
        for key in ("enqueued_unix", "claimed_unix", "completed_unix",
                    "failed_unix"):
            if rec.get(key):
                t_min = min(t_min, float(rec[key]))
    if t_min == float("inf"):
        t_min = 0.0

    def _us(t: float) -> float:
        return round((t - t_min) * 1e6, 3)

    for pid, rec in enumerate(items, start=1):
        item_id = str(rec.get("id"))
        result = rec.get("result") or {}
        spec = rec.get("spec") or {}
        label = (f"item {item_id} "
                 f"{result.get('benchmark') or spec.get('benchmark', '?')}"
                 + (f"/{result['strategy']}"
                    if result.get("strategy") else ""))
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 1, "args": {"name": label}})
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": 1, "args": {"name": "journal"}})
        for name, t, dur, lo in timelines[item_id]:
            events.append({
                "name": name, "cat": "journal", "ph": "X",
                "pid": pid, "tid": 1,
                "ts": _us(t), "dur": round(dur * 1e6, 3),
                "args": {"lo": lo},
            })
        # Queue lifecycle onto the fleet track: the claim/lease/complete
        # vocabulary of fleet/queue.py.
        for key, mark in (("enqueued_unix", "enqueue"),
                          ("claimed_unix", "claim"),
                          ("completed_unix", "complete"),
                          ("failed_unix", "fail")):
            if rec.get(key):
                events.append({
                    "name": f"{mark} {item_id}", "cat": "queue",
                    "ph": "i", "s": "t", "pid": 0, "tid": 1,
                    "ts": _us(float(rec[key])),
                    "args": {"item": item_id,
                             "worker": rec.get("worker")
                             or result.get("worker")},
                })
        if rec.get("claimed_unix") and rec.get("completed_unix"):
            events.append({
                "name": f"item {item_id}", "cat": "lease", "ph": "X",
                "pid": 0, "tid": 1,
                "ts": _us(float(rec["claimed_unix"])),
                "dur": round((float(rec["completed_unix"])
                              - float(rec["claimed_unix"])) * 1e6, 3),
                "args": {"worker": rec.get("worker")
                         or result.get("worker"),
                         "attempts": rec.get("attempts"),
                         "lease_expires_unix":
                             rec.get("lease_expires_unix")},
            })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"epoch_unix_s": round(t_min, 6),
                      "items": len(items),
                      "clock_offsets": clock_offsets},
    }


def write_merged_trace(queue, path: str) -> str:
    """``merge_traces`` + atomic write (tmp + rename, like every other
    fleet artifact -- a crash mid-dump must not leave a torn trace);
    returns ``path``."""
    from coast_tpu_torch.obs.metrics import atomic_write_json
    atomic_write_json(path, merge_traces(queue))
    return path
