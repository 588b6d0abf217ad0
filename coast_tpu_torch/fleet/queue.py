"""Crash-safe file-based campaign queue: the fleet's work ledger.

The port's copy of ``coast_tpu/fleet/queue.py``, with the same on-disk
layout and the same JSON bytes, so either package can drain a queue the
other wrote. The reference platform ran ``-t N`` parallel QEMU workers
inside ONE supervisor process (supervisor.py:335); a fleet of
*processes* needs the work list itself to be durable and contention-
safe. This queue is a directory of one-JSON-file-per-item with rename-
based state transitions -- ``os.rename`` within a filesystem is atomic,
so a state change either happened or it did not, with no locks, no
daemons, and no database:

    <root>/pending/<id>.json    enqueued, claimable
    <root>/claimed/<id>.json    leased to a worker (worker + expiry inside)
    <root>/done/<id>.json       completed (result summary inside)
    <root>/failed/<id>.json     failed terminally (error inside)
    <root>/journals/<id>.journal  the item's CampaignJournal
    <root>/status/<worker>.json   per-worker live status (fleet telemetry)
    <root>/cache/               shared compile cache (fleet.compile_cache)

**Item identity is the journal's identity.**  An item spec is the
:class:`~coast_tpu_torch.inject.spec.CampaignSpec` identity vocabulary in its
queue-item encoding -- benchmark, opt flags (the protection-config
source), section, seed/n/start_num, fault-model spec, equiv flag,
stop-when spec -- so the worker that claims an item can
regenerate the campaign and the journal header validates it, and a
*different* worker resuming after a SIGKILL regenerates the *same*
campaign bit-for-bit (the journal refuses anything else).

**Claim** is first-come-first-served over the sorted pending listing:
each claimant tries ``rename(pending/x, claimed/x)``; exactly one
succeeds per item (the losers get ``FileNotFoundError`` and move on).
**Lease**: the claimed file records the worker and an expiry; the worker
renews it from its progress heartbeat.  **Requeue**: an expired lease
(worker died, or was SIGKILL'd) renames the item back to pending --
the journal survives, so the next claimant resumes instead of
restarting.  A slow-but-alive worker whose lease was wrongly reaped is
harmless: the journal's exclusive flock (JournalLockedError) keeps the
duplicate claimant out of the append stream, and completion is
idempotent (``done`` is written atomically from the journal-backed
result, identical whichever attempt lands it).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Dict, List, Optional

from coast_tpu_torch.inject.spec import CampaignSpec, SpecError
from coast_tpu_torch.obs.metrics import atomic_write_json

__all__ = ["QueueError", "LostLeaseError", "QueueItem", "CampaignQueue",
           "item_spec"]

#: Item states, in directory form.  ``pending`` and ``claimed`` are the
#: live states; ``done`` and ``failed`` are terminal.
STATES = ("pending", "claimed", "done", "failed")

#: A claim's rename and its lease write are two steps (claim()'s
#: ms-scale window), and a requeued item still carries its previous
#: attempt's expired lease until the new claimant's write lands.  So
#: reapers never trust the recorded lease alone: the claim rename
#: refreshes the file's ctime, and anything whose ctime is within this
#: grace is a claim in progress, not an expired one -- reaping it would
#: leave the winner holding a claim the queue no longer records.
CLAIM_WRITE_GRACE_S = 5.0


class QueueError(RuntimeError):
    """Queue misuse or an unreadable/corrupt item file."""


class LostLeaseError(QueueError):
    """The worker's claim on an item vanished (lease reaped and the item
    requeued, or completed by another attempt) -- the worker must stop
    touching it."""


def item_spec(benchmark: str, n: int, seed: int = 0,
              opt_passes: str = "-TMR", section: str = "memory",
              batch_size: int = 4096, start_num: int = 0,
              fault_model: str = "single", equiv: bool = False,
              stop_when: Optional[str] = None, unroll: int = 1,
              throttle_s: float = 0.0,
              delta_from: Optional[str] = None,
              collect: str = "dense") -> Dict[str, object]:
    """One queued campaign, serialized through the shared
    :class:`~coast_tpu_torch.inject.spec.CampaignSpec` identity vocabulary
    (``to_item`` is bit-compatible with this function's historical
    output, so enqueue ids and pre-existing queue directories keep
    their meaning).

    ``throttle_s`` sleeps that long after every collected batch -- an
    operator rate-limit knob (and what makes kill-mid-campaign tests
    deterministic on a fast CPU backend).  ``delta_from`` makes the item
    a DELTA campaign: the worker re-injects only the sections whose
    propagation fingerprint changed since that journal was written and
    splices the rest (the protection-regression CI's work unit).
    Validation happens here, at enqueue time, so a bad spec fails the
    *enqueuer*, not a worker an hour later."""
    spec = CampaignSpec(
        benchmark=benchmark, n=n, seed=seed, opt_passes=opt_passes,
        section=section, batch_size=batch_size, start_num=start_num,
        fault_model=fault_model, equiv=equiv, stop_when=stop_when,
        unroll=unroll, throttle_s=throttle_s, delta_from=delta_from,
        collect=collect)
    try:
        spec.validate()
    except SpecError as e:
        # Parser-typed errors (FaultModel's ValueError, StopWhenError)
        # pass through untouched; the spec-level rules keep the queue's
        # historical QueueError type.
        raise QueueError(str(e)) from e
    return spec.to_item()


@dataclasses.dataclass
class QueueItem:
    """One claimed work item: the spec plus its claim bookkeeping."""

    id: str
    spec: Dict[str, object]
    attempts: int
    worker: str
    lease_expires_unix: float


class CampaignQueue:
    """File-based multi-process campaign queue rooted at one directory."""

    def __init__(self, root: str):
        self.root = str(root)
        for sub in (*STATES, "journals", "status"):
            os.makedirs(os.path.join(self.root, sub), exist_ok=True)

    # -- paths ---------------------------------------------------------------
    def _item_path(self, state: str, item_id: str) -> str:
        return os.path.join(self.root, state, f"{item_id}.json")

    def journal_path(self, item_id: str) -> str:
        return os.path.join(self.root, "journals", f"{item_id}.journal")

    def worker_status_path(self, worker: str) -> str:
        return os.path.join(self.root, "status", f"{worker}.json")

    @property
    def cache_dir(self) -> str:
        return os.path.join(self.root, "cache")

    # -- enqueue -------------------------------------------------------------
    def enqueue(self, spec: Dict[str, object]) -> str:
        """Durably add one item; returns its id.

        Ids are ``<seq>-<sha8>``: a monotone sequence number for FIFO
        claim order plus a spec fingerprint for the humans reading the
        directory.  ``O_CREAT|O_EXCL`` arbitrates concurrent enqueuers
        of the *same* spec racing for one slot; concurrent enqueuers of
        different specs may land the same sequence number, in which case
        the sha tiebreaks their claim order -- they raced, so no
        meaningful FIFO order exists between them anyway."""
        sha = hashlib.sha256(
            json.dumps(spec, sort_keys=True).encode()).hexdigest()[:8]
        seq = self._next_seq()
        while True:
            item_id = f"{seq:06d}-{sha}"
            doc = {"format": "coast-fleet-item", "version": 1,
                   "id": item_id, "spec": dict(spec), "attempts": 0,
                   "enqueued_unix": time.time()}
            try:
                fd = os.open(self._item_path("pending", item_id),
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                seq += 1
                continue
            with os.fdopen(fd, "w") as fh:
                json.dump(doc, fh, separators=(",", ":"), sort_keys=True)
                fh.flush()
                os.fsync(fh.fileno())
            return item_id

    def _next_seq(self) -> int:
        seq = 0
        for state in STATES:
            for name in os.listdir(os.path.join(self.root, state)):
                head = name.split("-", 1)[0]
                if head.isdigit():
                    seq = max(seq, int(head) + 1)
        return seq

    # -- claim / lease / requeue --------------------------------------------
    def claim(self, worker: str, lease_s: float = 60.0
              ) -> Optional[QueueItem]:
        """Atomically claim the oldest pending item, or None.

        The rename IS the claim: concurrent claimants racing for one
        item see exactly one winner.  The claimed file is then rewritten
        (atomically) with the worker and lease expiry."""
        pending = os.path.join(self.root, "pending")
        for name in sorted(os.listdir(pending)):
            if not name.endswith(".json"):
                continue
            item_id = name[:-len(".json")]
            if os.path.exists(self._item_path("done", item_id)):
                # A slow previous attempt already landed the result (see
                # complete()); this pending entry is a stale requeue.
                try:
                    os.unlink(os.path.join(pending, name))
                except FileNotFoundError:
                    pass
                continue
            dst = self._item_path("claimed", item_id)
            try:
                os.rename(os.path.join(pending, name), dst)
            except FileNotFoundError:
                continue                       # another claimant won
            try:
                doc = self._read(dst)
            except FileNotFoundError:
                # Our fresh claim was moved out from under us (a reaper
                # running with an artificial far-future ``now``): the
                # item is pending again and fair game for anyone.
                continue
            doc["worker"] = str(worker)
            doc["attempts"] = int(doc.get("attempts", 0)) + 1
            doc["claimed_unix"] = time.time()
            doc["lease_expires_unix"] = time.time() + float(lease_s)
            atomic_write_json(dst, doc)
            return QueueItem(id=item_id, spec=doc["spec"],
                             attempts=doc["attempts"], worker=str(worker),
                             lease_expires_unix=doc["lease_expires_unix"])
        return None

    def renew(self, item_id: str, worker: str, lease_s: float = 60.0
              ) -> None:
        """Extend the lease from the worker's heartbeat.  Raises
        :class:`LostLeaseError` if the claim vanished or moved to
        another worker -- the caller must abandon the item (its journal
        flock already keeps any replacement's appends safe)."""
        path = self._item_path("claimed", item_id)
        try:
            doc = self._read(path)
        except FileNotFoundError:
            raise LostLeaseError(
                f"item {item_id} is no longer claimed by {worker} "
                "(lease reaped or item completed)") from None
        if doc.get("worker") != worker:
            raise LostLeaseError(
                f"item {item_id} is now claimed by {doc.get('worker')!r}, "
                f"not {worker!r}")
        doc["lease_expires_unix"] = time.time() + float(lease_s)
        atomic_write_json(path, doc)

    def requeue_expired(self, now: Optional[float] = None) -> List[str]:
        """Move every expired-lease claimed item back to pending (its
        journal stays, so the next claimant resumes).  Returns the
        requeued ids.  ``now`` is injectable for tests."""
        now = time.time() if now is None else float(now)
        out: List[str] = []
        claimed = os.path.join(self.root, "claimed")
        for name in sorted(os.listdir(claimed)):
            if not name.endswith(".json"):
                continue
            item_id = name[:-len(".json")]
            path = os.path.join(claimed, name)
            try:
                doc = self._read(path)
            except FileNotFoundError:
                continue
            # The ctime floor covers the mid-claim window (see
            # CLAIM_WRITE_GRACE_S): a just-renamed claim whose doc still
            # shows the PREVIOUS attempt's expired lease (or none at
            # all) must not be reaped before its claimant's write lands.
            try:
                floor = os.stat(path).st_ctime + CLAIM_WRITE_GRACE_S
            except FileNotFoundError:
                continue
            expires = max(float(doc.get("lease_expires_unix") or 0.0),
                          floor)
            if expires > now:
                continue
            out.extend(self._requeue(item_id))
        return out

    def requeue_worker(self, worker: str) -> List[str]:
        """Requeue every item claimed by ``worker`` immediately -- the
        fleet supervisor's fast path when it *observed* the worker
        process die (no need to wait out the lease)."""
        out: List[str] = []
        claimed = os.path.join(self.root, "claimed")
        for name in sorted(os.listdir(claimed)):
            if not name.endswith(".json"):
                continue
            item_id = name[:-len(".json")]
            try:
                doc = self._read(os.path.join(claimed, name))
            except FileNotFoundError:
                continue
            if doc.get("worker") == worker:
                out.extend(self._requeue(item_id))
        return out

    def _requeue(self, item_id: str) -> List[str]:
        if os.path.exists(self._item_path("done", item_id)):
            # The "expired" worker actually finished (complete() is
            # journal-backed and idempotent): just drop the stale claim.
            try:
                os.unlink(self._item_path("claimed", item_id))
            except FileNotFoundError:
                pass
            return []
        try:
            os.rename(self._item_path("claimed", item_id),
                      self._item_path("pending", item_id))
        except FileNotFoundError:
            return []
        return [item_id]

    # -- terminal transitions ------------------------------------------------
    def complete(self, item_id: str, worker: str,
                 result: Dict[str, object]) -> None:
        """Land the item's result durably.  Written atomically (not
        renamed) so completion is idempotent: if the lease was wrongly
        reaped and two attempts finish, both derive the identical
        result from the same resumed journal, and last-writer-wins is
        bit-for-bit the same file.  The claim (and any stale pending
        requeue) is cleared afterwards."""
        doc = {"format": "coast-fleet-done", "version": 1, "id": item_id,
               "worker": str(worker), "completed_unix": time.time(),
               "result": dict(result)}
        try:
            claim = self._read(self._item_path("claimed", item_id))
            doc["spec"] = claim["spec"]
            doc["attempts"] = claim.get("attempts", 1)
            # Queue lifecycle timestamps ride into the done record so
            # the fleet trace federation (obs/federate.py) can plot the
            # claim->complete lease window without the claim doc, which
            # is unlinked below.
            for key in ("enqueued_unix", "claimed_unix",
                        "lease_expires_unix"):
                if claim.get(key) is not None:
                    doc[key] = claim[key]
        except FileNotFoundError:
            pass
        atomic_write_json(self._item_path("done", item_id), doc)
        for state in ("claimed", "pending"):
            try:
                os.unlink(self._item_path(state, item_id))
            except FileNotFoundError:
                pass

    def fail(self, item_id: str, worker: str, error: str) -> None:
        """Mark the item terminally failed (bad spec, fatal build error).
        Transient infrastructure failures should requeue instead -- this
        is for work that would fail identically on any worker."""
        path = self._item_path("claimed", item_id)
        try:
            doc = self._read(path)
        except FileNotFoundError:
            doc = {"id": item_id, "spec": {}}
        doc["format"] = "coast-fleet-failed"
        doc["worker"] = str(worker)
        doc["error"] = str(error)
        doc["failed_unix"] = time.time()
        atomic_write_json(self._item_path("failed", item_id), doc)
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass

    # -- queries -------------------------------------------------------------
    def _read(self, path: str) -> Dict[str, object]:
        with open(path) as fh:
            try:
                return json.load(fh)
            except ValueError as e:
                raise QueueError(f"queue item {path!r} is corrupt: {e}") \
                    from e

    def stats(self) -> Dict[str, int]:
        """Item counts per state (the fleet telemetry's queue gauges)."""
        return {state: len([n for n in os.listdir(
                    os.path.join(self.root, state))
                    if n.endswith(".json")])
                for state in STATES}

    def items(self, state: str) -> List[Dict[str, object]]:
        """Every item doc in ``state``, sorted by id (enqueue order)."""
        if state not in STATES:
            raise QueueError(f"unknown queue state {state!r}; "
                             f"want one of {STATES}")
        dirname = os.path.join(self.root, state)
        out = []
        for name in sorted(os.listdir(dirname)):
            if not name.endswith(".json"):
                continue
            try:
                out.append(self._read(os.path.join(dirname, name)))
            except FileNotFoundError:
                continue                       # moved mid-listing
        return out

    def drained(self) -> bool:
        """True when no live (pending or claimed) work remains."""
        stats = self.stats()
        return stats["pending"] == 0 and stats["claimed"] == 0
