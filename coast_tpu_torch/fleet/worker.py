"""Fleet worker: claim queued campaigns, run them crash-safely, report.

The port's copy of ``coast_tpu/fleet/worker.py``.  One worker is one
process in the fleet, on one device (the card unless the caller passes
``device="cpu"``).  Its loop is the reference supervisor's per-QEMU-worker
thread (threadFunctions.py) rebuilt on the journal, retry and runner
primitives:

  * it **claims** items from the :class:`~coast_tpu_torch.fleet.queue
    .CampaignQueue` (atomic rename; lease renewed from the campaign's
    own progress heartbeat);
  * it **runs** each item through a cached
    :class:`~coast_tpu_torch.inject.campaign.CampaignRunner`
    (:mod:`coast_tpu_torch.fleet.compile_cache`) with the item's journal --
    every collected batch is fsync'd before the lease beat that
    acknowledges it, so the journal is always at least as complete as
    the queue believes;
  * it **survives SIGKILL by construction**: the worker holds no state
    the queue + journal do not.  A killed worker's lease expires (or the
    fleet supervisor requeues it on observing the death), the next
    claimant re-opens the same journal, and ``CampaignRunner.run``
    resumes at the first missing batch bit-for-bit -- the journal's
    exclusive flock guarantees the kill really is dead (a merely-slow
    worker still holds the lock, and the duplicate claimant backs off
    with :class:`~coast_tpu_torch.inject.journal.JournalLockedError`).

Per item the worker lands a ``done`` record carrying the campaign
summary, the per-run ``codes`` sha256 (the fleet merge's parity pin),
and the compile-cache outcome.  Throughout, it mirrors a worker-status
doc (atomic JSON) into the queue's ``status/`` directory -- the fleet
aggregator's scrape surface (:mod:`coast_tpu_torch.fleet.telemetry`).
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
import traceback
from typing import Dict, Optional

import numpy as np

from coast_tpu_torch import device as device_mod
from coast_tpu_torch.fleet.compile_cache import CompileCache
from coast_tpu_torch.fleet.queue import (CampaignQueue, LostLeaseError,
                                         QueueItem)
from coast_tpu_torch.inject.journal import JournalError, JournalLockedError
from coast_tpu_torch.obs import flightrec
from coast_tpu_torch.obs.metrics import CampaignMetrics, atomic_write_json

__all__ = ["Worker", "codes_sha256"]


def codes_sha256(codes: np.ndarray) -> str:
    """Parity pin over a campaign's per-run class codes: bit-identical
    campaigns -- and nothing else -- share it."""
    return hashlib.sha256(
        np.ascontiguousarray(codes, dtype=np.int32).tobytes()).hexdigest()


class _LeaseKeeper:
    """Renew an item's lease from a background thread while the worker sits
    inside a long blocking phase with no progress beats -- the cold
    program build (the native kernels' ``nvcc``, the protection
    transform, an equiv capture), which compile_cache documents as
    the cold-start cost and which can outlast a short lease. Without
    this, every cold config's first attempt gets reaped mid-compile
    and the fleet pays N duplicate compiles. A renewal that fails
    with :class:`LostLeaseError` is parked in ``lost`` for the
    caller (raising on the keeper thread would vanish)."""

    def __init__(self, q: CampaignQueue, item_id: str, worker: str,
                 lease_s: float):
        self.q, self.item_id, self.worker = q, item_id, worker
        self.lease_s = float(lease_s)
        self.lost: Optional[LostLeaseError] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"lease-{item_id}", daemon=True)

    def __enter__(self) -> "_LeaseKeeper":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()

    def _run(self) -> None:
        while not self._stop.wait(self.lease_s / 3.0):
            try:
                self.q.renew(self.item_id, self.worker, self.lease_s)
                flightrec.record("lease_renew", item=self.item_id,
                                 phase="compile")
            except LostLeaseError as e:
                flightrec.record("lease_lost", item=self.item_id,
                                 phase="compile")
                self.lost = e
                return


class Worker:
    """One fleet worker process (or an in-process drain loop in tests)."""

    def __init__(self, queue: "CampaignQueue | str", worker_id: str,
                 mesh_devices: Optional[int] = None,
                 lease_s: float = 60.0, poll_s: float = 0.25,
                 cache: Optional[CompileCache] = None,
                 metrics: Optional[CampaignMetrics] = None,
                 max_retries: int = 2, max_item_attempts: int = 3,
                 device=device_mod.DEFAULT):
        self.q = (queue if isinstance(queue, CampaignQueue)
                  else CampaignQueue(queue))
        self.worker_id = str(worker_id)
        self.lease_s = float(lease_s)
        self.poll_s = float(poll_s)
        self.max_item_attempts = int(max_item_attempts)
        self.cache = cache if cache is not None \
            else CompileCache(self.q.cache_dir, device=device)
        self.metrics = metrics if metrics is not None else CampaignMetrics()
        self._mesh = None
        if mesh_devices:
            from coast_tpu_torch.parallel.mesh import make_mesh
            self._mesh = make_mesh(int(mesh_devices),
                                   device=self.cache.device)
        self._retry = None
        if max_retries > 0:
            from coast_tpu_torch.inject.resilience import RetryPolicy
            self._retry = RetryPolicy(max_attempts=int(max_retries) + 1)
        self.items_done = 0
        self.items_failed = 0
        self.items_yielded = 0            # journal-locked backoffs
        self._current_item: Optional[str] = None
        self._write_status("idle")

    # -- status doc ----------------------------------------------------------
    def _write_status(self, state: str) -> None:
        """Atomically mirror this worker's live state for the fleet
        aggregator.  The campaign block is the standard CampaignMetrics
        snapshot, included only while an item is actually running --
        completed items are counted from their durable done records, so
        the aggregate never double-counts a finished campaign."""
        doc: Dict[str, object] = {
            "format": "coast-fleet-worker", "version": 1,
            "worker": self.worker_id, "pid": os.getpid(),
            "state": state, "item": self._current_item,
            "items_done": self.items_done,
            "items_failed": self.items_failed,
            "items_yielded": self.items_yielded,
            "cache": self.cache.snapshot(),
            "updated_unix_s": round(time.time(), 6),
        }
        if state == "running":
            doc["campaign"] = self.metrics.snapshot()
        atomic_write_json(self.q.worker_status_path(self.worker_id), doc)

    # -- the drain loop ------------------------------------------------------
    def drain(self, idle_exit: bool = True,
              max_items: Optional[int] = None) -> int:
        """Claim-and-run until the queue is drained (``idle_exit``) or
        ``max_items`` items have been attempted.  Returns how many items
        this worker completed."""
        attempted = 0
        while max_items is None or attempted < max_items:
            self.q.requeue_expired()
            item = self.q.claim(self.worker_id, self.lease_s)
            if item is None:
                if idle_exit and self.q.drained():
                    break
                self._write_status("idle")
                time.sleep(self.poll_s)
                continue
            attempted += 1
            self.run_item(item)
        self._write_status("exited")
        return self.items_done

    # -- one item ------------------------------------------------------------
    def run_item(self, item: QueueItem) -> bool:
        """Run one claimed item to a terminal queue state.  Returns True
        if it completed (False: failed terminally or yielded)."""
        spec = item.spec
        self._current_item = item.id
        flightrec.record("lease_claim", item=item.id,
                         attempts=int(item.attempts))
        keeper = _LeaseKeeper(self.q, item.id, self.worker_id,
                              self.lease_s)
        try:
            with keeper:
                runner, strategy, cache_key, cache_event = \
                    self.cache.runner(spec, mesh=self._mesh,
                                      metrics=self.metrics,
                                      retry=self._retry)
        except (RuntimeError, ValueError) as e:
            # Deterministic build failure: any worker would fail the
            # same way, so the item is terminally failed, not requeued.
            self.items_failed += 1
            self._current_item = None
            self.q.fail(item.id, self.worker_id, f"build: {e}")
            self._write_status("idle")
            return False
        if keeper.lost is not None:
            # Our claim moved while we compiled.  The compile itself is
            # not wasted (the cache keeps it), but the item belongs to
            # another worker now -- stop touching it.
            flightrec.current().dump(
                "lease_lost", extra={"item": item.id,
                                     "worker": self.worker_id,
                                     "phase": "compile",
                                     "error": str(keeper.lost)})
            self.items_yielded += 1
            self._current_item = None
            self._write_status("idle")
            return False

        from coast_tpu_torch.inject.spec import CampaignSpec
        cs = CampaignSpec.from_item(spec)
        state = {"last_renew": time.monotonic(), "marked": False}
        throttle = cs.throttle_s

        def progress(done: int, counts: Dict[str, int]) -> None:
            # First collected batch proves the compile happened: record
            # the key so a restarted worker's rebuild is a cache hit.
            if not state["marked"]:
                self.cache.mark_compiled(cache_key, spec)
                state["marked"] = True
            now = time.monotonic()
            if now - state["last_renew"] >= self.lease_s / 3.0:
                self.q.renew(item.id, self.worker_id, self.lease_s)
                flightrec.record("lease_renew", item=item.id,
                                 phase="campaign", done=int(done))
                state["last_renew"] = now
            self._write_status("running")
            if throttle > 0:
                time.sleep(throttle)

        stop_when = cs.stop_when_parsed()
        try:
            with runner.telemetry.activate():
                if cs.delta_from:
                    # Delta item (the protection-regression CI's work
                    # unit): re-inject only fingerprint-changed
                    # sections, splice the rest from the base journal,
                    # each section convergence-bounded by stop_when.
                    # The live campaign writes no journal (the spliced
                    # rows never ran), so the result is materialized as
                    # one afterwards -- the done record must still have
                    # a journal to parity-check against, and the CI
                    # refresh wants it as the next splice base.
                    res = runner.run_delta(
                        cs.n, cs.delta_from, seed=cs.seed,
                        batch_size=cs.batch_size,
                        start_num=cs.start_num,
                        progress=progress, stop_when=stop_when,
                        static_budget=cs.static_budget)
                    jpath = self.q.journal_path(item.id)
                    if os.path.exists(jpath):
                        os.unlink(jpath)       # a previous attempt's
                    runner.journal_result(res, jpath, n=cs.n,
                                          batch_size=cs.batch_size)
                else:
                    res = runner.run(
                        cs.n, seed=cs.seed,
                        batch_size=cs.batch_size,
                        start_num=cs.start_num,
                        journal=self.q.journal_path(item.id),
                        progress=progress, stop_when=stop_when)
        except JournalLockedError:
            # The previous holder of this item is still alive and
            # appending (our claim came from a wrongly-reaped lease).
            # Yield: put the item back and let the journal's owner
            # finish it -- complete() is idempotent either way.
            self.items_yielded += 1
            self._current_item = None
            self.q.requeue_worker(self.worker_id)
            self._write_status("idle")
            time.sleep(self.poll_s)
            return False
        except LostLeaseError as e:
            # Our lease was reaped mid-campaign and someone else owns
            # the item now; the journal we already appended is theirs to
            # resume.  Stop touching it -- but leave the blackbox behind:
            # a reaped lease on a worker that believed itself healthy is
            # exactly the "who stalled, us or the supervisor?" dispute
            # the forensic bundle adjudicates.
            flightrec.record("lease_lost", item=item.id, phase="campaign")
            flightrec.current().dump(
                "lease_lost", extra={"item": item.id,
                                     "worker": self.worker_id,
                                     "error": str(e)})
            self.items_yielded += 1
            self._current_item = None
            self._write_status("idle")
            return False
        except JournalError as e:
            # Deterministic journal failure -- a delta item's base does
            # not describe this campaign (JournalMismatchError), a
            # corrupt/poisoned journal, or a journal_result parity
            # failure: every worker would fail the same way, so the
            # item is terminally failed, not requeued.  (The LOCKED
            # case is transient and already handled above.)
            self.items_failed += 1
            self._current_item = None
            self.q.fail(item.id, self.worker_id, f"journal: {e}")
            self._write_status("idle")
            return False
        except Exception as e:          # noqa: BLE001
            self._current_item = None
            if item.attempts < self.max_item_attempts:
                # Possibly transient infrastructure beyond what the
                # RetryPolicy absorbed on THIS worker (device hiccup,
                # disk blip): the journal is intact and resumable, so
                # requeue for another attempt before declaring the item
                # poison -- fail() is for work that would fail
                # identically anywhere.
                self.items_yielded += 1
                self.q.requeue_worker(self.worker_id)
                self._write_status("idle")
                return False
            self.items_failed += 1
            self.q.fail(item.id, self.worker_id,
                        f"attempt {item.attempts}: "
                        f"{type(e).__name__}: {e}\n"
                        f"{traceback.format_exc(limit=3)}")
            self._write_status("idle")
            return False

        # The done record's shape is what merge_fleet parity-checks and
        # FleetTelemetry aggregates: counts as a dict (not the summary's
        # flattened keys), the codes sha as the parity pin, the full
        # summary alongside for humans and json_parser-style consumers.
        result = {
            "benchmark": res.benchmark,
            "strategy": res.strategy,
            "injections": int(res.n),
            "seconds": round(float(res.seconds), 6),
            "counts": {k: int(v) for k, v in res.counts.items()},
            "codes_sha256": codes_sha256(res.codes),
            "cache_event": cache_event,
            "worker": self.worker_id,
            "summary": res.summary(),
        }
        if res.physical_n is not None:
            result["physical_injections"] = int(res.physical_n)
        if res.delta is not None:
            result["delta"] = dict(res.delta)
        self.q.complete(item.id, self.worker_id, result)
        self.items_done += 1
        self._current_item = None
        self._write_status("idle")
        return True
