"""The serving dispatch loop: request lanes + injection lanes, one batch.

The port's copy of ``coast_tpu/serve/engine.py``, on a device (the card
unless the caller passes ``device="cpu"``).  Every dispatch is the
campaign engine's shape -- one
:meth:`~coast_tpu_torch.passes.dataflow_protection.ProtectedProgram.run_batch`
over a fixed-size batch, where the reference runs
``jax.jit(jax.vmap(run_one))`` -- but its rows are split three ways:

====================  ===================================================
rows ``[0, r)``       live REQUEST lanes: disarmed faults
                      (:func:`~coast_tpu_torch.ops.bitflip.noop_fault`,
                      ``t = -1`` matches no step), outputs gathered into
                      responses;
rows ``[r, r+i)``     INJECTION lanes: the next ``i`` rows of a seeded
                      campaign schedule, outcomes journaled + fed to the
                      metrics hub -- the service's continuous
                      self-measurement;
rows ``[r+i, B)``     padding: disarmed, uncounted (every dispatch has
                      the one batch shape).
====================  ===================================================

Batch rows are independent by construction, which is what makes the
co-packing sound -- but "by construction" is exactly what a protection
bug (a voter reading across lanes) breaks, so the engine does not take
it on faith: the lane-isolation noninterference prover
(:func:`~coast_tpu_torch.analysis.propagation.prove_isolation`) runs at build
time and a refuted proof REFUSES to serve
(:class:`IsolationRefusedError`); at runtime every dispatch re-checks
that the armed fault rows are exactly the injection span before any
response is gathered (:class:`LaneLeakError` + flight-recorder bundle
otherwise).  The differential contract follows: served responses are
bit-identical with injection lanes on vs off.

Strategy selection is per request, by latency budget: DWC
(detect-and-retry) when a rerun still fits the SLA, TMR (vote-through)
when it does not; a DWC detection whose retry no longer fits escalates
to TMR once, and the retry path is journaled like any campaign batch.
Injection work is backed by the fleet
:class:`~coast_tpu_torch.fleet.queue.CampaignQueue` when one is attached --
the engine enqueues its standing measurement campaigns as queue items,
claims them back, journals them at the queue's canonical paths, and
lands worker-shaped done records, so fleet telemetry aggregates the
serving measurement like any campaign worker's.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from coast_tpu_torch import device as device_mod
from coast_tpu_torch.inject import classify as cls
from coast_tpu_torch.inject.journal import (CampaignJournal,
                                            config_fingerprint,
                                            schedule_fingerprint)
from coast_tpu_torch.inject.mem import MemoryMap
from coast_tpu_torch.inject.resilience import watchdog_collect
from coast_tpu_torch.inject.schedule import generate
from coast_tpu_torch.inject.supervisor import build_program, section_filter
from coast_tpu_torch.obs import flightrec
from coast_tpu_torch.obs.metrics import Histogram
from coast_tpu_torch.ops.bitflip import noop_fault
from coast_tpu_torch.serve.admission import (REJECT_DEADLINE, REJECT_SLA,
                                             AdmissionQueue, ServeRequest)
from coast_tpu_torch.serve.metrics import ServeMetrics

__all__ = ["ServeEngine", "IsolationRefusedError", "LaneLeakError",
           "response_digest"]

_WORD = 0xFFFFFFFF


def response_digest(output: torch.Tensor) -> torch.Tensor:
    """Per-row response digest of a ``[B, W]`` output: the reference's
    ``XOR_i (out_i * ((i * 2654435761) | 1)) mod 2^32`` over the output
    read as uint32 (``astype(uint32)``: integers wrap, floats convert by
    value with NaN to 0 and saturation, as XLA converts), as int64 values
    in ``[0, 2^32)``.  Position-mixed XOR, so permuted corruptions cannot
    cancel.

    Torch has no uint32 product and no XOR reduction: the words and
    multipliers are held in int64, the product is taken in two 16-bit
    halves of the multiplier (each partial product below 2^48, so no
    int64 overflow) and kept mod 2^32, and the XOR reduction folds the
    columns in halves, padding an odd count with a zero column."""
    rows = output.reshape(output.shape[0], -1)
    if rows.is_floating_point():
        words = torch.nan_to_num(rows.to(torch.float64), nan=0.0).clamp(
            0, _WORD).trunc().to(torch.int64)
    else:
        words = rows.to(torch.int64) & _WORD
    idx = torch.arange(words.shape[1], dtype=torch.int64,
                       device=words.device)
    mult = ((idx * 2654435761) & _WORD) | 1
    lo = words * (mult & 0xFFFF)
    hi = ((words * (mult >> 16)) & 0xFFFF) << 16
    mixed = (lo + hi) & _WORD
    while mixed.shape[1] > 1:
        if mixed.shape[1] % 2:
            mixed = torch.cat([mixed, torch.zeros_like(mixed[:, :1])], 1)
        half = mixed.shape[1] // 2
        mixed = mixed[:, :half] ^ mixed[:, half:]
    if mixed.shape[1] == 0:
        return torch.zeros(words.shape[0], dtype=torch.int64,
                           device=words.device)
    return mixed[:, 0]


def _on_device(device: torch.device):
    """Make ``device`` the calling thread's current CUDA device (a no-op
    context on the CPU): torch's current device is per thread, and the
    dispatch loop and the collect watchdog run on threads of their own."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class IsolationRefusedError(RuntimeError):
    """The lane-isolation prover refuted noninterference for a serving
    program: an injected lane could leak into a served response, so the
    engine refuses to start."""


class LaneLeakError(RuntimeError):
    """Runtime lane-leak assertion: an armed fault row landed outside
    the injection span of a dispatch.  Raised before any response is
    gathered from that batch."""


#: Classes a DWC lane treats as "the protection detected something":
#: the run did not complete cleanly, so the request must be re-run
#: (or escalated) rather than answered.
_DWC_DETECTED = frozenset(cls.DUE_CLASSES) | {"invalid"}


class _Lane:
    """Per-strategy serving state: the built program, its proof, its
    batch function, and the injection-campaign cursor/journal."""

    def __init__(self, strategy: str):
        self.strategy = strategy
        self.prog = None
        self.proof = None
        self.mmap: Optional[MemoryMap] = None
        # fault columns -> host columns code/errors/corrected/steps/digest
        self.run_batch: Optional[Callable] = None
        self.train = False
        # Standing (standalone) injection campaign.
        self.sched = None
        self.cursor = 0
        self.counts = np.zeros(cls.NUM_CLASSES, dtype=np.int64)
        self.journal: Optional[CampaignJournal] = None
        self.dispatch_s = 0.0
        self.t_last_collect = 0.0
        self.est_s: Optional[float] = None   # EWMA dispatch wall clock
        # Queue-backed injection item (None between items).
        self.item = None
        self.item_sched = None
        self.item_cursor = 0
        self.item_counts = np.zeros(cls.NUM_CLASSES, dtype=np.int64)
        self.item_codes: List[np.ndarray] = []
        self.item_journal: Optional[CampaignJournal] = None
        self.item_hists: Dict[str, Histogram] = {}
        self.item_t0 = 0.0
        self.item_lease_t = 0.0

    def inject_remaining(self) -> int:
        if self.item is not None:
            return int(self.item_spec_n() - self.item_cursor)
        if self.sched is None:
            return 0
        return int(len(self.sched) - self.cursor)

    def item_spec_n(self) -> int:
        return int(self.item.spec["n"]) if self.item is not None else 0


class ServeEngine:
    """Batched protected inference with continuous self-measurement.

    Construction IS the gate: both strategy programs are built
    (``build_program``, the opt-CLI parser's own flag semantics) and
    each must pass the lane-isolation prover before the engine exists.
    ``start()`` launches the dispatch loop; ``submit()`` is the request
    path (the HTTP front's handler body and the loadtest's inner loop).

    ``inject_share`` is the fraction of each batch offered to injection
    lanes (0.0 turns self-measurement off -- the differential contract's
    control arm).  ``journal_dir`` makes the standing injection
    campaigns crash-safe (one journal per strategy, resumed bit-for-bit
    on restart); ``queue`` attaches a fleet CampaignQueue instead, with
    items enqueued/claimed/completed like a worker's.

    ``detect_hook(req, code)`` is the DWC detection seam for tests and
    chaos drills: called for every DWC request row with its class code,
    returning True forces the detect-and-retry path even though request
    rows carry disarmed faults (reality: a detection surfaces as a DUE
    class code, which is also honored).
    """

    def __init__(self, bench: str,
                 batch_size: int = 64,
                 inject_share: float = 0.5,
                 sla_default_s: float = 0.25,
                 retry_factor: float = 2.0,
                 seed: int = 0,
                 inject_n: int = 1_000_000,
                 section: str = "memory",
                 journal_dir: Optional[str] = None,
                 queue=None,
                 metrics: Optional[ServeMetrics] = None,
                 slo: Optional[object] = None,
                 wedge_timeout_s: float = 0.0,
                 idle_throttle_s: float = 0.0,
                 strategies: Tuple[str, ...] = ("DWC", "TMR"),
                 device=device_mod.DEFAULT):
        if not 0.0 <= float(inject_share) <= 1.0:
            raise ValueError(f"inject_share must be in [0, 1], got "
                             f"{inject_share}")
        self.bench = bench
        self.batch_size = int(batch_size)
        self.inject_share = float(inject_share)
        self.sla_default_s = float(sla_default_s)
        self.retry_factor = float(retry_factor)
        self.seed = int(seed)
        self.inject_n = int(inject_n)
        self.section = section
        self.journal_dir = journal_dir
        self.queue = queue
        self.worker_id = f"serve-{os.getpid()}"
        self.wedge_timeout_s = float(wedge_timeout_s)
        self.idle_throttle_s = float(idle_throttle_s)
        self.device = device_mod.resolve(device)
        self.metrics = metrics if metrics is not None else ServeMetrics(
            slo=slo)
        if slo is not None and self.metrics.hub.slo_set is None:
            from coast_tpu_torch.obs.slo import SLOSet
            self.metrics.hub.slo_set = (SLOSet.parse(slo)
                                        if isinstance(slo, str) else slo)
        self.detect_hook: Optional[Callable] = None
        self.admission = AdmissionQueue(strategies)
        self.error: Optional[str] = None
        self._rid = 0
        self._rid_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._noop: Dict[str, int] = {
            k: int(v) for k, v in noop_fault().items()}

        self._lanes: Dict[str, _Lane] = {}
        for strategy in strategies:
            self._lanes[strategy] = self._build_lane(strategy)
        self.benchmark = self._lanes[strategies[0]].prog.region.name
        if self.queue is not None:
            self._enqueue_standing_items()

    # -- build + prover gate -------------------------------------------------
    def _build_lane(self, strategy: str) -> _Lane:
        from coast_tpu_torch.analysis.propagation import prove_isolation
        lane = _Lane(strategy)
        lane.prog, built = build_program(self.bench, f"-{strategy}",
                                         str(self.device))
        if built != strategy:
            raise ValueError(f"-{strategy} built a {built!r} program")
        lane.proof = prove_isolation(lane.prog, strategy=strategy)
        flightrec.record("serve_prover", strategy=strategy,
                         holds=lane.proof.holds,
                         vacuous=lane.proof.vacuous,
                         leak_paths=lane.proof.total_leak_paths)
        if not lane.proof.holds:
            raise IsolationRefusedError(
                f"lane-isolation proof REFUTED for {self.bench} "
                f"-{strategy}: an injected lane can reach a served "
                f"response; refusing to serve.\n{lane.proof.format()}")
        lane.train = lane.prog.region.train_probe is not None
        lane.mmap = MemoryMap(lane.prog,
                              section_filter(lane.prog, self.section))
        prog = lane.prog
        out_words = prog.output_words

        def run_batch(fault):
            rec = prog.run_batch(fault)
            # Response digest, folded on the device from the voted
            # output: requests attest "protected compute ran, output was
            # X" without shipping the whole output vector per row.
            out = {k: rec[k].to(torch.int32)
                   for k in ("errors", "corrected", "steps")}
            out["code"] = cls.classify(rec, out_words)
            out["digest"] = response_digest(rec["output"])
            return {k: v.cpu().numpy() for k, v in out.items()}

        lane.run_batch = run_batch
        if self.inject_share > 0.0:
            lane.sched = generate(lane.mmap, self.inject_n, self.seed,
                                  lane.prog.region.nominal_steps)
            if self.journal_dir:
                os.makedirs(self.journal_dir, exist_ok=True)
                path = os.path.join(self.journal_dir,
                                    f"serve-{strategy}.journal")
                lane.journal = CampaignJournal.open(
                    path, self._journal_header(lane, lane.sched,
                                               self.seed, self.inject_n))
                self._replay(lane)
        return lane

    def _journal_header(self, lane: _Lane, sched, seed: int,
                        n: int) -> Dict[str, object]:
        """The campaign journal identity block, mode ``serve``: a serve
        journal resumed under a different program, strategy, protection
        config, seed, or schedule refuses exactly like a campaign's."""
        return {"mode": "serve",
                "benchmark": lane.prog.region.name,
                "strategy": lane.strategy,
                "config_sha": config_fingerprint(lane.prog.cfg),
                "seed": int(seed), "n": int(n), "start_num": 0,
                "batch_size": self.batch_size,
                "schedule_sha": schedule_fingerprint(sched)}

    def _replay(self, lane: _Lane) -> None:
        """Resume the standing campaign from its journal's contiguous
        batch prefix: cursor + cumulative counts come back exactly, so
        the restarted service injects precisely the rows the killed one
        never collected (the SIGKILL-restart bit-for-bit guarantee)."""
        prefix = lane.journal.batch_prefix(0, self.inject_n)
        if not prefix:
            return
        lane.cursor = int(prefix[0]["lo"]) + sum(
            int(r["n"]) for r in prefix)
        for name, v in prefix[-1]["counts"].items():
            lane.counts[cls.CLASS_NAMES.index(name)] = int(v)
        flightrec.record("serve_journal_replay", strategy=lane.strategy,
                         batches=len(prefix), cursor=lane.cursor)

    # -- fleet-queue backing -------------------------------------------------
    def _enqueue_standing_items(self) -> None:
        """Enqueue this service's standing measurement campaigns as
        ordinary fleet items (one per strategy) -- claimed back below,
        journaled at the queue's canonical paths, completed with
        worker-shaped done records, so fleet telemetry sees serving
        self-measurement exactly like campaign work."""
        from coast_tpu_torch.fleet.queue import item_spec
        for strategy in self._lanes:
            self.queue.enqueue(item_spec(
                self.bench, self.inject_n, seed=self.seed,
                opt_passes=f"-{strategy}", section=self.section,
                batch_size=self.batch_size))

    def _claim_item(self, lane: _Lane) -> None:
        """Claim the oldest pending item if it matches this lane; a
        non-matching head is left alone (a dedicated serve queue only
        ever holds this engine's own items, so in the common deployment
        the head always matches)."""
        if self.queue is None or lane.item is not None:
            return
        head = self.queue.items("pending")
        if not head:
            return
        spec = head[0].get("spec", head[0])
        if not self._item_matches(lane, spec):
            return
        item = self.queue.claim(self.worker_id, lease_s=60.0)
        if item is None:
            return
        if not self._item_matches(lane, item.spec):
            # Raced with another enqueuer; serve it on the lane it
            # names instead.
            other = self._lanes.get(self._spec_strategy(item.spec))
            if other is None or other.item is not None:
                self.queue.fail(item.id, self.worker_id,
                                "serve engine cannot run this spec")
                return
            lane = other
        lane.item = item
        lane.item_sched = generate(
            lane.mmap, int(item.spec["n"]), int(item.spec["seed"]),
            lane.prog.region.nominal_steps)
        lane.item_cursor = 0
        lane.item_counts[:] = 0
        lane.item_codes = []
        lane.item_hists = {"device": Histogram(), "gap": Histogram()}
        lane.item_t0 = time.monotonic()
        lane.item_lease_t = time.monotonic()
        lane.item_journal = CampaignJournal.open(
            self.queue.journal_path(item.id),
            self._journal_header(lane, lane.item_sched,
                                 int(item.spec["seed"]),
                                 int(item.spec["n"])))
        prefix = lane.item_journal.batch_prefix(0, int(item.spec["n"]))
        for rec in prefix:
            codes = np.asarray(rec["codes"], dtype=np.int32)
            lane.item_codes.append(codes)
            lane.item_cursor += int(rec["n"])
        if prefix:
            for name, v in prefix[-1]["counts"].items():
                lane.item_counts[cls.CLASS_NAMES.index(name)] = int(v)
        flightrec.record("serve_item_claimed", item=item.id,
                         strategy=lane.strategy, resumed=len(prefix))

    @staticmethod
    def _spec_strategy(spec: Dict[str, object]) -> str:
        opt = str(spec.get("opt_passes", ""))
        if "-TMR" in opt.split():
            return "TMR"
        if "-DWC" in opt.split():
            return "DWC"
        return "unprotected"

    def _item_matches(self, lane: _Lane, spec: Dict[str, object]) -> bool:
        return (spec.get("benchmark") == self.bench
                and self._spec_strategy(spec) == lane.strategy
                and str(spec.get("fault_model", "single")) == "single"
                and not spec.get("equiv")
                and str(spec.get("collect", "dense")) == "dense"
                and int(spec.get("start_num", 0)) == 0)

    def _complete_item(self, lane: _Lane) -> None:
        codes = (np.concatenate(lane.item_codes)
                 if lane.item_codes else np.zeros(0, np.int32))
        from coast_tpu_torch.fleet.worker import codes_sha256
        counts = cls.counts_dict(lane.item_counts, train=lane.train)
        seconds = time.monotonic() - lane.item_t0
        result = {
            "benchmark": lane.prog.region.name,
            "strategy": lane.strategy,
            "injections": int(lane.item_cursor),
            "seconds": round(seconds, 6),
            "counts": counts,
            "codes_sha256": codes_sha256(codes),
            "cache_event": "serve",
            "worker": self.worker_id,
            "summary": {
                "benchmark": lane.prog.region.name,
                "strategy": lane.strategy,
                "n": int(lane.item_cursor),
                "counts": counts,
                "profile": {
                    "device_seconds_histogram":
                        lane.item_hists["device"].snapshot(),
                    "host_gap_seconds_histogram":
                        lane.item_hists["gap"].snapshot(),
                },
            },
        }
        lane.item_journal.close()
        self.queue.complete(lane.item.id, self.worker_id, result)
        flightrec.record("serve_item_done", item=lane.item.id,
                         strategy=lane.strategy,
                         injections=int(lane.item_cursor))
        lane.item = None
        lane.item_journal = None
        lane.item_sched = None

    # -- request path --------------------------------------------------------
    def choose_strategy(self, sla_s: float) -> str:
        """Latency-budget strategy selection: DWC (detect-and-retry)
        when a rerun still fits the SLA, TMR (vote-through, no rerun)
        when it does not.  The estimate is the DWC lane's EWMA dispatch
        wall clock (a conservative 50 ms before the first dispatch)."""
        if "DWC" not in self._lanes:
            return next(iter(self._lanes))
        if "TMR" not in self._lanes:
            return "DWC"
        est = self._lanes["DWC"].est_s
        est = 0.05 if est is None else est
        return ("DWC" if sla_s >= self.retry_factor * est else "TMR")

    def submit(self, payload: str, sla_s: Optional[float] = None,
               strategy: Optional[str] = None) -> ServeRequest:
        """Admit one request (non-blocking); the caller waits on
        ``req.done`` and reads ``req.response`` / ``req.error``."""
        if self.error:
            raise RuntimeError(f"serve engine failed: {self.error}")
        sla = float(sla_s) if sla_s is not None else self.sla_default_s
        now = time.monotonic()
        with self._rid_lock:
            self._rid += 1
            rid = self._rid
        req = ServeRequest(rid=rid, payload=str(payload), sla_s=sla,
                           deadline=now + sla, t_submit=now,
                           strategy=(strategy
                                     or self.choose_strategy(sla)),
                           pinned=strategy is not None)
        self.admission.submit(req)
        self.metrics.note_admitted(req.strategy)
        flightrec.record("serve_admit", rid=rid, strategy=req.strategy,
                         sla_s=sla)
        return req

    def _reject(self, req: ServeRequest, reason: str) -> None:
        req.error = reason
        self.metrics.note_rejected(reason)
        flightrec.record("serve_reject", rid=req.rid, reason=reason,
                         strategy=req.strategy)
        req.done.set()

    # -- batch packing + the runtime lane-leak assert ------------------------
    def _pack(self, lane: _Lane, reqs: List[ServeRequest]
              ) -> Tuple[Dict[str, np.ndarray], int, int, int]:
        """Pack one dispatch: request rows [0, r), injection rows
        [r, r+i), disarmed padding after.  Returns (fault, r, i, shed).
        The injection share yields to request pressure, never the other
        way around."""
        B = self.batch_size
        r = len(reqs)
        want = int(round(self.inject_share * B))
        fit = min(want, B - r)
        shed = want - fit
        i = min(fit, lane.inject_remaining())
        if lane.item is not None:
            cols = lane.item_sched.slice(
                lane.item_cursor, lane.item_cursor + i).device_arrays()
        elif i:
            cols = lane.sched.slice(
                lane.cursor, lane.cursor + i).device_arrays()
        else:
            cols = {}
        fault: Dict[str, np.ndarray] = {}
        for key, noop_val in self._noop.items():
            col = np.full(B, noop_val, dtype=np.int32)
            if i:
                col[r:r + i] = np.asarray(cols[key], dtype=np.int32)
            fault[key] = col
        # Runtime lane-leak assert, derived from the ACTUAL dispatch
        # inputs (not the intent): an armed row is any row whose fault
        # fires at some step (t >= 0; the disarmed noop is t = -1).
        # Armed rows must be exactly the injection span -- anything
        # else means an injected fault shares a row with a response
        # gather, the one thing the prover says cannot propagate and
        # the packer must never permit positionally.
        armed = np.flatnonzero(np.asarray(fault["t"]) >= 0)
        ok = bool(np.all((armed >= r) & (armed < r + i)))
        self.metrics.note_lane_leak_check(violated=not ok)
        if not ok:
            flightrec.record("serve_lane_leak", strategy=lane.strategy,
                             r=r, i=i, armed=armed.tolist()[:32])
            flightrec.current().dump("serve_lane_leak",
                                     extra={"strategy": lane.strategy,
                                            "r": r, "i": i})
            raise LaneLeakError(
                f"armed fault rows {armed.tolist()[:8]} outside the "
                f"injection span [{r}, {r + i}) of a {lane.strategy} "
                "dispatch")
        return fault, r, i, shed

    # -- one dispatch --------------------------------------------------------
    def _dispatch(self, lane: _Lane, reqs: List[ServeRequest]) -> None:
        fault, r, i, shed = self._pack(lane, reqs)
        saturated = (r >= self.batch_size
                     and self.inject_share > 0.0)
        self.metrics.note_dispatch(i, shed, saturated)
        if shed:
            flightrec.record("serve_shed", strategy=lane.strategy,
                             shed_lanes=shed, requests=r)
        t0 = time.monotonic()
        gap = (t0 - lane.t_last_collect) if lane.t_last_collect else 0.0
        # The whole dispatch, not just the copy, runs under the watchdog:
        # the step loop syncs with the host every trip, so a wedged card
        # shows inside run_batch.
        def collect():
            with _on_device(self.device):
                return lane.run_batch(fault)

        out = watchdog_collect(collect, self.wedge_timeout_s)
        t1 = time.monotonic()
        lane.t_last_collect = t1
        dt = t1 - t0
        lane.dispatch_s += dt
        lane.est_s = dt if lane.est_s is None else (0.7 * lane.est_s
                                                    + 0.3 * dt)
        flightrec.record("serve_dispatch", strategy=lane.strategy,
                         requests=r, inject=i, seconds=round(dt, 6))
        self._finish_requests(lane, reqs, out, t1)
        if i:
            self._finish_injection(lane, out, r, i, gap, dt)

    def _finish_requests(self, lane: _Lane, reqs: List[ServeRequest],
                         out: Dict[str, np.ndarray], now: float) -> None:
        for k, req in enumerate(reqs):
            code = int(out["code"][k])
            name = cls.CLASS_NAMES[code]
            detected = (lane.strategy == "DWC"
                        and (name in _DWC_DETECTED
                             or (self.detect_hook is not None
                                 and self.detect_hook(req, code))))
            if detected:
                self._detected(lane, req, now)
                continue
            req.response = {
                "id": req.rid,
                "payload": req.payload,
                "digest": int(out["digest"][k]),
                "class": name,
                "strategy": lane.strategy,
            }
            req.done.set()
            self.metrics.note_served(now - req.t_submit)

    def _detected(self, lane: _Lane, req: ServeRequest,
                  now: float) -> None:
        """DWC detected a fault on a request row: rerun if a rerun still
        fits the SLA, escalate to TMR if only a single (vote-through)
        attempt does, reject otherwise.  The retry is journaled like any
        campaign record -- the service's own error path leaves the same
        durable trail a campaign batch does."""
        budget = req.budget_s(now)
        est = lane.est_s if lane.est_s is not None else 0.05
        j = lane.item_journal or lane.journal
        if budget >= self.retry_factor * est:
            req.retries += 1
            self.metrics.note_retry()
            if j is not None:
                j.append({"kind": "serve_retry", "rid": req.rid,
                          "attempt": req.retries,
                          "strategy": lane.strategy})
            flightrec.record("serve_retry", rid=req.rid,
                             attempt=req.retries)
            self.admission.requeue(req)
        elif ("TMR" in self._lanes and not req.escalated
              and budget >= est):
            req.strategy = "TMR"
            req.escalated = True
            self.metrics.note_escalation()
            if j is not None:
                j.append({"kind": "serve_escalate", "rid": req.rid,
                          "from": lane.strategy, "to": "TMR"})
            flightrec.record("serve_escalate", rid=req.rid,
                             budget_s=round(budget, 6),
                             est_s=round(est, 6))
            self.admission.requeue(req)
        else:
            self._reject(req, REJECT_SLA)

    def _finish_injection(self, lane: _Lane, out: Dict[str, np.ndarray],
                          r: int, i: int, gap: float, dt: float) -> None:
        codes = np.asarray(out["code"][r:r + i], dtype=np.int32)
        binc = np.bincount(codes, minlength=cls.NUM_CLASSES)
        sl = slice(r, r + i)
        batch_out = {k: np.asarray(out[k][sl]) for k in
                     ("code", "errors", "corrected", "steps")}
        advance = 0
        if lane.item is not None:
            lo = lane.item_cursor
            lane.item_counts += binc
            lane.item_cursor += i
            lane.item_codes.append(codes)
            lane.item_hists["device"].observe(dt)
            lane.item_hists["gap"].observe(gap)
            counts = cls.counts_dict(lane.item_counts, train=lane.train)
            lane.item_journal.append_batch(
                lo, batch_out, counts,
                {"dispatch": round(lane.dispatch_s, 6)})
            if lane.item_cursor >= lane.item_spec_n():
                self._complete_item(lane)
            elif time.monotonic() - lane.item_lease_t > 20.0:
                self.queue.renew(lane.item.id, self.worker_id,
                                 lease_s=60.0)
                lane.item_lease_t = time.monotonic()
        else:
            lo = lane.cursor
            lane.counts += binc
            # The standing cursor moves last, once the hub holds this
            # batch's counts: ``drain_injection`` reads the cursor, and a
            # summary taken right after it must count the batch.
            advance = i
            if lane.journal is not None:
                lane.journal.append_batch(
                    lo, batch_out,
                    cls.counts_dict(lane.counts, train=lane.train),
                    {"dispatch": round(lane.dispatch_s, 6)})
        merged = np.zeros(cls.NUM_CLASSES, dtype=np.int64)
        done = advance
        for other in self._lanes.values():
            merged += other.counts + other.item_counts
            done += other.cursor + other.item_cursor
        self.metrics.hub.record_batch(
            done, i, cls.counts_dict(merged, train=lane.train),
            {"dispatch": round(sum(x.dispatch_s
                                   for x in self._lanes.values()), 6)},
            {}, profile={"device_s": dt, "gap_s": gap})
        lane.cursor += advance

    # -- the loop ------------------------------------------------------------
    def start(self) -> "ServeEngine":
        if self._thread is not None:
            return self
        self.metrics.hub.campaign_started(
            self.benchmark, "serve",
            total_rows=self.inject_n * len(self._lanes),
            total_effective=self.inject_n * len(self._lanes))
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="coast-serve-loop",
                                        daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        try:
            with _on_device(self.device):
                self._serve_until_stopped()
        except BaseException as e:    # noqa: BLE001 - loop must not vanish
            self.error = f"{type(e).__name__}: {e}"
            flightrec.record("serve_loop_error", error=self.error)
            flightrec.current().dump("serve_loop_error",
                                     extra={"error": self.error})
            self._fail_pending()
            if not isinstance(e, LaneLeakError):
                raise

    def _serve_until_stopped(self) -> None:
        while not self._stop.is_set():
            worked = False
            for lane in self._lanes.values():
                reqs, expired = self.admission.take(
                    lane.strategy, self.batch_size)
                for req in expired:
                    self._reject(req, REJECT_DEADLINE)
                if self.inject_share > 0.0:
                    self._claim_item(lane)
                if reqs or lane.inject_remaining():
                    self._dispatch(lane, reqs)
                    worked = True
            self.metrics.maybe_write_status()
            if not worked:
                self.admission.wait(0.05)
            elif self.idle_throttle_s and not self.admission.pending():
                time.sleep(self.idle_throttle_s)

    def _fail_pending(self) -> None:
        for strategy in self._lanes:
            while True:
                reqs, expired = self.admission.take(strategy,
                                                    self.batch_size)
                if not reqs and not expired:
                    break
                for req in reqs + expired:
                    self._reject(req, "server_error")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=60.0)
            self._thread = None
        self._fail_pending()
        for lane in self._lanes.values():
            if lane.item_journal is not None:
                lane.item_journal.close()
                lane.item_journal = None
            if lane.journal is not None:
                lane.journal.close()
                lane.journal = None
        self.metrics.hub.campaign_finished(summary=None,
                                           error=self.error)
        self.metrics.maybe_write_status(force=True)

    def __enter__(self) -> "ServeEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- drains + artifact ---------------------------------------------------
    def drain_injection(self, timeout_s: float = 120.0) -> bool:
        """Block until every lane's standing schedule is fully injected
        and any queue items are completed (tests + bounded runs)."""
        t_end = time.monotonic() + timeout_s
        while time.monotonic() < t_end:
            if self.error:
                return False
            if all(lane.inject_remaining() == 0 and lane.item is None
                   for lane in self._lanes.values()):
                return True
            time.sleep(0.01)
        return False

    def summary(self) -> Dict[str, object]:
        """The run artifact block: proofs, serving counters, injection
        counts + live SLO verdicts (the loadtest/smoke artifact body and
        the json_parser ``serving`` input)."""
        merged = np.zeros(cls.NUM_CLASSES, dtype=np.int64)
        train = False
        for lane in self._lanes.values():
            merged += lane.counts + lane.item_counts
            train = train or lane.train
        doc: Dict[str, object] = {
            "benchmark": self.benchmark,
            "strategies": sorted(self._lanes),
            "batch_size": self.batch_size,
            "inject_share": self.inject_share,
            "proofs": {s: lane.proof.summary()
                       for s, lane in self._lanes.items()},
            "counts": cls.counts_dict(merged, train=train),
            "serving": self.metrics.serving_block(),
        }
        slo = self.metrics.hub.slo_status()
        if slo is not None:
            from coast_tpu_torch.obs.slo import summary_block
            doc["slo"] = summary_block(slo)
        if self.error:
            doc["error"] = self.error
        return doc

    def lane_codes(self, strategy: str) -> np.ndarray:
        """Concatenated injection-lane class codes for ``strategy`` from
        its standing journal FILE (the bit-for-bit resume pin's probe).
        Re-loaded from disk on every call: the open journal's in-memory
        records hold only what resume loaded, never live appends."""
        if not self.journal_dir:
            raise ValueError("engine has no standing journal_dir")
        path = os.path.join(self.journal_dir,
                            f"serve-{strategy}.journal")
        _, records, _ = CampaignJournal._load(path)
        codes = [np.asarray(r["codes"], dtype=np.int32)
                 for r in records if r.get("kind") == "batch"]
        if not codes:
            return np.zeros(0, dtype=np.int32)
        return np.concatenate(codes)
