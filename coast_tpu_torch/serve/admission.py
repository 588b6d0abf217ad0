"""SLA-aware request admission: deadline-ordered, shed-by-injection.

The port's copy of ``coast_tpu/serve/admission.py`` (pure host code).

One in-process queue per protection strategy, ordered by absolute
deadline (earliest first) -- the serving analogue of the fleet
:class:`~coast_tpu_torch.fleet.queue.CampaignQueue`'s pending directory,
which the engine uses for the *injection* work riding the same batches.
The shedding policy is asymmetric by design: when a dispatch cycle is
oversubscribed, the batch packer shrinks the injection share first
(measurement consumes slack capacity) and the request share never; a
request is only ever dropped when its own deadline has already passed,
and that drop is an explicit typed rejection, not a silent timeout.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = ["ServeRequest", "AdmissionQueue", "REJECT_DEADLINE",
           "REJECT_SLA"]

#: Rejection reasons (the response's ``error`` field vocabulary).
REJECT_DEADLINE = "deadline_expired"
REJECT_SLA = "sla_exceeded"


@dataclasses.dataclass
class ServeRequest:
    """One in-flight request: payload + SLA budget + completion event.

    ``deadline`` is monotonic-clock absolute; ``strategy`` is assigned
    at admission (latency-budget selection) and may change once -- a
    DWC detection whose retry no longer fits the SLA escalates the
    request to TMR (``escalated``).  ``response`` carries ONLY
    deterministic fields (id, payload echo, output digest, class,
    strategy): timing lives in the metrics hub, so two runs of the same
    request stream serialize byte-identically regardless of load or
    injection share."""

    rid: int
    payload: str
    sla_s: float
    deadline: float
    t_submit: float
    strategy: str = ""
    pinned: bool = False       # caller chose the strategy explicitly
    retries: int = 0
    escalated: bool = False
    response: Optional[Dict[str, object]] = None
    error: Optional[str] = None
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event)

    def budget_s(self, now: Optional[float] = None) -> float:
        """Remaining latency budget (seconds; negative = expired)."""
        return self.deadline - (time.monotonic() if now is None else now)


class AdmissionQueue:
    """Deadline-ordered admission over the configured strategies.

    Writers (``submit`` / ``requeue``) are the HTTP handler threads and
    the engine's retry path; the single reader is the dispatch loop
    (``take``).  ``take`` pops at most ``limit`` requests whose
    deadlines still hold and returns the expired ones separately so the
    engine rejects them explicitly (and counts them) instead of letting
    them rot in the heap."""

    def __init__(self, strategies: Tuple[str, ...] = ("DWC", "TMR")):
        self.strategies = tuple(strategies)
        self._heaps: Dict[str, List[Tuple[float, int, ServeRequest]]] = {
            s: [] for s in self.strategies}
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._seq = itertools.count()
        self.submitted = 0

    def submit(self, req: ServeRequest) -> None:
        if req.strategy not in self._heaps:
            raise ValueError(
                f"unknown strategy {req.strategy!r}; one of "
                f"{self.strategies}")
        with self._wake:
            heapq.heappush(self._heaps[req.strategy],
                           (req.deadline, next(self._seq), req))
            self.submitted += 1
            self._wake.notify()

    def requeue(self, req: ServeRequest) -> None:
        """Push a retried/escalated request back, keeping its original
        deadline (an SLA is a promise about the ORIGINAL submission; a
        retry does not reset the clock)."""
        with self._wake:
            heapq.heappush(self._heaps[req.strategy],
                           (req.deadline, next(self._seq), req))
            self._wake.notify()

    def take(self, strategy: str, limit: int,
             now: Optional[float] = None
             ) -> Tuple[List[ServeRequest], List[ServeRequest]]:
        """Pop up to ``limit`` live requests for ``strategy`` (deadline
        order) -> ``(admitted, expired)``.  Expired requests are popped
        past greedily even beyond ``limit`` -- they occupy no batch row,
        and leaving them queued would starve the heap head."""
        t = time.monotonic() if now is None else now
        admitted: List[ServeRequest] = []
        expired: List[ServeRequest] = []
        with self._lock:
            heap = self._heaps[strategy]
            while heap and len(admitted) < limit:
                _, _, req = heapq.heappop(heap)
                (expired if req.deadline < t else admitted).append(req)
        return admitted, expired

    def pending(self) -> int:
        with self._lock:
            return sum(len(h) for h in self._heaps.values())

    def wait(self, timeout: float) -> bool:
        """Block until a submit/requeue lands or ``timeout`` elapses;
        True if work may be pending (the dispatch loop's idle park)."""
        with self._wake:
            if any(self._heaps.values()):
                return True
            return self._wake.wait(timeout)
