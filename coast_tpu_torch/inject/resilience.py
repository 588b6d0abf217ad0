"""Fault-tolerant dispatch: retries, OOM degradation, collect watchdog.

The counterpart of ``coast_tpu/inject/resilience.py``.  A batch of the
port's runner fails in one of four ways:

  * **transient** runtime errors (a dropped connection, a preempted
    context): the batch is re-dispatched -- the schedule is seeded, so a
    re-run is bit-identical;
  * **out of memory** (``torch.OutOfMemoryError``, "CUDA out of memory.
    Tried to allocate ..."): the batch geometry was too ambitious for the
    card, so the runner frees the caching allocator, halves
    ``batch_size``, re-pads and journals the new geometry;
  * **a wedged collect**: the device-to-host copy of a batch's result
    columns does not return within ``collect_timeout``;
    :func:`watchdog_collect` raises :class:`CampaignWedgedError` and the
    batch is re-dispatched;
  * **fatal**: everything else, re-raised unchanged -- a bug must never be
    retried into silence, and neither may a sticky CUDA error.

:class:`RetryPolicy` holds the knobs (attempts, backoff with jitter,
per-error-class handling, the collect timeout, the degradation floor).
Retries and degradations land in ``CampaignResult.summary()["resilience"]``
and, with a journal, as ``retry`` / ``geometry`` records.
"""

from __future__ import annotations

import dataclasses
import random
import threading
from typing import Optional, Tuple

__all__ = ["CampaignWedgedError", "RetryPolicy", "watchdog_collect"]


class CampaignWedgedError(RuntimeError):
    """The blocking collect (the device-to-host copy of a batch's result
    columns) exceeded the watchdog timeout: the batch is considered
    wedged, like a QEMU run that stops answering GDB.  The retry loop
    re-dispatches the batch."""


#: Message substrings of a CUDA library's own allocation failure: an
#: out-of-memory failure (the context stays usable), checked before the
#: sticky patterns, which would otherwise match "CUBLAS_STATUS_".
CUDA_OOM_PATTERNS: Tuple[str, ...] = (
    "CUBLAS_STATUS_ALLOC_FAILED", "CUDNN_STATUS_ALLOC_FAILED",
)

#: Message substrings of a sticky CUDA error.  Departure from the
#: reference, which has no such class: after an illegal or misaligned
#: address, a device-side assert or a failed launch the CUDA context is
#: dead, and a re-dispatch would only fail again or hang, so these are
#: fatal whatever else the message holds.  They are checked before every
#: other pattern: "CUBLAS_STATUS_INTERNAL_ERROR" contains the transient
#: pattern "INTERNAL", and a K1/K2 wrapper's "launch failed: cudaError N"
#: (``ops/hopper_voters.py``, ``ops/hopper_commit.py``) is fatal even for
#: N = 2 (an allocation failure inside the launch).
STICKY_CUDA_PATTERNS: Tuple[str, ...] = (
    "illegal memory access", "illegal address", "misaligned address",
    "illegal instruction", "device-side assert", "unspecified launch failure",
    "launch failed: cudaError", "CUBLAS_STATUS_", "CUDNN_STATUS_",
    "uncorrectable ECC", "hardware stop",
)

#: Message substrings that identify an out-of-memory failure: the
#: reference's (XLA's RESOURCE_EXHAUSTED and the prose forms), which
#: cover torch's "CUDA out of memory. Tried to allocate ...".
#: ``torch.OutOfMemoryError`` is also matched by class name
#: (:data:`_OOM_ERROR_NAMES`), so the port never imports torch here.
OOM_PATTERNS: Tuple[str, ...] = (
    "RESOURCE_EXHAUSTED", "Out of memory", "out of memory", "OOM",
    "Attempting to allocate",
)

#: Message substrings that identify a transient runtime failure worth
#: re-dispatching: device preemption, tunnel drops, transport errors.
TRANSIENT_PATTERNS: Tuple[str, ...] = (
    "UNAVAILABLE", "DEADLINE_EXCEEDED", "ABORTED", "DATA_LOSS",
    "INTERNAL", "CANCELLED", "Socket closed", "connection reset",
    "Connection reset", "failed to connect", "preempted",
)

#: Exception class names (any class in the MRO) whose messages are
#: eligible for pattern classification.  Arbitrary Python exceptions
#: (KeyError from a bug, KeyboardInterrupt) stay fatal no matter what
#: their message happens to contain.
_RUNTIME_ERROR_NAMES = frozenset({
    "XlaRuntimeError", "JaxRuntimeError", "RuntimeError", "OSError",
    "ConnectionError", "InternalError", "ResourceExhaustedError",
})

#: Exception class names (any class in the MRO) that are an
#: out-of-memory failure whatever their message: torch's
#: ``OutOfMemoryError`` (``torch.cuda.OutOfMemoryError``), a
#: ``RuntimeError`` subclass.
_OOM_ERROR_NAMES = frozenset({"OutOfMemoryError"})


def _is_runtime_error(exc: BaseException) -> bool:
    return any(t.__name__ in _RUNTIME_ERROR_NAMES
               for t in type(exc).__mro__)


@dataclasses.dataclass
class RetryPolicy:
    """Retry/degradation knobs for one campaign runner.

    ``max_attempts`` counts the first try: 3 means one dispatch plus up
    to two retries per batch.  Backoff before retry *k* (1-based) is
    ``min(max_delay, base_delay * 2**(k-1))`` scaled by up to
    ``jitter`` of random spread, so a fleet of resumed campaigns does
    not re-dispatch in lockstep.

    ``collect_timeout`` (seconds) arms the collect watchdog: a blocking
    device-to-host copy that exceeds it raises
    :class:`CampaignWedgedError`, which this policy classes as a
    re-dispatch.  ``None``/0 disables the watchdog (no extra thread).

    ``oom_degrade``: on an OOM the runner halves ``batch_size`` (never
    below ``min_batch_size``), re-pads, and journals the
    new geometry instead of retrying a shape that cannot fit.

    ``transient_types`` / ``oom_types`` / ``fatal_types`` extend the
    built-in classification with exact exception types (tests inject
    fakes this way; ``fatal_types`` wins)."""

    max_attempts: int = 3
    base_delay: float = 0.25
    max_delay: float = 30.0
    jitter: float = 0.25
    collect_timeout: Optional[float] = None
    oom_degrade: bool = True
    min_batch_size: int = 1
    transient_types: Tuple[type, ...] = ()
    oom_types: Tuple[type, ...] = ()
    fatal_types: Tuple[type, ...] = ()

    # -- classification ------------------------------------------------------
    def classify(self, exc: BaseException) -> str:
        """'wedged' | 'oom' | 'transient' | 'fatal' for one failure.
        Sticky CUDA errors are fatal before any other rule applies (see
        :data:`STICKY_CUDA_PATTERNS`)."""
        if isinstance(exc, CampaignWedgedError):
            return "wedged"
        if self.fatal_types and isinstance(exc, self.fatal_types):
            return "fatal"
        if _is_runtime_error(exc):
            if any(p in str(exc) for p in CUDA_OOM_PATTERNS):
                return "oom"
            if any(p in str(exc) for p in STICKY_CUDA_PATTERNS):
                return "fatal"
        if any(t.__name__ in _OOM_ERROR_NAMES for t in type(exc).__mro__):
            return "oom"
        if self.oom_types and isinstance(exc, self.oom_types):
            return "oom"
        if self.transient_types and isinstance(exc, self.transient_types):
            return "transient"
        if _is_runtime_error(exc):
            msg = str(exc)
            if any(p in msg for p in OOM_PATTERNS):
                return "oom"
            if any(p in msg for p in TRANSIENT_PATTERNS):
                return "transient"
        return "fatal"

    def backoff(self, attempt: int) -> float:
        """Sleep before retry ``attempt`` (1-based): exponential with
        jitter."""
        base = min(self.max_delay, self.base_delay * (2 ** (attempt - 1)))
        if self.jitter:
            base *= 1.0 + self.jitter * random.random()
        return base

    def degraded_batch(self, batch_size: int) -> Optional[int]:
        """The next batch size after an OOM, or None when degradation is
        off / already at the floor (the OOM is then fatal)."""
        if not self.oom_degrade:
            return None
        new = max(self.min_batch_size, batch_size // 2)
        return new if new < batch_size else None


def watchdog_collect(fn, timeout: Optional[float]):
    """Run the blocking collect ``fn()`` under a watchdog.

    Without a timeout this is a plain call (no thread).  With one, the
    collect runs in a daemon thread; if it has not returned within
    ``timeout`` seconds a :class:`CampaignWedgedError` is raised and the
    wedged thread is abandoned (it holds a copy of one batch's result
    columns, not the engine: a re-dispatch allocates its own tensors, and
    a daemon thread cannot keep the process alive).  A fire is counted
    in the ambient span recorder (``watchdog_fired``) and dumps the flight
    recorder's bundle before the wedged thread is abandoned, so the
    bundle's stacks still hold the hung collect."""
    if not timeout or timeout <= 0:
        return fn()
    box: dict = {}
    done = threading.Event()

    def _target():
        try:
            box["value"] = fn()
        except BaseException as e:          # noqa: BLE001 - re-raised below
            box["error"] = e
        finally:
            done.set()

    th = threading.Thread(target=_target, daemon=True,
                          name="coast-collect-watchdog")
    th.start()
    if not done.wait(timeout):
        from coast_tpu_torch.obs import flightrec, spans
        spans.current().count("watchdog_fired", timeout_s=timeout)
        flightrec.record("watchdog_fired", timeout_s=timeout)
        flightrec.current().dump("watchdog_wedge",
                                 extra={"timeout_s": timeout})
        raise CampaignWedgedError(
            f"collect did not return within {timeout}s; batch presumed "
            "wedged (device-to-host copy hung) -- re-dispatching")
    if "error" in box:
        raise box["error"]
    return box["value"]
