"""Continuous-protection serving: a protected inference service that
measures its own SDC rate under live traffic.

The port's copy of ``coast_tpu/serve``, on a device (the card unless the
caller passes ``device="cpu"`` / ``-d cpu``): each dispatch is one
``ProtectedProgram.run_batch`` over the co-packed rows where the
reference runs one ``jit(vmap(run_one))``.

Offline campaigns answer "what WAS this program's SDC rate"; a serving
system needs "what IS it, right now, on the binary actually taking
traffic".  This package fuses the two: every dispatch packs
live **request lanes** and spare-capacity **injection lanes** into one
protected batch (rows of the same protected step the campaign engine
runs), so the service continuously re-measures its own SDC/DUE
rates on the exact program serving users -- no shadow fleet, no stale
offline numbers.

The pieces, each reusing a subsystem of the package:

  * :mod:`~coast_tpu_torch.serve.admission` -- deadline-ordered request
    admission.  Load shedding shrinks the injection share first and the
    request share never (the measurement is the slack consumer, not the
    traffic).
  * :mod:`~coast_tpu_torch.serve.engine` -- the batched dispatch loop:
    per-request strategy selection by latency budget (DWC detect-and-
    retry when a rerun fits the SLA, TMR when it doesn't), the
    injection-lane campaign journaled crash-safe like any other
    (:mod:`coast_tpu_torch.inject.journal`), and the lane-isolation
    noninterference prover (:mod:`coast_tpu_torch.analysis.propagation`) as a
    build gate -- a refuted proof refuses to start serving -- plus a
    runtime assert that armed-lane indices never intersect the response
    gather.
  * :mod:`~coast_tpu_torch.serve.metrics` -- the serving hub: injection-lane
    outcomes feed :class:`~coast_tpu_torch.obs.metrics.CampaignMetrics` /
    :class:`~coast_tpu_torch.obs.slo.SLOSet` live, so ``/status`` and
    Prometheus report the service's own SDC rate (Wilson CI), DUE rate,
    availability, and p50/p99 dispatch latency as SLOs with burn
    verdicts.
  * :mod:`~coast_tpu_torch.serve.front` -- the stdlib HTTP front (the
    ``obs/serve.py`` server shape) and the ``python -m coast_tpu_torch
    serve`` CLI.

FastFlip (arXiv:2403.13989) motivates spending injection capacity
continuously where the evidence is thin; FuzzyFlow (arXiv:2306.16178)
motivates the differential contract the smoke driver pins: served
responses are bit-identical with injection lanes on vs off.
"""

from coast_tpu_torch.serve.admission import AdmissionQueue, ServeRequest
from coast_tpu_torch.serve.engine import (IsolationRefusedError,
                                          LaneLeakError, ServeEngine)
from coast_tpu_torch.serve.front import ServeFront
from coast_tpu_torch.serve.metrics import ServeMetrics

__all__ = [
    "AdmissionQueue", "ServeRequest", "ServeEngine", "ServeFront",
    "ServeMetrics", "IsolationRefusedError", "LaneLeakError",
]
