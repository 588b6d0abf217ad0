"""coast_tpu_torch.obs: campaign telemetry of the port (spans, live
metrics, trace export, profiling).

The observability layer of the injection pipeline, with the reference's
module names and output formats: nested wall-clock spans and counters
(:mod:`~coast_tpu_torch.obs.spans`), Chrome/Perfetto ``trace_event``
export (:mod:`~coast_tpu_torch.obs.trace_export`), a rate-limited
progress heartbeat (:mod:`~coast_tpu_torch.obs.heartbeat`), live
per-batch metrics (:mod:`~coast_tpu_torch.obs.metrics`) with a stdlib
HTTP endpoint (:mod:`~coast_tpu_torch.obs.serve`), statistical
convergence with Wilson-interval early stop
(:mod:`~coast_tpu_torch.obs.convergence`), a live TTY dashboard
(:mod:`~coast_tpu_torch.obs.console`), per-dispatch device-time
attribution (:mod:`~coast_tpu_torch.obs.profiler`) with roofline/MFU
accounting (:mod:`~coast_tpu_torch.obs.roofline`), fleet trace
federation (:mod:`~coast_tpu_torch.obs.federate`), declarative
reliability SLOs with error-budget burn rates
(:mod:`~coast_tpu_torch.obs.slo`), and a blackbox flight recorder
(:mod:`~coast_tpu_torch.obs.flightrec`).
"""

from coast_tpu_torch.obs.console import Console
from coast_tpu_torch.obs.convergence import (ConvergenceTracker, StopWhen,
                                             StopWhenError, wilson_interval)
from coast_tpu_torch.obs.federate import merge_traces, write_merged_trace
from coast_tpu_torch.obs.flightrec import FlightRecorder
from coast_tpu_torch.obs.heartbeat import Heartbeat
from coast_tpu_torch.obs.metrics import (CampaignMetrics, Histogram, Ring,
                                         atomic_write_json)
from coast_tpu_torch.obs.profiler import CampaignProfiler
from coast_tpu_torch.obs.serve import MetricsServer
from coast_tpu_torch.obs.slo import SLOError, SLOSet, SLOSpec
from coast_tpu_torch.obs.spans import (NULL, Telemetry, count, current,
                                       instant, span)
from coast_tpu_torch.obs.trace_export import (to_trace_doc, to_trace_events,
                                              write_trace)

__all__ = [
    "Telemetry", "NULL", "current", "span", "count", "instant",
    "to_trace_events", "to_trace_doc", "write_trace",
    "Heartbeat", "Console",
    "CampaignMetrics", "Histogram", "Ring", "MetricsServer",
    "atomic_write_json",
    "CampaignProfiler", "merge_traces", "write_merged_trace",
    "ConvergenceTracker", "StopWhen", "StopWhenError", "wilson_interval",
    "FlightRecorder", "SLOSpec", "SLOSet", "SLOError",
]
