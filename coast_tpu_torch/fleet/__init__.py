"""coast_tpu_torch.fleet: campaign fleet -- many campaigns x many workers.

The port's copy of ``coast_tpu/fleet``: the scale-out layer above
:class:`~coast_tpu_torch.inject.campaign.CampaignRunner`.  One process
per worker, one durable file-based queue per fleet, one journal per work
item:

  * :mod:`coast_tpu_torch.fleet.queue` -- crash-safe campaign queue with
    atomic claim / lease / requeue semantics (rename-based, lockless);
  * :mod:`coast_tpu_torch.fleet.worker` -- SIGKILL-surviving worker
    loop: a restarted worker resumes the claimed item's journal
    bit-for-bit;
  * :mod:`coast_tpu_torch.fleet.compile_cache` -- the build cache
    keyed by the journal's config-sha + mesh geometry, so the native
    kernel build and the program build are paid once per config;
  * :mod:`coast_tpu_torch.fleet.telemetry` -- merged fleet /metrics +
    /status served through the stock
    :class:`coast_tpu_torch.obs.serve.MetricsServer`;
  * :mod:`coast_tpu_torch.fleet.supervisor` -- the ``python -m
    coast_tpu_torch.fleet`` CLI (enqueue / run / worker / status /
    merge) with the parity-checked fleet merge.

The queue's on-disk format is the reference's, so either package drains a
queue the other wrote.
"""

from coast_tpu_torch.fleet.compile_cache import CompileCache
from coast_tpu_torch.fleet.queue import (CampaignQueue, LostLeaseError,
                                         QueueError, QueueItem, item_spec)
from coast_tpu_torch.fleet.supervisor import FleetParityError, merge_fleet
from coast_tpu_torch.fleet.telemetry import FleetTelemetry
from coast_tpu_torch.fleet.worker import Worker, codes_sha256

__all__ = [
    "CampaignQueue", "QueueItem", "QueueError", "LostLeaseError",
    "item_spec", "Worker", "codes_sha256", "CompileCache",
    "FleetTelemetry", "FleetParityError", "merge_fleet",
]
