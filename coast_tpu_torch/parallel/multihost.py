"""Multi-process campaign scale-out over ``torch.distributed``.

The counterpart of ``coast_tpu/parallel/multihost.py``, where every host
joins one multi-process JAX runtime and the sharded histogram is
``psum``'d across it.  Here every process joins one process group
(:func:`init_multihost`: ``gloo`` for CPU tensors, ``nccl`` for CUDA
ones, a ``tcp://`` coordinator), builds the same global mesh -- its own
shards plus the other processes' -- and runs its contiguous block of every
batch; the class histogram is ``all_reduce``'d, so every process prints
the same global counts.  Per-run records never cross processes.

Worker CLI (one invocation per process)::

    python -m coast_tpu_torch.parallel.multihost matrixMultiply \\
        --coordinator HOST:PORT --num-processes 2 --process-id 0 \\
        -e 4096 --seed 21

With ``--local-devices K`` a process runs K logical CPU shards over
``gloo`` (the rehearsal of several hosts on one machine); without it, one
shard on the card (``cuda:<process id mod card count>``) over ``nccl``.
Without ``--coordinator`` the group reads the ``env://`` variables a
launcher such as ``torchrun`` sets.  Every process prints ``[proc i/N]
devices=D counts={...}``; exit code 0 on success.
"""

from __future__ import annotations

import os
import sys
from typing import Optional


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   backend: str = "gloo") -> None:
    """Join the process group: ``backend`` is ``gloo`` (CPU tensors) or
    ``nccl`` (CUDA tensors).  With no coordinator the ``env://`` variables
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``) name the
    group; otherwise ``tcp://<coordinator>`` with the given size and rank."""
    import torch.distributed as dist

    if coordinator_address is None:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend,
                                init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)


def main(argv=None) -> int:
    import argparse

    from coast_tpu_torch.models import REGISTRY

    ap = argparse.ArgumentParser(
        prog="coast_tpu_torch.parallel.multihost",
        description="one worker of a multi-process sharded fault-injection "
                    "campaign; run once per process")
    ap.add_argument("benchmark", choices=sorted(REGISTRY))
    ap.add_argument("--coordinator", metavar="HOST:PORT",
                    help="coordinator address (omit under a launcher that "
                         "sets the env:// variables)")
    ap.add_argument("--num-processes", type=int)
    ap.add_argument("--process-id", type=int)
    ap.add_argument("--local-devices", type=int, default=0,
                    help="run N logical CPU shards a process over gloo "
                         "(rehearsal mode; 0 = one shard on the card, "
                         "over nccl)")
    ap.add_argument("-e", type=int, default=4096, metavar="N",
                    help="total injections across all processes")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--strategy", default="TMR", choices=("TMR", "DWC"))
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from coast_tpu_torch.parallel.mesh import Mesh, ShardedCampaignRunner
    from coast_tpu_torch.passes.strategies import DWC, TMR

    rehearsal = args.local_devices > 0
    if not rehearsal:
        # The rank's card, chosen before nccl joins the group.
        rank = args.process_id
        if rank is None:
            rank = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK",
                                                                   0)))
        torch.cuda.set_device(rank % torch.cuda.device_count())
    init_multihost(args.coordinator, args.num_processes, args.process_id,
                   backend="gloo" if rehearsal else "nccl")
    try:
        rank, world = dist.get_rank(), dist.get_world_size()
        if rehearsal:
            device, local = torch.device("cpu"), args.local_devices
        else:
            device = torch.device("cuda", torch.cuda.current_device())
            local = 1
        devices = np.empty(world * local, dtype=object)
        devices[:] = [device] * (world * local)
        mesh = Mesh(devices, ("data",), process_count=world,
                    process_index=rank, group=dist.group.WORLD)
        region = REGISTRY[args.benchmark]()
        prog = (TMR if args.strategy == "TMR" else DWC)(region,
                                                        device=device)
        runner = ShardedCampaignRunner(prog, mesh,
                                       strategy_name=args.strategy)
        counts = runner.run_histogram(args.e, seed=args.seed,
                                      batch_size=args.batch_size)
        # Every process holds the all_reduce'd histogram; the process id
        # lets a launcher check that they agree.
        print(f"[proc {rank}/{world}] devices={mesh.size} counts={counts}",
              flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
