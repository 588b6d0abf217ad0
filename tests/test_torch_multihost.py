"""The port's multi-process worker over ``torch.distributed``.

Real processes, each its own ``gloo`` rank on the CPU, joined through a
``tcp://`` coordinator on a free localhost port: the worker CLI
(``python -m coast_tpu_torch.parallel.multihost``) prints the same global
counts in every process, equal to the reference's sharded histogram of the
same campaign over as many devices; and the stencil's
``run_distributed_group`` (edge columns by ``batch_isend_irecv``) equals
``golden_trajectory`` bit for bit.  On the card, a one-rank ``nccl`` group
does both.  Every process has a 120 s timeout.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    return {**os.environ, "PYTHONPATH": _REPO + os.pathsep
            + os.environ.get("PYTHONPATH", "")}


def _run_all(cmds):
    """Start every command, then wait for each; returns their stdouts."""
    procs = [subprocess.Popen(cmd, env=_env(), cwd=_REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT)
            outs.append(out)
            assert p.returncode == 0, out[-2000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _worker_cmds(bench, world, local, extra):
    port = _free_port()
    cmds = []
    for pid in range(world):
        cmd = [sys.executable, "-m", "coast_tpu_torch.parallel.multihost",
               bench, "--coordinator", f"127.0.0.1:{port}",
               "--num-processes", str(world), "--process-id", str(pid),
               *extra]
        if local:
            cmd += ["--local-devices", str(local)]
        cmds.append(cmd)
    return cmds


def _counts_lines(outs):
    return [next(ln for ln in out.splitlines() if "counts=" in ln)
            for out in outs]


def _reference_histogram(bench, strategy, devices, n, seed, batch):
    import coast_tpu
    from coast_tpu.models import REGISTRY as JREGISTRY
    from coast_tpu.parallel.mesh import ShardedCampaignRunner, make_mesh
    prog = getattr(coast_tpu, strategy)(JREGISTRY[bench]())
    return ShardedCampaignRunner(prog, make_mesh(devices),
                                 strategy_name=strategy).run_histogram(
        n, seed=seed, batch_size=batch)


@pytest.mark.parametrize("bench,strategy,world,local,n,batch", [
    ("matrixMultiply", "TMR", 2, 4, 512, 256),
    ("crc16", "DWC", 3, 2, 300, 96),
    ("stencil", "TMR", 2, 1, 256, 64),
], ids=["mm_tmr_2x4", "crc16_dwc_3x2", "stencil_tmr_2x1"])
def test_worker_processes_print_the_reference_counts(bench, strategy, world,
                                                     local, n, batch):
    outs = _run_all(_worker_cmds(
        bench, world, local, ["-e", str(n), "--seed", "21", "--batch-size",
                              str(batch), "--strategy", strategy]))
    lines = _counts_lines(outs)
    counts = [ln.split("counts=", 1)[1] for ln in lines]
    assert len(set(counts)) == 1, lines
    for pid, line in enumerate(lines):
        assert line.startswith(f"[proc {pid}/{world}] "
                               f"devices={world * local} ")
    want = _reference_histogram(bench, strategy, world * local, n, 21, batch)
    assert counts[0] == str(want), (counts[0], want)


_DISTRIBUTED = """
import sys
import numpy as np
import torch.distributed as dist
from coast_tpu_torch.models import stencil
from coast_tpu_torch.parallel.multihost import init_multihost
port, rank, world, backend = sys.argv[1:5]
init_multihost(f"127.0.0.1:{port}", int(world), int(rank), backend=backend)
got = stencil.run_distributed_group()
dist.destroy_process_group()
print("grid", ",".join(str(int(v)) for v in got.reshape(-1)))
"""


def _distributed_grids(world, backend="gloo"):
    port = _free_port()
    outs = _run_all([[sys.executable, "-c", _DISTRIBUTED, str(port),
                      str(rank), str(world), backend]
                     for rank in range(world)])
    grids = []
    for out in outs:
        line = next(ln for ln in out.splitlines() if ln.startswith("grid "))
        grids.append(np.array([int(v) for v in line[5:].split(",")],
                              np.uint32))
    return grids


@pytest.mark.parametrize("world", (2, 3))
def test_run_distributed_over_a_gloo_group_equals_golden(world):
    from coast_tpu_torch.models import stencil
    want = stencil.golden_trajectory().reshape(-1)
    for grid in _distributed_grids(world):
        np.testing.assert_array_equal(grid, want)


def test_worker_refuses_an_unknown_benchmark():
    proc = subprocess.run(
        [sys.executable, "-m", "coast_tpu_torch.parallel.multihost",
         "noSuchBench"], env=_env(), cwd=_REPO, capture_output=True,
        text=True, timeout=TIMEOUT)
    assert proc.returncode == 2 and "invalid choice" in proc.stderr


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host; nccl needs one")
    return torch.device("cuda")


@pytest.mark.cuda
def test_one_rank_nccl_group(cuda):
    """One nccl rank on the card: the worker's counts equal the
    single-process sharded histogram on the card, and run_distributed_group
    equals the golden."""
    import coast_tpu_torch as ct
    from coast_tpu_torch.models import REGISTRY, stencil
    from coast_tpu_torch.parallel.mesh import ShardedCampaignRunner, make_mesh
    outs = _run_all(_worker_cmds("stencil", 1, 0, ["-e", "4096", "--seed",
                                                   "21"]))
    line = _counts_lines(outs)[0]
    assert line.startswith("[proc 0/1] devices=1 ")
    want = ShardedCampaignRunner(ct.TMR(REGISTRY["stencil"](), device=cuda),
                                 make_mesh(1)).run_histogram(
        4096, seed=21, batch_size=1024)
    assert line.split("counts=", 1)[1] == str(want)
    (grid,) = _distributed_grids(1, backend="nccl")
    np.testing.assert_array_equal(grid,
                                  stencil.golden_trajectory().reshape(-1))
