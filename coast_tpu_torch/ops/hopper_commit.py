"""K2 on Hopper: the fused flip + vote + repair as a hand-written CUDA kernel.

Replaces the Pallas TPU kernel ``coast_tpu/ops/fused_step.py``
``_commit_kernel``; the CUDA source and its design note are
``coast_tpu_torch/csrc/commit.cu``.  :func:`commit_sites` commits every
replica set of one engine sync point in one launch.  Its plain version is
``coast_tpu_torch/ops/fused_step.py`` ``plain_commit_sites``, which
``fused_step.commit_sites`` and ``fused_step.vote_flip_commit`` take only
for a tensor that lies on the CPU; on a CUDA tensor they call
:func:`commit_sites` here, which launches the kernel or raises.  There is
no size floor and no fall back.

``LAUNCHES`` counts kernel launches (one per call on the card), so a run
can show that its fused commits went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import torch

from coast_tpu_torch import build
from coast_tpu_torch.ops import site_table

LAUNCHES = 0

#: One site of a grouped commit: ``(lanes [R, n, *leaf], masks)``, masks an
#: int32 tensor of the same shape or None for no flip.
CommitSite = Tuple[torch.Tensor, Optional[torch.Tensor]]


@functools.lru_cache(maxsize=None)
def _kernel():
    """``coast_commit_sites`` of the built library, its C signature
    declared."""
    fn = build.load("commit").coast_commit_sites
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def commit_sites(sites: Sequence[CommitSite], num_clones: int
                 ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                            torch.Tensor]:
    """K2 over every site of one sync point in one launch -> ``(repaired
    [R, n, *leaf] per site, voted [R, *leaf] per site, flags int32
    [S, R])``.  All sites share R and n; widths, types and masks may
    differ.  Each repaired replica set is a fresh tensor of its own (the
    engine may commit it as state, which then holds no other output's
    bytes); the voted values and flags are views of one fresh buffer.
    No output is an input."""
    global LAUNCHES
    site_table.check_group("K2", len(sites), num_clones)
    first = sites[0][0]
    device, rows = first.device, first.shape[0]
    out = site_table.Buffer(len(sites) * rows)
    plan = []
    for lanes, masks in sites:
        width = site_table.check_lanes("K2", lanes, num_clones, device, rows)
        if masks is not None and (
                masks.device != device or masks.dtype != torch.int32
                or masks.shape != lanes.shape or not masks.is_contiguous()):
            raise ValueError(
                "masks must be a contiguous int32 tensor of the replica "
                f"set's shape {tuple(lanes.shape)} on its device")
        plan.append((width, torch.empty_like(lanes), out.take(rows * width)))
    base = out.allocate(device)
    table = site_table.pack([
        (lanes.data_ptr(), 0 if masks is None else masks.data_ptr(),
         rep.data_ptr(), base + 4 * vot, 0, base + 4 * s * rows, width,
         width, num_clones * width, 0, 0, int(lanes.dtype == torch.float32),
         0)
        for s, ((lanes, masks), (width, rep, vot))
        in enumerate(zip(sites, plan))])
    err = _kernel()(table, len(sites), rows, num_clones, device.index or 0,
                    site_table.stream(device))
    if err != 0:
        raise RuntimeError(
            f"K2 commit launch failed: cudaError {err} for sites "
            f"{[tuple(lanes.shape) for lanes, _ in sites]}")
    LAUNCHES += 1
    voted = [out.view((rows,) + tuple(lanes.shape[2:]), vot, lanes.dtype)
             for (lanes, _), (_, _, vot) in zip(sites, plan)]
    return [rep for _, rep, _ in plan], voted, out.flags(len(sites), rows)
