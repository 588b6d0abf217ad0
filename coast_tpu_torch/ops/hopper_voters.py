"""K1 on Hopper: the replica-set vote as a hand-written CUDA kernel.

Replaces the Pallas TPU kernel ``coast_tpu/ops/pallas_voters.py``
``_vote_kernel``; the CUDA source and its design note are
``coast_tpu_torch/csrc/vote.cu``.  :func:`vote_sites` votes every replica
set of one engine sync point in one launch.  Its plain version is
``coast_tpu_torch/ops/voters.py`` (``vote_sites``, ``vote``, ``window``),
which the wrappers here take only for a tensor that lies on the CPU.  On a
CUDA tensor they launch the kernel or raise; there is no size floor and no
fall back.  :func:`vote` and :func:`vote_window` are groups of one.

``LAUNCHES`` counts kernel launches (one per call on the card), so a run
can show that its votes went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import torch

from coast_tpu_torch import build
from coast_tpu_torch.ops import site_table, voters
from coast_tpu_torch.ops.voters import Site

LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def _kernel():
    """``coast_vote_sites`` of the built library, its C signature declared."""
    fn = build.load("vote").coast_vote_sites
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def vote_sites(sites: Sequence[Site], num_clones: int
               ) -> Tuple[List[Optional[torch.Tensor]], torch.Tensor]:
    """Vote every site of one sync point in one launch -> ``(voted per
    site, flags int32 [S, R])`` (see :class:`voters.Site` for what each
    voted value is).  All sites share R and n; widths, types and windows
    may differ.  The written outputs are views of one fresh buffer."""
    global LAUNCHES
    first = sites[0].lanes
    if first.device.type == "cpu":
        return voters.vote_sites(sites, num_clones)
    site_table.check_group("K1", len(sites), num_clones)
    device, rows = first.device, first.shape[0]
    out = site_table.Buffer(len(sites) * rows)
    plan = []
    for site in sites:
        lanes = site.lanes
        lane = site_table.check_lanes("K1", lanes, num_clones, device, rows)
        width = lane
        if site.offsets is not None:
            width = site.width
            offs = site.offsets
            if lanes.dim() != 3 or width is None or not 0 < width <= lane:
                raise ValueError(f"bad window {width} over "
                                 f"{tuple(lanes.shape)}")
            if (offs.device != device or offs.dtype != torch.int32
                    or offs.shape != (rows,) or not offs.is_contiguous()):
                raise ValueError("offsets must be a contiguous int32 [R] "
                                 "tensor on the replica set's device")
        write = num_clones == 3 or site.copy
        plan.append((width, lane, out.take(rows * width) if write else None))
    base = out.allocate(device)
    table = site_table.pack([
        (site.lanes.data_ptr(), 0, 0,
         0 if at is None else base + 4 * at,
         0 if site.offsets is None else site.offsets.data_ptr(),
         base + 4 * s * rows, width, lane, num_clones * lane, 0, 0,
         int(site.lanes.dtype == torch.float32), 0)
        for s, (site, (width, lane, at)) in enumerate(zip(sites, plan))])
    err = _kernel()(table, len(sites), rows, num_clones, device.index or 0,
                    site_table.stream(device))
    if err != 0:
        raise RuntimeError(
            f"K1 vote launch failed: cudaError {err} for sites "
            f"{[tuple(s.lanes.shape) for s in sites]}")
    LAUNCHES += 1
    voted: List[Optional[torch.Tensor]] = []
    for site, (width, lane, at) in zip(sites, plan):
        lanes = site.lanes
        if at is not None:
            shape = ((rows, width) if site.offsets is not None
                     else (rows,) + tuple(lanes.shape[2:]))
            voted.append(out.view(shape, at, lanes.dtype))
        elif site.offsets is None:
            voted.append(lanes[:, 0])      # DWC: lane 0, as dwc_check
        else:
            voted.append(None)
    return voted, out.flags(len(sites), rows)


def vote(lanes: torch.Tensor,
         num_clones: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vote a replica set ``[R, n, *leaf]`` -> ``(voted [R, *leaf],
    miscompare bool [R])``; DWC's voted value is lane 0, as
    ``voters.dwc_check`` returns it."""
    if lanes.device.type == "cpu":
        return voters.vote(lanes, num_clones)
    (voted,), flags = vote_sites([Site(lanes)], num_clones)
    return voted, flags[0].bool()


def vote_window(leaf: torch.Tensor, offsets: torch.Tensor, width: int,
                num_clones: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vote words ``[offsets[r], offsets[r] + width)`` of every lane of row
    ``r`` of a ``[R, n, L]`` replica set, read in place -> ``(voted
    [R, width], miscompare bool [R])``.  A start clamps into
    ``[0, L - width]``, so the kernel never reads outside the lane."""
    if leaf.device.type == "cpu":
        return voters.vote(voters.window(leaf, offsets, width), num_clones)
    (voted,), flags = vote_sites([Site(leaf, offsets, width, copy=True)],
                                 num_clones)
    return voted, flags[0].bool()
