"""Voters: TMR majority and DWC compare over the lane axis, in plain torch.

The counterpart of ``coast_tpu/ops/voters.py`` ``tmr_vote`` / ``dwc_check``
/ ``vote``, over an explicit leading batch axis: a replica set is
``[R, n, *leaf]`` and a voter returns ``(voted [R, *leaf], miscompare
bool [R])``.

Compares are in the leaf's dtype: IEEE equality for float32 (``+0 == -0``,
``NaN != NaN``), as the reference does.  A bitwise compare would disagree
with it on float leaves.  The reference's compare also treats subnormal
inputs as zero (XLA flushes them on the CPU, and so does the TPU), so a
float32 compare here reads each subnormal operand as zero (:func:`same`).
The voted word is always a lane's raw bits.

This is the plain version of the Hopper kernel in ``ops/hopper_voters.py``;
the engine always calls that wrapper, which comes here only for a tensor
that lies on the CPU.  :func:`vote_sites` is the plain version of one
grouped launch: every replica set of one sync point, one flag row each.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

_EXPONENT = 0x7F800000


def _all_rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).all(dim=1)


def _flush(x: torch.Tensor) -> torch.Tensor:
    """float32 subnormals -> 0.0; other words as they are."""
    return torch.where((x.view(torch.int32) & _EXPONENT) == 0, 0.0, x)


def same(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Word-wise equality as the reference compares: int words exactly,
    float32 words as IEEE floats with subnormal operands read as zero."""
    if a.dtype.is_floating_point:
        return _flush(a) == _flush(b)
    return a == b


def tmr_vote(lanes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``select(l0 == l1, l0, l2)``; miscompare when any lane disagreed."""
    l0, l1, l2 = lanes[:, 0], lanes[:, 1], lanes[:, 2]
    agree01 = same(l0, l1)
    voted = torch.where(agree01, l0, l2)
    miscompare = ~(_all_rows(agree01) & _all_rows(same(l1, l2)))
    return voted, miscompare


def dwc_check(lanes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Detection only: lane 0, and whether lanes 0 and 1 differ."""
    return lanes[:, 0], ~_all_rows(same(lanes[:, 0], lanes[:, 1]))


def vote(lanes: torch.Tensor,
         num_clones: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch on replica count: 3 -> TMR majority, 2 -> DWC compare."""
    if num_clones == 3:
        return tmr_vote(lanes)
    if num_clones == 2:
        return dwc_check(lanes)
    raise ValueError(
        f"unsupported replica count {num_clones} (COAST supports 2 or 3)")


def window(leaf: torch.Tensor, offsets: torch.Tensor,
           width: int) -> torch.Tensor:
    """Words ``[offsets[r], offsets[r] + width)`` of every lane of row
    ``r`` of a ``[R, n, L]`` replica set, as ``[R, n, width]``.  A start
    clamps into ``[0, L - width]``, so the window lies inside the lane."""
    start = offsets.to(torch.int64).clamp(0, leaf.shape[2] - width)
    idx = start[:, None] + torch.arange(width, device=leaf.device)
    return leaf.gather(2, idx[:, None, :].expand(-1, leaf.shape[1], -1))


class Site(NamedTuple):
    """One replica set of a grouped vote (:func:`vote_sites`).

    ``lanes`` is ``[R, n, *leaf]``.  With ``offsets`` (int32 ``[R]``) the
    vote covers words ``[offsets[r], offsets[r] + width)`` of every lane
    of a ``[R, n, L]`` set (:func:`window`).  ``copy`` (DWC only) writes
    lane 0 out as a fresh tensor; without it a DWC vote is a flags-only
    check whose voted value is the lane-0 view of a whole leaf and None
    for a window.  A TMR vote always writes its voted value."""

    lanes: torch.Tensor
    offsets: Optional[torch.Tensor] = None
    width: Optional[int] = None
    copy: bool = False


def vote_sites(sites: Sequence[Site], num_clones: int
               ) -> Tuple[List[Optional[torch.Tensor]], torch.Tensor]:
    """Vote every site -> ``(voted per site, flags int32 [S, R])``, flag
    ``[s, r]`` 1 where site ``s`` miscompared in row ``r``, else 0."""
    voted, flags = [], []
    for site in sites:
        lanes = site.lanes
        if site.offsets is not None:
            lanes = window(lanes, site.offsets, site.width)
        value, mis = vote(lanes, num_clones)
        if num_clones == 2:
            if site.copy:
                value = value.clone(memory_format=torch.contiguous_format)
            elif site.offsets is not None:
                value = None
        voted.append(value)
        flags.append(mis)
    return voted, torch.stack(flags).to(torch.int32)
