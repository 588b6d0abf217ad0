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

The lint tags (the reference's ``checkpoint_name`` markers, the same tag
strings): :func:`tag` is the identity unless a capture
(``analysis/lint/capture.py``) is recording, and then it is the
``coast_lint::tag`` operator, which the recorder sees.  Outside a
capture a tag site costs one Python bool test and adds no torch operator
to a trip.  The grouped voter wrappers tag every replica set they vote
``coast:voter`` (and ``coast:sync:<class>:<leaf>`` when its
:class:`Site` carries a class), so the linter reads sanctioned lane
collapses and voter coverage from what a trip really dispatched.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

_EXPONENT = 0x7F800000

# Tag namespace shared with analysis/lint (the reference's strings).
TAG_VOTER = "coast:voter"
TAG_SYNC = "coast:sync:"      # coast:sync:<class>:<leaf> -- classified vote
TAG_SPOF = "coast:spof:"      # coast:spof:<fn> -- accepted single-lane call
TAG_VIEW = "coast:view:"      # lane-0 views (DWC's voted view)

#: True while a capture records a trip (analysis/lint/capture.py).
CAPTURE = False
#: Replica sets voted by the grouped voter wrappers (K1, K2 or their plain
#: versions) since the last reset: the lint's voter-survival count.
SITE_RECORDS = 0
#: The recording capture while one records (``capture._Recorder``): the
#: sink of :func:`priced` scopes.
PRICE_HOOK = None
#: A list while ``opt -dumpModule=hlo`` records a trip's dispatch stream:
#: each grouped voter call appends ``(kernel, [site shapes])``.
STREAM: Optional[list] = None


def tag(x: torch.Tensor, name: str) -> torch.Tensor:
    """Identity; while a capture records, the ``coast_lint::tag`` marker
    (a CPU operator: a capture on a CUDA tensor raises)."""
    if not CAPTURE:
        return x
    if x.device.type != "cpu":
        raise RuntimeError(
            "a lint capture records CPU tensors only; this tag met a "
            f"tensor on {x.device}")
    return torch.ops.coast_lint.tag(x, name)


def priced(per_element: float):
    """Decorator: while a capture records, the operations a helper
    dispatches count as ``per_element`` arithmetic ops per element of its
    result (``obs/roofline``), whatever the port's spelling costs -- the
    op count of the reference's own primitive for the same function (a
    uint32 logical shift is one op, not the int64 shift and mask that
    emulate it).  ``0`` prices the helper's work at nothing.  Outside a
    capture it costs one test of a global."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            hook = PRICE_HOOK
            if hook is None:
                return fn(*args, **kwargs)
            mark = hook.price_begin()
            out = fn(*args, **kwargs)
            hook.price_end(mark, per_element, out)
            return out
        return inner
    return wrap


def sync_tag(lanes: torch.Tensor, klass: str, leaf: str) -> torch.Tensor:
    """Marks ``lanes`` as the input of a vote at sync class ``klass``
    covering ``leaf`` (the linter's voter-coverage unit)."""
    return tag(lanes, f"{TAG_SYNC}{klass}:{leaf}")


def lane_view(lanes: torch.Tensor) -> torch.Tensor:
    """Lane 0 of a replica set ``[R, n, ...]``, tagged as a sanctioned
    view (DWC has no majority to vote: the compare latches divergence)."""
    return tag(lanes, TAG_VIEW + "lane0")[:, 0]


def note_sites(kernel: str, sets: Sequence[torch.Tensor]) -> None:
    """Count one grouped voter call's replica sets (and record them in
    :data:`STREAM` when it is a list)."""
    global SITE_RECORDS
    SITE_RECORDS += len(sets)
    if STREAM is not None:
        STREAM.append((kernel, [(tuple(x.shape), str(x.dtype))
                                for x in sets]))


def tag_lanes(lanes: torch.Tensor, klass: Optional[str]) -> torch.Tensor:
    """A voted replica set's tags: its sync class (``"<class>:<leaf>"``,
    when it has one), then ``coast:voter``.  Identity outside a capture."""
    if not CAPTURE:
        return lanes
    if klass is not None:
        lanes = tag(lanes, TAG_SYNC + klass)
    return tag(lanes, TAG_VOTER)


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
    for a window.  A TMR vote always writes its voted value.  ``tag`` is
    the vote's sync class and leaf, ``"<class>:<leaf>"`` (the reference's
    ``coast:sync:`` tag), read by the linter; None for an unclassified
    vote (a view's)."""

    lanes: torch.Tensor
    offsets: Optional[torch.Tensor] = None
    width: Optional[int] = None
    copy: bool = False
    tag: Optional[str] = None


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
