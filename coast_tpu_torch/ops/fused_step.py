"""The fused protected step (``-fuseStep``): its static plan, the packed
latch word and the fused commit.

The counterpart of ``coast_tpu/ops/fused_step.py``.  The engine
(``passes/dataflow_protection.py``) activates it under
``ProtectionConfig.fuse_step`` when the plan's ``exact_dataflow`` holds.
Every choice of the plan keeps the run records bit-equal to the unfused
engine's:

  * *done-cone pruning*: ``done()`` reads a view voted only on the leaves
    it reads (:func:`done_cone`); the others read lane 0.  A vote is pure,
    so skipping one that ``done()`` never reads cannot change its value.
  * *freeze pruning*: the halt freeze keeps its select only on leaves whose
    committed value can differ from the pre-step image (written,
    commit-voted or pre-step repaired); the others commit the pre-step
    tensor itself.
  * *packed latches*: the five terminal latches are bits of one word per
    batch row, so "halted" is ``latch != 0`` and the boundary's
    ``reached_call`` is ``latch == LATCH_DONE_ONLY``.  Torch has no usable
    uint32, so the word is int32; bits 0-4 give it the reference's uint32
    value.
  * *bounded scan*: when ``max_steps == nominal_steps`` the loop runs every
    trip with no per-step host sync (the freeze makes trips after a row
    halts no-ops).
  * *sparse flip*: the port's flip is already the one-word form of the
    reference's ``make_sparse_flipper`` (``ops/bitflip.py``), so
    ``sparse_flip`` is always True.

Regions with a float leaf keep the unfused program (``exact_dataflow`` is
False): the reference measured that any restructuring of a float program
can re-round it, so it fuses only exact (integer) dataflow, and the port
follows it.

:func:`commit_sites` is the data plane: the per-site XOR flip, the vote
or compare, the miscompare flag and the TMR repair broadcast in one pass,
for every replica set of one sync point.  On the card it is one K2 launch
(``ops/hopper_commit.py``, ``csrc/commit.cu``); for a CPU tensor it is
:func:`plain_commit_sites`.  The engine calls it once at each sync point
whose TMR votes a repair follows: the pre-step load sync and the
whole-leaf commit votes.  :func:`vote_flip_commit` is a group of one.
"""

from __future__ import annotations

import dataclasses
from typing import (Dict, FrozenSet, Iterator, List, Mapping, Optional,
                    Sequence, Set, Tuple)

import torch

from coast_tpu_torch.ir.region import Region
from coast_tpu_torch.ops import hopper_commit, voters

# Latch word bit assignment (the reference's; record extraction and the
# boundary gate compare against these).
LATCH_DONE = 0
LATCH_DWC = 1
LATCH_CFC = 2
LATCH_STACK = 3
LATCH_ASSERT = 4

#: ``latch == LATCH_DONE_ONLY`` <=> completed with no fault latch set: the
#: region-boundary ``reached_call`` gate as one compare.
LATCH_DONE_ONLY = 1 << LATCH_DONE

_LATCH_NAMES = (("done", LATCH_DONE), ("dwc_fault", LATCH_DWC),
                ("cfc_fault", LATCH_CFC), ("stack_fault", LATCH_STACK),
                ("assert_fault", LATCH_ASSERT))

Flags = Dict[str, torch.Tensor]


def flags_init(batch: int, device) -> Flags:
    """Fused-mode flags, one entry per batch row: the five latches packed
    into one int32 word, the counters as separate int32 accumulators."""
    def zeros():
        return torch.zeros(batch, dtype=torch.int32, device=device)

    return {"latch": zeros(), "tmr_cnt": zeros(), "sync_cnt": zeros(),
            "steps": zeros()}


def latch_or(latch: torch.Tensor, bit: int, cond: torch.Tensor
             ) -> torch.Tensor:
    """OR ``cond`` (bool [B]) into latch bit ``bit``."""
    word = cond.to(torch.int32)
    if bit:
        word = word << bit
    return latch | word


def latch_get(latch: torch.Tensor, bit: int) -> torch.Tensor:
    """One latch bit back as a bool [B]."""
    word = latch >> bit if bit else latch
    return (word & 1) != 0


def unpack_latch(flags: Flags) -> Flags:
    """The packed flags back as the engine's unfused flag dict (done,
    dwc_fault, cfc_fault, stack_fault, assert_fault and the counters): the
    record-extraction point, once per run."""
    out = {name: latch_get(flags["latch"], bit) for name, bit in _LATCH_NAMES}
    for name in ("tmr_cnt", "sync_cnt", "steps"):
        out[name] = flags[name]
    return out


# -- the static plan ---------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FusePlan:
    """Static decisions of the fused build, made once when the program is
    built (the reference's five fields)."""

    #: Leaves ``done()`` reads: only these are voted in its view.
    done_leaves: FrozenSet[str]
    #: Leaves whose committed value can differ from their pre-step image
    #: (written, commit-voted or pre-step repaired): only these keep the
    #: halt-freeze select.
    frozen_leaves: FrozenSet[str]
    #: The flip XORs one word per row (always, in the port).
    sparse_flip: bool
    #: Run all ``max_steps`` trips with no per-step host sync (sound when
    #: ``max_steps == nominal_steps``).
    bounded_scan: bool
    #: True iff every leaf is integer: the gate that activates the plan.
    exact_dataflow: bool = True


class _ReadRecorder(Mapping):
    """A state mapping that records which leaves are read."""

    def __init__(self, state: Mapping[str, torch.Tensor]):
        self._state = state
        self.read: Set[str] = set()

    def __getitem__(self, name: str) -> torch.Tensor:
        self.read.add(name)
        return self._state[name]

    def __iter__(self) -> Iterator[str]:
        # A predicate that walks the whole state reads every leaf.
        self.read.update(self._state)
        return iter(self._state)

    def __len__(self) -> int:
        return len(self._state)


def done_cone(region: Region) -> FrozenSet[str]:
    """Leaves ``region.done`` reads.  The reference walks the predicate's
    jaxpr; the port calls it once on a one-row probe of the init image
    through a mapping that records each leaf read.  If the call raises,
    every leaf (the unfused behaviour, always sound)."""
    image = region.init("cpu")
    try:
        probe = _ReadRecorder({k: v.unsqueeze(0) for k, v in image.items()})
        region.done(probe)
        return frozenset(probe.read)
    except Exception:       # noqa: BLE001 - pruning must not break builds
        return frozenset(image)


def build_plan(prog) -> FusePlan:
    """The fused-step plan of a built ProtectedProgram.  The reference's
    ``wants_fns()`` branch (keep every freeze when function-scope wrappers
    run) has no counterpart yet: the port's Region refuses ``functions``
    (ROADMAP Queue A item 13)."""
    region = prog.region
    frozen = frozenset(
        name for name in region.spec
        if (name in prog.flow.written
            or prog.step_sync.get(name, False)
            or prog.pre_sync.get(name, False)))
    exact = not any(t.dtype.is_floating_point or t.dtype.is_complex
                    for t in region.init("cpu").values())
    return FusePlan(
        done_leaves=done_cone(region),
        frozen_leaves=frozen,
        sparse_flip=True,
        bounded_scan=region.max_steps == region.nominal_steps,
        exact_dataflow=exact)


# -- the fused commit --------------------------------------------------------

def plain_vote_flip_commit(lanes: torch.Tensor, masks: Optional[torch.Tensor],
                           num_clones: int
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """K2's plain version: the torch composition of the reference's
    fallback path (``fused_step.py`` ``vote_flip_commit``).  Outputs are
    fresh tensors, as the kernel's are."""
    flipped = (lanes if masks is None
               else (lanes.view(torch.int32) ^ masks).view(lanes.dtype))
    voted, mis = voters.vote(flipped, num_clones)
    if num_clones == 3:
        repaired = voted.unsqueeze(1).expand(flipped.shape).contiguous()
    else:
        # DWC has no majority: detection only, the lanes commit as flipped.
        # Lane 0 and an unflipped replica set would be views of the input.
        voted = voted.clone(memory_format=torch.contiguous_format)
        repaired = flipped.clone() if masks is None else flipped
    return repaired, voted, mis


def vote_flip_commit(lanes: torch.Tensor, masks: Optional[torch.Tensor],
                     num_clones: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused commit of a replica set ``lanes [R, n, *leaf]``: XOR the
    (already fire-gated) int32 ``masks`` of the same shape into every lane
    (None: no flip), vote or compare, repair.  Returns ``(repaired [R, n,
    *leaf], voted [R, *leaf], miscompare bool [R])``.  TMR's repaired lanes
    all hold the voted value; DWC's are the flipped lanes.

    A CPU tensor takes the plain version; a CUDA tensor launches K2 or
    raises."""
    if lanes.device.type == "cpu":
        return plain_vote_flip_commit(lanes, masks, num_clones)
    (repaired,), (voted,), flags = hopper_commit.commit_sites(
        [(lanes, masks)], num_clones)
    return repaired, voted, flags[0].bool()


def plain_commit_sites(sites: Sequence[hopper_commit.CommitSite],
                       num_clones: int
                       ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                                  torch.Tensor]:
    """K2's plain version over a group: :func:`plain_vote_flip_commit` per
    ``(lanes, masks)`` site, the flags as one int32 ``[S, R]`` block."""
    outs = [plain_vote_flip_commit(lanes, masks, num_clones)
            for lanes, masks in sites]
    return ([o[0] for o in outs], [o[1] for o in outs],
            torch.stack([o[2] for o in outs]).to(torch.int32))


def commit_sites(sites: Sequence[hopper_commit.CommitSite], num_clones: int
                 ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                            torch.Tensor]:
    """Fused commit of every ``(lanes, masks)`` site of one sync point ->
    ``(repaired per site, voted per site, flags int32 [S, R])``, each as
    :func:`vote_flip_commit` gives it.  A CPU tensor takes the plain
    version; a CUDA tensor makes one K2 launch or raises."""
    if sites[0][0].device.type == "cpu":
        return plain_commit_sites(sites, num_clones)
    return hopper_commit.commit_sites(sites, num_clones)
