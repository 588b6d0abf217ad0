"""towersOfHanoi: the recursion benchmark as a torch region.

The counterpart of ``coast_tpu/models/hanoi.py`` (tests/towersOfHanoi/
towers.c): the recursion runs as an explicit stack machine, one frame
visit a step, so the call stack is real injectable memory.  Frames
(num, from, to, aux, stage) live in the ``st_*`` leaves and the stack
pointer in ``sp``; all six are ``LeafSpec(stack=True)``, the target of
``-protectStack`` (voted every step under the ``stack`` sync class) and
of the supervisor's ``-s stack``.  NUM_DISKS is 8: 509 frame visits
fault-free, 1,527 at most.  Every move is applied to a disk-position
array, and the check wants 2^8 - 1 moves with every disk on peg C.

Frame reads are ``jnp.take(mode="clip")`` of a clipped ``top`` and frame
writes ``.at[].set(mode="drop")``, as in the reference.  The stage and
move selects are int32 here (``jnp.where(s0, 1, 2)`` is int32 in JAX).
Its block graph (``graph``, read by CFCSS) is the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from coast_tpu_torch.interop import state_from_numpy
from coast_tpu_torch.ir.graph import BlockGraph, pick
from coast_tpu_torch.ir.region import (KIND_CTRL, KIND_MEM, KIND_REG,
                                       LeafSpec, Region)
from coast_tpu_torch.ops.indexing import take_clip, update_drop
from coast_tpu_torch.passes.verification import RegionDataflow

NUM_DISKS = 8
DEPTH = NUM_DISKS + 1
PEG_FROM, PEG_TO, PEG_AUX = 0, 1, 2       # towers(num, 'A', 'C', 'B')
TOTAL_MOVES = (1 << NUM_DISKS) - 1
# Frame visits: non-leaf frames 3 (stages 0, 1, 2), leaves 1.
NOMINAL = 3 * ((1 << (NUM_DISKS - 1)) - 1) + (1 << (NUM_DISKS - 1))

STACK = ("st_num", "st_f", "st_t", "st_a", "st_stage", "sp")

# Equal to the reference's analyze() (pinned in tests/test_torch_hanoi.py):
# every written leaf depends on the whole frame stack.
_FRAMES = frozenset(STACK)
DATAFLOW = RegionDataflow(
    written=_FRAMES | {"disk_pos", "moves"},
    deps={**{name: _FRAMES for name in STACK},
          "disk_pos": _FRAMES | {"disk_pos"},
          "moves": _FRAMES | {"moves"}},
    load_addr=frozenset({"sp"}),
    store_addr=frozenset(STACK))


def _frame0(value: int) -> np.ndarray:
    z = np.zeros(DEPTH, np.int32)
    z[0] = value
    return z


def make_region() -> Region:
    image = {
        "st_num": _frame0(NUM_DISKS),
        "st_f": _frame0(PEG_FROM),
        "st_t": _frame0(PEG_TO),
        "st_a": _frame0(PEG_AUX),
        "st_stage": np.zeros(DEPTH, np.int32),
        "sp": np.int32(1),
        "disk_pos": np.full(NUM_DISKS, PEG_FROM, np.int32),
        "moves": np.int32(0),
    }

    def init(device):
        return state_from_numpy(image, device)

    def step(state, t):
        sp = state["sp"]
        running = sp > 0
        top = torch.clamp(sp - 1, 0, DEPTH - 1)
        # The frame is read as one record: one clamped take of the stacked
        # fields.  (The reference's five takes share one traced helper,
        # which its propagation walk reads as one value; this keeps the
        # equivalence partition's modes equal to the reference's.)
        num, f, to, aux, stage = take_clip(
            torch.stack([state[name] for name in
                         ("st_num", "st_f", "st_t", "st_a", "st_stage")],
                        dim=2), top).unbind(1)

        leaf = num <= 1
        s0 = stage == 0
        s1 = stage == 1

        # stage 0, leaf: move disk 1 (index 0), pop.
        # stage 0, non-leaf: stage <- 1, push (num-1, f, aux, to).
        # stage 1: move disk num (index num-1), stage <- 2,
        #          push (num-1, aux, to, f).
        # stage >= 2: pop.
        do_move = running & ((s0 & leaf) | s1)
        moved_disk = torch.where(s0 & leaf, 0,
                                 torch.clamp(num - 1, 0, NUM_DISKS - 1))
        disk_pos = torch.where(
            do_move[:, None],
            update_drop(state["disk_pos"], moved_disk, to),
            state["disk_pos"])

        push = running & ((s0 & ~leaf) | s1)
        pop = running & ~push

        def pushed(name, at, value, base=None):
            old = state[name] if base is None else base
            return torch.where(push[:, None], update_drop(old, at, value),
                               old)

        # The stage bump on the current frame before pushing the child.
        one, two = torch.ones_like(sp), torch.full_like(sp, 2)
        st_stage = pushed("st_stage", top, torch.where(s0, one, two))
        child = torch.clamp(sp, 0, DEPTH - 1)
        st_stage = pushed("st_stage", child, torch.zeros_like(sp),
                          base=st_stage)
        return {
            "st_num": pushed("st_num", child, num - 1),
            "st_f": pushed("st_f", child, torch.where(s0, f, aux)),
            "st_t": pushed("st_t", child, torch.where(s0, aux, to)),
            "st_a": pushed("st_a", child, torch.where(s0, to, f)),
            "st_stage": st_stage,
            "sp": torch.where(push, sp + 1, torch.where(pop, sp - 1, sp)),
            "disk_pos": disk_pos,
            "moves": state["moves"] + torch.where(do_move, 1, 0).to(
                torch.int32),
        }

    def done(state):
        return state["sp"] <= 0

    def check(state):
        wrong_moves = (state["moves"] != TOTAL_MOVES).to(torch.int32)
        off_peg = (state["disk_pos"] != PEG_TO).sum(dim=1).to(torch.int32)
        return wrong_moves + off_peg

    def output(state):
        return torch.cat([state["disk_pos"], state["moves"][:, None]], dim=1)

    return Region(
        name="towersOfHanoi",
        init=init,
        step=step,
        done=done,
        check=check,
        output=output,
        nominal_steps=NOMINAL,
        max_steps=3 * NOMINAL,
        spec={
            # The frame stack is the region's call stack: the target of
            # -protectStack (stackProtect.c / stackAttack.c scenarios).
            "st_num": LeafSpec(KIND_MEM, stack=True),
            "st_f": LeafSpec(KIND_MEM, stack=True),
            "st_t": LeafSpec(KIND_MEM, stack=True),
            "st_a": LeafSpec(KIND_MEM, stack=True),
            "st_stage": LeafSpec(KIND_MEM, stack=True),
            "sp": LeafSpec(KIND_CTRL, stack=True),
            "disk_pos": LeafSpec(KIND_MEM),
            "moves": LeafSpec(KIND_REG),
        },
        default_xmr=True,
        graph=BlockGraph(
            names=["entry", "towers", "exit"],
            edges=[(0, 1), (1, 1), (1, 2)],
            block_of=lambda s: pick(s["sp"] <= 0, 2, 1)),
        meta={"oracle": "all disks on peg C in 2^n-1 moves",
              "dataflow": DATAFLOW},
    )
