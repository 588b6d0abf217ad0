"""schedule2: the priority-scheduler benchmark as a torch region.

The counterpart of ``coast_tpu/models/schedule2.py`` (the Siemens
'schedule2' process scheduler): three fixed-capacity FIFO queues and a
blocked queue (rows of ``queues``, lengths in ``counts``), a tape of 128
(op, arg) commands, one command a step, and the completion log as the
oracle surface.  Every command's effect is computed and one selected,
as in the reference:

    0 NEW_JOB(prio)   1 UPGRADE_PRIO(prio)   2 BLOCK
    3 QUANTUM_EXPIRE  4 UNBLOCK(prio)        5 FINISH

The running job is the head of the highest non-empty priority queue.
Indices come from state words (the tape, the counts, the log length), so
each reference idiom keeps its rule (``ops/indexing.py``): ``cnt[row]``
and ``q[row, 0]`` wrap once and clamp, ``jnp.take(q, row, axis=0)``
reads the fill word out of range, every ``.at[].set`` drops an
out-of-range write, and the tape reads clamp.  Its block
graph (``graph``, read by CFCSS) is the reference's.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from coast_tpu_torch.interop import state_from_numpy
from coast_tpu_torch.ir.graph import BlockGraph, pick
from coast_tpu_torch.ir.region import (KIND_CTRL, KIND_MEM, KIND_REG,
                                       KIND_RO, LeafSpec, Region)
from coast_tpu_torch.models.common import Consts
from coast_tpu_torch.ops.indexing import (row_select, take_clip, take_fill,
                                          update_drop)
from coast_tpu_torch.passes.verification import RegionDataflow

QCAP = 16          # per-queue capacity
NQ = 3             # priority levels (2 = highest); row NQ = blocked
N_CMDS = 128

# Equal to the reference's analyze() (pinned in tests/test_torch_corpus.py).
_CTL = frozenset({"counts", "i", "tape"})
DATAFLOW = RegionDataflow(
    written=frozenset({"counts", "i", "log", "log_n", "next_id", "queues"}),
    deps={"tape": frozenset({"tape"}),
          "queues": _CTL | {"next_id", "queues"},
          "counts": _CTL,
          "log": _CTL | {"log", "log_n", "queues"},
          "log_n": _CTL | {"log_n", "next_id"},
          "next_id": _CTL | {"log_n", "next_id"},
          "i": frozenset({"i"})},
    load_addr=frozenset({"counts", "i", "next_id", "tape"}),
    store_addr=frozenset({"counts", "i", "log_n", "tape"}))


def make_tape(seed: int = 23) -> np.ndarray:
    """Command tape: (op, arg) pairs, biased towards NEW_JOB early."""
    rng = np.random.RandomState(seed)
    ops = []
    for k in range(N_CMDS):
        if k < 24:
            op = 0 if rng.rand() < 0.7 else int(rng.randint(0, 6))
        else:
            op = int(rng.randint(0, 6))
        arg = int(rng.randint(0, NQ))
        ops.append((op, arg))
    return np.array(ops, np.int64)


class _Sched:
    """Host oracle."""

    def __init__(self):
        self.queues: List[List[int]] = [[], [], []]
        self.blocked: List[int] = []
        self.next_id = 1
        self.log: List[int] = []

    def running(self) -> Tuple[int, int]:
        for prio in range(NQ - 1, -1, -1):
            if self.queues[prio]:
                return prio, self.queues[prio][0]
        return -1, 0

    def do(self, op: int, arg: int) -> None:
        if op == 0:                       # NEW_JOB
            if len(self.queues[arg]) < QCAP:
                self.queues[arg].append(self.next_id)
                self.next_id += 1
        elif op == 1:                     # UPGRADE_PRIO
            if arg < NQ - 1 and self.queues[arg] \
                    and len(self.queues[arg + 1]) < QCAP:
                self.queues[arg + 1].append(self.queues[arg].pop(0))
        elif op == 2:                     # BLOCK
            prio, _ = self.running()
            if prio >= 0 and len(self.blocked) < QCAP:
                self.blocked.append(self.queues[prio].pop(0))
        elif op == 3:                     # QUANTUM_EXPIRE
            prio, _ = self.running()
            if prio >= 0:
                self.queues[prio].append(self.queues[prio].pop(0))
        elif op == 4:                     # UNBLOCK
            if self.blocked and len(self.queues[arg]) < QCAP:
                self.queues[arg].append(self.blocked.pop(0))
        else:                             # FINISH
            prio, job = self.running()
            if prio >= 0:
                self.queues[prio].pop(0)
                self.log.append(job)


def golden_reference(tape: np.ndarray) -> np.ndarray:
    s = _Sched()
    for op, arg in tape:
        s.do(int(op), int(arg))
    log = s.log[:N_CMDS] + [0] * (N_CMDS - len(s.log))
    return np.array(log, np.int64)


def _enq(q, cnt, row, job):
    """Append ``job`` to queue ``row`` (the reference's ``enq``)."""
    n = row_select(cnt, row)
    slot = torch.clamp(n, 0, QCAP - 1)
    idx = torch.stack([row.to(torch.int64), slot.to(torch.int64)], dim=1)
    return update_drop(q, idx, job), update_drop(cnt, row, n + 1)


def _deq(q, cnt, row):
    """Pop the head of queue ``row`` (the reference's ``deq``)."""
    head = row_select(q, row)[:, 0]
    rest = take_fill(q, row)[:, 1:]
    shifted = torch.cat([rest, torch.zeros_like(rest[:, :1])], dim=1)
    return (head, update_drop(q, row, shifted),
            update_drop(cnt, row, row_select(cnt, row) - 1))


def _pick(cond, a, b):
    """``jnp.where(cond, a, b)`` for a per-row ``cond``."""
    return torch.where(cond.view(-1, *([1] * (a.dim() - 1))), a, b)


def make_region() -> Region:
    tape = make_tape()
    golden = golden_reference(tape)
    image = {
        "tape": tape.reshape(-1).astype(np.int32),
        # queues[prio, slot]; row NQ = the blocked queue.
        "queues": np.zeros((NQ + 1, QCAP), np.int32),
        "counts": np.zeros(NQ + 1, np.int32),
        "log": np.zeros(N_CMDS, np.int32),
        "log_n": np.int32(0),
        "next_id": np.int32(1),
        "i": np.int32(0),
    }
    consts = Consts(golden=golden.astype(np.int32))

    def init(device):
        return state_from_numpy(image, device)

    def step(state, t):
        i = state["i"]
        op = take_clip(state["tape"], 2 * i)
        arg = take_clip(state["tape"], 2 * i + 1)
        q, cnt = state["queues"], state["counts"]
        nid, log, log_n = state["next_id"], state["log"], state["log_n"]

        # Running job = head of the highest non-empty priority queue.
        minus1 = torch.full_like(i, -1)
        prio = torch.where(cnt[:, 2] > 0, 2, torch.where(
            cnt[:, 1] > 0, 1, torch.where(cnt[:, 0] > 0, 0, minus1)))
        run_row = torch.clamp(prio, 0, 2)
        blocked = torch.full_like(i, NQ)

        # op 0: NEW_JOB at arg.
        can0 = row_select(cnt, arg) < QCAP
        q0, c0 = _enq(q, cnt, arg, nid)
        q0, c0 = _pick(can0, q0, q), _pick(can0, c0, cnt)
        nid0 = torch.where(can0, nid + 1, nid)

        # op 1: UPGRADE the head of arg to arg + 1.
        up = torch.clamp(arg + 1, 0, NQ - 1)
        can1 = ((arg < NQ - 1) & (row_select(cnt, arg) > 0)
                & (row_select(cnt, up) < QCAP))
        h1, qd, cd = _deq(q, cnt, arg)
        q1, c1 = _enq(qd, cd, up, h1)
        q1, c1 = _pick(can1, q1, q), _pick(can1, c1, cnt)

        # op 2: BLOCK the running job (to row NQ).
        can2 = (prio >= 0) & (cnt[:, NQ] < QCAP)
        h2, qd2, cd2 = _deq(q, cnt, run_row)
        q2, c2 = _enq(qd2, cd2, blocked, h2)
        q2, c2 = _pick(can2, q2, q), _pick(can2, c2, cnt)

        # op 3: QUANTUM_EXPIRE - rotate the running queue.
        can3 = prio >= 0
        h3, qd3, cd3 = _deq(q, cnt, run_row)
        q3, c3 = _enq(qd3, cd3, run_row, h3)
        q3, c3 = _pick(can3, q3, q), _pick(can3, c3, cnt)

        # op 4: UNBLOCK the oldest blocked job to queue arg.
        can4 = (cnt[:, NQ] > 0) & (row_select(cnt, arg) < QCAP)
        h4, qd4, cd4 = _deq(q, cnt, blocked)
        q4, c4 = _enq(qd4, cd4, arg, h4)
        q4, c4 = _pick(can4, q4, q), _pick(can4, c4, cnt)

        # op 5: FINISH the running job.
        can5 = prio >= 0
        h5, qd5, cd5 = _deq(q, cnt, run_row)
        q5, c5 = _pick(can5, qd5, q), _pick(can5, cd5, cnt)
        log5 = _pick(can5, update_drop(
            log, torch.clamp(log_n, 0, N_CMDS - 1), h5), log)
        logn5 = torch.where(can5, log_n + 1, log_n)

        def by_op(*outs):
            new = outs[-1]
            for k in range(len(outs) - 2, -1, -1):
                new = _pick(op == k, outs[k], new)
            return new

        is5 = op == 5
        return {
            "queues": by_op(q0, q1, q2, q3, q4, q5),
            "counts": by_op(c0, c1, c2, c3, c4, c5),
            "log": _pick(is5, log5, log),
            "log_n": torch.where(is5, logn5, log_n),
            "next_id": torch.where(op == 0, nid0, nid),
            "i": i + 1,
        }

    def done(state):
        return state["i"] >= N_CMDS

    def check(state):
        want = consts.on(state["log"].device).golden
        return (state["log"] != want).sum(dim=1).to(torch.int32)

    return Region(
        name="schedule2",
        init=init,
        step=step,
        done=done,
        check=check,
        output=lambda s: s["log"],
        nominal_steps=N_CMDS,
        max_steps=N_CMDS + 8,
        spec={
            "tape": LeafSpec(KIND_RO),
            "queues": LeafSpec(KIND_MEM),
            "counts": LeafSpec(KIND_CTRL),
            "log": LeafSpec(KIND_MEM),
            "log_n": LeafSpec(KIND_CTRL),
            "next_id": LeafSpec(KIND_REG),
            "i": LeafSpec(KIND_CTRL),
        },
        default_xmr=True,
        graph=BlockGraph(
            names=["entry", "new_job", "upgrade_prio", "block",
                   "quantum_expire", "unblock", "finish", "exit"],
            edges=([(0, b) for b in range(1, 7)]
                   + [(a, b) for a in range(1, 7) for b in range(1, 7)]
                   + [(a, 7) for a in range(1, 7)]),
            block_of=lambda s: pick(
                s["i"] >= N_CMDS, 7,
                torch.clamp(take_clip(s["tape"], 2 * torch.clamp(
                    s["i"], 0, N_CMDS - 1)), 0, 5) + 1)),
        meta={"dataflow": DATAFLOW},
    )
