"""Preemptive RTOS kernel model: tick-driven round-robin as a region.

The counterpart of ``coast_tpu/rtos/kernel.py``.  One region step is one
tick interrupt:

    save context   -> push the live register file onto the running task's
                      stack at its saved SP (``push_frame``)
    pick next      -> round-robin over the ready list (``pick_next``, the
                      vTaskSwitchContext stand-in; the idle task when
                      nothing is ready)
    restore        -> pop the next task's frame into the register file
                      (``pop_frame``)
    run slice      -> one slice of the scheduled task's work (the app's
                      task functions, ``rtos/apps.py``)

State is the kernel's own data model, each leaf injectable per lane:
``stacks`` [N_TASKS, STACK_WORDS] (``KIND_STACK``, the canary at word 0,
the rest the watermark fill), ``tcb_sp`` (saved SPs), ``ready``,
``slices``, ``wmark`` (stack high-water marks), ``cur`` (the current-task
pointer), ``regs`` (the live register file), ``qbuf``/``qidx`` (the
message queue), ``uart`` (an unprotected mirror), ``sched_trace`` (which
task ran at each tick), ``seed`` and ``tick``.

The kernel's own failure detectors are the region's guards, which the
engine evaluates on every lane's stepped, pre-vote state: ``stack_guard``
(canary blown or a saved SP out of bounds -> DUE_STACK_OVERFLOW) and
``assert_guard`` (current-task pointer, ready flags or slice counts out of
range -> DUE_ASSERT).

Every function takes the port's ``[R, ...]`` rows.  The reference's index
rules hold per row: ``a[i]`` (``ops/indexing.row_select``/``row_update``),
``jnp.take(mode="clip")`` (``take_clip``), and ``lax.dynamic_slice`` /
``dynamic_update_slice`` for the frames (one negative wrap, then the start
clamped so the frame fits: a corrupted SP lands the frame at the clamped
place).  ``lax.rem`` truncates toward zero, as ``torch.fmod`` does; int32
products and sums that can wrap are made in int64 and wrapped
(``ops/u32.word``).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from coast_tpu_torch.interop import state_from_numpy
from coast_tpu_torch.ir.graph import loop_graph
from coast_tpu_torch.ir.region import (KIND_CTRL, KIND_MEM, KIND_REG, KIND_RO,
                                       KIND_STACK, LeafSpec, Region, rows)
from coast_tpu_torch.ops.indexing import row_select, row_update, take_clip
from coast_tpu_torch.ops.u32 import const, word
from coast_tpu_torch.passes.verification import RegionDataflow

N_TASKS = 3            # two workers + the idle task (task N_TASKS-1)
STACK_WORDS = 16       # words per task stack
FRAME_WORDS = 4        # saved context: r0..r3
CANARY = 0x5AC3A5C3    # stack-limit canary word
FILL = 0x0A5A5A5A      # watermark fill of unused stack words
QLEN = 32              # message-queue ring length
MASK = 0x7FFFFFFF

IDLE = N_TASKS - 1
# Saved-SP legal range: the canary occupies word 0; a frame must fit.
SP_MIN = 1
SP_MAX = STACK_WORDS - FRAME_WORDS


# -- kernel module functions: the unit the scope lists name ------------------

def clampi(i, n):
    """Index sanitiser: ``rem(max(i, 0), n)``."""
    return torch.fmod(torch.clamp(i, min=0), n)


def rng_next(seed):
    """LCG tick entropy (the rand() class: one stream, fanned out)."""
    return word((seed.to(torch.int64) * 1103515245 + 12345) & MASK)


def mix(x):
    """Shared hash round on every queued value."""
    x = word((x ^ (x >> 3)).to(torch.int64) * const(0x9E3779B1))
    return (x ^ (x >> 7)) & MASK


def fold(x):
    """Word fold companion to mix."""
    return ((x >> 16) ^ (x & 0xFFFF)) & MASK


def saturate(v):
    """Clamp into the logger's accepted range."""
    return torch.clamp(v, 0, 0x3FFFFFFF)


def uart_fmt(v):
    """UART formatter (the -ignoreFns xil_printf class)."""
    return v ^ 0x55AA55AA


def _frame_index(sp: torch.Tensor) -> torch.Tensor:
    """Word indices ``[R, FRAME_WORDS]`` of the frame at ``sp``, by
    ``lax.dynamic_slice``'s rule: one negative wrap, then the start
    clamped into ``[0, STACK_WORDS - FRAME_WORDS]``."""
    sp = sp.to(torch.int64)
    start = torch.clamp(torch.where(sp < 0, sp + STACK_WORDS, sp), 0,
                        STACK_WORDS - FRAME_WORDS)
    return start[:, None] + torch.arange(FRAME_WORDS, device=sp.device)


def push_frame(stacks, task, sp, regs):
    """Save context: write the register file onto ``task``'s stack at
    ``sp``."""
    row = row_select(stacks, task).scatter(1, _frame_index(sp), regs)
    return row_update(stacks, row, task)


def pop_frame(stacks, task, sp):
    """Restore context: read ``task``'s saved frame at ``sp``."""
    return row_select(stacks, task).gather(1, _frame_index(sp))


def pick_next(cur, ready):
    """vTaskSwitchContext: the next ready task after ``cur`` in
    round-robin order; the idle task when nothing is ready."""
    c1 = torch.fmod(cur + 1, N_TASKS)
    c2 = torch.fmod(cur + 2, N_TASKS)
    c3 = torch.fmod(cur + 3, N_TASKS)

    def rdy(c):
        return take_clip(ready, c) > 0

    return torch.where(rdy(c1), c1, torch.where(
        rdy(c2), c2, torch.where(rdy(c3), c3, IDLE)))


def queue_send(qbuf, idx, v):
    """xQueueSend: ``qbuf[idx] = v`` (the protectedLibFn class)."""
    return row_update(qbuf, v, idx)


def stack_mark(mark, sp):
    """Stack high-water bookkeeping (uxTaskGetStackHighWaterMark)."""
    return torch.maximum(mark, sp)


KERNEL_FUNCTIONS = {
    "clampi": clampi, "rng_next": rng_next, "mix": mix, "fold": fold,
    "saturate": saturate, "uart_fmt": uart_fmt,
    "push_frame": push_frame, "pop_frame": pop_frame,
    "pick_next": pick_next, "queue_send": queue_send,
    "stack_mark": stack_mark,
}

RTOS_SECTIONS = {
    "stack": ("stacks",),
    "tcb": ("tcb_sp", "ready", "slices", "wmark", "cur", "tick"),
    "task_data": ("qbuf", "uart", "sched_trace", "regs", "seed", "qidx",
                  "data"),
}


# -- region factory ----------------------------------------------------------

def _image(task_init: Tuple[int, int, int], ticks: int
           ) -> Dict[str, np.ndarray]:
    data = (((np.arange(32, dtype=np.int64) * 2654435761) >> 11)
            & 0xFFFF).astype(np.int32)
    stacks = np.full((N_TASKS, STACK_WORDS), FILL, np.int64)
    stacks[:, 0] = CANARY
    for k in range(N_TASKS):
        # Initial frame at SP_MIN: [acc, x, scratch, slice counter].
        stacks[k, SP_MIN:SP_MIN + FRAME_WORDS] = [task_init[k], 0, 0, 0]
    i32 = np.int32
    return {
        "data": data,
        "stacks": stacks.astype(i32),
        "tcb_sp": np.full(N_TASKS, SP_MIN, i32),
        "ready": np.ones(N_TASKS, i32),
        "slices": np.zeros(N_TASKS, i32),
        "wmark": np.full(N_TASKS, SP_MIN, i32),
        "cur": i32(IDLE),
        "regs": np.array([task_init[IDLE], 0, 0, 0], i32),
        "qbuf": np.zeros(QLEN, i32),
        "uart": np.zeros(QLEN, i32),
        "sched_trace": np.zeros(ticks, i32),
        "seed": i32(2026),
        "tick": i32(0),
        "qidx": i32(0),
    }


def make_kernel_region(
        name: str,
        tasks: Tuple[Callable, Callable, Callable],
        task_init: Tuple[int, int, int],
        task_names: Tuple[str, str, str],
        dataflow: RegionDataflow,
        ticks: int = 48,
        quota: int = 10) -> Region:
    """A preemptive kernel region over three task-slice functions.

    ``tasks[k](regs, d, seed, tick, qin) -> regs`` runs one slice of task
    k on its restored register file; ``task_init[k]`` seeds regs[0] of
    its initial frame.  Worker tasks (0 and 1) retire after ``quota``
    slices; the idle task (2) never does.  ``dataflow`` is the step's
    dataflow with the raw functions bound (the reference's ``analyze()``
    of the same region)."""
    image = _image(task_init, ticks)

    def init(device):
        return state_from_numpy(image, device)

    def step(s, t, fns):
        tick = s["tick"]
        cur = fns.clampi(s["cur"], N_TASKS)

        # Tick interrupt: save the running task's context at a
        # tick-varying frame depth in [SP_MIN, SP_MAX].
        sp_new = SP_MIN + torch.fmod(tick, 8)
        stacks = fns.push_frame(s["stacks"], cur, sp_new, s["regs"])
        tcb_sp = row_update(s["tcb_sp"], sp_new, cur)
        wmark = row_update(
            s["wmark"], fns.stack_mark(row_select(s["wmark"], cur), sp_new),
            cur)

        # Schedule and restore.
        nxt = fns.pick_next(cur, s["ready"])
        regs = fns.pop_frame(stacks, nxt, row_select(tcb_sp, nxt))

        # One slice of every task, the scheduled one selected; ``qin`` is
        # the queue-receive view the consumer-style tasks read.
        d = row_select(s["data"], fns.clampi(tick, 32))
        seed = fns.rng_next(s["seed"])
        qin = row_select(s["qbuf"], fns.clampi(s["slices"][:, 1], QLEN))
        outs = [fns[nm](regs, d, seed, tick, qin) for nm in task_names]
        regs = torch.where(rows(nxt == 0, regs), outs[0], torch.where(
            rows(nxt == 1, regs), outs[1], outs[2])) & MASK

        # Queue send and UART mirror (worker slices only).
        is_worker = nxt < IDLE
        val = fns.saturate(fns.fold(fns.mix(regs[:, 0])))
        slot = fns.clampi(s["qidx"], QLEN)
        worker = rows(is_worker, s["qbuf"])
        qbuf = torch.where(worker, fns.queue_send(s["qbuf"], slot, val),
                           s["qbuf"])
        uart = torch.where(worker,
                           row_update(s["uart"], fns.uart_fmt(val), slot),
                           s["uart"])

        # Retire workers at quota.
        slices = row_update(s["slices"], row_select(s["slices"], nxt) + 1,
                            nxt)
        retired = is_worker & (row_select(slices, nxt) >= quota)
        ready = torch.where(rows(retired, s["ready"]),
                            row_update(s["ready"], torch.zeros_like(nxt),
                                       nxt),
                            s["ready"])

        return {
            "stacks": stacks,
            "tcb_sp": tcb_sp,
            "ready": ready,
            "slices": slices,
            "wmark": wmark,
            "cur": nxt,
            "regs": regs,
            "qbuf": qbuf,
            "uart": uart,
            "sched_trace": row_update(s["sched_trace"], nxt,
                                      fns.clampi(tick, ticks)),
            "seed": seed,
            "tick": tick + 1,
            "qidx": s["qidx"] + is_worker.to(torch.int32),
        }

    def output(s):
        return torch.cat(
            [s["qbuf"], s["uart"], s["sched_trace"], s["regs"], s["slices"],
             s["wmark"], s["tcb_sp"],
             torch.stack([s["qidx"], s["cur"]], dim=1)], dim=1)

    def stack_guard(s):
        """taskCHECK_FOR_STACK_OVERFLOW: canary intact, saved SPs legal."""
        canary_blown = (s["stacks"][:, :, 0] != CANARY).any(dim=1)
        sp = s["tcb_sp"]
        return canary_blown | ((sp < SP_MIN) | (sp > SP_MAX)).any(dim=1)

    def assert_guard(s):
        """configASSERT: scheduler invariants."""
        cur_bad = (s["cur"] < 0) | (s["cur"] >= N_TASKS)
        ready_bad = ((s["ready"] < 0) | (s["ready"] > 1)).any(dim=1)
        slices_bad = ((s["slices"] < 0) | (s["slices"] > ticks)).any(dim=1)
        return cur_bad | ready_bad | slices_bad

    functions: Dict[str, Callable] = dict(KERNEL_FUNCTIONS)
    # Task slices join the namespace under their app names, so the scope
    # lists put user tasks in or out of scope apart from the kernel's.
    functions.update(zip(task_names, tasks))

    region = Region(
        name=name,
        init=init,
        step=step,
        done=lambda s: s["tick"] >= ticks,
        check=None,
        output=output,
        nominal_steps=ticks,
        max_steps=3 * ticks,
        spec={
            "data": LeafSpec(KIND_RO),
            "stacks": LeafSpec(KIND_STACK, xmr=True, canary_word=0),
            "tcb_sp": LeafSpec(KIND_MEM),
            "ready": LeafSpec(KIND_MEM),
            "slices": LeafSpec(KIND_MEM),
            "wmark": LeafSpec(KIND_MEM),
            "cur": LeafSpec(KIND_CTRL),
            "regs": LeafSpec(KIND_REG),
            "qbuf": LeafSpec(KIND_MEM, xmr=True),
            # The UART mirror lives outside the SoR (xil_printf class,
            # boundary-voted stores).
            "uart": LeafSpec(KIND_MEM, xmr=False, no_verify=True),
            "sched_trace": LeafSpec(KIND_MEM),
            "seed": LeafSpec(KIND_REG),
            "tick": LeafSpec(KIND_CTRL),
            "qidx": LeafSpec(KIND_CTRL),
        },
        default_xmr=True,
        graph=loop_graph("tick", "tick", ticks),
        functions=functions,
        meta={"oracle": "Number of errors: 0",
              "rtos_sections": RTOS_SECTIONS,
              "dataflow": dataflow},
        stack_guard=stack_guard,
        assert_guard=assert_guard,
    )

    # The golden output: the port's own fault-free unprotected run.
    golden = output({k: v.unsqueeze(0) for k, v in
                     region.run_unprotected(device="cpu").items()})[0]
    cache = {}

    def check(s):
        dev = s["qbuf"].device
        if dev not in cache:
            cache[dev] = golden.to(dev)
        return (output(s) != cache[dev]).sum(dim=1).to(torch.int32)

    region.check = check
    return region
