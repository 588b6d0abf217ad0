"""RTOS application task sets: the rtos_mm and rtos_kUser targets.

The counterpart of ``coast_tpu/rtos/apps.py``.  Each task function is one
slice of its task (the work between two tick interrupts) over the task's
restored register file ``regs`` ``[R, FRAME_WORDS]`` ([acc, x, scratch,
count]):

    task(regs, d, seed, tick, qin) -> regs'

``d`` is the tick's input word, ``seed`` the tick entropy, ``qin`` the
queue-receive view.  Task state lives only in ``regs``: between slices it
sits as a saved frame on the task's stack, which is what makes stack
corruption consequential.
"""

from __future__ import annotations

import torch

from coast_tpu_torch.ops.u32 import word
from coast_tpu_torch.passes.verification import RegionDataflow
from coast_tpu_torch.rtos.kernel import MASK, make_kernel_region


def _pack(acc, x, scratch, count):
    """The four words of a slice's register file, each masked to 31 bits;
    ``acc`` and ``scratch`` may come in int64 (wrapped first)."""
    parts = [p if p.dtype == torch.int32 else word(p)
             for p in (acc, x, scratch, count)]
    return torch.stack(parts, dim=1) & MASK


def _w(x):
    return x.to(torch.int64)


# -- rtos_mm: the matrix-multiply workload as tasks --------------------------

def task_mm(regs, d, seed, tick, qin):
    """Multiply-accumulate worker (the rtos_mm payload)."""
    acc = _w(regs[:, 0]) + _w(d) * _w(d)
    return _pack(acc, d, regs[:, 2] ^ word(acc), _w(regs[:, 3]) + 1)


def task_crc(regs, d, seed, tick, qin):
    """CRC-ish fold worker."""
    x = (regs[:, 0] ^ d) & 0xFFFF
    acc = (regs[:, 0] << 5) ^ (x * 0x5BD1) ^ (x >> 3)
    return _pack(acc, x, _w(regs[:, 2]) + _w(d), _w(regs[:, 3]) + 1)


def task_idle(regs, d, seed, tick, qin):
    """Idle/heartbeat task: checksum over the tick entropy."""
    acc = _w(regs[:, 0]) + _w(tick) * 31 + _w(seed & 0xFFFF)
    return _pack(acc, seed, regs[:, 2], _w(regs[:, 3]) + 1)


# The reference's analyze() of each target with the raw functions bound
# (pinned in tests/test_torch_rtos_kernel.py).
_TCB = frozenset({"cur", "ready"})
_FRAME = frozenset({"cur", "data", "ready", "regs", "seed", "stacks",
                    "tcb_sp", "tick"})


def _dataflow(regs_extra: frozenset) -> RegionDataflow:
    regs = _FRAME | regs_extra
    qbuf = regs | {"qbuf", "qidx"}
    return RegionDataflow(
        written=frozenset({"cur", "qbuf", "qidx", "ready", "regs",
                           "sched_trace", "seed", "slices", "stacks",
                           "tcb_sp", "tick", "uart", "wmark"}),
        deps={"cur": _TCB, "data": frozenset({"data"}),
              "qbuf": qbuf, "qidx": _TCB | {"qidx"},
              "ready": _TCB | {"slices"}, "regs": regs,
              "sched_trace": _TCB | {"sched_trace", "tick"},
              "seed": frozenset({"seed"}), "slices": _TCB | {"slices"},
              "stacks": frozenset({"cur", "regs", "stacks", "tick"}),
              "tcb_sp": frozenset({"cur", "tcb_sp", "tick"}),
              "tick": frozenset({"tick"}), "uart": qbuf | {"uart"},
              "wmark": frozenset({"cur", "tick", "wmark"})},
        load_addr=frozenset({"cur", "ready", "slices", "tcb_sp", "tick"}),
        store_addr=frozenset({"cur", "qidx", "ready", "tick"}))


MM_DATAFLOW = _dataflow(frozenset())
# The consumer reads the queue at the slot the slice count names.
KUSER_DATAFLOW = _dataflow(frozenset({"qbuf", "slices"}))


def make_rtos_mm():
    return make_kernel_region(
        name="rtos_mm",
        tasks=(task_mm, task_crc, task_idle),
        task_init=(0, 0x1D0F, 0),
        task_names=("task_mm", "task_crc", "task_idle"),
        dataflow=MM_DATAFLOW,
        ticks=48, quota=10)


# -- rtos_kUser: queue-passing user app (kernel+user protection scope) -------

def task_prod(regs, d, seed, tick, qin):
    """Producer: a message from the tick entropy and its own running
    state; the kernel's queue_send publishes it."""
    acc = _w(regs[:, 0]) * 0x9E3B + _w(seed & 0xFFFFF) + _w(d)
    return _pack(acc, seed, regs[:, 2] ^ d, _w(regs[:, 3]) + 1)


def task_cons(regs, d, seed, tick, qin):
    """Consumer: folds the queue-receive view into its accumulator."""
    acc = _w((regs[:, 0] << 3) ^ qin ^ (regs[:, 0] >> 11)) + 0x101
    return _pack(acc, qin, _w(regs[:, 2]) + _w(qin), _w(regs[:, 3]) + 1)


def task_wdg(regs, d, seed, tick, qin):
    """Watchdog/idle: liveness counter over ticks."""
    acc = _w(regs[:, 0]) + _w(tick ^ 0x5A5) + 1
    return _pack(acc, tick, regs[:, 2], _w(regs[:, 3]) + 1)


def make_rtos_kuser():
    return make_kernel_region(
        name="rtos_kUser",
        tasks=(task_prod, task_cons, task_wdg),
        task_init=(1, 0, 0),
        task_names=("task_prod", "task_cons", "task_wdg"),
        dataflow=KUSER_DATAFLOW,
        ticks=60, quota=12)
