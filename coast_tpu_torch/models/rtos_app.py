"""rtos_app: the RTOS-scale scope-configuration demonstrator.

The counterpart of ``coast_tpu/models/rtos_app.py``: a cooperative
round-robin scheduler app in the shape of the reference's FreeRTOS
``rtos_mm`` build.  Three tasks (a multiply-accumulate worker, a CRC
worker, an idle heartbeat) are dispatched one a tick for 48 ticks; each
result goes through a protected ring-buffer queue send and is mirrored to
an unprotected UART buffer.  Every piece of behaviour sits behind one of
twelve named sub-functions, so all seven function-scope list kinds apply
to real callees at once.  The canonical scope configuration is
``rtos/functions.config`` (file keys) plus the CL lists of
``rtos/Makefile``, read through ``interface/config.py``.

The golden output is the fault-free unprotected run's, as the reference
computes it.  The words are int32 as in the reference; products and sums
that can leave int32 are made in int64 and wrapped (``ops/u32.word``).
"""

from __future__ import annotations

import numpy as np
import torch

from coast_tpu_torch.interop import state_from_numpy
from coast_tpu_torch.ir.graph import loop_graph
from coast_tpu_torch.ir.region import (KIND_CTRL, KIND_MEM, KIND_REG, KIND_RO,
                                       LeafSpec, Region)
from coast_tpu_torch.ops.indexing import row_update, take_clip
from coast_tpu_torch.ops.u32 import const, word
from coast_tpu_torch.passes.verification import RegionDataflow

TICKS = 48
RING = 64
N_TASKS = 3

# Equal to the reference's analyze() with the raw functions bound (pinned
# in tests/test_torch_rtos_app.py).
DATAFLOW = RegionDataflow(
    written=frozenset({"acc_crc", "acc_mm", "depth", "ring", "seed", "tick",
                       "uart", "widx"}),
    deps={"data": frozenset({"data"}),
          "ring": frozenset({"acc_crc", "acc_mm", "data", "ring", "seed",
                             "tick", "widx"}),
          "uart": frozenset({"acc_crc", "acc_mm", "data", "seed", "tick",
                             "uart", "widx"}),
          "acc_mm": frozenset({"acc_mm", "data", "tick"}),
          "acc_crc": frozenset({"acc_crc", "acc_mm", "data", "tick"}),
          "seed": frozenset({"seed"}),
          "depth": frozenset({"depth", "tick"}),
          "tick": frozenset({"tick"}),
          "widx": frozenset({"widx"})},
    load_addr=frozenset({"tick"}),
    store_addr=frozenset({"widx"}))


# -- the app's module functions: the unit every scope list names ------------

def pick_task(tick):
    """Scheduler: round-robin dispatch (the vTaskSwitchContext stand-in)."""
    return torch.fmod(tick, N_TASKS)


def clampi(i, n):
    """Index sanitiser for queue/ring addressing: ``rem(max(i, 0), n)``."""
    return torch.fmod(torch.clamp(i, min=0), n)


def rng_next(seed):
    """LCG tick entropy (the rand() stand-in; one stream, fanned out under
    -cloneAfterCall)."""
    return word((seed.to(torch.int64) * 1103515245 + 12345) & 0x7FFFFFFF)


def run_mm(acc, d):
    """Task 0: multiply-accumulate work unit (the rtos_mm payload)."""
    d = d.to(torch.int64)
    return word(acc.to(torch.int64) + d * d)


def run_crc(acc, d):
    """Task 1: CRC-ish fold work unit."""
    x = (acc ^ d) & 0xFFFF
    return ((acc << 5) ^ (x * 0x5BD1) ^ (x >> 3)) & 0x7FFFFFFF


def heartbeat(tick, seed):
    """Task 2: idle/heartbeat checksum."""
    return word((tick.to(torch.int64) * 31 + (seed & 0xFFFF))
                & 0x7FFFFFFF)


def mix(x):
    """Shared hash round used by every task's result path."""
    x = word((x ^ (x >> 3)).to(torch.int64) * const(0x9E3779B1))
    return (x ^ (x >> 7)) & 0x7FFFFFFF


def fold(x):
    """Word fold companion to mix."""
    return ((x >> 16) ^ (x & 0xFFFF)) & 0x7FFFFFFF


def saturate(v):
    """Clamp into the logger's accepted range."""
    return torch.clamp(v, 0, 0x3FFFFFFF)


def ring_push(ring, idx, v):
    """Protected queue send: ``ring[idx] = v`` (the xQueueSend stand-in;
    the protectedLibFn citizen)."""
    return row_update(ring, v, idx)


def uart_fmt(v):
    """UART formatter: the library call kept outside the SoR (-ignoreFns,
    the xil_printf class)."""
    return v ^ 0x55AA55AA


def stack_note(depth, tick):
    """Stack high-water bookkeeping (uxTaskGetStackHighWaterMark class)."""
    return torch.maximum(depth, torch.fmod(tick, 7))


FUNCTIONS = {
    "pick_task": pick_task, "clampi": clampi, "rng_next": rng_next,
    "run_mm": run_mm, "run_crc": run_crc, "heartbeat": heartbeat,
    "mix": mix, "fold": fold, "saturate": saturate,
    "ring_push": ring_push, "uart_fmt": uart_fmt, "stack_note": stack_note,
}


def make_region() -> Region:
    data = (((np.arange(64, dtype=np.int64) * 2654435761) >> 13)
            & 0xFFFF).astype(np.int32)
    image = {
        "data": data,
        "ring": np.zeros(RING, np.int32),
        "uart": np.zeros(RING, np.int32),
        "acc_mm": np.int32(0),
        "acc_crc": np.int32(0x1D0F),
        "seed": np.int32(42),
        "depth": np.int32(0),
        "tick": np.int32(0),
        "widx": np.int32(0),
    }

    def init(device):
        return state_from_numpy(image, device)

    def step(s, t, fns):
        tick = s["tick"]
        task = fns.pick_task(tick)
        d = take_clip(s["data"], fns.clampi(tick, 64))
        seed = fns.rng_next(s["seed"])

        r_mm = fns.run_mm(s["acc_mm"], d)
        r_crc = fns.run_crc(s["acc_crc"], d)
        r_idle = fns.heartbeat(tick, seed)
        val = torch.where(task == 0, r_mm,
                          torch.where(task == 1, r_crc, r_idle))
        val = fns.saturate(fns.fold(fns.mix(val)))

        widx = fns.clampi(s["widx"], RING)
        return {
            "ring": fns.ring_push(s["ring"], widx, val),
            "uart": row_update(s["uart"], fns.uart_fmt(val), widx),
            "acc_mm": torch.where(task == 0, r_mm, s["acc_mm"]),
            "acc_crc": torch.where(task == 1, r_crc, s["acc_crc"]),
            "seed": seed,
            "depth": fns.stack_note(s["depth"], tick),
            "tick": tick + 1,
            "widx": s["widx"] + 1,
        }

    def output(s):
        return torch.cat([s["ring"], s["uart"],
                          torch.stack([s["acc_mm"], s["acc_crc"],
                                       s["depth"]], dim=1)], dim=1)

    region = Region(
        name="rtos_app",
        init=init,
        step=step,
        done=lambda s: s["tick"] >= TICKS,
        check=None,
        output=output,
        nominal_steps=TICKS,
        max_steps=3 * TICKS,
        spec={
            "data": LeafSpec(KIND_RO),
            "ring": LeafSpec(KIND_MEM, xmr=True),
            # The UART mirror lives outside the SoR, like the reference's
            # xil_printf buffers (boundary-voted stores).
            "uart": LeafSpec(KIND_MEM, xmr=False, no_verify=True),
            "acc_mm": LeafSpec(KIND_REG),
            "acc_crc": LeafSpec(KIND_REG),
            "seed": LeafSpec(KIND_REG),
            "depth": LeafSpec(KIND_REG),
            "tick": LeafSpec(KIND_CTRL),
            "widx": LeafSpec(KIND_CTRL),
        },
        default_xmr=True,
        graph=loop_graph("dispatch", "tick", TICKS),
        functions=dict(FUNCTIONS),
        meta={"oracle": "Number of errors: 0", "dataflow": DATAFLOW},
    )

    golden = output({k: v.unsqueeze(0) for k, v in
                     region.run_unprotected(device="cpu").items()})[0]
    cache = {}

    def check(s):
        dev = s["ring"].device
        if dev not in cache:
            cache[dev] = golden.to(dev)
        return (output(s) != cache[dev]).sum(dim=1).to(torch.int32)

    region.check = check
    return region
