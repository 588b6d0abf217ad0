"""Smoke-tier benchmarks as torch regions: trivial, helloWorld, simpleTMR.

The counterpart of ``coast_tpu/models/smoke.py``: near-empty programs that
still satisfy the whole Region contract, so every strategy and the
campaign machinery run on degenerate inputs (one step, a tiny loop, a
string).  ``trivial`` is the engine's one-step edge case: a fault window
of one step and a watchdog of four.  Their block graphs (``graph``,
read by CFCSS) are the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from coast_tpu_torch.interop import state_from_numpy
from coast_tpu_torch.ir.graph import loop_graph
from coast_tpu_torch.ir.region import (KIND_CTRL, KIND_MEM, KIND_REG,
                                       KIND_RO, LeafSpec, Region)
from coast_tpu_torch.models.common import Consts
from coast_tpu_torch.ops.indexing import take_clip, update_drop
from coast_tpu_torch.passes.verification import RegionDataflow

# Each equal to the reference's analyze() (pinned in
# tests/test_torch_corpus.py).  trivial's step passes ``ret`` through.
TRIVIAL_DATAFLOW = RegionDataflow(
    written=frozenset({"i"}),
    deps={"ret": frozenset({"ret"}), "i": frozenset({"i"})})
HELLO_DATAFLOW = RegionDataflow(
    written=frozenset({"i", "out"}),
    deps={"text": frozenset({"text"}),
          "out": frozenset({"i", "out", "text"}),
          "i": frozenset({"i"})},
    load_addr=frozenset({"i"}),
    store_addr=frozenset({"i"}))
SIMPLE_TMR_DATAFLOW = RegionDataflow(
    written=frozenset({"acc", "i"}),
    deps={"acc": frozenset({"acc", "i"}), "i": frozenset({"i"})})


def make_trivial_region() -> Region:
    """tests/trivial: main returns 0."""
    image = {"ret": np.int32(0), "i": np.int32(0)}

    def init(device):
        return state_from_numpy(image, device)

    def step(state, t):
        return {"i": state["i"] + 1}

    return Region(
        name="trivial",
        init=init,
        step=step,
        done=lambda s: s["i"] >= 1,
        check=lambda s: (s["ret"] != 0).to(torch.int32),
        output=lambda s: s["ret"].reshape(-1, 1),
        nominal_steps=1,
        max_steps=4,
        spec={"ret": LeafSpec(KIND_REG), "i": LeafSpec(KIND_CTRL)},
        default_xmr=True,
        graph=loop_graph("main", "i", 1),
        meta={"dataflow": TRIVIAL_DATAFLOW},
    )


_HELLO = b"Hello world!"


def make_hello_region() -> Region:
    """tests/helloWorld: emit the string, one character a step (a putchar
    loop).  The read is ``jnp.take(mode="clip")`` and the store
    ``.at[i].set(mode="drop")`` of a clipped ``i``."""
    msg = np.frombuffer(_HELLO + b"\x00" * (-len(_HELLO) % 4),
                        dtype=np.uint8).astype(np.uint32)
    n = len(msg)
    image = {"text": msg, "out": np.zeros(n, np.uint32), "i": np.int32(0)}
    consts = Consts(msg=msg)

    def init(device):
        return state_from_numpy(image, device)

    def step(state, t):
        i = torch.clamp(state["i"], 0, n - 1)
        ch = take_clip(state["text"], i)
        return {"out": update_drop(state["out"], i, ch),
                "i": state["i"] + 1}

    def check(state):
        want = consts.on(state["out"].device).msg
        return (state["out"] != want).sum(dim=1).to(torch.int32)

    return Region(
        name="helloWorld",
        init=init,
        step=step,
        done=lambda s: s["i"] >= n,
        check=check,
        output=lambda s: s["out"],
        nominal_steps=n,
        max_steps=n + 4,
        spec={"text": LeafSpec(KIND_RO, unsigned=True),
              "out": LeafSpec(KIND_MEM, unsigned=True),
              "i": LeafSpec(KIND_CTRL)},
        default_xmr=True,
        graph=loop_graph("puts", "i", n),
        meta={"message": _HELLO.decode(), "dataflow": HELLO_DATAFLOW},
    )


N_ACC = 32


def make_simple_tmr_region() -> Region:
    """tests/simpleTMR: the minimal accumulate loop of the TMR demo."""
    golden = sum(range(N_ACC)) * 3 + 7
    image = {"acc": np.int32(7), "i": np.int32(0)}

    def init(device):
        return state_from_numpy(image, device)

    def step(state, t):
        return {"acc": state["acc"] + 3 * torch.clamp(state["i"], 0,
                                                      N_ACC - 1),
                "i": state["i"] + 1}

    return Region(
        name="simpleTMR",
        init=init,
        step=step,
        done=lambda s: s["i"] >= N_ACC,
        check=lambda s: (s["acc"] != golden).to(torch.int32),
        output=lambda s: s["acc"].reshape(-1, 1),
        nominal_steps=N_ACC,
        max_steps=N_ACC + 8,
        spec={"acc": LeafSpec(KIND_REG), "i": LeafSpec(KIND_CTRL)},
        default_xmr=True,
        graph=loop_graph("accumulate", "i", N_ACC),
        meta={"golden": golden, "dataflow": SIMPLE_TMR_DATAFLOW},
    )
