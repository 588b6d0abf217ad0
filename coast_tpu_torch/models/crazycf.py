"""crazyCF: the irregular-control-flow benchmark as a torch region.

The counterpart of ``coast_tpu/models/crazycf.py``: a dispatch machine
over a 96-word data array.  Each step reads the current word with
``jnp.take(mode="clip")``, classifies it into one of seven switch cases
(``v % 7``, an unsigned remainder) and applies that case's update to the
uint32 accumulator; every case is computed and one selected, as the
reference does.  ``data`` and ``acc`` are uint32 in the reference, int32
words here.  Its 10-node block graph (``graph``, read by CFCSS) is
the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from coast_tpu_torch.interop import state_from_numpy
from coast_tpu_torch.ir.graph import BlockGraph, pick
from coast_tpu_torch.ir.region import (KIND_CTRL, KIND_MEM, KIND_RO,
                                       LeafSpec, Region)
from coast_tpu_torch.ops.indexing import take_clip
from coast_tpu_torch.ops.u32 import const, lsr, ult, wide, word
from coast_tpu_torch.passes.verification import RegionDataflow

N = 96

# Equal to the reference's analyze() (pinned in tests/test_torch_corpus.py).
DATAFLOW = RegionDataflow(
    written=frozenset({"acc", "i"}),
    deps={"data": frozenset({"data"}),
          "acc": frozenset({"acc", "data", "i"}),
          "i": frozenset({"i"})},
    load_addr=frozenset({"i"}))


def make_input() -> np.ndarray:
    rng = np.random.RandomState(17)
    return rng.randint(0, 2**31, N).astype(np.int64)


def _case_update(v: int, acc: int) -> int:
    """The host oracle's switch body (Python ints, wrapped to uint32)."""
    m = 0xFFFFFFFF
    c = v % 7
    if c == 0:
        acc = (acc + v) & m
    elif c == 1:
        acc = (acc ^ (v << 3)) & m
    elif c == 2:
        acc = (acc * 2654435761) & m if v & 1 else (acc + 0x9E3779B9) & m
    elif c == 3:
        acc = ((acc >> 5) | (acc << 27)) & m
    elif c == 4:
        acc = (acc - v) & m if acc > v else (v - acc) & m
    elif c == 5:
        acc = (acc | (v >> 7)) & m
    else:
        acc = (acc & (v | 0xFF)) & m
    return acc


def golden_reference(data: np.ndarray) -> int:
    acc = 0x12345678
    for v in data:
        acc = _case_update(int(v) & 0xFFFFFFFF, acc)
    return acc


def make_region() -> Region:
    data = make_input()
    golden = golden_reference(data)
    image = {"data": data.astype(np.uint32), "acc": np.uint32(0x12345678),
             "i": np.int32(0)}

    def init(device):
        return state_from_numpy(image, device)

    def step(state, t):
        i = torch.clamp(state["i"], 0, N - 1)
        v = take_clip(state["data"], i)
        acc = state["acc"]
        c = wide(v) % 7
        r0 = acc + v
        r1 = acc ^ (v << 3)
        r2 = torch.where((v & 1) == 1,
                         word(acc.to(torch.int64) * const(2654435761)),
                         acc + const(0x9E3779B9))
        r3 = lsr(acc, 5) | (acc << 27)
        r4 = torch.where(ult(v, acc), acc - v, v - acc)
        r5 = acc | lsr(v, 7)
        r6 = acc & (v | 0xFF)
        new_acc = torch.where(c == 0, r0,
                   torch.where(c == 1, r1,
                    torch.where(c == 2, r2,
                     torch.where(c == 3, r3,
                      torch.where(c == 4, r4,
                       torch.where(c == 5, r5, r6))))))
        return {"acc": new_acc, "i": state["i"] + 1}

    def done(state):
        return state["i"] >= N

    def check(state):
        return (state["acc"] != const(golden)).to(torch.int32)

    def output(state):
        return state["acc"].reshape(-1, 1)

    def block_of(state):
        i = state["i"]
        v = take_clip(state["data"], torch.clamp(i, 0, N - 1))
        return pick(i >= N, 9, wide(v) % 7 + 2)

    # block_of reports the case block (2..8) the step will execute; every
    # case can follow every case (via the merge).
    names = ["entry", "dispatch"] + [f"case{k}" for k in range(7)] + ["exit"]
    edges = [(0, c) for c in range(2, 9)]
    edges += [(a, b) for a in range(2, 9) for b in range(2, 9)]
    edges += [(c, 9) for c in range(2, 9)]
    edges += [(0, 1), (1, 2)]          # keep dispatch reachable

    return Region(
        name="crazyCF",
        init=init,
        step=step,
        done=done,
        check=check,
        output=output,
        nominal_steps=N,
        max_steps=N + 8,
        spec={
            "data": LeafSpec(KIND_RO, unsigned=True),
            "acc": LeafSpec(KIND_MEM, unsigned=True),
            "i": LeafSpec(KIND_CTRL),
        },
        default_xmr=True,
        graph=BlockGraph(names=names, edges=edges, block_of=block_of),
        meta={"golden": golden, "dataflow": DATAFLOW},
    )
