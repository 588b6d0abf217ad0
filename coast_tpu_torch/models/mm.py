"""matrixMultiply: the reference's zero-to-aha benchmark as a torch region.

The counterpart of ``coast_tpu/models/mm.py``: a 9x9 product in mod-2^32
arithmetic (C unsigned semantics), golden copy made at build time, self
check counting mismatching words.  Two micro-steps per output row:

    phase 0: acc  <- first[i,:] . second
    phase 1: results[i,:] <- acc ; i += 1

``results``, ``golden`` and ``acc`` are uint32 in the reference; here they
are int32 tensors holding the same bits (``LeafSpec.unsigned``).  Products
and row sums are computed in int64, masked to 32 bits and reinterpreted as
int32, which is the reference's wrapping uint32 arithmetic word for word.
"""

from __future__ import annotations

import numpy as np
import torch

from coast_tpu_torch.interop import state_from_numpy
from coast_tpu_torch.ir.graph import BlockGraph, pick
from coast_tpu_torch.ir.region import (KIND_CTRL, KIND_MEM, KIND_REG,
                                       KIND_RO, LeafSpec, Region)
from coast_tpu_torch.ops.indexing import row_select, row_update
from coast_tpu_torch.ops.voters import priced
from coast_tpu_torch.passes.verification import RegionDataflow

SIDE = 9
SEED = 42
_MASK32 = 0xFFFFFFFF

# The dataflow of the matrixMultiply family (mm and mm256 share the step
# shape): ``i`` indexes the row read of ``first`` and the row write of
# ``results``.  Equal to the reference's analyze() of both (pinned in
# tests/test_torch_regions.py).
DATAFLOW = RegionDataflow(
    written=frozenset({"acc", "results", "i", "phase"}),
    deps={
        "first": frozenset({"first"}),
        "second": frozenset({"second"}),
        "golden": frozenset({"golden"}),
        "acc": frozenset({"acc", "first", "i", "phase", "second"}),
        "results": frozenset({"acc", "i", "phase", "results"}),
        "i": frozenset({"i", "phase"}),
        "phase": frozenset({"phase"}),
    },
    load_addr=frozenset({"i"}),
    store_addr=frozenset({"i"}))


def _lcg_fill(seed: int, n: int) -> np.ndarray:
    """Deterministic 15-bit pseudo-random values (stands in for rand())."""
    out = []
    x = seed & 0x7FFFFFFF
    for _ in range(n):
        x = (1103515245 * x + 12345) & 0x7FFFFFFF
        out.append((x >> 16) & 0x7FFF)
    return np.array(out, dtype=np.int32)


def _matmul_u32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Product in mod-2^32 arithmetic (host side, for the golden copy)."""
    au = a.astype(np.uint32).astype(np.uint64)
    bu = b.astype(np.uint32).astype(np.uint64)
    acc = np.zeros((a.shape[0], b.shape[1]), np.uint64)
    for k in range(a.shape[1]):
        acc = (acc + (au[:, k, None] * bu[None, k, :]) % 2**32) % 2**32
    return acc.astype(np.uint32)


@priced(0)
def _to_word(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 tensor with the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _dot_u32(row: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """``sum_k row[r, k] * mat[r, k, :]`` mod 2^32 over uint32 words held
    as int32.  Sign-extended int32 products fit int64 (|a*b| <= 2^62) and
    keep the right low 32 bits; each is masked before the sum so the sum
    cannot overflow either."""
    prod = (row.to(torch.int64)[:, :, None] * mat.to(torch.int64)) & _MASK32
    return _to_word(prod.sum(dim=1) & _MASK32)


def make_region() -> Region:
    first = _lcg_fill(SEED, SIDE * SIDE).reshape(SIDE, SIDE)
    second = _lcg_fill(SEED + 1, SIDE * SIDE).reshape(SIDE, SIDE)
    golden = _matmul_u32(first, second)
    golden_xor = int(np.bitwise_xor.reduce(golden.reshape(-1)))
    image = {
        "first": first,
        "second": second,
        "results": np.zeros((SIDE, SIDE), np.uint32),
        "golden": golden,
        "acc": np.zeros((SIDE,), np.uint32),
        "i": np.int32(0),
        "phase": np.int32(0),
    }

    def init(device):
        return state_from_numpy(image, device)

    def step(state, t):
        i, phase = state["i"], state["phase"]
        # A corrupted i clamps: it reads/writes a wrong row, never traps.
        computed = _dot_u32(row_select(state["first"], i), state["second"])
        compute_phase = phase == 0
        acc = torch.where(compute_phase[:, None], computed, state["acc"])
        stored = row_update(state["results"], state["acc"], i)
        results = torch.where(compute_phase[:, None, None],
                              state["results"], stored)
        return {
            "acc": acc,
            "results": results,
            "i": torch.where(compute_phase, i, i + 1),
            "phase": torch.where(compute_phase, 1, 0).to(torch.int32),
        }

    def done(state):
        return state["i"] >= SIDE

    def check(state):
        mism = state["golden"] != state["results"]
        return mism.reshape(mism.shape[0], -1).sum(dim=1).to(torch.int32)

    def output(state):
        return state["results"].reshape(state["results"].shape[0], -1)

    return Region(
        name="matrixMultiply",
        init=init,
        step=step,
        done=done,
        check=check,
        output=output,
        nominal_steps=2 * SIDE,
        max_steps=6 * SIDE,
        spec={
            "first": LeafSpec(KIND_MEM),
            "second": LeafSpec(KIND_MEM),
            "results": LeafSpec(KIND_MEM, xmr=True, unsigned=True),
            "golden": LeafSpec(KIND_RO, unsigned=True),
            "acc": LeafSpec(KIND_REG, unsigned=True),
            "i": LeafSpec(KIND_CTRL),
            "phase": LeafSpec(KIND_CTRL),
        },
        default_xmr=True,
        graph=BlockGraph(
            names=["entry", "compute", "store", "exit"],
            edges=[(0, 1), (1, 2), (2, 1), (2, 3)],
            # The loop-exit test lives in the store/latch block: 'exit' is
            # reached only from a post-store state (phase back at 0).
            block_of=lambda s: pick(s["phase"] == 0,
                                    pick(s["i"] >= SIDE, 3, 1), 2)),
        meta={"golden_xor": golden_xor, "oracle": "Number of errors: 0",
              "dataflow": DATAFLOW},
    )
