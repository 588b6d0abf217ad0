"""matrixMultiply256/1024: the flagship family as torch regions.

The counterpart of ``coast_tpu/models/mm256.py``: the same program as the
9x9 matrixMultiply (golden made at build time, blocked product, self check
counting mismatching words) at a size where the replica tensors are large.
One step is one ``block``-row output block; two micro-steps per block
(compute into the live ``acc`` register leaf, then commit).

Entries are integer-valued floats sized per side so every product and row
sum stays below 2^24: the float32 product is exact and the golden compare
is bitwise-stable under any summation order.  That only holds while the
product runs in full float32, so importing this module pins it:
``torch.backends.cuda.matmul.allow_tf32 = False``,
``torch.backends.cudnn.allow_tf32 = False`` and
``torch.set_float32_matmul_precision("highest")``.  TF32 would round the
(possibly flipped) operands differently from the reference.

A flip into a mantissa bit of ``first``, ``second`` or ``acc`` adds a
non-integer term, and whether the row sum rounds back onto the golden then
depends on the summation order, which differs between XLA, MKL and cuBLAS.
The same flip into a zero entry makes a subnormal.  The port's voters read
a subnormal as zero, as the reference's do (``ops/voters.py``), but the
step's own float ops do not: XLA's CPU backend (like the TPU) flushes a
subnormal operand of a product or sum and torch keeps it.
:func:`order_sensitive` names those rows; every other row is exact.
"""

from __future__ import annotations

import numpy as np
import torch

from coast_tpu_torch.interop import state_from_numpy
from coast_tpu_torch.ir.graph import BlockGraph, pick
from coast_tpu_torch.ir.region import (KIND_CTRL, KIND_MEM, KIND_REG,
                                       KIND_RO, LeafSpec, Region)
from coast_tpu_torch.models.common import lcg_words
from coast_tpu_torch.models.mm import DATAFLOW
from coast_tpu_torch.ops.indexing import row_select, row_update

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

SIDE = 256
BLOCK = 32
SEED = 42
# Leaves whose mantissa flips make the row sums order-dependent.
ORDER_SENSITIVE_LEAVES = ("first", "second", "acc")
MANTISSA_BITS = 23


def _fill(seed: int, n: int, bits: int) -> np.ndarray:
    """Deterministic integer-valued entries in [0, 2^bits)."""
    return lcg_words(seed, n, bits=bits).astype(np.float32)


def _entry_bits(side: int, bf16_matmul: bool) -> int:
    """Largest entry width keeping every row sum exactly representable:
    side * (2^bits - 1)^2 < 2^24.  bf16 operands also cap entries below
    2^8 so the bfloat16 cast is exact."""
    bits = 1
    while side * (2 ** (bits + 1) - 1) ** 2 < 2 ** 24:
        bits += 1
    return min(bits, 8) if bf16_matmul else bits


def make_region(side: int = SIDE, block: int = BLOCK,
                bf16_matmul: bool = False,
                name: "str | None" = None) -> Region:
    """The flagship family: ``side`` x ``side`` blocked matmul.

    ``bf16_matmul=True`` rounds the operands to bfloat16 inside the step
    and accumulates in float32 (state stays 32-bit).  The product is
    ``matmul(a.to(bf16).float(), b.to(bf16).float())``, never a bf16
    matmul, which would round its output to bf16."""
    n_blocks = side // block
    bits = _entry_bits(side, bf16_matmul)
    first = _fill(SEED, side * side, bits).reshape(side, side)
    second = _fill(SEED + 1, side * side, bits).reshape(side, side)
    # Exact in f32 (sums < 2^24), so host float64 rounds to the same values.
    golden = (first.astype(np.float64) @ second.astype(np.float64)
              ).astype(np.float32)
    image = {
        "first": first,
        "second": second,
        "results": np.zeros((side, side), np.float32),
        "golden": golden,
        "acc": np.zeros((block, side), np.float32),
        "i": np.int32(0),
        "phase": np.int32(0),
    }

    def init(device):
        return state_from_numpy(image, device)

    def step(state, t):
        i, phase = state["i"], state["phase"]
        n_rows = i.shape[0]
        blk_i = torch.clamp(i, 0, n_blocks - 1)
        block_a = row_select(
            state["first"].reshape(n_rows, n_blocks, block, side), blk_i)
        if bf16_matmul:
            computed = torch.matmul(
                block_a.to(torch.bfloat16).float(),
                state["second"].to(torch.bfloat16).float())
        else:
            computed = torch.matmul(block_a, state["second"])
        compute_phase = phase == 0
        acc = torch.where(compute_phase[:, None, None], computed,
                          state["acc"])
        stored = row_update(
            state["results"].reshape(n_rows, n_blocks, block, side),
            state["acc"], blk_i).reshape(n_rows, side, side)
        results = torch.where(compute_phase[:, None, None],
                              state["results"], stored)
        return {
            "acc": acc,
            "results": results,
            "i": torch.where(compute_phase, i, i + 1),
            "phase": torch.where(compute_phase, 1, 0).to(torch.int32),
        }

    def done(state):
        return state["i"] >= n_blocks

    def check(state):
        mism = state["golden"] != state["results"]
        return mism.reshape(mism.shape[0], -1).sum(dim=1).to(torch.int32)

    def output(state):
        res = state["results"]
        return res.reshape(res.shape[0], -1).view(torch.int32)

    def store_slice(view, t):
        # Each commit micro-step stores one block of rows of `results`:
        # the store sync votes just those rows.  Per-row starts (a
        # corrupted i moves the window) and a per-row `active` flag
        # (compute micro-steps store nothing).
        return ((torch.clamp(view["i"], 0, n_blocks - 1) * block, 0),
                (block, side),
                view["phase"] == 1)

    return Region(
        name=name or f"matrixMultiply{side}",
        init=init,
        step=step,
        done=done,
        check=check,
        output=output,
        nominal_steps=2 * n_blocks,
        max_steps=6 * n_blocks,
        spec={
            "first": LeafSpec(KIND_MEM),
            "second": LeafSpec(KIND_MEM),
            "results": LeafSpec(KIND_MEM, xmr=True),
            "golden": LeafSpec(KIND_RO),
            "acc": LeafSpec(KIND_REG),
            "i": LeafSpec(KIND_CTRL),
            "phase": LeafSpec(KIND_CTRL),
        },
        default_xmr=True,
        graph=BlockGraph(
            names=["entry", "compute", "store", "exit"],
            edges=[(0, 1), (1, 2), (2, 1), (2, 3)],
            block_of=lambda s: pick(s["phase"] == 0,
                                    pick(s["i"] >= n_blocks, 3, 1), 2)),
        meta={"oracle": "Number of errors: 0",
              "bf16_matmul": bf16_matmul,
              "dataflow": DATAFLOW,
              "store_slice": {"results": store_slice}},
    )


def make_region_1024() -> Region:
    """1024x1024 with bf16 operands (4 MiB per leaf)."""
    return make_region(side=1024, block=128, bf16_matmul=True)


def make_region_1024_b512() -> Region:
    """block=512: 4 commit steps instead of 16, same program and oracle."""
    return make_region(side=1024, block=512, bf16_matmul=True,
                       name="matrixMultiply1024b512")


def order_sensitive(leaf_order, leaf_id: np.ndarray,
                    bit: np.ndarray) -> np.ndarray:
    """Rows of a schedule whose record may legitimately differ between
    frameworks: a flip below the f32 exponent of ``first``, ``second`` or
    ``acc`` (summation order, and the subnormal flush of the step's float
    ops; module docstring)."""
    ids = [leaf_order.index(n) for n in ORDER_SENSITIVE_LEAVES
           if n in leaf_order]
    return np.isin(np.asarray(leaf_id), ids) & (np.asarray(bit)
                                                < MANTISSA_BITS)
