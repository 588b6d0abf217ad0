"""COAST's ``tests/matrixMultiply`` as a stepped program, in plain torch.

Two builds of the one program (``make``):

* ``words="u32"``: the C source's ``unsigned int`` ``side`` x ``side``
  product, wrapping mod 2^32, one output row a block (``block=1``).
  Entries are ``rand()``'s 15-bit values (glibc's LCG, seeds 42 and 43).
* ``words="f32"``: the same program with float32 words and ``block``
  output rows a block, entries integer-valued and small enough that every
  row sum is below 2^24, so the fault-free product is exact in float32;
  ``operands="bf16"`` rounds both operands to bfloat16 inside the step and
  accumulates in float32.

Either way a block takes two steps: ``acc <- first[block rows] @ second``,
then ``results[block rows] <- acc; i += 1``.  The golden copy is the
exact product, made here; the self check counts result words that differ
from it.  A corrupted ``i`` wraps once when negative and then clamps, so it
reads or writes a wrong block and never traps.

``precision`` is what the step computes the product in: ``"stated"`` is
the configuration's own; the lower ones are the control's (the nearest
precision below the stated one): float32 for the u32 product, fp8 (e4m3)
operands for bfloat16 ones.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.engine import (KIND_CTRL, KIND_MEM, KIND_REG,
                                        KIND_RO, Leaf, Region)

_MASK32 = 0xFFFFFFFF
_LCG_A, _LCG_C, _LCG_MASK = 1103515245, 12345, 0x7FFFFFFF


def lcg(seed: int, n: int, bits: int) -> np.ndarray:
    """glibc ``rand()``'s LCG: ``(state >> 16)`` masked to ``bits``."""
    out = np.empty(n, np.int64)
    x = seed & _LCG_MASK
    for k in range(n):
        x = (_LCG_A * x + _LCG_C) & _LCG_MASK
        out[k] = (x >> 16) & ((1 << bits) - 1)
    return out


def _lcg_fast(seed: int, n: int, bits: int) -> np.ndarray:
    """:func:`lcg` for large ``n``: the affine map applied by strides."""
    if n <= 4096:
        return lcg(seed, n, bits)
    states = np.empty(n, np.int64)
    x = seed & _LCG_MASK
    stride = 4096
    for k in range(stride):
        x = (_LCG_A * x + _LCG_C) & _LCG_MASK
        states[k] = x
    a_s, c_s = 1, 0
    for _ in range(stride):
        a_s = (_LCG_A * a_s) & _LCG_MASK
        c_s = (_LCG_A * c_s + _LCG_C) & _LCG_MASK
    for lo in range(stride, n, stride):
        m = min(stride, n - lo)
        states[lo:lo + m] = (a_s * states[lo - stride:lo - stride + m]
                             + c_s) & _LCG_MASK
    return (states >> 16) & ((1 << bits) - 1)


def _entry_bits(side: int, operands: str) -> int:
    """Widest entry keeping every row sum below 2^24 (and below 2^8 where
    the operands are rounded to bfloat16, so that rounding is exact)."""
    bits = 1
    while side * (2 ** (bits + 1) - 1) ** 2 < 2 ** 24:
        bits += 1
    return min(bits, 8) if operands == "bf16" else bits


def _clamp_index(i: torch.Tensor, n: int) -> torch.Tensor:
    i = i.to(torch.int64)
    return torch.clamp(torch.where(i < 0, i + n, i), 0, n - 1)


def _to_word(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) -> int32 with the same bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def _product_u32(row: torch.Tensor, mat: torch.Tensor,
                 precision: str) -> torch.Tensor:
    """``row [R, k] . mat [R, k, n]`` mod 2^32 over uint32 words."""
    if precision == "float32":
        prod = (row.to(torch.int64) & _MASK32).to(torch.float32)[:, :, None] \
            * (mat.to(torch.int64) & _MASK32).to(torch.float32)
        return _to_word(prod.sum(dim=1).to(torch.float64)
                        .remainder(2.0 ** 32).to(torch.int64) & _MASK32)
    # Sign-extended int32 products fit int64 and keep the low 32 bits;
    # each is masked before the sum, so the sum fits too.
    prod = (row.to(torch.int64)[:, :, None] * mat.to(torch.int64)) & _MASK32
    return _to_word(prod.sum(dim=1) & _MASK32)


def _product_f32(block_a: torch.Tensor, second: torch.Tensor,
                 operands: str, precision: str) -> torch.Tensor:
    if precision == "fp8":
        cast = torch.float8_e4m3fn
    elif operands == "bf16":
        cast = torch.bfloat16
    else:
        cast = None
    if cast is not None:
        block_a = block_a.to(cast).to(torch.float32)
        second = second.to(cast).to(torch.float32)
    return torch.matmul(block_a, second)


def make(side: int, block: int = 1, words: str = "u32",
         operands: str = "f32", seed: int = 42,
         precision: str = "stated", name: str = "matrixMultiply") -> Region:
    if side % block:
        raise ValueError(f"block {block} does not divide side {side}")
    if words not in ("u32", "f32"):
        raise ValueError(f"words {words!r}: u32 or f32")
    n_blocks = side // block
    if words == "u32":
        first = _lcg_fast(seed, side * side, 15).astype(np.uint32)
        second = _lcg_fast(seed + 1, side * side, 15).astype(np.uint32)
        golden = np.zeros((side, side), np.uint64)
        a, b = first.astype(np.uint64).reshape(side, side), \
            second.astype(np.uint64).reshape(side, side)
        for k in range(side):
            golden = (golden + (a[:, k, None] * b[None, k, :]) % 2 ** 32) \
                % 2 ** 32
        golden = golden.astype(np.uint32)
        dtype = np.uint32
    else:
        bits = _entry_bits(side, operands)
        first = _lcg_fast(seed, side * side, bits).astype(np.float32)
        second = _lcg_fast(seed + 1, side * side, bits).astype(np.float32)
        golden = (first.astype(np.float64).reshape(side, side)
                  @ second.astype(np.float64).reshape(side, side)
                  ).astype(np.float32)
        dtype = np.float32
    image = {
        "first": first.reshape(side, side),
        "second": second.reshape(side, side),
        "results": np.zeros((side, side), dtype),
        "golden": golden,
        "acc": np.zeros((block, side) if block > 1 else (side,), dtype),
        "i": np.int32(0),
        "phase": np.int32(0),
    }

    def step(state, t):
        i, phase = state["i"], state["phase"]
        rows = i.shape[0]
        compute = phase == 0
        if words == "u32":
            ic = _clamp_index(i, n_blocks)
            row = state["first"][torch.arange(rows, device=i.device), ic]
            computed = _product_u32(row, state["second"], precision)
            acc = torch.where(compute[:, None], computed, state["acc"])
            stored = state["results"].clone()
            stored[torch.arange(rows, device=i.device), ic] = state["acc"]
            results = torch.where(compute[:, None, None], state["results"],
                                  stored)
        else:
            ic = _clamp_index(torch.clamp(i, 0, n_blocks - 1), n_blocks)
            ar = torch.arange(rows, device=i.device)
            block_a = state["first"].reshape(rows, n_blocks, block,
                                             side)[ar, ic]
            computed = _product_f32(block_a, state["second"], operands,
                                    precision)
            acc = torch.where(compute[:, None, None], computed, state["acc"])
            stored = state["results"].reshape(rows, n_blocks, block,
                                              side).clone()
            stored[ar, ic] = state["acc"]
            results = torch.where(compute[:, None, None], state["results"],
                                  stored.reshape(rows, side, side))
        return {"acc": acc, "results": results,
                "i": torch.where(compute, i, i + 1),
                "phase": torch.where(compute, torch.ones_like(phase),
                                     torch.zeros_like(phase))}

    def done(view):
        return view["i"] >= n_blocks

    def check(view):
        mism = view["golden"] != view["results"]
        return mism.reshape(mism.shape[0], -1).sum(dim=1).to(torch.int32)

    windows = {}
    if block > 1:
        def results_window(view):
            first_row = torch.clamp(view["i"], 0, n_blocks - 1) * block
            return first_row, block, view["phase"] == 1
        windows["results"] = results_window

    shape_acc = (block, side) if block > 1 else (side,)
    return Region(
        name=name,
        leaves=[Leaf("first", KIND_MEM, (side, side)),
                Leaf("second", KIND_MEM, (side, side)),
                Leaf("results", KIND_MEM, (side, side)),
                Leaf("golden", KIND_RO, (side, side)),
                Leaf("acc", KIND_REG, shape_acc),
                Leaf("i", KIND_CTRL, ()),
                Leaf("phase", KIND_CTRL, ())],
        image=image, step=step, done=done, check=check,
        output_words=side * side,
        nominal_steps=2 * n_blocks, max_steps=6 * n_blocks,
        load_addr=frozenset({"i"}), store_addr=frozenset({"i"}),
        written=frozenset({"acc", "results", "i", "phase"}),
        done_leaves=("i",), windows=windows, window_rows=block,
        # A block computes on its even step and stores on its odd one.
        store_trips=lambda steps: steps // 2)
