"""CHStone dfadd / dfmul / dfdiv / dfsin: IEEE double soft-float kernels,
as torch regions.

The counterpart of ``coast_tpu/models/chstone/dfkernels.py``, on the limb
soft-float of :mod:`df64`:

  * df{add,mul,div}: one step = one test vector through the op; the
    vectors cover every special-value pair (0/+-1/+-1.5/+-inf/NaN,
    denormals, max/min normals) plus seeded random patterns, and the
    goldens come from numpy's IEEE float64 (NaNs canonicalised);
  * dfsin: one step = one Taylor term of one input
    (term_j = -term_{j-1} * x^2 / ((2j)(2j+1)), 10 terms x 36 inputs); the
    golden runs the same recurrence in numpy float64.

The vector reads are ``jnp.take(mode="clip")`` and the result writes
``.at[].set(mode="drop")``; ``i // 10`` and ``i % 10`` are floor division
and modulo.  Its block graph (``graph``, read by CFCSS) is the
reference's.
"""

from __future__ import annotations

import struct
from typing import Callable

import numpy as np
import torch

from coast_tpu_torch.interop import state_from_numpy
from coast_tpu_torch.ir.graph import loop_graph
from coast_tpu_torch.ir.region import (KIND_CTRL, KIND_MEM, KIND_RO,
                                       LeafSpec, Region)
from coast_tpu_torch.models.chstone import df64
from coast_tpu_torch.models.common import Consts
from coast_tpu_torch.ops.indexing import take_clip, update_drop
from coast_tpu_torch.ops.u32 import wide, word
from coast_tpu_torch.passes.verification import RegionDataflow

_SPECIALS = np.array([
    0x0000000000000000, 0x8000000000000000,        # +-0
    0x3FF0000000000000, 0xBFF0000000000000,        # +-1
    0x3FF8000000000000, 0xBFF8000000000000,        # +-1.5
    0x4000000000000000, 0xC000000000000000,        # +-2
    0x7FF0000000000000, 0xFFF0000000000000,        # +-inf
    0x7FF8000000000000,                            # nan
    0x0000000000000001, 0x000FFFFFFFFFFFFF,        # denormals
    0x0010000000000000, 0x7FEFFFFFFFFFFFFF,        # min/max normal
    0x3FF0000000000001, 0x3CA0000000000000,        # 1+ulp, 2^-53
], dtype=np.uint64)

N_VECTORS = 64

# Equal to the reference's analyze() (pinned in tests/test_torch_baseline.py).
OP_DATAFLOW = RegionDataflow(
    written=frozenset({"i", "z"}),
    deps={
        "a_in": frozenset({"a_in"}),
        "b_in": frozenset({"b_in"}),
        "z": frozenset({"a_in", "b_in", "i", "z"}),
        "i": frozenset({"i"}),
    },
    load_addr=frozenset({"i"}),
    store_addr=frozenset({"i"}))
SIN_DATAFLOW = RegionDataflow(
    written=frozenset({"acc", "i", "term", "x2"}),
    deps={
        "x_in": frozenset({"x_in"}),
        "divs": frozenset({"divs"}),
        "acc": frozenset({"acc", "divs", "i", "term", "x2", "x_in"}),
        "term": frozenset({"divs", "i", "term", "x2", "x_in"}),
        "x2": frozenset({"i", "x2", "x_in"}),
        "i": frozenset({"i"}),
    },
    load_addr=frozenset({"i", "term", "x2", "x_in"}),
    store_addr=frozenset({"i"}))


def _vectors(op: str) -> tuple:
    """Special-pair coverage + seeded randoms."""
    rng = np.random.RandomState({"add": 11, "mul": 22, "div": 33}[op])
    k = len(_SPECIALS)
    idx = np.arange(N_VECTORS)
    a = _SPECIALS[idx % k].copy()
    b = _SPECIALS[(idx * 7 + 3) % k].copy()
    n_rand = N_VECTORS - 40
    a[40:] = rng.randint(0, 2**64, n_rand, dtype=np.uint64)
    b[40:] = rng.randint(0, 2**64, n_rand, dtype=np.uint64)
    return a, b


def _split2(bits: np.ndarray) -> np.ndarray:
    hi, lo = df64.split_bits(bits)
    return np.stack([hi, lo], axis=-1)


def _pair(x: torch.Tensor):
    """A [R, 2] word pair -> (hi, lo) in the soft-float's int64 form."""
    w = wide(x)
    return w[:, 0], w[:, 1]


def _words(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    return torch.stack([word(hi), word(lo)], dim=1)


def _count_bad_rows(z: torch.Tensor, golden: torch.Tensor) -> torch.Tensor:
    return (z != golden).any(dim=2).sum(dim=1).to(torch.int32)


def _make_df_op_region(kname: str, op: str, op_fn: Callable) -> Region:
    a_bits, b_bits = _vectors(op)
    golden = Consts(z=_split2(df64.oracle_op(op, a_bits, b_bits)))
    image = {
        "a_in": _split2(a_bits),
        "b_in": _split2(b_bits),
        "z": np.zeros((N_VECTORS, 2), np.uint32),
        "i": np.int32(0),
    }

    def init(device):
        return state_from_numpy(image, device)

    def step(state, t):
        i = torch.clamp(state["i"], 0, N_VECTORS - 1)
        z = op_fn(*_pair(take_clip(state["a_in"], i)),
                  *_pair(take_clip(state["b_in"], i)))
        return {"z": update_drop(state["z"], i, _words(*z)),
                "i": state["i"] + 1}

    def done(state):
        return state["i"] >= N_VECTORS

    def check(state):
        # main_result counts exact matches; errors = misses.
        return _count_bad_rows(state["z"], golden.on(state["z"].device).z)

    def output(state):
        return state["z"].reshape(state["z"].shape[0], -1)

    return Region(
        name=kname,
        init=init,
        step=step,
        done=done,
        check=check,
        output=output,
        nominal_steps=N_VECTORS,
        max_steps=N_VECTORS + 8,
        spec={
            "a_in": LeafSpec(KIND_RO, unsigned=True),
            "b_in": LeafSpec(KIND_RO, unsigned=True),
            "z": LeafSpec(KIND_MEM, unsigned=True),
            "i": LeafSpec(KIND_CTRL),
        },
        default_xmr=True,
        graph=loop_graph(f"float64_{op}", "i", N_VECTORS),
        meta={"oracle": f"numpy float64 {op} (NaN-canonicalised)",
              "dataflow": OP_DATAFLOW},
    )


def make_dfadd() -> Region:
    return _make_df_op_region("chstone_dfadd", "add", df64.f64_add)


def make_dfmul() -> Region:
    return _make_df_op_region("chstone_dfmul", "mul", df64.f64_mul)


def make_dfdiv() -> Region:
    return _make_df_op_region("chstone_dfdiv", "div", df64.f64_div)


# -- dfsin -------------------------------------------------------------------

N_INPUTS = 36
N_TERMS = 10
SIN_STEPS = N_INPUTS * N_TERMS


def _dbl(x: float) -> int:
    return struct.unpack("<Q", struct.pack("<d", x))[0]


# Term divisors (2j)(2j+1), j=1..9: small exact integers.
_DIVS = [float((2 * j) * (2 * j + 1)) for j in range(1, N_TERMS)]


def _sin_inputs() -> np.ndarray:
    xs = [-np.pi + k * (2 * np.pi / (N_INPUTS - 1)) for k in range(N_INPUTS)]
    return np.array([_dbl(float(v)) for v in xs], dtype=np.uint64)


def _sin_golden(x_bits: np.ndarray) -> np.ndarray:
    """The same recurrence in numpy float64 (one rounding an op)."""
    out = []
    for xb in x_bits:
        x = np.uint64(xb).view(np.float64)
        with np.errstate(all="ignore"):
            x2 = x * x
            term = x
            acc = x
            for j in range(1, N_TERMS):
                term = np.float64(term * x2)
                term = np.float64(term / np.float64(_DIVS[j - 1]))
                term = -term
                acc = np.float64(acc + term)
        out.append(np.float64(acc).view(np.uint64))
    return df64.canonicalize_nan64(np.array(out, dtype=np.uint64))


def make_dfsin() -> Region:
    x_bits = _sin_inputs()
    golden = Consts(acc=_split2(_sin_golden(x_bits)))
    image = {
        "x_in": _split2(x_bits),
        "divs": _split2(np.array([_dbl(d) for d in _DIVS], dtype=np.uint64)),
        "acc": np.zeros((N_INPUTS, 2), np.uint32),
        "term": np.zeros(2, np.uint32),
        "x2": np.zeros(2, np.uint32),
        "i": np.int32(0),
    }

    def init(device):
        return state_from_numpy(image, device)

    def step(state, t):
        i = state["i"]
        inp = torch.clamp(i // N_TERMS, 0, N_INPUTS - 1)
        j = i % N_TERMS
        first = (j == 0)[:, None]

        x = take_clip(state["x_in"], inp)
        xw = wide(x)
        x2 = torch.where(first, torch.stack(df64.f64_mul(
            xw[:, 0], xw[:, 1], xw[:, 0], xw[:, 1]), dim=1),
            wide(state["x2"]))

        # term_j = -(term_{j-1} * x2) / divs[j-1]
        th, tl = df64.f64_mul(*_pair(state["term"]), x2[:, 0], x2[:, 1])
        d = take_clip(state["divs"], torch.clamp(j - 1, 0, N_TERMS - 2))
        th, tl = df64.f64_div(th, tl, *_pair(d))
        term = torch.where(first, x, _words(th ^ 0x80000000, tl))

        acc_prev = take_clip(state["acc"], inp)
        sh, sl = df64.f64_add(*_pair(acc_prev), *_pair(term))
        acc_new = torch.where(first, x, _words(sh, sl))
        return {"acc": update_drop(state["acc"], inp, acc_new),
                "term": term, "x2": _words(x2[:, 0], x2[:, 1]),
                "i": i + 1}

    def done(state):
        return state["i"] >= SIN_STEPS

    def check(state):
        return _count_bad_rows(state["acc"],
                               golden.on(state["acc"].device).acc)

    def output(state):
        return state["acc"].reshape(state["acc"].shape[0], -1)

    return Region(
        name="chstone_dfsin",
        init=init,
        step=step,
        done=done,
        check=check,
        output=output,
        nominal_steps=SIN_STEPS,
        max_steps=SIN_STEPS + 8,
        spec={
            "x_in": LeafSpec(KIND_RO, unsigned=True),
            "divs": LeafSpec(KIND_RO, unsigned=True),
            "acc": LeafSpec(KIND_MEM, unsigned=True),
            "term": LeafSpec(KIND_MEM, unsigned=True),
            "x2": LeafSpec(KIND_MEM, unsigned=True),
            "i": LeafSpec(KIND_CTRL),
        },
        default_xmr=True,
        graph=loop_graph("sin_term", "i", SIN_STEPS),
        meta={"oracle": "numpy float64 identical-recurrence Taylor sine",
              "dataflow": SIN_DATAFLOW},
    )
