"""nestedCalls: a multi-function region for the function-scope lists.

The counterpart of ``coast_tpu/models/nested_calls.py``: a hash pipeline
whose step calls two named sub-functions through the ``fns`` namespace,
so every scope class (-ignoreFns, -skipLibCalls, -replicateFnCalls,
-cloneFns, -cloneReturn, -cloneAfterCall, -protectedLibFn) can be applied
to them and its call-boundary behaviour observed.

Program: ``out[i] = fold(mix(acc ^ data[i]))``, ``acc`` chaining through
``mix``, so a flipped lane keeps diverging until a call-boundary or store
sync repairs or detects it.  The words are uint32 in the reference and
int32 bits here (``ops/u32.py``: logical shifts, products in int64).
"""

from __future__ import annotations

import numpy as np
import torch

from coast_tpu_torch.interop import state_from_numpy
from coast_tpu_torch.ir.graph import loop_graph
from coast_tpu_torch.ir.region import (KIND_CTRL, KIND_MEM, KIND_REG, KIND_RO,
                                       LeafSpec, Region)
from coast_tpu_torch.models.common import Consts
from coast_tpu_torch.ops.indexing import row_select, row_update
from coast_tpu_torch.ops.u32 import const, lsr, word
from coast_tpu_torch.passes.verification import RegionDataflow

N = 24

# Equal to the reference's analyze() with the raw functions bound (pinned
# in tests/test_torch_fn_scope.py).
DATAFLOW = RegionDataflow(
    written=frozenset({"acc", "i", "out"}),
    deps={"data": frozenset({"data"}),
          "out": frozenset({"acc", "data", "i", "out"}),
          "i": frozenset({"i"}),
          "acc": frozenset({"acc", "data", "i"})},
    load_addr=frozenset({"i"}),
    store_addr=frozenset({"i"}))


def mix(x: torch.Tensor) -> torch.Tensor:
    """Inner hash round (a protected callee by default)."""
    x = word((x ^ lsr(x, 3)).to(torch.int64) * const(0x9E3779B1))
    return x ^ lsr(x, 7)


def fold(x: torch.Tensor) -> torch.Tensor:
    """Word fold (the function the scope tests move between classes)."""
    return word((lsr(x, 16) ^ (x & 0xFFFF)).to(torch.int64)
                * const(0x85EBCA6B))


def _golden(data: np.ndarray) -> np.ndarray:
    """The final ``out`` with the raw functions, on the host."""
    m = 0xFFFFFFFF
    acc, outs = 1, []
    for v in data.tolist():
        x = acc ^ v
        y = ((x ^ (x >> 3)) * 0x9E3779B1) & m
        y ^= y >> 7
        outs.append((((y >> 16) ^ (y & 0xFFFF)) * 0x85EBCA6B) & m)
        acc = y
    return np.asarray(outs, np.uint32)


def make_region() -> Region:
    data = ((np.arange(N, dtype=np.uint64) * 2654435761) & 0xFFFFFFFF) >> 13
    data = data.astype(np.uint32)
    image = {"data": data, "out": np.zeros(N, np.uint32), "i": np.int32(0),
             "acc": np.uint32(1)}
    consts = Consts(golden=_golden(data))

    def init(device):
        return state_from_numpy(image, device)

    def step(state, t, fns):
        i = state["i"]
        y = fns.mix(state["acc"] ^ row_select(state["data"], i))
        z = fns.fold(y)
        return {"out": row_update(state["out"], z, i), "i": i + 1, "acc": y}

    def check(state):
        want = consts.on(state["out"].device).golden
        return (state["out"] != want).sum(dim=1).to(torch.int32)

    return Region(
        name="nestedCalls",
        init=init,
        step=step,
        done=lambda s: s["i"] >= N,
        check=check,
        output=lambda s: s["out"],
        nominal_steps=N,
        max_steps=3 * N,
        spec={
            "data": LeafSpec(KIND_RO, unsigned=True),
            "out": LeafSpec(KIND_MEM, unsigned=True),
            "i": LeafSpec(KIND_CTRL),
            "acc": LeafSpec(KIND_REG, unsigned=True),
        },
        default_xmr=True,
        graph=loop_graph("loop", "i", N),
        functions={"mix": mix, "fold": fold},
        meta={"oracle": "Number of errors: 0", "dataflow": DATAFLOW},
    )
