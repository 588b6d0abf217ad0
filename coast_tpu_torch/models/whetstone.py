"""whetstone: the floating-point synthetic benchmark as a torch region.

The counterpart of ``coast_tpu/models/whetstone.py`` (whetstone.c /
whets.c): one step is one iteration of Whetstone module 1 over the f32
4-word working set ``e``, 128 iterations.  Each sum runs left to right
and each product is its own operator, one rounding an operator, as in
the reference and its numpy golden.  The check has the reference's 1e-4
tolerance.  :func:`order_sensitive` names the flips whose records may
differ from the reference's.  Its block graph (``graph``, read
by CFCSS) is the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from coast_tpu_torch.interop import state_from_numpy
from coast_tpu_torch.ir.graph import loop_graph
from coast_tpu_torch.ir.region import KIND_CTRL, KIND_REG, LeafSpec, Region
from coast_tpu_torch.models.common import Consts
from coast_tpu_torch.passes.verification import RegionDataflow

N_ITER = 128
T = np.float32(0.499975)
T1 = np.float32(0.50025)
T2 = np.float32(2.0)

# Equal to the reference's analyze() (pinned in
# tests/test_torch_corpus_float.py).
DATAFLOW = RegionDataflow(
    written=frozenset({"e", "i"}),
    deps={"e": frozenset({"e"}), "i": frozenset({"i"})})


def golden_reference() -> np.ndarray:
    e = np.array([1.0, -1.0, -1.0, -1.0], np.float32)
    for _ in range(N_ITER):
        # Module 1: simple identifiers (whets.c N1 body).
        e0 = np.float32((e[0] + e[1] + e[2] - e[3]) * T)
        e1 = np.float32((e0 + e[1] - e[2] + e[3]) * T)
        e2 = np.float32((e0 - e1 + e[2] + e[3]) * T)
        e3 = np.float32((-e0 + e1 + e2 + e[3]) * T)
        e = np.array([e0, e1, e2, np.float32(e3 / T2)], np.float32)
    return e


def make_region() -> Region:
    golden = golden_reference()
    image = {"e": np.array([1.0, -1.0, -1.0, -1.0], np.float32),
             "i": np.int32(0)}
    consts = Consts(golden=golden)
    t, t2 = float(T), float(T2)     # the f32 values, exactly

    def init(device):
        return state_from_numpy(image, device)

    def step(state, step_t):
        a, b, c, d = state["e"].unbind(1)
        e0 = (a + b + c - d) * t
        e1 = (e0 + b - c + d) * t
        e2 = (e0 - e1 + c + d) * t
        e3 = (-e0 + e1 + e2 + d) * t
        return {"e": torch.stack([e0, e1, e2, e3 / t2], dim=1),
                "i": state["i"] + 1}

    def done(state):
        return state["i"] >= N_ITER

    def check(state):
        want = consts.on(state["e"].device).golden
        return ((state["e"] - want).abs() > 1e-4).sum(dim=1).to(torch.int32)

    return Region(
        name="whetstone",
        init=init,
        step=step,
        done=done,
        check=check,
        output=lambda s: s["e"].view(torch.int32),
        nominal_steps=N_ITER,
        max_steps=N_ITER + 8,
        spec={"e": LeafSpec(KIND_REG), "i": LeafSpec(KIND_CTRL)},
        default_xmr=True,
        graph=loop_graph("module1", "i", N_ITER),
        meta={"golden_bits": [hex(int(x)) for x in golden.view(np.uint32)],
              "dataflow": DATAFLOW},
    )


def order_sensitive(leaf_order, leaf_id: np.ndarray,
                    bit: np.ndarray) -> np.ndarray:
    """Rows of a whetstone schedule whose record may legitimately differ
    between frameworks: every flip of ``e``, whatever its bit.  Each word
    of ``e`` enters every sum of the next step beside the others, and the
    words drift apart in size over the run (``e[3]`` falls to about
    1.3e-5), so a sum's rounding can absorb a flip of a small word, or
    what is left of it, and whether it does (a masked fault: no
    correction, no DWC detection) depends on how each step was rounded.
    XLA contracts multiply-adds of the batched step into fused ones; the
    port rounds every operator."""
    del bit
    return np.isin(np.asarray(leaf_id), [leaf_order.index("e")])
