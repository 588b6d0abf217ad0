"""quicksort: the LANL sort benchmark as a torch region (BASELINE config 3,
-DWC).

The counterpart of ``coast_tpu/models/quicksort.py``: 580 pseudo-random
ints sorted forward twice, then in reverse twice, each ascending result
counted against the golden sorted array into ``errs`` and the final one
checked against the descending golden.  The sort is an odd-even
transposition sort: one region step a phase, each phase a 580-wide
compare-exchange of the pairs ``(offset + 2k, offset + 2k + 1)``.  The
phase and pass counters are the control state; ``phase % 2`` is a floor
modulo, as in the reference.  Its block graph (``graph``, read
by CFCSS) is the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from coast_tpu_torch.interop import state_from_numpy
from coast_tpu_torch.ir.graph import BlockGraph, pick
from coast_tpu_torch.ir.region import (KIND_CTRL, KIND_MEM, KIND_REG,
                                       KIND_RO, LeafSpec, Region)
from coast_tpu_torch.models.common import lcg_words
from coast_tpu_torch.passes.verification import RegionDataflow

ELEMS = 580            # array_elements, quicksort.c:84
PASSES = 4             # fwd, fwd, rev, rev
SEED = 7

# No index is formed from state: the transposition phases are static
# slices.  Equal to the reference's analyze() (pinned in
# tests/test_torch_baseline.py).
DATAFLOW = RegionDataflow(
    written=frozenset({"array", "errs", "pass_", "phase"}),
    deps={
        "array": frozenset({"array", "pass_", "phase"}),
        "golden": frozenset({"golden"}),
        "golden_rev": frozenset({"golden_rev"}),
        "pass_": frozenset({"pass_", "phase"}),
        "phase": frozenset({"pass_", "phase"}),
        "errs": frozenset({"array", "errs", "golden", "pass_", "phase"}),
    },
    load_addr=frozenset(),
    store_addr=frozenset())


def _exchange(a: torch.Tensor, offset: int,
              ascending: torch.Tensor) -> torch.Tensor:
    """One transposition phase over the pairs (offset+2k, offset+2k+1)."""
    m = ((ELEMS - offset) // 2) * 2
    body = a[:, offset:offset + m]
    left, right = body[:, 0::2], body[:, 1::2]
    lo, hi = torch.minimum(left, right), torch.maximum(left, right)
    asc = ascending[:, None]
    merged = torch.stack([torch.where(asc, lo, hi),
                          torch.where(asc, hi, lo)], dim=2)
    return torch.cat([a[:, :offset], merged.reshape(a.shape[0], m),
                      a[:, offset + m:]], dim=1)


def make_region() -> Region:
    vals = lcg_words(SEED, ELEMS, bits=15)
    image = {
        "array": vals.astype(np.int32),
        "golden": np.sort(vals).astype(np.int32),
        "golden_rev": np.sort(vals)[::-1].astype(np.int32),
        "pass_": np.int32(0),
        "phase": np.int32(0),
        "errs": np.int32(0),
    }

    def init(device):
        return state_from_numpy(image, device)

    def step(state, t):
        a, p, phase = state["array"], state["pass_"], state["phase"]
        active = p < PASSES
        ascending = p < 2
        new_a = torch.where(((phase % 2) == 0)[:, None],
                            _exchange(a, 0, ascending),
                            _exchange(a, 1, ascending))
        last_phase = phase >= ELEMS - 1
        # End of the ascending passes: count against the golden (the final
        # state is counted in check()).
        asc_done = last_phase & (p == 1)
        asc_errs = (new_a != state["golden"]).sum(dim=1).to(torch.int32)
        return {
            "array": torch.where(active[:, None], new_a, a),
            "phase": torch.where(active, torch.where(
                last_phase, torch.zeros_like(phase), phase + 1), phase),
            "pass_": torch.where(active & last_phase, p + 1, p),
            "errs": state["errs"] + torch.where(active & asc_done, asc_errs,
                                                torch.zeros_like(asc_errs)),
        }

    def done(state):
        return state["pass_"] >= PASSES

    def check(state):
        final = (state["array"] != state["golden_rev"]).sum(dim=1)
        return state["errs"] + final.to(torch.int32)

    def output(state):
        return state["array"]

    return Region(
        name="quicksort",
        init=init,
        step=step,
        done=done,
        check=check,
        output=output,
        nominal_steps=PASSES * ELEMS,
        max_steps=PASSES * ELEMS + ELEMS,
        spec={
            "array": LeafSpec(KIND_MEM),
            # The golden arrays live outside the protected compute and
            # are never written: read-only (still injectable).
            "golden": LeafSpec(KIND_RO),
            "golden_rev": LeafSpec(KIND_RO),
            "pass_": LeafSpec(KIND_CTRL),
            "phase": LeafSpec(KIND_CTRL),
            "errs": LeafSpec(KIND_REG),
        },
        default_xmr=True,
        graph=BlockGraph(
            names=["entry", "sort_fwd", "sort_rev", "exit"],
            edges=[(0, 1), (1, 1), (1, 2), (2, 2), (2, 3)],
            block_of=lambda s: pick(s["pass_"] >= PASSES, 3,
                                    pick(s["pass_"] < 2, 1, 2))),
        meta={"oracle": "local_errors == 0", "dataflow": DATAFLOW},
    )
