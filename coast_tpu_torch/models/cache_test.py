"""cache_test: the strided memory-walk benchmark as a torch region.

The counterpart of ``coast_tpu/models/cache_test.py``: a 1024-word uint32
table (4 KiB) walked three times, with strides 1, 17 and 257, each
visited word read-modify-written; 3 x 1024 = 3,072 nominal steps.  The
cursor ``idx`` is a state word: the read is ``jnp.take(mode="clip")``,
the store ``.at[idx].set(mode="drop")``, so a flipped cursor clamps on
the read and drops the write as in the reference.  ``i // 1024`` and
``i % 1024`` are floor division and floor modulo, as jnp's are.  
Its block graph (``graph``, read by CFCSS) is the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from coast_tpu_torch.interop import state_from_numpy
from coast_tpu_torch.ir.graph import loop_graph
from coast_tpu_torch.ir.region import KIND_CTRL, KIND_MEM, LeafSpec, Region
from coast_tpu_torch.models.common import Consts
from coast_tpu_torch.ops.indexing import lookup, take_clip, update_drop
from coast_tpu_torch.ops.u32 import word
from coast_tpu_torch.passes.verification import RegionDataflow

WORDS = 1024
PASSES = 3
STRIDES = (1, 17, 257)
N_STEPS = PASSES * WORDS

# Equal to the reference's analyze() (pinned in tests/test_torch_corpus.py).
DATAFLOW = RegionDataflow(
    written=frozenset({"i", "idx", "table"}),
    deps={"table": frozenset({"i", "idx", "table"}),
          "idx": frozenset({"i", "idx"}),
          "i": frozenset({"i"})},
    load_addr=frozenset({"i", "idx"}),
    store_addr=frozenset({"idx"}))


def golden_reference() -> np.ndarray:
    mem = (np.arange(WORDS, dtype=np.uint64) * 2246822519) % (1 << 32)
    for p in range(PASSES):
        stride = STRIDES[p]
        idx = 0
        for k in range(WORDS):
            mem[idx] = (mem[idx] * 5 + k + p) % (1 << 32)
            idx = (idx + stride) % WORDS
    return mem.astype(np.uint32)


def make_region() -> Region:
    golden = golden_reference()
    init_mem = ((np.arange(WORDS, dtype=np.uint64) * 2246822519)
                % (1 << 32)).astype(np.uint32)
    image = {"table": init_mem, "idx": np.int32(0), "i": np.int32(0)}
    consts = Consts(golden=golden, strides=np.asarray(STRIDES, np.int32))

    def init(device):
        return state_from_numpy(image, device)

    def step(state, t):
        i, idx = state["i"], state["idx"]
        p = torch.clamp(i // WORDS, 0, PASSES - 1)
        k = i % WORDS
        v = word(take_clip(state["table"], idx).to(torch.int64) * 5 + k + p)
        table = update_drop(state["table"], idx, v)
        # The pass boundary resets the cursor to 0 for the next stride.
        stride = lookup(consts.on(idx.device).strides, p)
        next_idx = (idx + stride) % WORDS
        next_idx = torch.where(k == WORDS - 1, 0, next_idx)
        return {"table": table, "idx": next_idx, "i": i + 1}

    def done(state):
        return state["i"] >= N_STEPS

    def check(state):
        want = consts.on(state["table"].device).golden
        return (state["table"] != want).sum(dim=1).to(torch.int32)

    return Region(
        name="cache_test",
        init=init,
        step=step,
        done=done,
        check=check,
        output=lambda s: s["table"],
        nominal_steps=N_STEPS,
        max_steps=N_STEPS + 8,
        spec={
            "table": LeafSpec(KIND_MEM, unsigned=True),
            "idx": LeafSpec(KIND_CTRL),
            "i": LeafSpec(KIND_CTRL),
        },
        default_xmr=True,
        graph=loop_graph("walk", "i", N_STEPS),
        meta={"dataflow": DATAFLOW},
    )
