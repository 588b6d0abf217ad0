"""crc16: the CRC-16/CCITT benchmark as a torch region.

The counterpart of ``coast_tpu/models/crc16.py``: reflected CCITT
polynomial 0x8408, init 0xFFFF, over the 13-byte message "Automated TMR";
one region step per message byte.  ``check`` compares the CRC word with
the build-time golden CRC, ``output`` is the CRC word.  Its block
graph (``graph``, read by CFCSS and the trace instrumentation) is the
reference's.

Two rules of the reference's int32 arithmetic matter once a fault lands:

  * the byte read is ``jnp.take(msg, i, mode="clip")``: a corrupted ``i``
    clamps into ``[0, 12]``; a negative one is not wrapped once, unlike a
    ``dynamic_slice`` start (``ops/indexing.py``);
  * a flip of bit 31 makes ``crc`` or ``i`` negative, and ``crc << 8``
    wraps as XLA's int32 shift does.  The CRC update is computed in int64
    and masked to 16 bits, which keeps the same low bits.
"""

from __future__ import annotations

import numpy as np
import torch

from coast_tpu_torch.interop import state_from_numpy
from coast_tpu_torch.ir.graph import loop_graph
from coast_tpu_torch.ir.region import (KIND_CTRL, KIND_MEM, KIND_REG,
                                       LeafSpec, Region)
from coast_tpu_torch.ops.indexing import in_range
from coast_tpu_torch.passes.verification import RegionDataflow

MESSAGE = b"Automated TMR"
POLY = 0x8408

# ``i`` indexes the byte read; every written leaf depends on all three.
# Equal to the reference's analyze() (pinned in tests/test_torch_regions.py).
DATAFLOW = RegionDataflow(
    written=frozenset({"crc", "i"}),
    deps={
        "msg": frozenset({"msg"}),
        "crc": frozenset({"crc", "i", "msg"}),
        "i": frozenset({"crc", "i", "msg"}),
    },
    load_addr=frozenset({"i"}),
    store_addr=frozenset())


def _crc16_host(data: bytes) -> int:
    """Host-side golden model (an oracle independent of the step)."""
    crc = 0xFFFF
    for byte in data:
        x = ((crc >> 8) ^ byte) & 0xFF
        x ^= x >> 4
        crc = ((crc << 8) ^ (x << 12) ^ (x << 5) ^ x) & 0xFFFF
    return crc


GOLDEN = _crc16_host(MESSAGE)


def make_region() -> Region:
    n = len(MESSAGE)
    image = {
        "msg": np.frombuffer(MESSAGE, dtype=np.uint8).astype(np.int32),
        "crc": np.int32(0xFFFF),
        "i": np.int32(0),
    }

    def init(device):
        return state_from_numpy(image, device)

    def step(state, t):
        i, crc = state["i"], state["crc"]
        idx = in_range(i.to(torch.int64), n)
        byte = state["msg"].gather(1, idx[:, None])[:, 0].to(torch.int64)
        wide = crc.to(torch.int64)
        x = ((wide >> 8) ^ (byte & 0xFF)) & 0xFF
        x = x ^ (x >> 4)
        new_crc = ((wide << 8) ^ (x << 12) ^ (x << 5) ^ x) & 0xFFFF
        active = i < n
        return {
            "crc": torch.where(active, new_crc.to(torch.int32), crc),
            "i": torch.where(active, i + 1, i),
        }

    def done(state):
        return state["i"] >= n

    def check(state):
        return (state["crc"] != GOLDEN).to(torch.int32)

    def output(state):
        return state["crc"].reshape(-1, 1)

    return Region(
        name="crc16",
        init=init,
        step=step,
        done=done,
        check=check,
        output=output,
        nominal_steps=n,
        max_steps=4 * n,
        spec={
            # The message is a global string inside the SoR by default.
            "msg": LeafSpec(KIND_MEM),
            "crc": LeafSpec(KIND_REG),
            "i": LeafSpec(KIND_CTRL),
        },
        default_xmr=True,
        graph=loop_graph("loop", "i", n),
        meta={"golden": GOLDEN, "oracle": f"result: {GOLDEN:x}",
              "dataflow": DATAFLOW},
    )
