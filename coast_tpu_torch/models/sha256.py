"""sha256: the SHA-256 benchmark as a torch region (BASELINE config 2,
-TMR).

The counterpart of ``coast_tpu/models/sha256.py``: hash a fixed 41-byte
message in one padded block and compare the digest ``h`` with the one
hashlib gives.  Stepped at round granularity:

    phase 0 (48 steps): message-schedule expansion  w[16+round] = ...
    phase 1 (64 steps): one compression round a step on regs a..h
    phase 2 (1 step):   h += regs; done

``w``, ``h``, ``regs``, ``k`` and ``golden`` are uint32 in the reference,
int32 words here (``ops/u32.py`` gives the logical shifts).  The reads
are ``jnp.take(mode="clip")`` (a negative index reads word 0) and the
schedule store is ``w.at[j].set(mode="drop")``.  Its block
graph (``graph``, read by CFCSS) is the reference's.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from coast_tpu_torch.interop import state_from_numpy
from coast_tpu_torch.ir.graph import BlockGraph
from coast_tpu_torch.ir.region import (KIND_CTRL, KIND_MEM, KIND_REG,
                                       KIND_RO, LeafSpec, Region)
from coast_tpu_torch.ops.indexing import take_clip, update_drop
from coast_tpu_torch.ops.u32 import lsr, rotr
from coast_tpu_torch.passes.verification import RegionDataflow

MESSAGE = b"coast_tpu sha256 benchmark: Automated TMR"

_K = [
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2]

_H0 = [0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
       0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19]

# Equal to the reference's analyze() (pinned in tests/test_torch_baseline.py).
DATAFLOW = RegionDataflow(
    written=frozenset({"h", "phase", "regs", "round", "w"}),
    deps={
        "w": frozenset({"phase", "round", "w"}),
        "h": frozenset({"h", "k", "phase", "regs", "round", "w"}),
        "regs": frozenset({"h", "k", "phase", "regs", "round", "w"}),
        "k": frozenset({"k"}),
        "golden": frozenset({"golden"}),
        "round": frozenset({"phase", "round"}),
        "phase": frozenset({"phase", "round"}),
    },
    load_addr=frozenset({"round"}),
    store_addr=frozenset({"round"}))


def _pad_block(msg: bytes) -> np.ndarray:
    assert len(msg) <= 55, "single-block region: message must fit 55 bytes"
    buf = bytearray(64)
    buf[:len(msg)] = msg
    buf[len(msg)] = 0x80
    buf[56:64] = (len(msg) * 8).to_bytes(8, "big")
    return np.frombuffer(bytes(buf), dtype=">u4").astype(np.uint32)


def make_region() -> Region:
    w0 = np.zeros(64, np.uint32)
    w0[:16] = _pad_block(MESSAGE)
    golden = np.frombuffer(hashlib.sha256(MESSAGE).digest(),
                           dtype=">u4").astype(np.uint32)
    image = {
        "w": w0,
        "h": np.asarray(_H0, np.uint32),
        "regs": np.asarray(_H0, np.uint32),
        "k": np.asarray(_K, np.uint32),
        "golden": golden,
        "round": np.int32(0),
        "phase": np.int32(0),
    }

    def init(device):
        return state_from_numpy(image, device)

    def step(state, t):
        w, regs = state["w"], state["regs"]
        rnd, phase = state["round"], state["phase"]

        # phase 0: schedule expansion w[16 + rnd].
        j = torch.clamp(rnd, 0, 47) + 16
        s1w, s0w, w7, w16 = take_clip(
            w, torch.stack([j - 2, j - 15, j - 7, j - 16], dim=1)).unbind(1)
        sig1 = rotr(s1w, 17) ^ rotr(s1w, 19) ^ lsr(s1w, 10)
        sig0 = rotr(s0w, 7) ^ rotr(s0w, 18) ^ lsr(s0w, 3)
        w_expanded = update_drop(w, j, sig1 + w7 + sig0 + w16)

        # phase 1: compression round rnd.
        a, b, c, d, e, f, g, h = regs.unbind(1)
        i = torch.clamp(rnd, 0, 63)
        ep1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = h + ep1 + ch + take_clip(state["k"], i) + take_clip(w, i)
        ep0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        regs_next = torch.stack([t1 + ep0 + maj, a, b, c, d + t1, e, f, g],
                                dim=1)

        # phase 2: finalize.
        h_final = state["h"] + regs

        p0, p1, p2 = phase == 0, phase == 1, phase == 2
        active = phase < 3
        last0 = p0 & (rnd >= 47)
        last1 = p1 & (rnd >= 63)
        zero = torch.zeros_like(rnd)
        new_w = torch.where(p0[:, None], w_expanded, w)
        new_regs = torch.where(p1[:, None], regs_next, regs)
        new_h = torch.where(p2[:, None], h_final, state["h"])
        new_round = torch.where(
            p0, torch.where(last0, zero, rnd + 1),
            torch.where(p1, torch.where(last1, zero, rnd + 1), rnd))
        new_phase = torch.where(last0, 1, torch.where(
            last1, 2, torch.where(p2, 3, phase))).to(torch.int32)
        act = active[:, None]
        return {
            "w": torch.where(act, new_w, w),
            "regs": torch.where(act, new_regs, regs),
            "h": torch.where(act, new_h, state["h"]),
            "round": torch.where(active, new_round, rnd),
            "phase": torch.where(active, new_phase, phase),
        }

    def done(state):
        return state["phase"] >= 3

    def check(state):
        return (state["h"] != state["golden"]).sum(dim=1).to(torch.int32)

    def output(state):
        return state["h"]

    return Region(
        name="sha256",
        init=init,
        step=step,
        done=done,
        check=check,
        output=output,
        nominal_steps=48 + 64 + 1,
        max_steps=3 * (48 + 64 + 1),
        spec={
            "w": LeafSpec(KIND_MEM, unsigned=True),
            "h": LeafSpec(KIND_MEM, unsigned=True),
            "regs": LeafSpec(KIND_REG, unsigned=True),
            "k": LeafSpec(KIND_RO, unsigned=True),
            # The digest compare runs outside the SoR (__NO_xMR); never
            # written, so read-only (still injectable).
            "golden": LeafSpec(KIND_RO, unsigned=True),
            "round": LeafSpec(KIND_CTRL),
            "phase": LeafSpec(KIND_CTRL),
        },
        default_xmr=True,
        graph=BlockGraph(
            names=["entry", "schedule", "compress", "finalize", "exit"],
            edges=[(0, 1), (1, 1), (1, 2), (2, 2), (2, 3), (3, 4)],
            block_of=lambda s: torch.clamp(s["phase"] + 1, 1, 4)),
        meta={"oracle": "Number of errors: 0",
              "golden_hex": hashlib.sha256(MESSAGE).hexdigest(),
              "dataflow": DATAFLOW},
    )
