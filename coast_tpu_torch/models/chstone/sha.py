"""CHStone sha: SHA-1 over two 8 KiB streams, as a torch region.

The counterpart of ``coast_tpu/models/chstone/sha.py``: two deterministic
8 KiB text streams, padded host-side into the read-only block array, the
golden digests from hashlib.  One region step is one SHA-1 block
compression (the 80 rounds unrolled inside the step); the steps walk
(stream, block) with ``i``.

State layout:
  * ``msg``    (ro)   [2, 129, 16] uint32: padded big-endian message blocks
  * ``digest`` (mem)  [2, 5] uint32: running h0..h4 a stream
  * ``i``      (ctrl) step counter (which (stream, block) is next)

The block read is ``jnp.take(jnp.take(msg, stream, axis=0), blk,
mode="clip")``: the outer take has no mode, so a stream index outside
the array would read the fill word 0xFFFFFFFF (``stream`` is clipped
first, so it never is); the digest read is the same fill-mode take.
``i // 129`` and ``i % 129`` are floor division and modulo.  Its
block graph (``graph``, read by CFCSS) is the reference's.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from coast_tpu_torch.interop import state_from_numpy
from coast_tpu_torch.ir.graph import loop_graph
from coast_tpu_torch.ir.region import (KIND_CTRL, KIND_MEM, KIND_RO,
                                       LeafSpec, Region)
from coast_tpu_torch.models.common import Consts
from coast_tpu_torch.ops.indexing import take_fill, update_drop
from coast_tpu_torch.ops.u32 import const, rotl
from coast_tpu_torch.passes.verification import RegionDataflow

N_STREAMS = 2
STREAM_BYTES = 8192
BLOCKS_PER_STREAM = STREAM_BYTES // 64 + 1        # +1 padding block
TOTAL_STEPS = N_STREAMS * BLOCKS_PER_STREAM

_H0 = (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0)
_KS = (0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xCA62C1D6)

_TEXT = (b"Wear sunscreen. If I could offer you only one tip for the "
         b"future, sunscreen would be it. The long term benefits of "
         b"sunscreen have been proved by scientists. ")

# Equal to the reference's analyze() (pinned in tests/test_torch_baseline.py).
DATAFLOW = RegionDataflow(
    written=frozenset({"digest", "i"}),
    deps={
        "msg": frozenset({"msg"}),
        "digest": frozenset({"digest", "i", "msg"}),
        "i": frozenset({"i"}),
    },
    load_addr=frozenset({"i"}),
    store_addr=frozenset({"i"}))


def _stream_bytes(k: int) -> bytes:
    """Deterministic 8 KiB corpus a stream (the stream index varies the
    phase so the two hashes differ)."""
    reps = (STREAM_BYTES // len(_TEXT) + 2)
    return (_TEXT * reps)[k * 37: k * 37 + STREAM_BYTES]


def _padded_blocks(data: bytes) -> np.ndarray:
    """SHA-1 padding -> [BLOCKS_PER_STREAM, 16] big-endian uint32."""
    bitlen = 8 * len(data)
    padded = data + b"\x80" + b"\x00" * 55 + bitlen.to_bytes(8, "big")
    arr = np.frombuffer(padded, dtype=">u4").astype(np.uint32)
    return arr.reshape(-1, 16)


def _block(msg: torch.Tensor, stream: torch.Tensor,
           blk: torch.Tensor) -> torch.Tensor:
    """``take(take(msg, stream, axis=0), blk, axis=0, mode="clip")`` a
    row: the outer index in fill mode, the inner clamped."""
    n = msg.shape[1]
    s = stream.to(torch.int64)
    s = torch.where(s < 0, s + n, s)
    ok = (s >= 0) & (s < n)
    b = torch.clamp(blk.to(torch.int64), 0, msg.shape[2] - 1)
    rows = torch.arange(msg.shape[0], device=msg.device)
    words = msg[rows, torch.clamp(s, 0, n - 1), b]
    return torch.where(ok[:, None], words, torch.full_like(words, -1))


def make_region() -> Region:
    msg_np = np.stack([_padded_blocks(_stream_bytes(k))
                       for k in range(N_STREAMS)])
    golden = np.stack([
        np.frombuffer(hashlib.sha1(_stream_bytes(k)).digest(),
                      dtype=">u4").astype(np.uint32)
        for k in range(N_STREAMS)])
    image = {
        "msg": msg_np,
        "digest": np.tile(np.asarray(_H0, np.uint32), (N_STREAMS, 1)),
        "i": np.int32(0),
    }
    consts = Consts(h0=np.asarray(_H0, np.uint32), golden=golden)
    ks = [const(v) for v in _KS]

    def init(device):
        return state_from_numpy(image, device)

    def step(state, t):
        i = state["i"]
        stream = torch.clamp(i // BLOCKS_PER_STREAM, 0, N_STREAMS - 1)
        blk = i % BLOCKS_PER_STREAM
        first = blk == 0

        w = list(_block(state["msg"], stream, blk).unbind(1))
        # Message schedule W[0..79] (sha_transform, sha.c:92-102).
        for j in range(16, 80):
            w.append(rotl(w[j - 3] ^ w[j - 8] ^ w[j - 14] ^ w[j - 16], 1))

        # A fresh block of a new stream starts from H0; otherwise the
        # running digest.
        h = torch.where(first[:, None], consts.on(i.device).h0,
                        take_fill(state["digest"], stream, unsigned=True))
        a, b, c, d, e = h.unbind(1)
        for j in range(80):
            if j < 20:
                f = (b & c) | (~b & d)
            elif j < 40:
                f = b ^ c ^ d
            elif j < 60:
                f = (b & c) | (b & d) | (c & d)
            else:
                f = b ^ c ^ d
            tmp = rotl(a, 5) + f + e + w[j] + ks[j // 20]
            a, b, c, d, e = tmp, a, rotl(b, 30), c, d

        new_h = h + torch.stack([a, b, c, d, e], dim=1)
        return {"digest": update_drop(state["digest"], stream, new_h),
                "i": i + 1}

    def done(state):
        return state["i"] >= TOTAL_STEPS

    def check(state):
        bad = state["digest"] != consts.on(state["digest"].device).golden
        return bad.reshape(bad.shape[0], -1).sum(dim=1).to(torch.int32)

    def output(state):
        return state["digest"].reshape(state["digest"].shape[0], -1)

    return Region(
        name="chstone_sha",
        init=init,
        step=step,
        done=done,
        check=check,
        output=output,
        nominal_steps=TOTAL_STEPS,
        max_steps=TOTAL_STEPS + 8,
        spec={
            "msg": LeafSpec(KIND_RO, unsigned=True),
            "digest": LeafSpec(KIND_MEM, unsigned=True),
            "i": LeafSpec(KIND_CTRL),
        },
        default_xmr=True,
        graph=loop_graph("sha_transform", "i", TOTAL_STEPS),
        meta={"golden": golden.tolist(),
              "oracle": "hashlib.sha1 digests of both streams",
              "dataflow": DATAFLOW},
    )
