"""CHStone blowfish: Blowfish CFB64 encryption of a 5200-byte corpus, as a
torch region.

The counterpart of ``coast_tpu/models/chstone/blowfish.py``: a 1171-step
machine,

  * steps 0..520: the key schedule -- each step one encryption of the
    chaining block whose result fills the next P pair (9 steps) or S-box
    pair (4 x 128 steps);
  * steps 521..1170: one CFB64 block each (encrypt the ivec, xor the
    plaintext, the ciphertext becomes the next ivec).

The P-array and S-boxes are injectable memory leaves.  The pi-derived
initial tables come from a fixed-point Machin formula; the goldens from
the pure-python oracle below (both copied from the reference, with the
published zero-key vector 0x4EF99745 0x6198DD78 pinned in the tests).
The table writes are ``.at[].set(mode="drop")``: the P-pair index runs
past the array once the schedule reaches the S-boxes, and those writes
are dropped.  Its block graph (``graph``, read by CFCSS) is the
reference's.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Tuple

import numpy as np
import torch

from coast_tpu_torch.interop import state_from_numpy
from coast_tpu_torch.ir.graph import BlockGraph, pick
from coast_tpu_torch.ir.region import (KIND_CTRL, KIND_MEM, KIND_RO,
                                       LeafSpec, Region)
from coast_tpu_torch.models.common import Consts
from coast_tpu_torch.ops.indexing import row_select, take_clip, update_drop
from coast_tpu_torch.ops.u32 import lsr
from coast_tpu_torch.passes.verification import RegionDataflow

DATA_BYTES = 5200
N_BLOCKS = DATA_BYTES // 8                 # 650 CFB64 blocks
KS_STEPS = 9 + 4 * 128                     # 521 key-schedule encryptions
N_STEPS = KS_STEPS + N_BLOCKS

_M32 = 0xFFFFFFFF

KEY = b"TPUcoastBlowfish66"                # 18-byte key (1..56 bytes legal)

_TEXT = (b"The quick brown fox jumps over the lazy dog. "
         b"Pack my box with five dozen liquor jugs. ")

# Equal to the reference's analyze() (pinned in tests/test_torch_baseline.py).
DATAFLOW = RegionDataflow(
    written=frozenset({"P", "S", "chain", "i", "out"}),
    deps={
        "plain": frozenset({"plain"}),
        "P": frozenset({"P", "S", "chain", "i"}),
        "S": frozenset({"P", "S", "chain", "i"}),
        "out": frozenset({"P", "S", "chain", "i", "out", "plain"}),
        "chain": frozenset({"P", "S", "chain", "i", "plain"}),
        "i": frozenset({"i"}),
    },
    load_addr=frozenset({"P", "S", "chain", "i"}),
    store_addr=frozenset({"i"}))


def _corpus() -> bytes:
    reps = DATA_BYTES // len(_TEXT) + 2
    return (_TEXT * reps)[:DATA_BYTES]


@lru_cache(maxsize=1)
def pi_hex_words(n_words: int = 1042) -> List[int]:
    """First ``n_words`` 32-bit words of pi's fractional hex expansion
    (the Blowfish initial P/S constants), via fixed-point Machin:
    pi = 16*atan(1/5) - 4*atan(1/239)."""
    hex_digits = n_words * 8 + 16                      # guard digits
    scale = 1 << (4 * hex_digits)

    def atan_inv_exact(x: int) -> int:
        total = 0
        term = scale // x
        x2 = x * x
        k = 0
        while term:
            total += term // (2 * k + 1) if k % 2 == 0 else -(
                term // (2 * k + 1))
            term //= x2
            k += 1
        return total

    pi = 16 * atan_inv_exact(5) - 4 * atan_inv_exact(239)
    frac = pi - 3 * scale                              # fractional part
    words = []
    for _ in range(n_words):
        frac *= 1 << 32
        w, frac = divmod(frac, scale)
        words.append(int(w) & _M32)
    return words


def _initial_tables() -> Tuple[List[int], List[int]]:
    words = pi_hex_words()
    return words[:18], words[18:18 + 1024]


# -- pure-python oracle (build-time golden generator) ------------------------

def _f(s: List[int], x: int) -> int:
    a, b, c, d = (x >> 24) & 255, (x >> 16) & 255, (x >> 8) & 255, x & 255
    return ((((s[a] + s[256 + b]) & _M32) ^ s[512 + c]) + s[768 + d]) & _M32


def _encrypt_block(p: List[int], s: List[int], xl: int, xr: int
                   ) -> Tuple[int, int]:
    for i in range(16):
        xl ^= p[i]
        xr ^= _f(s, xl)
        xl, xr = xr, xl
    xl, xr = xr, xl
    xr ^= p[16]
    xl ^= p[17]
    return xl, xr


def _keyed_p(key: bytes) -> List[int]:
    p = list(_initial_tables()[0])
    for i in range(18):
        kw = 0
        for j in range(4):
            kw = (kw << 8) | key[(4 * i + j) % len(key)]
        p[i] ^= kw
    return p


def key_schedule(key: bytes) -> Tuple[List[int], List[int]]:
    p = _keyed_p(key)
    s = list(_initial_tables()[1])
    dl = dr = 0
    for i in range(0, 18, 2):
        dl, dr = _encrypt_block(p, s, dl, dr)
        p[i], p[i + 1] = dl, dr
    for i in range(0, 1024, 2):
        dl, dr = _encrypt_block(p, s, dl, dr)
        s[i], s[i + 1] = dl, dr
    return p, s


def golden_reference(key: bytes, data: bytes) -> np.ndarray:
    """CFB64-encrypt; the ciphertext as uint32 [N_BLOCKS, 2]."""
    p, s = key_schedule(key)
    ivl = ivr = 0
    out = []
    for b in range(0, len(data), 8):
        kl, kr = _encrypt_block(p, s, ivl, ivr)
        cl = int.from_bytes(data[b:b + 4], "big") ^ kl
        cr = int.from_bytes(data[b + 4:b + 8], "big") ^ kr
        out.append((cl, cr))
        ivl, ivr = cl, cr
    return np.array(out, np.int64).astype(np.uint32)


# -- the torch region ---------------------------------------------------------

_BYTE = Consts(base=np.array([0, 256, 512, 768]))


def _jf(s: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The F function: the four S-box words of x's bytes (``s[a]``),
    one gather."""
    idx = torch.stack([lsr(x, 24) & 255, lsr(x, 16) & 255, lsr(x, 8) & 255,
                       x & 255], dim=1) + _BYTE.on(x.device).base
    sa, sb, sc, sd = row_select(s, idx).unbind(1)
    return ((sa + sb) ^ sc) + sd


def _jencrypt(p: torch.Tensor, s: torch.Tensor, xl: torch.Tensor,
              xr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    for i in range(16):
        xl = xl ^ p[:, i]
        xr = xr ^ _jf(s, xl)
        xl, xr = xr, xl
    xl, xr = xr, xl
    return xl ^ p[:, 17], xr ^ p[:, 16]


def make_region() -> Region:
    data = _corpus()
    golden = golden_reference(KEY, data)
    image = {
        "plain": np.frombuffer(data, dtype=">u4").astype(np.uint32)
                   .reshape(-1, 2),
        "P": np.asarray(_keyed_p(KEY), np.uint32),
        "S": np.asarray(_initial_tables()[1], np.uint32),
        "out": np.zeros((N_BLOCKS, 2), np.uint32),
        "chain": np.zeros(2, np.uint32),   # key-schedule data / CFB ivec
        "i": np.int32(0),
    }
    tables = Consts(golden=golden.view(np.int32))

    def init(device):
        return state_from_numpy(image, device)

    def step(state, t):
        i = state["i"]
        p, s = state["P"], state["S"]
        in_ks = i < KS_STEPS

        # Both phases encrypt the chaining block with the current tables.
        xl, xr = _jencrypt(p, s, state["chain"][:, 0], state["chain"][:, 1])
        pair = torch.stack([xl, xr], dim=1)

        # Key-schedule phase: the pair into P or S (S index negative while
        # the schedule is still on P: wrapped once, that value unused).
        ks_i = torch.clamp(i, 0, KS_STEPS - 1)
        is_p = ks_i < 9
        p_idx, s_idx = 2 * ks_i, 2 * (ks_i - 9)
        new_p = torch.where((in_ks & is_p)[:, None], update_drop(
            update_drop(p, p_idx, xl), p_idx + 1, xr), p)
        new_s = torch.where((in_ks & ~is_p)[:, None], update_drop(
            update_drop(s, s_idx, xl), s_idx + 1, xr), s)

        # CFB phase: keystream xor plaintext.
        blk = torch.clamp(i - KS_STEPS, 0, N_BLOCKS - 1)
        ct = take_clip(state["plain"], blk) ^ pair
        new_out = torch.where(in_ks[:, None, None], state["out"],
                              update_drop(state["out"], blk, ct))

        # Chain: the key schedule feeds the encryption back; CFB chains
        # the ciphertext.  Crossing into CFB resets the ivec to 0.
        chain = torch.where(in_ks[:, None], pair, ct)
        chain = torch.where((i == KS_STEPS - 1)[:, None],
                            torch.zeros_like(chain), chain)
        return {"P": new_p, "S": new_s, "out": new_out, "chain": chain,
                "i": i + 1}

    def done(state):
        return state["i"] >= N_STEPS

    def check(state):
        bad = state["out"] != tables.on(state["out"].device).golden
        return bad.reshape(bad.shape[0], -1).sum(dim=1).to(torch.int32)

    def output(state):
        return state["out"].reshape(state["out"].shape[0], -1)

    return Region(
        name="chstone_blowfish",
        init=init,
        step=step,
        done=done,
        check=check,
        output=output,
        nominal_steps=N_STEPS,
        max_steps=N_STEPS + 8,
        spec={
            "plain": LeafSpec(KIND_RO, unsigned=True),
            "P": LeafSpec(KIND_MEM, unsigned=True),
            "S": LeafSpec(KIND_MEM, unsigned=True),
            "out": LeafSpec(KIND_MEM, unsigned=True),
            "chain": LeafSpec(KIND_MEM, unsigned=True),
            "i": LeafSpec(KIND_CTRL),
        },
        default_xmr=True,
        graph=BlockGraph(
            names=["entry", "BF_set_key", "BF_cfb64_encrypt", "exit"],
            edges=[(0, 1), (1, 1), (1, 2), (2, 2), (2, 3)],
            block_of=lambda s: pick(s["i"] >= N_STEPS, 3,
                                    pick(s["i"] >= KS_STEPS, 2, 1))),
        meta={"oracle": "pure-python Blowfish (pi tables via Machin)",
              "golden_head": golden[0].tolist(), "dataflow": DATAFLOW},
    )
