"""CHStone jpeg: the baseline JPEG decode core -- Huffman entropy decode,
dequantisation, integer IDCT -- as a torch region.

The counterpart of ``coast_tpu/models/chstone/jpeg.py``.  At build time a
deterministic 16-block 8x8 image is forward-DCT'd, quantised (standard
luminance table), zigzag'd and Huffman-encoded with the JPEG Annex K.3
luminance tables; on the device a stepped state machine decodes that
stream: one step is one Huffman symbol (the canonical min/max-code
ladder over 16 lengths) and its magnitude bits, or one block's dequant
and fixed-point 2D IDCT once its EOB arrives.  The golden comes from the
pure-python decoder with the same integer IDCT (copied from the
reference).

The coefficient write is ``coef.at[blk, k].set(mode="drop")`` (a 2-D
index), the block read ``jnp.take(coef, blk, axis=0)`` in fill mode (both
indices are clipped first, so neither drops nor fills); the IDCT
products wrap as int32.  Its block graph (``graph``, read by
CFCSS) is the reference's.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from coast_tpu_torch.interop import state_from_numpy
from coast_tpu_torch.ir.graph import BlockGraph, pick
from coast_tpu_torch.ir.region import (KIND_CTRL, KIND_MEM, KIND_REG,
                                       KIND_RO, LeafSpec, Region)
from coast_tpu_torch.models.chstone._bits import BitReader, BitWriter, jshow
from coast_tpu_torch.models.common import Consts
from coast_tpu_torch.ops.indexing import lookup, take_fill, update_drop
from coast_tpu_torch.passes.verification import RegionDataflow

NB = 16                       # 8x8 blocks
CONST_BITS = 13
PASS1_BITS = 2

# Standard luminance quantisation table (Annex K.1).
QTAB = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99], np.int64).reshape(8, 8)

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int64)

# Annex K.3.1: luminance DC (BITS, HUFFVAL).
DC_BITS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
DC_VALS = list(range(12))
# Annex K.3.2: luminance AC.
AC_BITS = [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]
AC_VALS = [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41,
    0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91,
    0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24,
    0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A,
    0x25, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53,
    0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66,
    0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
    0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93,
    0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
    0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7,
    0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2,
    0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA]

_CTRL = frozenset({"blk", "k", "pos", "pred", "stream"})
# Equal to the reference's analyze() (pinned in tests/test_torch_baseline.py).
DATAFLOW = RegionDataflow(
    written=frozenset({"blk", "coef", "i", "k", "pixels", "pos", "pred"}),
    deps={
        "stream": frozenset({"stream"}),
        "coef": _CTRL | {"coef", "pixels"},
        "pixels": _CTRL | {"coef", "pixels"},
        "pos": _CTRL,
        "blk": _CTRL,
        "k": _CTRL,
        "pred": _CTRL,
        "i": frozenset({"i"}),
    },
    load_addr=_CTRL,
    store_addr=_CTRL - {"pred"})


def _canonical(bits: List[int], vals: List[int]):
    """(code, length) a symbol + the decoder ladder
    (mincode/maxcode/valptr a length), JPEG Annex C."""
    codes = {}
    mincode = [0] * 17
    maxcode = [-1] * 17
    valptr = [0] * 17
    code = 0
    k = 0
    for length in range(1, 17):
        valptr[length] = k
        mincode[length] = code
        for _ in range(bits[length - 1]):
            codes[vals[k]] = (code, length)
            code += 1
            k += 1
        maxcode[length] = code - 1
        code <<= 1
    return codes, mincode, maxcode, valptr


DC_CODES, DC_MIN, DC_MAX, DC_PTR = _canonical(DC_BITS, DC_VALS)
AC_CODES, AC_MIN, AC_MAX, AC_PTR = _canonical(AC_BITS, AC_VALS)


def make_image() -> np.ndarray:
    """Deterministic [NB, 8, 8] image (smooth gradients + texture)."""
    y, x = np.mgrid[0:8, 0:8]
    blocks = []
    for b in range(NB):
        img = (128 + 60 * np.sin(2 * np.pi * (x + 3 * b) / 13)
               + 40 * np.cos(2 * np.pi * (y + b) / 9)
               + 10 * np.sin(2 * np.pi * (x * y) / 31 + b))
        blocks.append(np.clip(img, 0, 255))
    return np.array(blocks)


def _fdct(block: np.ndarray) -> np.ndarray:
    """Float forward DCT-II (8x8), level-shifted."""
    f = block.astype(np.float64) - 128.0
    n = 8
    c = np.array([[np.cos((2 * i + 1) * u * np.pi / 16) for i in range(n)]
                  for u in range(n)])
    a = np.array([np.sqrt(1 / 8) if u == 0 else np.sqrt(2 / 8)
                  for u in range(n)])
    return a[:, None] * a[None, :] * (c @ f @ c.T)


def _quantise(coef: np.ndarray) -> np.ndarray:
    return np.round(coef / QTAB).astype(np.int64)


def _size_cat(v: int) -> int:
    return 0 if v == 0 else int(abs(v)).bit_length()


class _Writer(BitWriter):
    """BitWriter + JPEG magnitude coding; pads with 1s (Annex B)."""

    def __init__(self):
        super().__init__(pad_bit=1)

    def put_mag(self, v: int, size: int):
        if size == 0:
            return
        if v < 0:
            v = v + (1 << size) - 1
        self.put(v, size)


def encode(blocks_q: np.ndarray) -> Tuple[np.ndarray, int]:
    """Huffman-encode zigzag'd quantised blocks; returns (stream words,
    huffman-symbol count) -- the symbol count sizes the step budget."""
    wr = _Writer()
    pred = 0
    n_sym = 0
    for b in range(NB):
        zz = blocks_q[b].reshape(64)[ZIGZAG]
        diff = int(zz[0]) - pred
        pred = int(zz[0])
        size = _size_cat(diff)
        wr.put(*DC_CODES[size])
        wr.put_mag(diff, size)
        n_sym += 1
        run = 0
        last_nz = 0
        for k in range(1, 64):
            if zz[k] != 0:
                last_nz = k
        for k in range(1, last_nz + 1):
            v = int(zz[k])
            if v == 0:
                run += 1
                continue
            while run >= 16:
                wr.put(*AC_CODES[0xF0])               # ZRL
                n_sym += 1
                run -= 16
            size = _size_cat(v)
            wr.put(*AC_CODES[(run << 4) | size])
            wr.put_mag(v, size)
            n_sym += 1
            run = 0
        if last_nz != 63:
            wr.put(*AC_CODES[0x00])                   # EOB
            n_sym += 1
    return wr.words(), n_sym


# -- the integer IDCT (host oracle and device share it) -----------------------

_C = {  # round(cos(k*pi/16) * 2^13) constants, jpeg_idct_islow style
    "0_298631336": 2446, "0_390180644": 3196, "0_541196100": 4433,
    "0_765366865": 6270, "0_899976223": 7373, "1_175875602": 9633,
    "1_501321110": 12299, "1_847759065": 15137, "1_961570560": 16069,
    "2_053119869": 16819, "2_562915447": 20995, "3_072711026": 25172,
}


def _idct_1d(s0, s1, s2, s3, s4, s5, s6, s7, shift):
    """One islow-style fixed-point IDCT pass over 8 values (numpy int64 on
    the host, torch int32 on the device)."""
    z2, z3 = s2, s6
    z1 = (z2 + z3) * _C["0_541196100"]
    tmp2 = z1 + z3 * (-_C["1_847759065"])
    tmp3 = z1 + z2 * _C["0_765366865"]
    z2, z3 = s0, s4
    tmp0 = (z2 + z3) * (1 << CONST_BITS)
    tmp1 = (z2 - z3) * (1 << CONST_BITS)
    t10, t13 = tmp0 + tmp3, tmp0 - tmp3
    t11, t12 = tmp1 + tmp2, tmp1 - tmp2

    t0, t1, t2, t3 = s7, s5, s3, s1
    z1 = t0 + t3
    z2 = t1 + t2
    z3 = t0 + t2
    z4 = t1 + t3
    z5 = (z3 + z4) * _C["1_175875602"]
    t0 = t0 * _C["0_298631336"]
    t1 = t1 * _C["2_053119869"]
    t2 = t2 * _C["3_072711026"]
    t3 = t3 * _C["1_501321110"]
    z1 = z1 * (-_C["0_899976223"])
    z2 = z2 * (-_C["2_562915447"])
    z3 = z3 * (-_C["1_961570560"]) + z5
    z4 = z4 * (-_C["0_390180644"]) + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4

    rnd = 1 << (shift - 1)
    return ((t10 + t3 + rnd) >> shift, (t11 + t2 + rnd) >> shift,
            (t12 + t1 + rnd) >> shift, (t13 + t0 + rnd) >> shift,
            (t13 - t0 + rnd) >> shift, (t12 - t1 + rnd) >> shift,
            (t11 - t2 + rnd) >> shift, (t10 - t3 + rnd) >> shift)


def idct_2d_host(c: np.ndarray) -> np.ndarray:
    """8x8 integer IDCT of natural-order dequantised coefficients."""
    w = np.stack(_idct_1d(*c, CONST_BITS - PASS1_BITS))
    rows = _idct_1d(*(w[:, j] for j in range(8)),
                    CONST_BITS + PASS1_BITS + 3)
    return np.clip(np.stack(rows, axis=1) + 128, 0, 255)


def idct_2d(c: torch.Tensor) -> torch.Tensor:
    """The same IDCT on int32 blocks [R, 8, 8] (columns pass, rows pass)."""
    w = torch.stack(_idct_1d(*c.unbind(1), CONST_BITS - PASS1_BITS), dim=1)
    rows = _idct_1d(*w.unbind(2), CONST_BITS + PASS1_BITS + 3)
    return torch.clamp(torch.stack(rows, dim=2) + 128, 0, 255)


# -- host oracle --------------------------------------------------------------

def _decode_symbol(rd: BitReader, mincode, maxcode, valptr, vals) -> int:
    code = 0
    for length in range(1, 17):
        code = (code << 1) | rd.get(1)
        if maxcode[length] >= code >= mincode[length]:
            return vals[valptr[length] + code - mincode[length]]
    raise ValueError("bad huffman code")


def _extend(v: int, size: int) -> int:
    if size == 0:
        return 0
    return v - ((1 << size) - 1) if v < (1 << (size - 1)) else v


def golden_reference(words: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray, int]:
    """(pixels [NB,8,8], coefficients [NB,8,8], huffman symbol count)."""
    rd = BitReader(words)
    pred = 0
    coefs = np.zeros((NB, 64), np.int64)
    n_sym = 0
    for b in range(NB):
        size = _decode_symbol(rd, DC_MIN, DC_MAX, DC_PTR, DC_VALS)
        diff = _extend(rd.get(size), size) if size else 0
        pred += diff
        coefs[b, 0] = pred
        n_sym += 1
        k = 1
        while k < 64:
            rs = _decode_symbol(rd, AC_MIN, AC_MAX, AC_PTR, AC_VALS)
            n_sym += 1
            run, size = rs >> 4, rs & 15
            if rs == 0x00:
                break
            if rs == 0xF0:
                k += 16
                continue
            k += run
            coefs[b, k] = _extend(rd.get(size), size)
            k += 1
    pixels = np.zeros((NB, 8, 8), np.int64)
    nat = np.zeros((NB, 8, 8), np.int64)
    for b in range(NB):
        block = np.zeros(64, np.int64)
        block[ZIGZAG] = coefs[b]
        nat[b] = block.reshape(8, 8) * QTAB
        pixels[b] = idct_2d_host(nat[b])
    return pixels, nat, n_sym


# -- region -------------------------------------------------------------------

def _ladder(mn, mx, ptr, vals):
    """The decoder ladder of one table as device tables for lengths
    1..16 (DecodeHuffman, huffman.c)."""
    return dict(mn=mn[1:], mx=mx[1:], ptr=ptr[1:], vals=vals)


_LENGTHS = np.arange(1, 17)
_DC = Consts(**_ladder(DC_MIN, DC_MAX, DC_PTR, DC_VALS + [0] * 4))
_AC = Consts(**_ladder(AC_MIN, AC_MAX, AC_PTR, AC_VALS))


def _decode(peek16: torch.Tensor, table: Consts):
    """The canonical ladder over lengths 1..16 at once: the symbol of the
    first length whose code lies in [mincode, maxcode], and that length
    (17, clipped to 16, when none does)."""
    t = table.on(peek16.device)
    lengths = torch.arange(1, 17, dtype=torch.int32, device=peek16.device)
    code = peek16[:, None] >> (16 - lengths)
    hit = (code <= t.mx) & (code >= t.mn)
    any_hit = hit.any(dim=1)
    first = hit.to(torch.int32).argmax(dim=1)
    rows = torch.arange(code.shape[0], device=code.device)
    idx = torch.clamp(t.ptr[first] + code[rows, first] - t.mn[first], 0,
                      t.vals.shape[0] - 1)
    sym = torch.where(any_hit, lookup(t.vals, idx), 0)
    length = torch.where(any_hit, lengths[first], 17)
    return sym, torch.clamp(length, 1, 16)


def _extend_dev(v, size):
    one = torch.ones_like(size)
    half = torch.where(size == 0, 0, one << torch.clamp(size - 1, 0, 15))
    full = torch.where(size == 0, one, (one << torch.clamp(size, 0, 16)) - 1)
    return torch.where(size == 0, 0, torch.where(v < half, v - full, v))


def make_region() -> Region:
    image_px = make_image()
    blocks_q = np.stack([_quantise(_fdct(image_px[b])) for b in range(NB)])
    words, n_sym = encode(blocks_q)
    g_pixels, _, n_sym2 = golden_reference(words)
    assert n_sym == n_sym2
    n_steps = n_sym + NB                 # symbols + one IDCT step a block
    unzig = np.zeros(64, np.int64)
    unzig[ZIGZAG] = np.arange(64)        # natural pos -> zigzag index
    consts = Consts(qtab_zz=QTAB.reshape(64)[ZIGZAG], zig_of_nat=unzig,
                    golden=g_pixels.reshape(NB, 64))
    image = {
        "stream": words,
        "coef": np.zeros((NB, 64), np.int32),   # zigzag order
        "pixels": np.zeros((NB, 64), np.int32),
        "pos": np.int32(0),
        "blk": np.int32(0),
        "k": np.int32(0),       # next zigzag position (0 = DC next)
        "pred": np.int32(0),
        "i": np.int32(0),
    }

    def init(device):
        return state_from_numpy(image, device)

    def step(state, t):
        c = consts.on(state["i"].device)
        blk_s, pos, k = state["blk"], state["pos"], state["k"]
        blk = torch.clamp(blk_s, 0, NB - 1)
        stream = state["stream"]
        zero = torch.zeros_like(k)

        # Entropy phase (k in [0, 64)).
        is_dc = k == 0
        peek16 = jshow(stream, pos, 16)
        dsym, dlen = _decode(peek16, _DC)
        asym, alen = _decode(peek16, _AC)
        sym = torch.where(is_dc, dsym, asym)
        slen = torch.where(is_dc, dlen, alen)
        size = torch.where(is_dc, sym, sym & 15)
        run = torch.where(is_dc, zero, sym >> 4)
        mag_raw = jshow(stream, pos + slen, 16) >> (
            16 - torch.clamp(size, 1, 16))
        mag = _extend_dev(torch.where(size == 0, zero, mag_raw), size)
        consumed = slen + size

        eob = ~is_dc & (sym == 0x00)
        zrl = ~is_dc & (sym == 0xF0)
        pred_new = torch.where(is_dc, state["pred"] + mag, state["pred"])
        value = torch.where(is_dc, pred_new, mag)
        write_k = torch.clamp(torch.where(is_dc, zero, k + run), 0, 63)
        coef = torch.where((~eob & ~zrl)[:, None, None], update_drop(
            state["coef"], torch.stack([blk, write_k], dim=1), value),
            state["coef"])
        k_next = torch.where(eob, 64, torch.where(zrl, k + 16, write_k + 1))

        # IDCT phase (k == 64): dequant + 2D IDCT, advance the block.
        in_idct = k >= 64
        deq_zz = take_fill(state["coef"], blk) * c.qtab_zz
        nat = deq_zz[:, c.zig_of_nat.to(torch.int64)]
        pix = idct_2d(nat.reshape(-1, 8, 8)).reshape(-1, 64)
        pixels = torch.where(in_idct[:, None, None],
                             update_drop(state["pixels"], blk, pix),
                             state["pixels"])

        new_blk = torch.where(in_idct, blk_s + 1, blk_s)
        new_k = torch.where(in_idct, zero,
                            torch.where(k_next >= 64, 64, k_next))
        new_pos = torch.where(in_idct, pos, pos + consumed)
        finished = blk_s >= NB
        keep = in_idct | finished
        return {
            "coef": torch.where(keep[:, None, None], state["coef"], coef),
            "pixels": pixels,
            "pos": torch.where(finished, pos, new_pos),
            "blk": torch.where(finished, blk_s, new_blk),
            "k": torch.where(finished, k, new_k),
            "pred": torch.where(keep, state["pred"], pred_new),
            "i": state["i"] + 1,
        }

    def done(state):
        return state["blk"] >= NB

    def check(state):
        want = consts.on(state["i"].device).golden
        return (state["pixels"] != want).any(dim=2).sum(dim=1).to(
            torch.int32)

    def output(state):
        return state["pixels"].reshape(state["pixels"].shape[0], -1)

    return Region(
        name="chstone_jpeg",
        init=init,
        step=step,
        done=done,
        check=check,
        output=output,
        nominal_steps=n_steps,
        max_steps=n_steps + 16,
        spec={
            "stream": LeafSpec(KIND_RO, unsigned=True),
            "coef": LeafSpec(KIND_MEM),
            "pixels": LeafSpec(KIND_MEM),
            "pos": LeafSpec(KIND_CTRL),
            "blk": LeafSpec(KIND_CTRL),
            "k": LeafSpec(KIND_CTRL),
            "pred": LeafSpec(KIND_REG),
            "i": LeafSpec(KIND_CTRL),
        },
        default_xmr=True,
        graph=BlockGraph(
            names=["entry", "decode_dc", "decode_ac", "idct", "exit"],
            edges=[(0, 1), (1, 2), (2, 2), (2, 3), (3, 1), (3, 4)],
            block_of=lambda s: pick(
                s["blk"] >= NB, 4,
                pick(s["k"] >= 64, 3, pick(s["k"] == 0, 1, 2)))),
        meta={"oracle": "pure-python baseline JPEG decode, shared int IDCT",
              "dataflow": DATAFLOW},
    )
