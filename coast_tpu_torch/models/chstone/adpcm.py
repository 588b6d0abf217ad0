"""CHStone adpcm: CCITT G.722 split-band ADPCM encode + decode, as a torch
region.

The counterpart of ``coast_tpu/models/chstone/adpcm.py``: 100 samples,
steps 0..49 encode one sample pair each (transmit QMF + two-band ADPCM),
steps 50..99 decode one code word each (two-band ADPCM + receive QMF).
The predictor state (QMF delay lines, zero/pole-section coefficients, log
scale factors) lives in injectable leaves; the scalars of each codec half
are one register-file leaf.  The golden vectors come from the pure-python
C-``long`` oracle below, copied from the reference with its G.722
constants and the ``upzero`` delay-line quirk (slot 2 not shifted).

All step arithmetic is int32 with the reference's wrapping products and
sums; the table reads ``TAB[i]`` follow ``a[i]``'s rule (one negative
wrap, then a clamp: the high-band code ``ih`` of a corrupted code word
indexes past QQ2/WH), the sample and code reads are
``jnp.take(mode="clip")`` and the code and result writes
``.at[].set(mode="drop")``.  Its block graph (``graph``, read
by CFCSS) is the reference's.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from coast_tpu_torch.interop import state_from_numpy
from coast_tpu_torch.ir.graph import BlockGraph, pick
from coast_tpu_torch.ir.region import (KIND_CTRL, KIND_MEM, KIND_REG,
                                       KIND_RO, LeafSpec, Region)
from coast_tpu_torch.models.common import Consts
from coast_tpu_torch.ops.indexing import lookup, take_clip, update_drop
from coast_tpu_torch.ops.u32 import sar, word
from coast_tpu_torch.passes.verification import RegionDataflow

SIZE = 100
N_STEPS = SIZE                      # 50 encode + 50 decode

# QMF coefficients, scaled x4 vs the CCITT table (adpcm.c:92-95).
H = [12, -44, -44, 212, 48, -624, 128, 1448, -840, -3220, 3804, 15504,
     15504, 3804, -3220, -840, 1448, 128, -624, 48, 212, -44, -44, 12]

QQ4 = [0, -20456, -12896, -8968, -6288, -4240, -2584, -1200,
       20456, 12896, 8968, 6288, 4240, 2584, 1200, 0]
QQ6 = [-136, -136, -136, -136, -24808, -21904, -19008, -16704, -14984,
       -13512, -12280, -11192, -10232, -9360, -8576, -7856, -7192, -6576,
       -6000, -5456, -4944, -4464, -4008, -3576, -3168, -2776, -2400,
       -2032, -1688, -1360, -1040, -728, 24808, 21904, 19008, 16704,
       14984, 13512, 12280, 11192, 10232, 9360, 8576, 7856, 7192, 6576,
       6000, 5456, 4944, 4464, 4008, 3576, 3168, 2776, 2400, 2032, 1688,
       1360, 1040, 728, 432, 136, -432, -136]
WL = [-60, 3042, 1198, 538, 334, 172, 58, -30,
      3042, 1198, 538, 334, 172, 58, -30, -60]
ILB = [2048, 2093, 2139, 2186, 2233, 2282, 2332, 2383, 2435, 2489, 2543,
       2599, 2656, 2714, 2774, 2834, 2896, 2960, 3025, 3091, 3158, 3228,
       3298, 3371, 3444, 3520, 3597, 3676, 3756, 3838, 3922, 4008]
DECIS_LEVL = [280, 576, 880, 1200, 1520, 1864, 2208, 2584, 2960, 3376,
              3784, 4240, 4696, 5200, 5712, 6288, 6864, 7520, 8184, 8968,
              9752, 10712, 11664, 12896, 14120, 15840, 17560, 20456,
              23352, 32767]
Q26_POS = [61, 60, 59, 58, 57, 56, 55, 54, 53, 52, 51, 50, 49, 48, 47, 46,
           45, 44, 43, 42, 41, 40, 39, 38, 37, 36, 35, 34, 33, 32, 32]
Q26_NEG = [63, 62, 31, 30, 29, 28, 27, 26, 25, 24, 23, 22, 21, 20, 19, 18,
           17, 16, 15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 4]
QQ2 = [-7408, -1616, 7408, 1616]
WH = [798, -214, 798, -214]

# The encoder's state, and everything the decoder reads besides.
_ENC = frozenset({"enc_bph", "enc_bpl", "enc_dhx", "enc_dltx", "enc_s",
                  "i", "tqmf"})
_DEC = _ENC | {"compressed", "dec_bph", "dec_bpl", "dec_dhx", "dec_dltx",
               "dec_s"}
# Equal to the reference's analyze() (pinned in tests/test_torch_baseline.py).
DATAFLOW = RegionDataflow(
    written=frozenset(_DEC | {"accumc", "accumd", "result"}),
    deps={
        "input": frozenset({"input"}),
        "compressed": frozenset(_ENC | {"compressed"}),
        "result": frozenset(_DEC | {"accumc", "accumd", "result"}),
        "tqmf": frozenset({"i", "input", "tqmf"}),
        "accumc": frozenset(_DEC | {"accumc"}),
        "accumd": frozenset(_DEC | {"accumc", "accumd"}),
        **{name: frozenset(_DEC) for name in (
            "enc_s", "dec_s", "enc_bpl", "enc_dltx", "enc_bph", "enc_dhx",
            "dec_bpl", "dec_dltx", "dec_bph", "dec_dhx")},
        "i": frozenset({"i"}),
    },
    load_addr=frozenset(_DEC - {"dec_bph", "dec_dhx"}),
    store_addr=frozenset(_ENC))


def make_input() -> np.ndarray:
    """Deterministic 100-sample 16 kHz-ish waveform (two mixed tones)."""
    i = np.arange(SIZE)
    x = (1200 * np.sin(2 * np.pi * i / 23)
         + 600 * np.sin(2 * np.pi * i / 7 + 1.0))
    return x.astype(np.int64)


# -- pure-python-int oracle (C `long` semantics) ------------------------------

class _G722:
    """Shared encoder/decoder half-state (one sub-band pair)."""

    def __init__(self):
        self.detl, self.deth = 32, 8
        self.nbl = self.al1 = self.al2 = self.plt1 = self.plt2 = 0
        self.rlt1 = self.rlt2 = 0
        self.nbh = self.ah1 = self.ah2 = self.ph1 = self.ph2 = 0
        self.rh1 = self.rh2 = 0
        self.bpl = [0] * 6
        self.dltx = [0] * 6
        self.bph = [0] * 6
        self.dhx = [0] * 6


def _filtez(bpl: List[int], dlt: List[int]) -> int:
    return sum(b * d for b, d in zip(bpl, dlt)) >> 14


def _filtep(r1: int, a1: int, r2: int, a2: int) -> int:
    return (a1 * 2 * r1 + a2 * 2 * r2) >> 15


def _quantl(el: int, detl: int) -> int:
    wd = abs(el)
    for mil in range(30):
        if wd <= (DECIS_LEVL[mil] * detl) >> 15:
            break
    else:
        mil = 30
    return Q26_POS[mil] if el >= 0 else Q26_NEG[mil]


def _logscl(il: int, nbl: int) -> int:
    nbl = ((nbl * 127) >> 7) + WL[il >> 2]
    return min(max(nbl, 0), 18432)


def _logsch(ih: int, nbh: int) -> int:
    nbh = ((nbh * 127) >> 7) + WH[ih]
    return min(max(nbh, 0), 22528)


def _scalel(nbl: int, shift: int) -> int:
    wd1 = (nbl >> 6) & 31
    wd2 = nbl >> 11
    return (ILB[wd1] >> (shift + 1 - wd2)) << 3


def _upzero(dlt: int, dlti: List[int], bli: List[int]) -> None:
    if dlt == 0:
        for i in range(6):
            bli[i] = (255 * bli[i]) >> 8
    else:
        for i in range(6):
            wd2 = 128 if dlt * dlti[i] >= 0 else -128
            bli[i] = wd2 + ((255 * bli[i]) >> 8)
    # Delay-line quirk: slot 2 is not shifted (adpcm.c:640-645).
    dlti[5] = dlti[4]
    dlti[4] = dlti[3]
    dlti[3] = dlti[2]
    dlti[1] = dlti[0]
    dlti[0] = dlt


def _uppol2(al1: int, al2: int, plt: int, plt1: int, plt2: int) -> int:
    wd2 = 4 * al1
    if plt * plt1 >= 0:
        wd2 = -wd2
    wd2 >>= 7
    wd4 = wd2 + 128 if plt * plt2 >= 0 else wd2 - 128
    apl2 = wd4 + ((127 * al2) >> 7)
    return min(max(apl2, -12288), 12288)


def _uppol1(al1: int, apl2: int, plt: int, plt1: int) -> int:
    wd2 = (al1 * 255) >> 8
    apl1 = wd2 + 192 if plt * plt1 >= 0 else wd2 - 192
    wd3 = 15360 - apl2
    return min(max(apl1, -wd3), wd3)


def _band(st: _G722, low: bool, d: int, sz: int) -> int:
    """The post-quantizer update of one sub-band: zero section, pole
    section, delay; returns the reconstructed predictor input."""
    p = d + sz
    if low:
        _upzero(d, st.dltx, st.bpl)
        st.al2 = _uppol2(st.al1, st.al2, p, st.plt1, st.plt2)
        st.al1 = _uppol1(st.al1, st.al2, p, st.plt1)
        st.plt2, st.plt1 = st.plt1, p
    else:
        _upzero(d, st.dhx, st.bph)
        st.ah2 = _uppol2(st.ah1, st.ah2, p, st.ph1, st.ph2)
        st.ah1 = _uppol1(st.ah1, st.ah2, p, st.ph1)
        st.ph2, st.ph1 = st.ph1, p
    return p


def golden_reference(data: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Encode + decode host-side: (compressed[50], result[100])."""
    enc, dec = _G722(), _G722()
    tqmf = [0] * 24
    accumc = [0] * 11
    accumd = [0] * 11
    compressed, result = [], []

    for i in range(0, SIZE, 2):
        xin1, xin2 = int(data[i]), int(data[i + 1])
        # Transmit QMF (adpcm.c:236-260).
        xa = sum(tqmf[2 * j] * H[2 * j] for j in range(12))
        xb = sum(tqmf[2 * j + 1] * H[2 * j + 1] for j in range(12))
        tqmf[2:] = tqmf[:-2]
        tqmf[0], tqmf[1] = xin2, xin1
        xl = (xa + xb) >> 15
        xh = (xa - xb) >> 15

        szl = _filtez(enc.bpl, enc.dltx)
        sl = szl + _filtep(enc.rlt1, enc.al1, enc.rlt2, enc.al2)
        il = _quantl(xl - sl, enc.detl)
        dlt = (enc.detl * QQ4[il >> 2]) >> 15
        enc.nbl = _logscl(il, enc.nbl)
        enc.detl = _scalel(enc.nbl, 8)
        _band(enc, True, dlt, szl)
        enc.rlt2, enc.rlt1 = enc.rlt1, sl + dlt

        szh = _filtez(enc.bph, enc.dhx)
        sh = _filtep(enc.rh1, enc.ah1, enc.rh2, enc.ah2) + szh
        eh = xh - sh
        ih = 3 if eh >= 0 else 1
        if abs(eh) > (564 * enc.deth) >> 12:
            ih -= 1
        dh = (enc.deth * QQ2[ih]) >> 15
        enc.nbh = _logsch(ih, enc.nbh)
        enc.deth = _scalel(enc.nbh, 10)
        _band(enc, False, dh, szh)
        enc.rh2, enc.rh1 = enc.rh1, sh + dh

        compressed.append(il | (ih << 6))

    for i in range(0, SIZE, 2):
        inp = compressed[i // 2]
        ilr = inp & 0x3F
        ih = inp >> 6
        szl = _filtez(dec.bpl, dec.dltx)
        sl = _filtep(dec.rlt1, dec.al1, dec.rlt2, dec.al2) + szl
        dlt = (dec.detl * QQ4[ilr >> 2]) >> 15
        rl = ((dec.detl * QQ6[ilr]) >> 15) + sl
        dec.nbl = _logscl(ilr, dec.nbl)
        dec.detl = _scalel(dec.nbl, 8)
        _band(dec, True, dlt, szl)
        dec.rlt2, dec.rlt1 = dec.rlt1, sl + dlt

        szh = _filtez(dec.bph, dec.dhx)
        sh = _filtep(dec.rh1, dec.ah1, dec.rh2, dec.ah2) + szh
        dh = (dec.deth * QQ2[ih]) >> 15
        dec.nbh = _logsch(ih, dec.nbh)
        dec.deth = _scalel(dec.nbh, 10)
        _band(dec, False, dh, szh)
        rh = sh + dh
        dec.rh2, dec.rh1 = dec.rh1, rh

        # Receive QMF (adpcm.c:481-511).
        xd, xs = rl - rh, rl + rh
        xa1 = xd * H[0] + sum(accumc[j] * H[2 * j + 2] for j in range(11))
        xa2 = xs * H[1] + sum(accumd[j] * H[2 * j + 3] for j in range(11))
        result.append(xa1 >> 14)
        result.append(xa2 >> 14)
        accumc[1:] = accumc[:-1]
        accumd[1:] = accumd[:-1]
        accumc[0], accumd[0] = xd, xs

    return np.array(compressed, np.int64), np.array(result, np.int64)


# -- the torch step (int32) ---------------------------------------------------

# Scalar predictor state packed into one register-file leaf a codec half.
_SCALARS = ("detl", "deth", "nbl", "nbh", "al1", "al2", "plt1", "plt2",
            "rlt1", "rlt2", "ah1", "ah2", "ph1", "ph2", "rh1", "rh2")
_SIDX = {n: i for i, n in enumerate(_SCALARS)}

_T = Consts(H=H, QQ4=QQ4, QQ6=QQ6, WL=WL, ILB=ILB, DECIS=DECIS_LEVL,
            POS=Q26_POS, NEG=Q26_NEG, QQ2=QQ2, WH=WH)


def _tables(like: torch.Tensor):
    return _T.on(like.device)


def _sum(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sum`` of int32 over the last axis: wraps like int32."""
    return word(x.sum(dim=-1))


def _clip(x, lo, hi):
    """``jnp.clip``: maximum with ``lo``, then minimum with ``hi``."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _dfiltez(bpl, dltx):
    return _sum(bpl * dltx) >> 14


def _dfiltep(r1, a1, r2, a2):
    return (a1 * (2 * r1) + a2 * (2 * r2)) >> 15


def _dquantl(el, detl):
    c = _tables(el)
    decis = (c.DECIS * detl[:, None]) >> 15
    hit = el.abs()[:, None] <= decis
    mil = torch.where(hit.any(dim=1), hit.to(torch.int32).argmax(dim=1),
                      30)
    return torch.where(el >= 0, lookup(c.POS, mil), lookup(c.NEG, mil))


def _dlogscl(il, nbl):
    nbl = ((nbl * 127) >> 7) + lookup(_tables(il).WL, il >> 2)
    return torch.clamp(nbl, 0, 18432)


def _dlogsch(ih, nbh):
    nbh = ((nbh * 127) >> 7) + lookup(_tables(ih).WH, ih)
    return torch.clamp(nbh, 0, 22528)


def _dscalel(nbl, shift: int):
    wd1 = (nbl >> 6) & 31
    wd2 = nbl >> 11
    return sar(lookup(_tables(nbl).ILB, wd1), shift + 1 - wd2) << 3


def _dupzero(dlt, dlti, bli):
    leak = (255 * bli) >> 8
    wd2 = torch.where(dlt[:, None] * dlti >= 0, 128, -128).to(torch.int32)
    bli_new = torch.where((dlt == 0)[:, None], leak, wd2 + leak)
    dlti_new = torch.stack([dlt, dlti[:, 0], dlti[:, 2], dlti[:, 2],
                            dlti[:, 3], dlti[:, 4]], dim=1)
    return dlti_new, bli_new


def _duppol2(al1, al2, plt, plt1, plt2):
    wd2 = torch.where(plt * plt1 >= 0, -(4 * al1), 4 * al1) >> 7
    wd4 = torch.where(plt * plt2 >= 0, wd2 + 128, wd2 - 128)
    return torch.clamp(wd4 + ((127 * al2) >> 7), -12288, 12288)


def _duppol1(al1, apl2, plt, plt1):
    wd2 = (al1 * 255) >> 8
    apl1 = torch.where(plt * plt1 >= 0, wd2 + 192, wd2 - 192)
    wd3 = 15360 - apl2
    return _clip(apl1, -wd3, wd3)


def _pole_update(s, low: bool, p):
    """New (a1, a2) of one sub-band's pole section."""
    a1, a2, p1, p2 = (s[:, _SIDX[n]] for n in (
        ("al1", "al2", "plt1", "plt2") if low else
        ("ah1", "ah2", "ph1", "ph2")))
    new_a2 = _duppol2(a1, a2, p, p1, p2)
    return _duppol1(a1, new_a2, p, p1), new_a2


def _half(st, pre: str, s, xl, xh, il, ih):
    """The two sub-band updates of one codec half (``pre`` "enc_" or
    "dec_"): the new predictor leaves and the reconstructed signals
    (rlt, rh) -- shared by the encoder, which quantizes first, and the
    decoder, which reads its codes."""
    c = _tables(s)
    detl, deth = s[:, _SIDX["detl"]], s[:, _SIDX["deth"]]
    szl = _dfiltez(st[pre + "bpl"], st[pre + "dltx"])
    sl = _dfiltep(s[:, _SIDX["rlt1"]], s[:, _SIDX["al1"]],
                 s[:, _SIDX["rlt2"]], s[:, _SIDX["al2"]]) + szl
    if il is None:
        il = _dquantl(xl - sl, detl)
    dlt = (detl * lookup(c.QQ4, il >> 2)) >> 15
    nbl = _dlogscl(il, s[:, _SIDX["nbl"]])
    plt = dlt + szl
    dltx, bpl = _dupzero(dlt, st[pre + "dltx"], st[pre + "bpl"])
    al1, al2 = _pole_update(s, True, plt)

    szh = _dfiltez(st[pre + "bph"], st[pre + "dhx"])
    sh = _dfiltep(s[:, _SIDX["rh1"]], s[:, _SIDX["ah1"]],
                 s[:, _SIDX["rh2"]], s[:, _SIDX["ah2"]]) + szh
    if ih is None:
        eh = xh - sh
        ih = torch.where(eh >= 0, 3, 1).to(torch.int32)
        ih = torch.where(eh.abs() > (564 * deth) >> 12, ih - 1, ih)
    dh = (deth * lookup(c.QQ2, ih)) >> 15
    nbh = _dlogsch(ih, s[:, _SIDX["nbh"]])
    ph = dh + szh
    dhx, bph = _dupzero(dh, st[pre + "dhx"], st[pre + "bph"])
    ah1, ah2 = _pole_update(s, False, ph)
    rh = sh + dh

    vals = {"detl": _dscalel(nbl, 8), "deth": _dscalel(nbh, 10), "nbl": nbl,
            "nbh": nbh, "al1": al1, "al2": al2, "plt1": plt,
            "plt2": s[:, _SIDX["plt1"]], "rlt1": sl + dlt,
            "rlt2": s[:, _SIDX["rlt1"]], "ah1": ah1, "ah2": ah2,
            "ph1": ph, "ph2": s[:, _SIDX["ph1"]], "rh1": rh,
            "rh2": s[:, _SIDX["rh1"]]}
    # The reference writes the new scalars one partial update after the
    # other, in this order, into the old vector.
    new_s = s
    for name in _SCALARS:
        new_s = torch.select_scatter(new_s, vals[name], 1, _SIDX[name])
    leaves = {pre + "s": new_s,
              pre + "bpl": bpl, pre + "dltx": dltx, pre + "bph": bph,
              pre + "dhx": dhx}
    return leaves, il, ih, sl, rh, detl


def _encode_step(st, k):
    """k in [0, 50): encode the pair (input[2k], input[2k+1])."""
    c = _tables(k)
    xin1, xin2 = take_clip(st["input"], torch.stack(
        [2 * k, 2 * k + 1], dim=1)).unbind(1)
    tq = st["tqmf"]
    xa = _sum(tq[:, 0::2] * c.H[0::2])
    xb = _sum(tq[:, 1::2] * c.H[1::2])
    tq = torch.cat([torch.stack([xin2, xin1], dim=1), tq[:, :-2]], dim=1)
    xl, xh = (xa + xb) >> 15, (xa - xb) >> 15
    leaves, il, ih, _, _, _ = _half(st, "enc_", st["enc_s"], xl, xh,
                                    None, None)
    return {**leaves, "tqmf": tq,
            "compressed": update_drop(st["compressed"], k, il | (ih << 6))}


def _decode_step(st, k):
    """k in [0, 50): decode compressed[k] -> result[2k], result[2k+1]."""
    c = _tables(k)
    inp = take_clip(st["compressed"], k)
    ilr, ih = inp & 0x3F, inp >> 6
    s = st["dec_s"]
    leaves, _, _, sl, rh, detl = _half(st, "dec_", s, None, None, ilr, ih)
    rl = ((detl * lookup(c.QQ6, ilr)) >> 15) + sl
    xd, xs = rl - rh, rl + rh
    xa1 = xd * c.H[0] + _sum(st["accumc"] * c.H[2::2])
    xa2 = xs * c.H[1] + _sum(st["accumd"] * c.H[3::2])
    result = update_drop(st["result"], 2 * k, xa1 >> 14)
    result = update_drop(result, 2 * k + 1, xa2 >> 14)
    return {**leaves, "result": result,
            "accumc": torch.cat([xd[:, None], st["accumc"][:, :-1]], dim=1),
            "accumd": torch.cat([xs[:, None], st["accumd"][:, :-1]], dim=1)}


def make_region() -> Region:
    data = make_input()
    g_comp, g_res = golden_reference(data)
    s0 = np.zeros(len(_SCALARS), np.int32)
    s0[_SIDX["detl"]] = 32
    s0[_SIDX["deth"]] = 8
    zeros6 = np.zeros(6, np.int32)
    image = {
        "input": data.astype(np.int32),
        "compressed": np.zeros(SIZE // 2, np.int32),
        "result": np.zeros(SIZE, np.int32),
        "tqmf": np.zeros(24, np.int32),
        "accumc": np.zeros(11, np.int32),
        "accumd": np.zeros(11, np.int32),
        "enc_s": s0,
        "dec_s": s0,
        **{name: zeros6 for name in (
            "enc_bpl", "enc_dltx", "enc_bph", "enc_dhx",
            "dec_bpl", "dec_dltx", "dec_bph", "dec_dhx")},
        "i": np.int32(0),
    }
    goldens = Consts(comp=g_comp.astype(np.int32), res=g_res.astype(np.int32))

    def init(device):
        return state_from_numpy(image, device)

    def step(state, t):
        i = state["i"]
        half = SIZE // 2
        enc = _encode_step(state, torch.clamp(i, 0, half - 1))
        dec = _decode_step(state, torch.clamp(i - half, 0, half - 1))
        is_enc = i < half
        merged = {}
        for name in state:
            if name in ("input", "i"):
                continue
            e, d = enc.get(name, state[name]), dec.get(name, state[name])
            merged[name] = torch.where(
                is_enc.view(-1, *([1] * (e.dim() - 1))), e, d)
        merged["i"] = i + 1
        return merged

    def done(state):
        return state["i"] >= N_STEPS

    def check(state):
        g = goldens.on(state["i"].device)
        bad = ((state["compressed"] != g.comp).sum(dim=1)
               + (state["result"] != g.res).sum(dim=1))
        return bad.to(torch.int32)

    def output(state):
        return torch.cat([state["compressed"], state["result"]], dim=1)

    spec = {
        "input": LeafSpec(KIND_RO),
        "compressed": LeafSpec(KIND_MEM),
        "result": LeafSpec(KIND_MEM),
        "tqmf": LeafSpec(KIND_MEM),
        "accumc": LeafSpec(KIND_MEM),
        "accumd": LeafSpec(KIND_MEM),
        "enc_s": LeafSpec(KIND_REG),
        "dec_s": LeafSpec(KIND_REG),
        **{name: LeafSpec(KIND_MEM) for name in (
            "enc_bpl", "enc_dltx", "enc_bph", "enc_dhx",
            "dec_bpl", "dec_dltx", "dec_bph", "dec_dhx")},
        "i": LeafSpec(KIND_CTRL),
    }

    return Region(
        name="chstone_adpcm",
        init=init,
        step=step,
        done=done,
        check=check,
        output=output,
        nominal_steps=N_STEPS,
        max_steps=N_STEPS + 8,
        spec=spec,
        default_xmr=True,
        graph=BlockGraph(
            names=["entry", "encode", "decode", "exit"],
            edges=[(0, 1), (1, 1), (1, 2), (2, 2), (2, 3)],
            block_of=lambda s: pick(s["i"] >= N_STEPS, 3,
                                    pick(s["i"] >= SIZE // 2, 2, 1))),
        meta={"oracle": "pure-python C-long G.722 reference",
              "golden_compressed_head": g_comp[:4].tolist(),
              "dataflow": DATAFLOW},
    )
