"""CHStone motion: MPEG-2 motion-vector decoding, as a torch region.

The counterpart of ``coast_tpu/models/chstone/motion.py``: a 32-call
decode chain of ``motion_vectors()``, one step a component (horizontal
or vertical), 64 steps.  Each step pulls a Table B-10 VLC and its
residual from the bit buffer and updates the predictor (with the mvscale
halving on odd calls).  The injectable surface is the bit buffer, the
bit cursor and the predictors: a flipped cursor bit desynchronises the
VLC like a corrupted ``ld->Bfr``.

The bitstream is encoded at build time by inverting the decoder; the
golden comes from the pure-python decoder (both copied from the
reference).  The table reads are ``tab[i, 0]`` (one negative wrap, then
a clamp), the predictor read ``jnp.take(mode="clip")`` and the writes
``.at[].set(mode="drop")``.  Its block graph (``graph``, read
by CFCSS) is the reference's.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from coast_tpu_torch.interop import state_from_numpy
from coast_tpu_torch.ir.graph import loop_graph
from coast_tpu_torch.ir.region import (KIND_CTRL, KIND_MEM, KIND_RO,
                                       LeafSpec, Region)
from coast_tpu_torch.models.chstone._bits import BitReader, BitWriter, jshow
from coast_tpu_torch.models.common import Consts
from coast_tpu_torch.ops.indexing import lookup, take_clip, update_drop
from coast_tpu_torch.passes.verification import RegionDataflow

NV = 32                     # motion_vector() calls
N_STEPS = 2 * NV            # one component a step
R_SIZE = 8                  # h_r_size = v_r_size = 200 % 32 (motion.c:151)

# Table B-10 (getvlc.h:62-81).
MVTAB0 = [(99, 0), (3, 3), (2, 2), (2, 2), (1, 1), (1, 1), (1, 1), (1, 1)]
MVTAB1 = [(99, 0), (99, 0), (99, 0), (7, 6), (6, 6), (5, 6), (4, 5), (4, 5)]
MVTAB2 = [(16, 9), (15, 9), (14, 9), (13, 9), (12, 9), (11, 9),
          (10, 8), (10, 8), (9, 8), (9, 8), (8, 8), (8, 8)]

# Equal to the reference's analyze() (pinned in tests/test_torch_baseline.py).
DATAFLOW = RegionDataflow(
    written=frozenset({"hist", "i", "pmv", "pos"}),
    deps={
        "stream": frozenset({"stream"}),
        "pmv": frozenset({"i", "pmv", "pos", "stream"}),
        "hist": frozenset({"hist", "i", "pmv", "pos", "stream"}),
        "pos": frozenset({"pos", "stream"}),
        "i": frozenset({"i"}),
    },
    load_addr=frozenset({"i", "pos", "stream"}),
    store_addr=frozenset({"i", "pos", "stream"}))


def _decode_motion_code(rd: BitReader) -> int:
    """Literal Get_motion_code (getvlc.c:78-103)."""
    if rd.get(1):
        return 0
    code = rd.show(9)
    if code >= 64:
        code >>= 6
        rd.pos += MVTAB0[code][1]
        return -MVTAB0[code][0] if rd.get(1) else MVTAB0[code][0]
    if code >= 24:
        code >>= 3
        rd.pos += MVTAB1[code][1]
        return -MVTAB1[code][0] if rd.get(1) else MVTAB1[code][0]
    code -= 12
    if code < 0:
        return 0
    rd.pos += MVTAB2[code][1]
    return -MVTAB2[code][0] if rd.get(1) else MVTAB2[code][0]


def _vlc_for(mc: int) -> Tuple[int, int]:
    """Invert the decoder: (bits, length) whose Get_motion_code == mc > 0
    (prefix only, without the leading 0 and the sign bit)."""
    for length in range(1, 10):
        for value in range(1 << length):
            probe = [(value >> k) & 1 for k in range(length - 1, -1, -1)]
            rd = BitReader(probe + [0] * 12)
            code = rd.show(9)
            if code >= 64:
                tab = MVTAB0[code >> 6]
            elif code >= 24:
                tab = MVTAB1[code >> 3]
            elif code - 12 >= 0:
                tab = MVTAB2[code - 12]
            else:
                continue
            if tab[0] == mc and tab[1] == length:
                return value, length
    raise AssertionError(f"no VLC for motion code {mc}")


def make_stream(seed: int = 5) -> Tuple[np.ndarray, List[Tuple[int, int]]]:
    """Encode 2*NV components; returns (stream words, [(code, residual)])."""
    rng = np.random.RandomState(seed)
    wr = BitWriter(pad_bit=0)
    plan = []
    for _ in range(2 * NV):
        mc = int(rng.randint(-16, 17))
        residual = int(rng.randint(0, 1 << R_SIZE)) if mc != 0 else 0
        plan.append((mc, residual))
        if mc == 0:
            wr.put(1, 1)
        else:
            wr.put(0, 1)
            bits, length = _vlc_for(abs(mc))
            wr.put(bits, length)
            wr.put(1 if mc < 0 else 0, 1)
            wr.put(residual, R_SIZE)
    return wr.words(), plan


def _decode_mv(pred: int, r_size: int, mc: int, residual: int) -> int:
    """decode_motion_vector (mpeg2.c:146-166), full_pel_vector = 0."""
    lim = 16 << r_size
    vec = pred
    if mc > 0:
        vec += ((mc - 1) << r_size) + residual + 1
        if vec >= lim:
            vec -= lim + lim
    elif mc < 0:
        vec -= ((-mc - 1) << r_size) + residual + 1
        if vec < -lim:
            vec += lim + lim
    return vec


def golden_reference(words: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Decode the stream host-side: (history [NV, 2], final PMV [2])."""
    rd = BitReader(words)
    pmv = [0, 0]
    hist = []
    for call in range(NV):
        mvscale = call % 2                  # alternate frame/field calls
        mc = _decode_motion_code(rd)
        residual = rd.get(R_SIZE) if mc != 0 else 0
        pmv[0] = _decode_mv(pmv[0], R_SIZE, mc, residual)
        mc = _decode_motion_code(rd)
        residual = rd.get(R_SIZE) if mc != 0 else 0
        if mvscale:
            pmv[1] >>= 1
        pmv[1] = _decode_mv(pmv[1], R_SIZE, mc, residual)
        if mvscale:
            pmv[1] <<= 1
        hist.append((pmv[0], pmv[1]))
    return np.array(hist, np.int64), np.array(pmv, np.int64)


# -- device decoder -----------------------------------------------------------

def make_region() -> Region:
    words, _plan = make_stream()
    g_hist, g_pmv = golden_reference(words)
    image = {
        "stream": words,
        "pmv": np.zeros(2, np.int32),
        "hist": np.zeros((NV, 2), np.int32),
        "pos": np.int32(0),
        "i": np.int32(0),
    }
    tabs = Consts(tab0=np.asarray(MVTAB0, np.int32),
                  tab1=np.asarray(MVTAB1, np.int32),
                  tab2=np.asarray(MVTAB2, np.int32),
                  g_hist=g_hist.astype(np.int32),
                  g_pmv=g_pmv.astype(np.int32))

    def init(device):
        return state_from_numpy(image, device)

    def step(state, t):
        i, pos, stream = state["i"], state["pos"], state["stream"]
        c = tabs.on(i.device)
        zero = torch.zeros_like(i)
        call = i >> 1
        vertical = (i & 1) == 1
        mvscale = (call % 2) == 1

        b0 = jshow(stream, pos, 1)
        code9 = jshow(stream, pos + 1, 9)

        # Table dispatch (Get_motion_code, getvlc.c:78-103).
        idx0, idx1 = code9 >> 6, code9 >> 3
        idx2 = torch.clamp(code9 - 12, 0, 11)
        in0 = code9 >= 64
        in1 = ~in0 & (code9 >= 24)
        in2 = (code9 < 24) & (code9 - 12 >= 0)

        def pick(col):
            return torch.where(in0, lookup(c.tab0[:, col], idx0), torch.where(
                in1, lookup(c.tab1[:, col], idx1), torch.where(
                    in2, lookup(c.tab2[:, col], idx2), zero)))

        mag, vlen = pick(0), pick(1)
        sign = jshow(stream, pos + 1 + vlen, 1)
        mc_nz = torch.where(sign == 1, -mag, mag)
        zero_short = b0 == 1                 # leading 1 -> code 0
        zero_tab = (b0 == 0) & ~in0 & ~in1 & ~in2
        mc = torch.where(zero_short | zero_tab, zero, mc_nz)
        consumed = torch.where(zero_short | zero_tab, 1, 2 + vlen)
        residual = torch.where(mc != 0, jshow(stream, pos + consumed, R_SIZE),
                               zero)
        consumed = consumed + (mc != 0).to(torch.int32) * R_SIZE

        # decode_motion_vector (mpeg2.c:146-166).
        comp = vertical.to(torch.int32)
        scaled = vertical & mvscale
        pred = take_clip(state["pmv"], comp)
        pred = torch.where(scaled, pred >> 1, pred)
        lim = 16 << R_SIZE
        mag_m1 = torch.where(mc > 0, mc - 1, -mc - 1)
        delta = (mag_m1 << R_SIZE) + residual + 1
        vec_pos = pred + delta
        vec_pos = torch.where(vec_pos >= lim, vec_pos - 2 * lim, vec_pos)
        vec_neg = pred - delta
        vec_neg = torch.where(vec_neg < -lim, vec_neg + 2 * lim, vec_neg)
        vec = torch.where(mc > 0, vec_pos, torch.where(mc < 0, vec_neg, pred))
        vec = torch.where(scaled, vec << 1, vec)

        pmv = update_drop(state["pmv"], comp, vec)
        hist = torch.where(vertical[:, None, None], update_drop(
            state["hist"], torch.clamp(call, 0, NV - 1),
            torch.stack([pmv[:, 0], vec], dim=1)), state["hist"])
        return {"pmv": pmv, "hist": hist, "pos": pos + consumed,
                "i": i + 1}

    def done(state):
        return state["i"] >= N_STEPS

    def check(state):
        c = tabs.on(state["i"].device)
        bad = (state["hist"] != c.g_hist).any(dim=2).sum(dim=1)
        bad = bad + (state["pmv"] != c.g_pmv).sum(dim=1)
        return bad.to(torch.int32)

    def output(state):
        return torch.cat([state["hist"].reshape(state["hist"].shape[0], -1),
                          state["pmv"]], dim=1)

    return Region(
        name="chstone_motion",
        init=init,
        step=step,
        done=done,
        check=check,
        output=output,
        nominal_steps=N_STEPS,
        max_steps=N_STEPS + 8,
        spec={
            "stream": LeafSpec(KIND_RO, unsigned=True),
            "pmv": LeafSpec(KIND_MEM),
            "hist": LeafSpec(KIND_MEM),
            "pos": LeafSpec(KIND_CTRL),
            "i": LeafSpec(KIND_CTRL),
        },
        default_xmr=True,
        graph=loop_graph("motion_vector", "i", N_STEPS),
        meta={"oracle": "pure-python Table B-10 VLC decoder",
              "dataflow": DATAFLOW},
    )
