"""CHStone gsm: GSM 06.10 LPC analysis, as a torch region.

The counterpart of ``coast_tpu/models/chstone/gsm.py``: autocorrelation
with dynamic scaling, Schur recursion to 8 reflection coefficients, the
log-area-ratio transform and quantization over one 160-sample frame,
checked against the pure-python oracle (copied from the reference) on the
scaled samples and the 8 LARc codes.  One stepped machine, ctrl leaf
``i``:

  * steps 0..159    : running max |s[k]| (Autocorrelation's scaling search)
  * step  160       : scalauto = 4 - gsm_norm(smax << 16); latch
  * steps 161..320  : conditional GSM_MULT_R down-scaling of s[k]
  * steps 321..480  : L_ACF[0..8] multiply-accumulate for sample k
  * step  481       : L_ACF <<= 1 and s re-scaling (vector step)
  * steps 482..489  : one Schur recursion stage n each (gsm_div inside)
  * step  490       : LAR transform + quantization (vector step)

The GSM fixed-point word set (saturating add, rounded multiply, 15-step
restoring division, bit normalisation) runs on int32 leaves with the
reference's wrapping products; ``gsm_norm`` counts leading zeros with a
popcount (``ops/u32.py``, the counterpart of ``lax.population_count``).
The sample reads are ``jnp.take(mode="clip")`` (the lag window's negative
indices read s[0]) and the writes ``.at[].set(mode="drop")``.  Its
block graph (``graph``, read by CFCSS) is the reference's.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from coast_tpu_torch.interop import state_from_numpy
from coast_tpu_torch.ir.graph import BlockGraph, pick
from coast_tpu_torch.ir.region import (KIND_CTRL, KIND_MEM, KIND_REG,
                                       KIND_RO, LeafSpec, Region)
from coast_tpu_torch.models.common import Consts
from coast_tpu_torch.ops.indexing import take_clip, update_drop
from coast_tpu_torch.ops.u32 import clz
from coast_tpu_torch.passes.verification import RegionDataflow

N = 160
M = 8
STEP_SMAX0 = 0
STEP_SCAL = N                    # 160
STEP_SCALE0 = N + 1              # 161
STEP_ACF0 = 2 * N + 1            # 321
STEP_SHIFT = 3 * N + 1           # 481
STEP_SCHUR0 = 3 * N + 2          # 482
STEP_LAR = STEP_SCHUR0 + M       # 490
N_STEPS = STEP_LAR + 1           # 491

MAXW, MINW = 32767, -32768

# Equal to the reference's analyze() (pinned in tests/test_torch_baseline.py).
DATAFLOW = RegionDataflow(
    written=frozenset({"i", "k", "l_acf", "larc", "p", "r", "s", "scal"}),
    deps={
        "input": frozenset({"input"}),
        "s": frozenset({"i", "s", "scal"}),
        "l_acf": frozenset({"i", "k", "l_acf", "p", "s", "scal"}),
        "p": frozenset({"i", "k", "l_acf", "p", "s", "scal"}),
        "k": frozenset({"i", "k", "l_acf", "p", "s", "scal"}),
        "r": frozenset({"i", "l_acf", "p", "r", "s", "scal"}),
        "larc": frozenset({"i", "k", "l_acf", "larc", "p", "r", "s",
                           "scal"}),
        "scal": frozenset({"i", "l_acf", "p", "s", "scal"}),
        "i": frozenset({"i"}),
    },
    load_addr=frozenset({"i", "scal"}),
    store_addr=frozenset({"i", "scal"}))


def make_input() -> np.ndarray:
    """One deterministic 160-sample voiced-ish frame (int16 range)."""
    i = np.arange(N)
    x = (9000 * np.sin(2 * np.pi * i / 29)
         + 4000 * np.sin(2 * np.pi * i / 5 + 0.7)
         + 2000 * np.cos(2 * np.pi * i / 53))
    return np.clip(x, MINW, MAXW).astype(np.int64)


# -- pure-python GSM fixed-point oracle (add.c semantics) --------------------

def _sat(x: int) -> int:
    return MINW if x < MINW else (MAXW if x > MAXW else x)


def _mult_r(a: int, b: int) -> int:
    if a == MINW and b == MINW:
        return MAXW
    prod = ((a * b + 16384) >> 15) & 0xFFFF
    return prod - 0x10000 if prod & 0x8000 else prod


def _mult(a: int, b: int) -> int:
    if a == MINW and b == MINW:
        return MAXW
    return (a * b) >> 15


def _abs_w(a: int) -> int:
    return MAXW if a == MINW else abs(a)


def _norm(a: int) -> int:
    """Left shifts to normalise a 32-bit value (add.c:76-106)."""
    if a < 0:
        if a <= -1073741824:
            return 0
        a = ~a & 0xFFFFFFFF
    n = 0
    while not (a & 0x40000000):
        a = (a << 1) & 0xFFFFFFFF
        n += 1
    return n


def _div(num: int, denum: int) -> int:
    if num == 0:
        return 0
    div = 0
    l_num, l_denum = num, denum
    for _ in range(15):
        div <<= 1
        l_num <<= 1
        if l_num >= l_denum:
            l_num -= l_denum
            div += 1
    return div


_QTAB = [(20480, 0, 31, -32), (20480, 0, 31, -32),
         (20480, 2048, 15, -16), (20480, -2560, 15, -16),
         (13964, 94, 7, -8), (15360, -1792, 7, -8),
         (8534, -341, 3, -4), (9036, -1144, 3, -4)]


def golden_reference(data: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(scaled samples s[160], LARc[8]) for one frame."""
    s = [int(v) for v in data]
    smax = 0
    for v in s:
        smax = max(smax, _abs_w(v))
    scalauto = 0 if smax == 0 else 4 - _norm(smax << 16)
    if 0 < scalauto <= 4:
        f = 16384 >> (scalauto - 1)
        s = [_mult_r(v, f) for v in s]

    l_acf = [0] * 9
    for k in range(N):
        for j in range(min(k, 8) + 1):
            l_acf[j] += s[k] * s[k - j]
    l_acf = [v << 1 for v in l_acf]

    if scalauto > 0:
        s = [v << scalauto for v in s]

    r = [0] * M
    if l_acf[0] != 0:
        t = _norm(l_acf[0])
        # SASR(L_ACF[i] << t, 16) with 32-bit longword semantics.
        acf = []
        for v in l_acf:
            shifted = (v << t) & 0xFFFFFFFF
            if shifted & 0x80000000:
                shifted -= 0x100000000
            acf.append(shifted >> 16)
        k_arr = acf[1:8] + [0]
        p = list(acf)
        n = 1
        while n <= 8:
            if p[0] < _abs_w(p[1]):
                break
            rv = _div(_abs_w(p[1]), p[0])
            if p[1] > 0:
                rv = -rv
            r[n - 1] = rv
            if n == 8:
                break
            p[0] = _sat(p[0] + _mult_r(p[1], rv))
            for m in range(1, 8 - n + 1):
                p[m] = _sat(p[m + 1] + _mult_r(k_arr[m - 1], rv))
                k_arr[m - 1] = _sat(k_arr[m - 1] + _mult_r(p[m + 1], rv))
            n += 1

    # Transformation to log-area ratios, then quantization.
    larc = []
    for rv, (a, b, mac, mic) in zip(r, _QTAB):
        t = _abs_w(rv)
        if t < 22118:
            t >>= 1
        elif t < 31130:
            t -= 11059
        else:
            t = (t - 26112) << 2
        t = _mult(a, -t if rv < 0 else t)
        t = _sat(_sat(t + b) + 256) >> 9
        larc.append(mac - mic if t > mac else (0 if t < mic else t - mic))
    return np.array(s, np.int64), np.array(larc, np.int64)


# -- torch fixed-point helpers ------------------------------------------------

def _dsat(x):
    return torch.clamp(x, MINW, MAXW)


def _dword(x):
    """The low 16 bits as a signed word."""
    return ((x & 0xFFFF) ^ 0x8000) - 0x8000


def _dmult_r(a, b):
    both_min = (a == MINW) & (b == MINW)
    return torch.where(both_min, MAXW, _dword((a * b + 16384) >> 15))


def _dmult(a, b):
    both_min = (a == MINW) & (b == MINW)
    return torch.where(both_min, MAXW, (a * b) >> 15)


def _dabs(a):
    return torch.where(a == MINW, MAXW, a.abs())


def _dnorm32(a):
    """gsm_norm on an int32 longword: clz(a or ~a) - 1, 0 at or below
    -2^30."""
    n = clz(torch.where(a < 0, ~a, a)) - 1
    return torch.where(a <= -1073741824, 0, n)


def _ddiv(num, denum):
    """15-step restoring division (add.c:109-140), unrolled."""
    div = torch.zeros_like(num)
    l_num = num
    for _ in range(15):
        div = div << 1
        l_num = l_num << 1
        ge = l_num >= denum
        l_num = torch.where(ge, l_num - denum, l_num)
        div = torch.where(ge, div + 1, div)
    return torch.where(num == 0, 0, div)


def _set_col(x, col: int, v):
    """``x.at[:, col].set(v)`` a row."""
    return torch.cat([x[:, :col], v[:, None], x[:, col + 1:]], dim=1)


_Q = Consts(a=[q[0] for q in _QTAB], b=[q[1] for q in _QTAB],
            mac=[q[2] for q in _QTAB], mic=[q[3] for q in _QTAB],
            lags=np.arange(9), m_next=np.minimum(np.arange(2, 10), 8),
            m_idx=np.arange(1, 9))


def make_region() -> Region:
    data = make_input()
    g_s, g_larc = golden_reference(data)
    image = {
        "input": data.astype(np.int32),
        "s": data.astype(np.int32),
        "l_acf": np.zeros(9, np.int32),
        "p": np.zeros(9, np.int32),
        "k": np.zeros(9, np.int32),
        "r": np.zeros(M, np.int32),
        "larc": np.zeros(M, np.int32),
        "scal": np.zeros(3, np.int32),   # smax, scalauto, schur_done
        "i": np.int32(0),
    }
    goldens = Consts(s=g_s, larc=g_larc)

    def init(device):
        return state_from_numpy(image, device)

    def step(state, t):
        i, s, scal = state["i"], state["s"], state["scal"]
        c = _Q.on(i.device)
        p_arr, k_arr, r_arr = state["p"], state["k"], state["r"]
        smax, scalauto, schur_done = scal.unbind(1)

        # Phase A: running max of |s[k]|.
        k_a = torch.clamp(i, 0, N - 1)
        scal_a = _set_col(scal, 0, torch.maximum(
            smax, _dabs(take_clip(s, k_a))))

        # Phase B: scaling factor.
        scal_b = _set_col(scal, 1, torch.where(
            smax == 0, 0, 4 - _dnorm32(smax << 16)))

        # Phase C: down-scale one sample.
        k_c = torch.clamp(i - STEP_SCALE0, 0, N - 1)
        do_scale = (scalauto > 0) & (scalauto <= 4)
        f = 16384 >> torch.clamp(scalauto - 1, 0, 3)
        s_c = torch.where(do_scale[:, None], update_drop(
            s, k_c, _dmult_r(take_clip(s, k_c), f)), s)

        # Phase D: L_ACF accumulation for sample k.
        k_d = torch.clamp(i - STEP_ACF0, 0, N - 1)
        sk = take_clip(s, k_d)
        prev = take_clip(s, k_d[:, None] - c.lags)
        contrib = torch.where(c.lags <= k_d[:, None], sk[:, None] * prev, 0)
        l_acf_d = state["l_acf"] + contrib

        # Phase E: L_ACF <<= 1; rescale s; the Schur arrays from the ACF.
        l_acf_e = state["l_acf"] << 1
        s_e = torch.where((scalauto > 0)[:, None],
                          s << torch.clamp(scalauto, 0, 4)[:, None], s)
        zero_acf = l_acf_e[:, 0] == 0
        acf = (l_acf_e << _dnorm32(l_acf_e[:, 0])[:, None]) >> 16
        z = zero_acf[:, None]
        p_e = torch.where(z, p_arr, acf)
        # ``k.at[1:8].set(acf[1:8])``: a partial update into k.
        k_e = torch.where(z, k_arr, torch.slice_scatter(
            k_arr, acf[:, 1:8], dim=1, start=1, end=8))
        scal_e = _set_col(scal, 2, zero_acf.to(torch.int32))

        # Phase F: one Schur stage n = i - STEP_SCHUR0 + 1.
        n = torch.clamp(i - STEP_SCHUR0, 0, M - 1) + 1
        p0, p1 = p_arr[:, 0], p_arr[:, 1]
        abs_p1 = _dabs(p1)
        bail = (p0 < abs_p1) | (schur_done != 0)
        rv = _ddiv(abs_p1, p0)
        rv = torch.where(p1 > 0, -rv, rv)
        rv = torch.where(bail, 0, rv)
        r_f = update_drop(r_arr, n - 1, rv)
        # The reference returns from stage n == 8 before the P/K update.
        p0_new = torch.where(n < 8, _dsat(p0 + _dmult_r(p1, rv)), p0)
        p_next = p_arr[:, c.m_next]
        p_m, k_m = p_arr[:, c.m_idx], k_arr[:, c.m_idx]
        upd = c.m_idx <= (8 - n)[:, None]
        rvc = rv[:, None]
        p_new = torch.where(upd, _dsat(p_next + _dmult_r(k_m, rvc)), p_m)
        k_new = torch.where(upd, _dsat(k_m + _dmult_r(p_next, rvc)), k_m)
        b = bail[:, None]
        p_f = torch.where(b, p_arr, torch.cat([p0_new[:, None], p_new], 1))
        k_f = torch.where(b, k_arr, torch.cat([k_arr[:, :1], k_new], 1))
        scal_f = _set_col(scal, 2, torch.where(bail, 1, schur_done))

        # Phase G: LAR transform + quantization (vector).
        t_abs = _dabs(r_arr)
        lar = torch.where(t_abs < 22118, t_abs >> 1, torch.where(
            t_abs < 31130, t_abs - 11059, (t_abs - 26112) << 2))
        lar = torch.where(r_arr < 0, -lar, lar)
        tq = _dsat(_dsat(_dmult(c.a, lar) + c.b) + 256) >> 9
        larc = torch.where(tq > c.mac, c.mac - c.mic,
                           torch.where(tq < c.mic, 0, tq - c.mic))

        # Select by phase.
        in_a = (i < STEP_SCAL)[:, None]
        in_b = (i == STEP_SCAL)[:, None]
        in_c = ((i >= STEP_SCALE0) & (i < STEP_ACF0))[:, None]
        in_d = ((i >= STEP_ACF0) & (i < STEP_SHIFT))[:, None]
        in_e = (i == STEP_SHIFT)[:, None]
        in_f = ((i >= STEP_SCHUR0) & (i < STEP_LAR))[:, None]
        in_g = (i >= STEP_LAR)[:, None]
        return {
            "scal": torch.where(in_a, scal_a, torch.where(
                in_b, scal_b, torch.where(in_e, scal_e, torch.where(
                    in_f, scal_f, scal)))),
            "s": torch.where(in_c, s_c, torch.where(in_e, s_e, s)),
            "l_acf": torch.where(in_d, l_acf_d, torch.where(
                in_e, l_acf_e, state["l_acf"])),
            "p": torch.where(in_e, p_e, torch.where(in_f, p_f, p_arr)),
            "k": torch.where(in_e, k_e, torch.where(in_f, k_f, k_arr)),
            "r": torch.where(in_f, r_f, r_arr),
            "larc": torch.where(in_g, larc, state["larc"]),
            "i": i + 1,
        }

    def done(state):
        return state["i"] >= N_STEPS

    def check(state):
        g = goldens.on(state["i"].device)
        bad = ((state["s"] != g.s).sum(dim=1)
               + (state["larc"] != g.larc).sum(dim=1))
        return bad.to(torch.int32)

    def output(state):
        return torch.cat([state["s"], state["larc"]], dim=1)

    return Region(
        name="chstone_gsm",
        init=init,
        step=step,
        done=done,
        check=check,
        output=output,
        nominal_steps=N_STEPS,
        max_steps=N_STEPS + 8,
        spec={
            "input": LeafSpec(KIND_RO),
            "s": LeafSpec(KIND_MEM),
            "l_acf": LeafSpec(KIND_MEM),
            "p": LeafSpec(KIND_MEM),
            "k": LeafSpec(KIND_MEM),
            "r": LeafSpec(KIND_MEM),
            "larc": LeafSpec(KIND_MEM),
            "scal": LeafSpec(KIND_REG),
            "i": LeafSpec(KIND_CTRL),
        },
        default_xmr=True,
        graph=BlockGraph(
            names=["entry", "Autocorrelation", "Reflection_coefficients",
                   "Quantization_and_coding", "exit"],
            edges=[(0, 1), (1, 1), (1, 2), (2, 2), (2, 3), (3, 3), (3, 4),
                   (1, 3)],
            block_of=lambda s: pick(
                s["i"] >= N_STEPS, 4,
                pick(s["i"] >= STEP_LAR, 3,
                     pick(s["i"] >= STEP_SCHUR0, 2, 1)))),
        meta={"oracle": "pure-python GSM 06.10 fixed-point LPC",
              "dataflow": DATAFLOW},
    )
