"""IEEE-754 binary64 soft-float on 32-bit limb pairs (the engine behind the
CHStone dfadd/dfmul/dfdiv/dfsin kernels), on torch tensors.

The counterpart of ``coast_tpu/models/chstone/df64.py``.  The memory map is
32-bit words, so a double lives as a (hi, lo) pair of uint32 words and
every 64-bit operation is built from 32-bit limb operations, as in the
reference: a campaign flips any word of a double on its own.  Semantics:
round-to-nearest-even, subnormals, every NaN result canonicalised to
0x7FF8000000000000.

Inside these functions a uint32 word is an int64 tensor holding its
value in ``[0, 2^32)`` (a leaf's int32 word goes in through
``ops/u32.wide`` and comes out through ``ops/u32.word``): unsigned
compares are then plain compares, ``>>`` is logical, and every add,
subtract and left shift that could leave the range is masked back to 32
bits, which is the reference's uint32 wrap.  The reference's int32
intermediates (exponents, shift counts) are plain int64 here; none of
them can leave the int32 range.

One departure in form, none in value: the division's 56-step restoring
loop runs on the 64-bit significands as single int64 numbers (the
reference shifts and subtracts limb pairs).  Both operands are below
2^54 whenever the quotient is used, so no step overflows and every
quotient bit and the sticky bit are the same; the one input whose
divisor significand is not normalised, a zero divisor, gives an infinity
or a NaN that replaces the quotient, in the reference as here.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from coast_tpu_torch.ops import u32

M32 = 0xFFFFFFFF
_NAN_HI = 0x7FF80000

Pair = Tuple[torch.Tensor, torch.Tensor]


def _m(x):
    return x & M32


def _s32(x):
    """A uint32 value read as int32 (``.astype(jnp.int32)``)."""
    return torch.where(x >= 2**31, x - 2**32, x)


def _where(c, a, b):
    """``jnp.where`` with Python ints taken as int64 words."""
    if isinstance(a, int):
        a = torch.full_like(b, a) if isinstance(b, torch.Tensor) else a
    if isinstance(b, int):
        b = torch.full_like(a, b)
    return torch.where(c, a, b)


# -- 64-bit primitives on (hi, lo) pairs ------------------------------------

def add64(ah, al, bh, bl) -> Pair:
    lo = _m(al + bl)
    carry = (lo < al).to(torch.int64)
    return _m(ah + bh + carry), lo


def sub64(ah, al, bh, bl) -> Pair:
    lo = _m(al - bl)
    borrow = (al < bl).to(torch.int64)
    return _m(ah - bh - borrow), lo


def lt64(ah, al, bh, bl):
    return (ah < bh) | ((ah == bh) & (al < bl))


def _safe_shl32(x, k):
    """x << k for k in [0, 2^32); k >= 32 yields 0."""
    return _where(k < 32, _m(x << torch.clamp(k, 0, 31)), 0)


def _safe_shr32(x, k):
    return _where(k < 32, x >> torch.clamp(k, 0, 31), 0)


def shl64(h, l, k) -> Pair:
    """(h, l) << k, k a uint32 count (64 or more gives 0)."""
    k = _m(k)
    hi_small = _safe_shl32(h, k) | _where(k == 0, 0,
                                          _safe_shr32(l, _m(32 - k)))
    hi_big = _safe_shl32(l, _m(k - 32))
    return _where(k < 32, hi_small, hi_big), _safe_shl32(l, k)


def shr64(h, l, k) -> Pair:
    k = _m(k)
    lo_small = _safe_shr32(l, k) | _where(k == 0, 0,
                                          _safe_shl32(h, _m(32 - k)))
    lo_big = _safe_shr32(h, _m(k - 32))
    return _safe_shr32(h, k), _where(k < 32, lo_small, lo_big)


def shr64_jam(h, l, k) -> Pair:
    """Right shift with sticky: any bit shifted out ORs into the LSB
    (softfloat shift64RightJamming)."""
    k = torch.clamp(k, 0, 127)
    big = k >= 64
    kk = _where(big, 0, k)
    sh, sl = shr64(h, l, kk)
    # Lost bits: (h, l) << (64 - k) != 0, for 0 < k < 64.
    lh, ll = shl64(h, l, _where(kk == 0, 0, 64 - kk))
    lost_small = (kk != 0) & ((lh | ll) != 0)
    sticky = torch.where(big, (h | l) != 0, lost_small)
    return (_where(big, 0, sh),
            _where(big, 0, sl) | sticky.to(torch.int64))


def clz32(x):
    return u32.clz(x).to(torch.int64)


def clz64(h, l):
    return torch.where(h != 0, clz32(h), 32 + clz32(l))


def umul32(a, b) -> Pair:
    """Full 32x32 -> 64 multiply in 16-bit limbs."""
    a0, a1 = a & 0xFFFF, a >> 16
    b0, b1 = b & 0xFFFF, b >> 16
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = (p00 >> 16) + (p01 & 0xFFFF) + (p10 & 0xFFFF)
    lo = _m((mid << 16) | (p00 & 0xFFFF))
    hi = _m(p11 + (p01 >> 16) + (p10 >> 16) + (mid >> 16))
    return hi, lo


# -- unpack / pack -----------------------------------------------------------

def _unpack(hi, lo):
    return hi >> 31, (hi >> 20) & 0x7FF, hi & 0xFFFFF, lo


def _classes(exp, fh, fl):
    """(nan, inf, zero) of an unpacked operand."""
    frac0 = (fh | fl) == 0
    top = exp == 0x7FF
    return top & ~frac0, top & frac0, (exp == 0) & frac0


def _pack_inf(sign) -> Pair:
    return (sign << 31) | 0x7FF00000, torch.zeros_like(sign)


def _pack_zero(sign) -> Pair:
    return sign << 31, torch.zeros_like(sign)


def _round_pack(sign, exp, sigh, sigl, g: int = 3) -> Pair:
    """Round-to-nearest-even and pack.  zSig = (sigh, sigl) in
    [2^(52+g), 2^(53+g)) for a normal result (the low ``g`` bits guard,
    round and sticky); zExp may be <= 0 (subnormal territory).  ``g`` is 3
    for mul/div and 10 for add/sub."""
    is_sub = exp < 1
    jh, jl = shr64_jam(sigh, sigl, torch.clamp(1 - exp, 0, 127))
    sigh = torch.where(is_sub, jh, sigh)
    sigl = torch.where(is_sub, jl, sigl)
    exp = _where(is_sub, 1, exp)

    half = 1 << (g - 1)
    rb = sigl & ((1 << g) - 1)
    sigh, sigl = shr64(sigh, sigl, torch.full_like(sigh, g))
    round_up = (rb > half) | ((rb == half) & ((sigl & 1) == 1))
    sigh, sigl = add64(sigh, sigl, torch.zeros_like(sigh),
                       round_up.to(torch.int64))

    # Mantissa overflow from rounding: 2^53 means exp + 1.
    overflow = (sigh == 0x200000) & (sigl == 0)
    exp = torch.where(overflow, exp + 1, exp)
    sigh = _where(overflow, 0x100000, sigh)
    sigl = _where(overflow, 0, sigl)

    # Normal iff the implicit bit survived (>= 2^52).
    is_norm = sigh >= 0x100000
    packed_exp = _where(is_norm, _m(exp), 0)
    frac_h = torch.where(is_norm, _m(sigh - 0x100000), sigh)
    hi = (sign << 31) | _m(packed_exp << 20) | frac_h
    ih, il = _pack_inf(sign)
    to_inf = exp >= 0x7FF
    return torch.where(to_inf, ih, hi), torch.where(to_inf, il, sigl)


def _norm_sig(exp, fh, fl):
    """Effective (exp, 53-bit significand in [2^52, 2^53)) of a finite
    nonzero operand; subnormals are normalised."""
    is_sub = exp == 0
    shift = _m(clz64(fh, fl) - 11)           # >= 11 for subnormals
    sh, sl = shl64(fh, fl, shift)
    eff_exp = torch.where(is_sub, 1 - _s32(shift), exp)
    return (eff_exp, torch.where(is_sub, sh, fh | 0x100000),
            torch.where(is_sub, sl, fl))


def _finish(hi, lo, *overrides) -> Pair:
    """Apply (mask, (hi, lo)) overrides in order, the last one winning."""
    for mask, (oh, ol) in overrides:
        hi = torch.where(mask, oh, hi)
        lo = torch.where(mask, ol, lo)
    return hi, lo


def _nan_like(x) -> Pair:
    return torch.full_like(x, _NAN_HI), torch.zeros_like(x)


# -- float64 add -------------------------------------------------------------

def f64_add(ah, al, bh, bl) -> Pair:
    """a + b on (hi, lo) pairs (float64_add)."""
    sa, ea, fah, fal = _unpack(ah, al)
    sb, eb, fbh, fbl = _unpack(bh, bl)
    a_nan, a_inf, a_zero = _classes(ea, fah, fal)
    b_nan, b_inf, b_zero = _classes(eb, fbh, fbl)

    # Magnitude ordering (exp, frac): make A >= B.
    swap = (ea < eb) | ((ea == eb) & lt64(fah, fal, fbh, fbl))

    def pick(x, y):
        return torch.where(swap, y, x), torch.where(swap, x, y)

    sa_, sb_ = pick(sa, sb)
    ea_, eb_ = pick(ea, eb)
    fah_, fbh_ = pick(fah, fbh)
    fal_, fbl_ = pick(fal, fbl)

    # Significands << 10 (softfloat's add alignment): [2^62, 2^63).
    ea_eff, sah, sal = _norm_sig(ea_, fah_, fal_)
    eb_eff, sbh, sbl = _norm_sig(eb_, fbh_, fbl_)
    ten = torch.full_like(sah, 10)
    sah, sal = shl64(sah, sal, ten)
    sbh, sbl = shl64(sbh, sbl, ten)
    # Zero operands have garbage normalisation; zero them.
    a_z = (ea_ == 0) & ((fah_ | fal_) == 0)
    b_z = (eb_ == 0) & ((fbh_ | fbl_) == 0)
    sah, sal = _where(a_z, 0, sah), _where(a_z, 0, sal)
    sbh, sbl = _where(b_z, 0, sbh), _where(b_z, 0, sbl)
    ea_eff = _where(a_z, 1, ea_eff)
    eb_eff = _where(b_z, 1, eb_eff)

    sbh, sbl = shr64_jam(sbh, sbl, torch.clamp(ea_eff - eb_eff, 0, 127))

    same_sign = sa_ == sb_
    # Same sign: add; may carry to 2^63.
    sumh, suml = add64(sah, sal, sbh, sbl)
    carried = sumh >= 0x80000000
    ch, cl = shr64_jam(sumh, suml, torch.ones_like(sumh))
    add_h = torch.where(carried, ch, sumh)
    add_l = torch.where(carried, cl, suml)
    add_exp = torch.where(carried, ea_eff + 1, ea_eff)

    # Opposite sign: subtract (A >= B in magnitude).
    dfh, dfl = sub64(sah, sal, sbh, sbl)
    cancel = (dfh | dfl) == 0
    norm_shift = torch.clamp(torch.minimum(_s32(_m(clz64(dfh, dfl) - 1)),
                                           ea_eff - 1), 0, 63)
    nfh, nfl = shl64(dfh, dfl, norm_shift)
    sub_exp = ea_eff - norm_shift

    hi, lo = _round_pack(sa_, torch.where(same_sign, add_exp, sub_exp),
                         torch.where(same_sign, add_h, nfh),
                         torch.where(same_sign, add_l, nfl), g=10)
    opp_inf = a_inf & b_inf & (sa != sb)
    zero = torch.zeros_like(sa)
    return _finish(
        hi, lo,
        # Exact cancellation -> +0 (round-to-nearest rule).
        (~same_sign & cancel, _pack_zero(zero)),
        # Both zero: (+0)+(+0)=+0, (-0)+(-0)=-0, mixed -> +0.
        (a_zero & b_zero, _pack_zero(torch.where(same_sign, sa, zero))),
        (a_inf | b_inf, _pack_inf(torch.where(a_inf, sa, sb))),
        (a_nan | b_nan | opp_inf, _nan_like(hi)))


# -- float64 mul -------------------------------------------------------------

def f64_mul(ah, al, bh, bl) -> Pair:
    sa, ea, fah, fal = _unpack(ah, al)
    sb, eb, fbh, fbl = _unpack(bh, bl)
    zsign = sa ^ sb
    a_nan, a_inf, a_zero = _classes(ea, fah, fal)
    b_nan, b_inf, b_zero = _classes(eb, fbh, fbl)

    ea_eff, sah, sal = _norm_sig(ea, fah, fal)
    eb_eff, sbh, sbl = _norm_sig(eb, fbh, fbl)

    # 53x53 -> 106-bit product in 4 limbs.
    h00, l00 = umul32(sal, sbl)
    h01, l01 = umul32(sal, sbh)
    h10, l10 = umul32(sah, sbl)
    h11, l11 = umul32(sah, sbh)
    p0 = l00
    p1 = _m(h00 + l01)
    c1 = (p1 < h00).to(torch.int64)
    p1n = _m(p1 + l10)
    c1 = c1 + (p1n < p1).to(torch.int64)
    p1 = p1n
    p2 = _m(h01 + h10)
    c2 = (p2 < h01).to(torch.int64)
    p2n = _m(p2 + l11)
    c2 = c2 + (p2n < p2).to(torch.int64)
    p2 = _m(p2n + c1)
    c2 = c2 + (p2 < c1).to(torch.int64)
    p3 = _m(h11 + c2)

    zexp = ea_eff + eb_eff - 0x3FF

    # Normalise the product to [2^105, 2^106): if below, shift left 1.
    lo_norm = ((p3 >> 9) & 1) == 0
    q3 = _m((p3 << 1) | (p2 >> 31))
    q2 = _m((p2 << 1) | (p1 >> 31))
    q1 = _m((p1 << 1) | (p0 >> 31))
    q0 = _m(p0 << 1)
    p3 = torch.where(lo_norm, q3, p3)
    p2 = torch.where(lo_norm, q2, p2)
    p1 = torch.where(lo_norm, q1, p1)
    p0 = torch.where(lo_norm, q0, p0)
    zexp = torch.where(lo_norm, zexp, zexp + 1)

    # zSig = bits [105:50] (56 bits), sticky from bits [49:0].
    sig_l = _m((p1 >> 18) | (p2 << 14))
    sig_h = _m((p2 >> 18) | (p3 << 14)) & 0xFFFFFF
    sticky = (p0 != 0) | ((p1 & 0x3FFFF) != 0)
    sig_l = sig_l | sticky.to(torch.int64)

    hi, lo = _round_pack(zsign, zexp, sig_h, sig_l)
    inf_times_zero = (a_inf & b_zero) | (b_inf & a_zero)
    return _finish(
        hi, lo,
        (a_zero | b_zero, _pack_zero(zsign)),
        (a_inf | b_inf, _pack_inf(zsign)),
        (a_nan | b_nan | inf_times_zero, _nan_like(hi)))


# -- float64 div -------------------------------------------------------------

def f64_div(ah, al, bh, bl) -> Pair:
    sa, ea, fah, fal = _unpack(ah, al)
    sb, eb, fbh, fbl = _unpack(bh, bl)
    zsign = sa ^ sb
    a_nan, a_inf, a_zero = _classes(ea, fah, fal)
    b_nan, b_inf, b_zero = _classes(eb, fbh, fbl)

    ea_eff, sah, sal = _norm_sig(ea, fah, fal)
    eb_eff, sbh, sbl = _norm_sig(eb, fbh, fbl)
    zexp = ea_eff - eb_eff + 0x3FF

    # Make the dividend significand >= the divisor's.
    a_lt = lt64(sah, sal, sbh, sbl)
    rem = (sah << 32) | sal
    div = (sbh << 32) | sbl
    rem = torch.where(a_lt, rem << 1, rem)
    zexp = torch.where(a_lt, zexp - 1, zexp)

    # Restoring division: 56 quotient bits (leading bit 1).
    q = torch.zeros_like(rem)
    for _ in range(56):
        ge = rem >= div
        rem = torch.where(ge, rem - div, rem) << 1
        q = (q << 1) | ge.to(torch.int64)
    ql = (q & M32) | (rem != 0).to(torch.int64)

    hi, lo = _round_pack(zsign, zexp, q >> 32, ql)
    return _finish(
        hi, lo,
        # x / inf -> 0;  0 / y -> 0.
        (b_inf | a_zero, _pack_zero(zsign)),
        # inf / y -> inf;  x / 0 -> inf.
        (a_inf | b_zero, _pack_inf(zsign)),
        # NaN: a NaN operand, inf/inf, 0/0.
        (a_nan | b_nan | (a_inf & b_inf) | (a_zero & b_zero),
         _nan_like(hi)))


# -- numpy oracle ------------------------------------------------------------

def canonicalize_nan64(bits: np.ndarray) -> np.ndarray:
    """uint64 bit patterns: any NaN -> 0x7FF8000000000000."""
    bits = np.asarray(bits, np.uint64)
    exp = (bits >> np.uint64(52)) & np.uint64(0x7FF)
    frac = bits & np.uint64((1 << 52) - 1)
    is_nan = (exp == 0x7FF) & (frac != 0)
    return np.where(is_nan, np.uint64(0x7FF8000000000000), bits)


def oracle_op(op: str, a_bits: np.ndarray, b_bits: np.ndarray) -> np.ndarray:
    """IEEE-correct result via numpy float64 (round-nearest-even)."""
    a = np.asarray(a_bits, np.uint64).view(np.float64)
    b = np.asarray(b_bits, np.uint64).view(np.float64)
    with np.errstate(all="ignore"):
        z = {"add": np.add, "mul": np.multiply, "div": np.divide}[op](a, b)
    return canonicalize_nan64(z.view(np.uint64))


def split_bits(bits: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    bits = np.asarray(bits, np.uint64)
    return ((bits >> np.uint64(32)).astype(np.uint32),
            (bits & np.uint64(0xFFFFFFFF)).astype(np.uint32))
