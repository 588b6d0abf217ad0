"""Unsigned 32-bit word arithmetic on int32-carried words.

The reference holds its hash, cipher and soft-float state as ``uint32``;
the port carries the same bits as int32 (``LeafSpec.unsigned``), because
``torch.uint32`` has no shift, compare or add.  Addition, subtraction,
multiplication, ``&``, ``|``, ``^``, ``~`` and ``<<`` by a count in
``[0, 31]`` give the same bits either way (two's complement wraps like
mod 2^32).  What differs is below: torch's ``>>`` on int32 is arithmetic
and its ``<`` is signed.

Shift counts follow XLA's rule for a count outside ``[0, 31]``: a
logical right shift gives 0, an arithmetic right shift gives the sign
fill.  A count may be a Python int or a tensor (then read as unsigned, so
a negative count is out of range too).

For the roofline's op count (``voters.priced``) each helper counts what
the reference's uint32 operation counts: a shift or compare is one op a
word, the int32/int64 reinterpretations (:func:`word`, :func:`wide`)
none, as the reference's ``astype`` is a conversion.
"""

from __future__ import annotations

from typing import Union

import torch

from coast_tpu_torch.ops.voters import priced

Count = Union[int, torch.Tensor]

MASK32 = 0xFFFFFFFF
_SIGN = -2**31


@priced(0)
def word(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 tensor with the same low 32 bits.  The wrap is
    arithmetic, with no select, as the reference's ``astype`` is: the
    low 32 bits offset by 2^31, then shifted back into int32's range."""
    return (((x + 2**31) & MASK32) - 2**31).to(torch.int32)


@priced(0)
def wide(x: torch.Tensor) -> torch.Tensor:
    """int32 word -> its unsigned value, in int64 ``[0, 2^32)``."""
    return x.to(torch.int64) & MASK32


def const(v: int) -> int:
    """A uint32 constant as the Python int of its int32 bits."""
    v &= MASK32
    return v - 2**32 if v >= 2**31 else v


def _count(n: torch.Tensor) -> torch.Tensor:
    """A tensor count read as unsigned, in int64."""
    return wide(n) if n.dtype == torch.int32 else n.to(torch.int64) & MASK32


@priced(1)
def lsr(x: torch.Tensor, n: Count) -> torch.Tensor:
    """Logical right shift (uint32 ``>>``)."""
    if isinstance(n, int):
        n &= MASK32
        if n >= 32:
            return torch.zeros_like(x)
        if n == 0:
            return x
        return (x >> n) & ((1 << (32 - n)) - 1)
    n = _count(n)
    out = wide(x) >> torch.clamp(n, max=31)
    return word(torch.where(n < 32, out, 0))


@priced(1)
def sar(x: torch.Tensor, n: Count) -> torch.Tensor:
    """Arithmetic right shift (int32 ``>>``); a count outside ``[0, 31]``
    gives the sign fill."""
    if isinstance(n, int):
        n &= MASK32
        return x >> min(n, 31)
    n = _count(n)
    return x >> torch.clamp(n, max=31).to(x.dtype)


def _flip(x):
    if isinstance(x, int):
        return const(x) ^ _SIGN
    return x ^ _SIGN


@priced(1)
def ult(a, b) -> torch.Tensor:
    """Unsigned ``a < b`` (either side may be a Python int)."""
    return _flip(a) < _flip(b)


@priced(1)
def ule(a, b) -> torch.Tensor:
    return _flip(a) <= _flip(b)


def rotl(x: torch.Tensor, n: int) -> torch.Tensor:
    """Rotate left by a constant ``n`` in ``[1, 31]``."""
    return (x << n) | lsr(x, 32 - n)


def rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Rotate right by a constant ``n`` in ``[1, 31]``."""
    return lsr(x, n) | (x << (32 - n))


@priced(1)
def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (``lax.population_count``), int32.
    Takes int32 words or int64 values in ``[0, 2^32)``."""
    v = x.to(torch.int64) & MASK32
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & MASK32) >> 24).to(torch.int32)


def clz(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of each 32-bit word (32 for 0), int32."""
    y = x.to(torch.int64) & MASK32
    for k in (1, 2, 4, 8, 16):
        y = y | (y >> k)
    return 32 - popcount(y)


def umulhi(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """High 32 bits of the unsigned 64-bit product of two words."""
    a, b = wide(a), wide(b)
    al, ah = a & 0xFFFF, a >> 16
    bl, bh = b & 0xFFFF, b >> 16
    mid = ah * bl + al * bh + ((al * bl) >> 16)
    return word(ah * bh + (mid >> 16))


def mullo(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of the product of two words (signed or unsigned: the
    same bits), computed in int64 so no int32 product overflows."""
    return word(a.to(torch.int64) * b.to(torch.int64))
