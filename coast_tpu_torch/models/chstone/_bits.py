"""Shared bitstream helpers for the VLC-driven CHStone kernels (motion:
Table B-10 decode; jpeg: Huffman entropy decode).

The counterpart of ``coast_tpu/models/chstone/_bits.py``.  Host side: the
MSB-first bit writer and reader over 32-bit words, copied.  Device side:
:func:`jshow`, the ``show_bits`` window over a uint32 word array held as
int32 words.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from coast_tpu_torch.ops.indexing import take_clip
from coast_tpu_torch.ops.u32 import lsr


class BitWriter:
    """MSB-first accumulator; ``words()`` pads with ``pad_bit`` plus two
    guard words so device reads past the end stay in bounds."""

    def __init__(self, pad_bit: int = 0):
        self.bits: List[int] = []
        self.pad_bit = pad_bit

    def put(self, value: int, n: int) -> None:
        for k in range(n - 1, -1, -1):
            self.bits.append((value >> k) & 1)

    def words(self) -> np.ndarray:
        bits = self.bits + [self.pad_bit] * ((-len(self.bits)) % 32 + 64)
        out = []
        for w in range(0, len(bits), 32):
            v = 0
            for b in bits[w:w + 32]:
                v = (v << 1) | b
            out.append(v)
        return np.array(out, np.uint32)


class BitReader:
    """MSB-first reader over a bit list or a uint32 word array."""

    def __init__(self, source):
        if isinstance(source, np.ndarray):
            self.bits = []
            for w in source:
                for k in range(31, -1, -1):
                    self.bits.append((int(w) >> k) & 1)
        else:
            self.bits = list(source)
        self.pos = 0

    def get(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bits[self.pos]
            self.pos += 1
        return v

    def show(self, n: int) -> int:
        v = 0
        for k in range(n):
            b = self.bits[self.pos + k] if self.pos + k < len(self.bits) else 0
            v = (v << 1) | b
        return v


def jshow(words: torch.Tensor, pos: torch.Tensor, n: int) -> torch.Tensor:
    """The n-bit window (n <= 25) at bit cursor ``pos`` of each row's word
    array (Show_Bits, getbits.c:102).  ``pos >> 5`` is arithmetic and the
    word reads are ``jnp.take(mode="clip")``, as in the reference; the
    shifts are uint32 shifts (``32 - off`` is 32 when ``off`` is 0, and
    that branch is not taken)."""
    off = pos & 31
    w = pos >> 5
    w1, w2 = take_clip(words, torch.stack([w, w + 1], dim=1)).unbind(1)
    hi = w1 << off
    lo = torch.where(off == 0, torch.zeros_like(w2), lsr(w2, 32 - off))
    return lsr(hi | lo, 32 - n)
