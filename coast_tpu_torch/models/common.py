"""Shared helpers for the benchmark regions: the deterministic LCG inputs
and the per-device constant tables.

``lcg_words`` is a numpy copy of ``coast_tpu/models/common.py``'s: the
same stream, so the port's regions start from the reference's words.
"""

from __future__ import annotations

import functools
import types

import numpy as np
import torch

_LCG_A, _LCG_C, _LCG_MASK = 1103515245, 12345, 0x7FFFFFFF


@functools.lru_cache(maxsize=64)
def _lcg_state_stream(seed: int, n: int) -> np.ndarray:
    """The raw LCG state sequence, cached and read-only.

    Affine maps compose, so after one stride is generated sequentially the
    rest is vectorised: x[i+s] = (A^s x[i] + C_s) mod 2^31.  int64 holds the
    products exactly (a_s, x < 2^31)."""
    out = np.empty(n, dtype=np.int64)
    stride = min(n, 4096)
    x = seed & _LCG_MASK
    for i in range(stride):
        x = (_LCG_A * x + _LCG_C) & _LCG_MASK
        out[i] = x
    a_s, c_s = 1, 0
    for _ in range(stride):
        a_s, c_s = (_LCG_A * a_s) & _LCG_MASK, (_LCG_A * c_s + _LCG_C) & _LCG_MASK
    filled = stride
    while filled < n:
        m = min(stride, n - filled)
        out[filled:filled + m] = (
            a_s * out[filled - stride:filled - stride + m] + c_s) & _LCG_MASK
        filled += m
    out.setflags(write=False)
    return out


def lcg_words(seed: int, n: int, bits: int = 15) -> np.ndarray:
    """n deterministic pseudo-random values of ``bits`` width."""
    return (_lcg_state_stream(seed, n) >> 16) & ((1 << bits) - 1)


class Consts:
    """The constant tables a region's step reads, made once a device (a
    step finds its device on any state leaf).  Integer tables become
    int32 (uint32 values as their int32 bits), as region words are."""

    def __init__(self, **arrays):
        self._arrays = {k: _word_array(v) for k, v in arrays.items()}
        self._made = {}

    def on(self, device) -> types.SimpleNamespace:
        key = str(device)
        made = self._made.get(key)
        if made is None:
            made = self._made[key] = types.SimpleNamespace(**{
                k: torch.tensor(v, device=device)
                for k, v in self._arrays.items()})
        return made


def _word_array(v) -> np.ndarray:
    arr = np.asarray(v)
    if arr.dtype.kind in "iu":
        if arr.size and not (-2**31 <= arr.min() and arr.max() < 2**32):
            raise ValueError("a constant table word does not fit 32 bits")
        arr = (arr.astype(np.int64) & 0xFFFFFFFF).astype(np.uint32)
        arr = arr.view(np.int32)
    return arr
