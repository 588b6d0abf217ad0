"""Shared helpers for the benchmark regions: the deterministic LCG inputs.

A numpy copy of ``coast_tpu/models/common.py`` ``lcg_words``: the same
stream, so the port's regions start from the reference's words.
"""

from __future__ import annotations

import functools

import numpy as np

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
