"""The numpy seed streams: counter-mode splitmix64 and the flip-group
expansion.

The counterpart of the numpy half of ``coast_tpu/native/__init__.py``.  The
reference runs these in a C++ core when it is built and falls back to
numpy with bit-identical results; the port keeps the numpy bodies only.
:func:`splitmix_fill` is the stream every seeded schedule draws from, and
:func:`fault_expand` turns a base single-site schedule into the extra rows
of its flip groups (``inject/schedule.FaultModel``), drawing from a
derived stream keyed by :data:`FAULT_EXPAND_SALT`.
"""

from __future__ import annotations

from typing import Mapping, Sequence, Tuple

import numpy as np

_SPLITMIX_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_MASK64 = 0xFFFFFFFFFFFFFFFF

#: Derived-stream salt of the flip-group expansion: its draws come from
#: ``_splitmix_at(seed, FAULT_EXPAND_SALT)``, so they never collide with the
#: base schedule's own (seed, counter) stream.
FAULT_EXPAND_SALT = 0x5EEDFA11

_FAULT_KINDS = ("multibit", "cluster", "burst")


def splitmix_fill(seed: int, n: int) -> np.ndarray:
    """n counter-mode splitmix64 draws (uint64): value i is the finalizer
    of ``seed + (i + 1) * golden``."""
    seed = seed & _MASK64
    with np.errstate(over="ignore"):
        idx = np.arange(1, n + 1, dtype=np.uint64)
        z = np.uint64(seed) + idx * _SPLITMIX_GOLDEN
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def _splitmix_at(seed: int, i: int) -> int:
    """Value ``i`` of the ``seed`` stream (a Python int)."""
    z = (seed + (i + 1) * 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def fault_expand(seed: int, kind: str, sites: int, span: int, window: int,
                 steps: int, base: Mapping[str, np.ndarray],
                 sec_tables: Sequence[np.ndarray]
                 ) -> Tuple[np.ndarray, ...]:
    """Expand a base single-site schedule into its extra flip-group rows.

    ``base`` holds int32 columns (leaf_id, lane, word, bit, t,
    section_idx), one row per injection; ``sec_tables`` is
    ``MemoryMap.section_tables()``: ``(bits_end, leaf, lanes, words)``.
    Returns ``(group, leaf_id, lane, word, bit, t)`` int32 arrays of length
    ``n * (sites - 1)``, site-major within an injection: extra row
    ``i * (sites - 1) + (j - 1)`` is injection i's site j."""
    if kind not in _FAULT_KINDS:
        raise KeyError(kind)
    n = len(base["leaf_id"])
    m = n * (sites - 1)
    cols = {k: np.ascontiguousarray(base[k], np.int32)
            for k in ("leaf_id", "lane", "word", "bit", "t", "section_idx")}
    bits_end = np.ascontiguousarray(sec_tables[0], np.int64)
    sec_leaf, sec_lanes, sec_words = (
        np.ascontiguousarray(a, np.int32) for a in sec_tables[1:])
    exp_seed = _splitmix_at(seed & _MASK64, FAULT_EXPAND_SALT)
    extras = sites - 1
    group = np.repeat(np.arange(n, dtype=np.int32), extras)
    i = group.astype(np.int64)                    # base row per extra row
    j = np.tile(np.arange(1, sites, dtype=np.int64), n)   # site index
    if kind == "multibit":
        u = splitmix_fill(exp_seed, n)
        stride = (1 + 2 * (u % np.uint64(16)))[i]
        bit = ((cols["bit"][i].astype(np.uint64)
                + j.astype(np.uint64) * stride) % np.uint64(32))
        return (group, cols["leaf_id"][i], cols["lane"][i],
                cols["word"][i], bit.astype(np.int32), cols["t"][i])
    # Extra row r (site-major: r = i*extras + (j-1) = 0..m-1 in order)
    # consumes stream draws 2r and 2r+1.
    u = splitmix_fill(exp_seed, 2 * m) if m else np.zeros(0, np.uint64)
    u0, u1 = u[0::2], u[1::2]
    if kind == "cluster":
        s = cols["section_idx"][i]
        words = sec_words[s].astype(np.uint64)
        lw = sec_lanes[s].astype(np.uint64) * words
        phys = (cols["lane"][i].astype(np.uint64) * words
                + cols["word"][i].astype(np.uint64)
                + np.uint64(1) + u0 % np.uint64(span)) % lw
        return (group, cols["leaf_id"][i],
                (phys // words).astype(np.int32),
                (phys % words).astype(np.int32),
                (u1 % np.uint64(32)).astype(np.int32), cols["t"][i])
    # burst: a fresh uniform location over the whole map, clustered time.
    total_bits = np.uint64(bits_end[-1])
    flat = (u0 % total_bits).astype(np.int64)
    s = np.searchsorted(bits_end, flat, side="right")
    start = np.where(s == 0, 0, bits_end[np.maximum(s - 1, 0)])
    off = flat - start
    per_lane = sec_words[s].astype(np.int64) * 32
    t0 = cols["t"][i].astype(np.int64)
    tj = np.minimum(t0 + (u1 % np.uint64(window)).astype(np.int64),
                    steps - 1)
    return (group, sec_leaf[s].astype(np.int32),
            (off // per_lane).astype(np.int32),
            ((off % per_lane) // 32).astype(np.int32),
            (off % 32).astype(np.int32),
            np.where(t0 < 0, t0, tj).astype(np.int32))
