"""Seeded fault schedules: where and when each campaign row flips its bit.

The counterpart of ``coast_tpu/inject/schedule.py`` for the single-site
fault model: one row per injection, ``(leaf_id, lane, word, bit, t)``,
drawn up front from a seed -- uniform over the injectable bits and over the
nominal runtime -- so a campaign is deterministic and replayable.  The
stream is the reference's counter-mode splitmix64 (a numpy copy of
``coast_tpu/native`` ``splitmix_fill``), so the same seed gives the same
schedule.  Multi-site models and equivalence reduction are ROADMAP Queue A
items 10 and 17.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from coast_tpu_torch.inject.mem import MemoryMap

SITE_KEYS = ("leaf_id", "lane", "word", "bit", "t")
_SPLITMIX_GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def splitmix_fill(seed: int, n: int) -> np.ndarray:
    """n counter-mode splitmix64 draws (uint64): value i is the finalizer
    of ``seed + (i + 1) * golden``."""
    seed = seed & 0xFFFFFFFFFFFFFFFF
    with np.errstate(over="ignore"):
        idx = np.arange(1, n + 1, dtype=np.uint64)
        z = np.uint64(seed) + idx * _SPLITMIX_GOLDEN
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


@dataclasses.dataclass
class FaultSchedule:
    """One campaign's worth of single-site injection targets (numpy)."""

    leaf_id: np.ndarray   # int32 [n]
    lane: np.ndarray      # int32 [n]
    word: np.ndarray      # int32 [n]
    bit: np.ndarray       # int32 [n]
    t: np.ndarray         # int32 [n] step index of the flip
    section_idx: np.ndarray  # int32 [n] index into MemoryMap.sections
    seed: int

    def __len__(self) -> int:
        return len(self.leaf_id)

    def device_arrays(self) -> Dict[str, np.ndarray]:
        """The per-injection fault columns the engine takes."""
        return {k: getattr(self, k) for k in SITE_KEYS}

    def slice(self, lo: int, hi: int) -> "FaultSchedule":
        return FaultSchedule(
            self.leaf_id[lo:hi], self.lane[lo:hi], self.word[lo:hi],
            self.bit[lo:hi], self.t[lo:hi], self.section_idx[lo:hi],
            self.seed)


def generate(mmap: MemoryMap, n: int, seed: int, nominal_steps: int,
             model=None, equiv=None) -> FaultSchedule:
    """n seeded draws: uniform over all injectable bits x uniform over the
    nominal runtime window."""
    if model is not None and getattr(model, "kind", model) != "single":
        raise NotImplementedError(
            "only the single-bit fault model is ported; multi-site models "
            "are ROADMAP Queue A item 10")
    if equiv is not None:
        raise NotImplementedError(
            "equivalence-reduced schedules are ROADMAP Queue A item 17")
    raw = splitmix_fill(seed, 2 * n)
    flat_bits = (raw[:n] % np.uint64(mmap.total_bits)).astype(np.int64)
    t = (raw[n:] % np.uint64(max(nominal_steps, 1))).astype(np.int32)
    leaf_id, lane, word, bit, sec_idx = mmap.decode(flat_bits)
    return FaultSchedule(leaf_id, lane, word, bit, t,
                         sec_idx.astype(np.int32), seed)
