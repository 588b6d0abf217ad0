"""Memory map: the injectable address space of a protected program.

The counterpart of ``coast_tpu/inject/mem.py``: the sections are the
program's injectable leaves, word-addressed (32-bit); a replicated leaf
contributes one independently corruptible copy per lane.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class MemorySection:
    """One injectable leaf: ``bits = lanes * words * 32``."""

    name: str
    leaf_id: int
    kind: str
    lanes: int          # num_clones if replicated else 1
    words: int          # flat 32-bit words per lane

    @property
    def bits(self) -> int:
        return self.lanes * self.words * 32


class MemoryMap:
    """Section table + uniform sampling over all injectable bits."""

    def __init__(self, prog, sections: Optional[Sequence[str]] = None):
        self.sections: List[MemorySection] = []
        for leaf_id, (name, kind, lanes, words) in enumerate(
                prog.injectable_sections()):
            if sections is not None and kind not in sections \
                    and name not in sections:
                continue
            self.sections.append(MemorySection(
                name=name, leaf_id=leaf_id, kind=kind, lanes=lanes,
                words=max(words, 1)))
        if not self.sections:
            raise ValueError("no injectable sections selected")
        self.total_bits = sum(s.bits for s in self.sections)

    def by_name(self, name: str) -> MemorySection:
        for s in self.sections:
            if s.name == name:
                return s
        raise KeyError(name)

    def section_tables(self):
        """The flat section layout the flip-group expansion and the
        device generator read: ``(bits_end, leaf_id, lanes, words)``, the
        cumulative bit edges (int64) and the per-section int32 columns."""
        return (np.cumsum([s.bits for s in self.sections]).astype(np.int64),
                np.array([s.leaf_id for s in self.sections], np.int32),
                np.array([s.lanes for s in self.sections], np.int32),
                np.array([s.words for s in self.sections], np.int32))

    def decode(self, flat_bits: np.ndarray):
        """Map uniform draws over [0, total_bits) to (leaf_id, lane, word,
        bit, section index)."""
        flat_bits = np.asarray(flat_bits, dtype=np.int64)
        edges = np.cumsum([s.bits for s in self.sections])
        sec_idx = np.searchsorted(edges, flat_bits, side="right")
        leaf_ids = np.array([s.leaf_id for s in self.sections])[sec_idx]
        offs = flat_bits - (edges[sec_idx] - np.array(
            [s.bits for s in self.sections])[sec_idx])
        words_per = np.array([s.words for s in self.sections])[sec_idx]
        lane = offs // (words_per * 32)
        rem = offs % (words_per * 32)
        word = rem // 32
        bit = rem % 32
        return (leaf_ids.astype(np.int32), lane.astype(np.int32),
                word.astype(np.int32), bit.astype(np.int32), sec_idx)
