"""Cache and register injection models: the MemHierarchy / A9Register
analogues.

The counterpart of ``coast_tpu/inject/hierarchy.py``, numpy over the
port's ``MemoryMap``: the same seed gives the reference's cache schedule
bit for bit (``tests/test_torch_supervisor.py``).

The reference injects into three target families (injector.py:125-200):
named CPU registers (``A9Register`` enum, resources/registers.py), ELF
memory sections (resources/mem.py:56-85), and cache words addressed as
(row, block, word) through the QEMU plugin's geometry model
(``CacheData``/``MemHierarchy``, resources/mem.py:86-161; geometry table
resources/benchmarks.py:186-207).  A stepped program has no architectural
registers or SRAM caches, so each family is mapped onto the region's state
with a documented fidelity envelope (SURVEY.md §7):

  * **registers** -> words of ``reg``/``ctrl`` leaves (loop-carried state),
    named like a register file (:class:`RegisterFile`);
  * **dcache / l2cache** -> a geometry-faithful overlay on the ``mem``
    leaves: a random (row, block, word) maps to a backing memory word when
    the line falls inside the program's footprint, and is *discarded as an
    invalid line* otherwise -- mirroring the plugin's valid-line queries
    (injector.pluginCommunicate, injector.py:74-123): an injection into an
    invalid/clean line never lands in the guest's dataflow;
  * **icache** -> control state (``ctrl`` + CFCSS signature leaves):
    an instruction-fetch corruption manifests as a control-flow error,
    which is precisely the fault class CFCSS exists to catch.

Geometry defaults are the pynq (Cortex-A9) table so campaign shapes stay
comparable with the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from coast_tpu_torch.inject.mem import MemoryMap
from coast_tpu_torch.inject.schedule import FaultSchedule

# Cache geometry (resources/benchmarks.py:186-207, board "pynq").
CACHE_INFO: Dict[str, Dict[str, Dict[str, int]]] = {
    "pynq": {
        "icache": {"size": 32768, "assoc": 4, "bSize": 32, "policy": 0},
        "dcache": {"size": 32768, "assoc": 4, "bSize": 32, "policy": 0},
        "l2cache": {"size": 524288, "assoc": 8, "bSize": 32, "policy": 1},
    },
}
# The accelerator "boards" keep the A9 geometry so campaign section weights
# match the reference's; alias rather than copy.
CACHE_INFO["tpu"] = CACHE_INFO["pynq"]
CACHE_INFO["gpu"] = CACHE_INFO["pynq"]


@dataclasses.dataclass(frozen=True)
class CacheData:
    """One cache's geometry (resources/mem.py:86-117)."""

    name: str
    size: int
    assoc: int
    block_size: int
    policy: int
    word_size: int = 4

    @property
    def rows(self) -> int:
        return self.size // (self.block_size * self.assoc)

    @property
    def words_per_block(self) -> int:
        return self.block_size // self.word_size

    @property
    def total_words(self) -> int:
        return self.size // self.word_size

    def random_word_cache_addr(self, rng: np.random.RandomState
                               ) -> Tuple[int, int, int]:
        """(row, block, word), uniform (randomWordCacheAddr mem.py:113-117)."""
        return (int(rng.randint(self.rows)),
                int(rng.randint(self.assoc)),
                int(rng.randint(self.words_per_block)))


class MemHierarchy:
    """All of a board's caches + size-weighted random choice
    (resources/mem.py:120-161)."""

    def __init__(self, board: str = "gpu"):
        if board not in CACHE_INFO:
            raise ValueError(f"Invalid board for cache setup: {board!r}")
        self.board = board
        self.caches: Dict[str, CacheData] = {
            name: CacheData(name, g["size"], g["assoc"], g["bSize"],
                            g["policy"])
            for name, g in CACHE_INFO[board].items()
        }
        self._names = list(self.caches)
        self._weights = np.array(
            [c.size for c in self.caches.values()], dtype=np.float64)
        self._weights /= self._weights.sum()

    def random_word_cache_addr(self, rng: np.random.RandomState,
                               cache_name: Optional[str] = None
                               ) -> Tuple[str, int, int, int]:
        if cache_name is None:
            cache_name = self._names[
                int(rng.choice(len(self._names), p=self._weights))]
        cache = self.caches[cache_name]
        return (cache_name, *cache.random_word_cache_addr(rng))


class RegisterFile:
    """Named pseudo-registers over the loop-carried state: the A9Register
    enum analogue (resources/registers.py:1-184).

    Every 32-bit word of a ``reg``/``ctrl`` leaf is one register; scalars
    keep the leaf name ('sp'), vector words are indexed ('moves[3]') --
    like r0..r15 / s0..s31 naming a physical register file.
    """

    def __init__(self, prog):
        self.prog = prog
        # (name, leaf_id, lane, word): replicated leaves contribute one
        # register file per lane (N independently corruptible copies, like
        # cloned globals at distinct addresses).
        self._rows: List[Tuple[str, int, int, int]] = []
        for leaf_id, (name, kind, lanes, words) in enumerate(
                prog.injectable_sections()):
            if kind not in ("reg", "ctrl"):
                continue
            for lane in range(lanes):
                suffix = f"@{lane}" if lanes > 1 else ""
                if words == 1:
                    self._rows.append((f"{name}{suffix}", leaf_id, lane, 0))
                else:
                    self._rows.extend(
                        (f"{name}[{w}]{suffix}", leaf_id, lane, w)
                        for w in range(words))
        if not self._rows:
            raise ValueError("program has no register-class leaves")

    @property
    def names(self) -> List[str]:
        return [r[0] for r in self._rows]

    def name_lookup(self, reg_str: str) -> Optional[Tuple[int, int, int]]:
        """(leaf_id, lane, word) for a register name, None if absent
        (nameLookup, registers.py:193-198)."""
        for name, leaf_id, lane, word in self._rows:
            if name == reg_str:
                return leaf_id, lane, word
        return None

    def random(self, rng: np.random.RandomState
               ) -> Tuple[str, int, int, int]:
        return self._rows[int(rng.randint(len(self._rows)))]


# What each cache overlays: instruction fetch corruption manifests in
# control/CFCSS state; data caches back the memory image.  Shared by the
# scalar mapping, the vectorised scheduler, and the supervisor's 'text'
# section alias.
ICACHE_KINDS = ("ctrl", "cfcss")
# Training regions' parameters and optimizer state (the train regions) are
# data in HBM like any KIND_MEM image: the dcache overlays them, and the
# supervisor's 'memory' section reaches them.  Regions without train
# leaves match nothing extra, so pre-train footprints are unchanged.
DCACHE_KINDS = ("mem", "ro", "param", "opt_state")


def _overlay_rows(mmap: MemoryMap, cache_name: str):
    """The (section_idx, section) rows a cache overlays, in map order --
    the single source of truth for the footprint mapping."""
    kinds = ICACHE_KINDS if cache_name == "icache" else DCACHE_KINDS
    return [(idx, s) for idx, s in enumerate(mmap.sections)
            if s.kind in kinds]


def cache_addr_to_fault(mmap: MemoryMap, cache: CacheData, row: int,
                        block: int, word: int
                        ) -> Optional[Tuple[int, int, int, int]]:
    """Map a (row, block, word) cache address onto an injectable word.

    Returns (leaf_id, lane, word, section_idx) of the backing word, or
    ``None`` when the line is outside the program footprint (an
    invalid-line injection, discarded exactly as the plugin's validity
    query discards it).

      * data caches overlay the ``mem``/``ro`` sections in memory-map
        order (physically-indexed cache over the address space);
      * the icache overlays control state (``ctrl`` and CFCSS leaves).
    """
    rows = _overlay_rows(mmap, cache.name)
    if not rows:
        return None
    linear = ((row * cache.assoc) + block) * cache.words_per_block + word
    total = sum(s.lanes * s.words for _, s in rows)
    # Footprint model: the cache is direct-mapped onto the program image;
    # lines past the image hold no program data (invalid).
    if linear >= total:
        return None
    for sec_idx, s in rows:
        sec_words = s.lanes * s.words
        if linear < sec_words:
            return (s.leaf_id, linear // s.words, linear % s.words, sec_idx)
        linear -= sec_words
    raise AssertionError("unreachable")


def generate_cache_schedule(mmap: MemoryMap, hierarchy: MemHierarchy,
                            n: int, seed: int, nominal_steps: int,
                            cache_name: Optional[str] = None
                            ) -> FaultSchedule:
    """A cache-section campaign schedule: n draws over the hierarchy,
    fully vectorised (one numpy pass per cache, no per-draw python loop --
    the schedule must not become the bottleneck of a 10^6-injection
    campaign).

    Non-resident draws keep their row in the schedule with ``t = -1`` --
    the flip never fires (the enable predicate requires t == step), and the
    run classifies as success, mirroring an injection the plugin discarded
    (logs mark them '<invalid-line>').
    """
    rng = np.random.RandomState(seed)
    bit = rng.randint(0, 32, n).astype(np.int32)
    t = rng.randint(0, max(nominal_steps, 1), n).astype(np.int32)
    if cache_name is None:
        cache_idx = rng.choice(len(hierarchy._names), size=n,
                               p=hierarchy._weights)
    else:
        cache_idx = np.full(n, hierarchy._names.index(cache_name))
    leaf_id = np.zeros(n, np.int32)
    lane = np.zeros(n, np.int32)
    word = np.zeros(n, np.int32)
    sec = np.zeros(n, np.int32)
    for ci, cname in enumerate(hierarchy._names):
        mask = cache_idx == ci
        k = int(mask.sum())
        if k == 0:
            continue
        c = hierarchy.caches[cname]
        row = rng.randint(0, c.rows, k)
        blk = rng.randint(0, c.assoc, k)
        w = rng.randint(0, c.words_per_block, k)
        linear = ((row * c.assoc) + blk) * c.words_per_block + w
        rows = _overlay_rows(mmap, cname)
        if not rows:
            t[mask] = -1
            continue
        sizes = np.array([s.lanes * s.words for _, s in rows])
        edges = np.cumsum(sizes)
        resident = linear < int(edges[-1])
        sidx = np.clip(np.searchsorted(edges, linear, side="right"),
                       0, len(rows) - 1)
        offs = linear - (edges[sidx] - sizes[sidx])
        words_per = np.array([s.words for _, s in rows])[sidx]
        leaf_id[mask] = np.where(
            resident, np.array([s.leaf_id for _, s in rows])[sidx], 0)
        lane[mask] = np.where(resident, offs // words_per, 0)
        word[mask] = np.where(resident, offs % words_per, 0)
        sec[mask] = np.where(resident,
                             np.array([i for i, _ in rows])[sidx], 0)
        t_m = t[mask]
        t_m[~resident] = -1
        t[mask] = t_m
    return FaultSchedule(leaf_id, lane, word, bit, t, sec, seed)
