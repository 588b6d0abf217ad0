"""Seeded fault schedules: where and when each campaign row flips its bits.

The counterpart of ``coast_tpu/inject/schedule.py``: one row per
injection, ``(leaf_id, lane, word, bit, t)``, drawn up front from a seed --
uniform over the injectable bits and over the nominal runtime -- so a
campaign is deterministic and replayable.  The stream is the reference's
counter-mode splitmix64 (``coast_tpu_torch/native.py``), so the same seed
gives the same schedule.

A :class:`FaultModel` turns each row into a flip GROUP: the base row keeps
the single-site layout (a ``single`` schedule is the historical stream)
and the extra sites live in ``FaultSchedule.extra``, a struct-of-arrays
with a group index, expanded from the seed by ``native.fault_expand``.
``generate(equiv=partition)`` reduces a single-bit schedule to one
representative a propagation class (``analysis/equiv``), each row carrying
its ``class_weight``.
"""

from __future__ import annotations

import dataclasses
import re
import sys
from typing import Dict, Optional

import numpy as np

from coast_tpu_torch.inject.mem import MemoryMap
from coast_tpu_torch.native import fault_expand, splitmix_fill

__all__ = ["SITE_KEYS", "FaultModel", "FaultSchedule", "generate",
           "generate_stratified", "generate_stratified_total", "link_steps",
           "splitmix_fill"]

#: Site-column names shared by the base rows and the extra-site arrays.
SITE_KEYS = ("leaf_id", "lane", "word", "bit", "t")


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """How many bits one injection flips, and how they correlate.

    * ``single`` -- one bit, one word, one step (the default).
    * ``multibit(k)`` -- k distinct bits of the same word at one step.
    * ``cluster(span, k)`` -- k flips in adjacent words of one leaf: each
      extra site lands 1..span words past the base site in the lane-major
      word space, so a cluster can cross replica (lane) boundaries.
    * ``burst(window, rate)`` -- ``round(window * rate)`` sites (at least
      one), each at a fresh uniform location, fired at ``t0 + U[0,
      window)`` clamped to the nominal window.
    * ``link(offset, period)`` -- one bit of a ``link``-kind section (the
      in-flight words of a sharded region), at a step of the receive
      window ``offset + i * period``.  Where a map has link sections they
      are this model's exclusive surface: every other model's base draw
      maps onto the complement.

    Two sites of one cluster or burst group may coincide; their XORs then
    cancel, as a double upset of one cell restores it."""

    kind: str = "single"
    k: int = 1            # sites for multibit/cluster
    span: int = 1         # max word offset of a cluster site
    window: int = 1       # burst time window (steps)
    rate: float = 1.0     # burst flips per step within the window
    t_offset: int = 0     # link only: t = offset + i * period
    t_period: int = 0

    def __post_init__(self):
        if self.kind not in ("single", "multibit", "cluster", "burst",
                             "link"):
            raise ValueError(f"unknown fault-model kind {self.kind!r}")
        if self.kind == "multibit" and not (2 <= self.k <= 32):
            raise ValueError("multibit needs 2 <= k <= 32 (distinct bits "
                             "of one 32-bit word)")
        if self.kind == "cluster" and (self.k < 2 or self.span < 1):
            raise ValueError("cluster needs k >= 2 sites and span >= 1")
        if self.kind == "burst" and (self.window < 1 or self.rate <= 0):
            raise ValueError("burst needs window >= 1 and rate > 0")
        if self.kind == "link":
            if self.t_offset < 0 or self.t_period < 0:
                raise ValueError("link needs offset >= 0 and period >= 0")
            if self.t_period == 0 and self.t_offset != 0:
                raise ValueError(
                    "link offset without a period is meaningless (the "
                    "window is offset + i*period); pass period too")
        elif self.t_offset or self.t_period:
            raise ValueError(
                f"offset/period are link-model arguments, not {self.kind!r}")

    @classmethod
    def single(cls) -> "FaultModel":
        return cls()

    @classmethod
    def multibit(cls, k: int = 2) -> "FaultModel":
        return cls(kind="multibit", k=int(k))

    @classmethod
    def cluster(cls, span: int = 4, k: int = 2) -> "FaultModel":
        return cls(kind="cluster", span=int(span), k=int(k))

    @classmethod
    def burst(cls, window: int = 8, rate: float = 0.25) -> "FaultModel":
        return cls(kind="burst", window=int(window), rate=float(rate))

    @classmethod
    def link(cls, offset: int = 0, period: int = 0) -> "FaultModel":
        return cls(kind="link", t_offset=int(offset), t_period=int(period))

    @property
    def sites(self) -> int:
        """Flip sites per injection (the group size; 1 is the single-site
        path)."""
        if self.kind in ("multibit", "cluster"):
            return self.k
        if self.kind == "burst":
            return max(1, int(round(self.window * self.rate)))
        return 1

    def spec(self) -> str:
        """Canonical string form (the CLI vocabulary)."""
        if self.kind == "multibit":
            return f"multibit(k={self.k})"
        if self.kind == "cluster":
            return f"cluster(span={self.span},k={self.k})"
        if self.kind == "burst":
            return f"burst(window={self.window},rate={self.rate:g})"
        if self.kind == "link":
            if self.t_period:
                return f"link(offset={self.t_offset},period={self.t_period})"
            return "link"
        return "single"

    @classmethod
    def parse(cls, text: str) -> "FaultModel":
        """Parse ``single``, ``multibit(k=3)`` / ``multibit:k=3`` / bare
        ``multibit`` (defaults), and likewise for the other kinds."""
        text = text.strip()
        m = re.fullmatch(r"(\w+)(?:[:(]([^()]*)\)?)?", text)
        if not m:
            raise ValueError(f"unparseable fault model {text!r}")
        kind, argstr = m.group(1), (m.group(2) or "").strip()
        args: Dict[str, float] = {}
        if argstr:
            for part in argstr.split(","):
                key, eq, val = part.partition("=")
                if not eq:
                    raise ValueError(
                        f"fault-model argument {part!r} is not key=value")
                args[key.strip()] = float(val)
        try:
            if kind == "single":
                if args:
                    raise ValueError("single takes no arguments")
                return cls.single()
            if kind == "multibit":
                return cls.multibit(k=int(args.pop("k", 2)), **args)
            if kind == "cluster":
                return cls.cluster(span=int(args.pop("span", 4)),
                                   k=int(args.pop("k", 2)), **args)
            if kind == "burst":
                return cls.burst(window=int(args.pop("window", 8)),
                                 rate=args.pop("rate", 0.25), **args)
            if kind == "link":
                return cls.link(offset=int(args.pop("offset", 0)),
                                period=int(args.pop("period", 0)), **args)
        except TypeError as e:
            raise ValueError(f"bad fault-model arguments in {text!r}: {e}")
        raise ValueError(f"unknown fault-model kind {kind!r} in {text!r}")


@dataclasses.dataclass
class FaultSchedule:
    """One campaign's worth of injection targets (numpy).

    The five site columns hold each injection's base site (site 0).  A
    multi-site model adds ``extra``: the other ``sites - 1`` flips of every
    injection, site-major, keyed ``group`` + :data:`SITE_KEYS`, where extra
    row ``i * (sites - 1) + (j - 1)`` is injection i's site j.

    A schedule whose rows are a contiguous window of one ``generate()``
    stream records the stream's length (``gen_stream_n``), the window's
    offset in it (``gen_lo``) and the step modulus of its t column
    (``gen_steps``): the device generator (``inject/device_gen.py``)
    regenerates every row from those and the seed.  None for schedules the
    stream cannot reproduce row by row (stratified strata,
    equivalence-reduced subsets).

    An equivalence-reduced schedule's rows are propagation-class
    representatives, row i standing for ``class_weight[i]`` drawn sites
    (int64); ``equiv_sha`` is the partition's fingerprint, part of the
    campaign's identity.  Both are None for an exhaustive schedule."""

    leaf_id: np.ndarray   # int32 [n]
    lane: np.ndarray      # int32 [n]
    word: np.ndarray      # int32 [n]
    bit: np.ndarray       # int32 [n]
    t: np.ndarray         # int32 [n] step index of the flip
    section_idx: np.ndarray  # int32 [n] index into MemoryMap.sections
    seed: int
    extra: Optional[Dict[str, np.ndarray]] = None
    model: FaultModel = FaultModel()
    class_weight: Optional[np.ndarray] = None   # int64 [n]
    equiv_sha: Optional[str] = None
    gen_stream_n: Optional[int] = None
    gen_lo: int = 0
    gen_steps: Optional[int] = None

    def __len__(self) -> int:
        return len(self.leaf_id)

    @property
    def effective_n(self) -> int:
        """Injections this schedule represents: the row count, or the
        summed class weights of a reduced schedule."""
        if self.class_weight is None:
            return len(self)
        return int(self.class_weight.sum())

    @property
    def sites(self) -> int:
        """Flip sites per injection (1 unless a multi-site model)."""
        return 1 if self.extra is None else self.model.sites

    def device_arrays(self) -> Dict[str, np.ndarray]:
        """The fault columns the engine takes: [n] for single sites, [n,
        sites] for flip groups (column 0 the base site)."""
        if self.extra is None:
            return {k: getattr(self, k) for k in SITE_KEYS}
        n, e = len(self), self.sites - 1
        return {k: np.concatenate([getattr(self, k)[:, None],
                                   self.extra[k].reshape(n, e)], axis=1)
                for k in SITE_KEYS}

    def slice(self, lo: int, hi: int) -> "FaultSchedule":
        extra = None
        if self.extra is not None:
            e = self.sites - 1
            extra = {k: v[lo * e:hi * e] for k, v in self.extra.items()}
            extra["group"] = (extra["group"] - np.int32(lo)).astype(np.int32)
        return FaultSchedule(
            self.leaf_id[lo:hi], self.lane[lo:hi], self.word[lo:hi],
            self.bit[lo:hi], self.t[lo:hi], self.section_idx[lo:hi],
            self.seed, extra=extra, model=self.model,
            class_weight=(None if self.class_weight is None
                          else self.class_weight[lo:hi]),
            equiv_sha=self.equiv_sha,
            gen_stream_n=self.gen_stream_n, gen_lo=self.gen_lo + lo,
            gen_steps=self.gen_steps)


def _expand(mmap: MemoryMap, sched: FaultSchedule, model: FaultModel,
            seed: int, nominal_steps: int) -> FaultSchedule:
    """Attach a multi-site model's extra flip-group rows to a base
    schedule."""
    if model.kind == "single":
        return sched
    sched.model = model
    if model.sites == 1:          # e.g. burst(window*rate <= 1): base only
        return sched
    base = {"leaf_id": sched.leaf_id, "lane": sched.lane,
            "word": sched.word, "bit": sched.bit, "t": sched.t,
            "section_idx": sched.section_idx}
    group, leaf_id, lane, word, bit, t = fault_expand(
        seed, model.kind, model.sites, model.span, model.window,
        max(nominal_steps, 1), base, mmap.section_tables())
    sched.extra = {"group": group, "leaf_id": leaf_id, "lane": lane,
                   "word": word, "bit": bit, "t": t}
    return sched


def _draw_tables(mmap: MemoryMap, link: bool):
    """Draw remapping tables for the sections with (link=True) or without
    (link=False) ``kind == 'link'``: per-section bit sizes, local
    cumulative edges and each section's global flat-bit start."""
    idx = [i for i, s in enumerate(mmap.sections)
           if (s.kind == "link") == link]
    sizes = np.array([mmap.sections[i].bits for i in idx], np.int64)
    local_edges = np.cumsum(sizes)
    all_edges = np.cumsum([s.bits for s in mmap.sections]).astype(np.int64)
    global_starts = np.array(
        [all_edges[i] - mmap.sections[i].bits for i in idx], np.int64)
    return sizes, local_edges, global_starts


def _nonlink_sites(mmap: MemoryMap, raws: np.ndarray) -> np.ndarray:
    """Base-site draws of every non-link model: uniform over the non-link
    sections' bits, relocated into the global flat space.  Without link
    sections this is ``raws % total_bits``."""
    if not any(s.kind == "link" for s in mmap.sections):
        return (raws % np.uint64(mmap.total_bits)).astype(np.int64)
    sizes, local_edges, global_starts = _draw_tables(mmap, link=False)
    if not len(sizes):
        raise ValueError(
            "every injectable section is link-kind: non-link fault "
            "models have no compute/memory surface to draw from")
    local = (raws % np.uint64(int(local_edges[-1]))).astype(np.int64)
    li = np.searchsorted(local_edges, local, side="right")
    return global_starts[li] + (local - (local_edges[li] - sizes[li]))


def generate(mmap: MemoryMap, n: int, seed: int, nominal_steps: int,
             model: Optional[FaultModel] = None,
             equiv=None) -> FaultSchedule:
    """n seeded draws: uniform over the injectable bits x uniform over the
    nominal runtime window.  ``model`` makes each draw a flip group whose
    base sites are this same stream.

    ``equiv`` (an :class:`~coast_tpu_torch.analysis.equiv.EquivPartition`)
    reduces the draws to one representative a realized propagation class:
    the first draw of each class, in stream order, with ``class_weight``
    so the counts multiply back out to n.  Defined for the single-bit
    model only."""
    raw = splitmix_fill(seed, 2 * n)
    if model is not None and model.kind == "link":
        if equiv is not None:
            raise ValueError(
                "equiv= reduction is defined for the single-bit "
                f"fault model, not {model.spec()!r}: link draws are "
                "restricted to the interconnect sections and their "
                "receive window, which the site-equivalence partition "
                "does not reason about")
        return _generate_link(mmap, raw, n, seed, nominal_steps, model)
    flat_bits = _nonlink_sites(mmap, raw[:n])
    t = (raw[n:] % np.uint64(max(nominal_steps, 1))).astype(np.int32)
    leaf_id, lane, word, bit, sec_idx = mmap.decode(flat_bits)
    sched = FaultSchedule(leaf_id, lane, word, bit, t,
                          sec_idx.astype(np.int32), seed, gen_stream_n=n,
                          gen_steps=max(nominal_steps, 1))
    if model is not None and model.kind != "single":
        if equiv is not None:
            raise ValueError(
                "equiv= reduction is defined for the single-bit "
                f"fault model, not {model.spec()!r}: a flip GROUP's "
                "outcome is not a function of one site's "
                "propagation class")
        return _expand(mmap, sched, model, seed, nominal_steps)
    if equiv is not None:
        return equiv.reduce(sched)
    return sched


def link_steps(model: FaultModel, nominal_steps: int) -> int:
    """How many distinct steps a link model's t column can take inside the
    nominal runtime (shared by the host and device generators)."""
    steps = max(nominal_steps, 1)
    if model.t_period <= 0:
        return steps
    k = len(range(model.t_offset, steps, model.t_period))
    if k < 1:
        raise ValueError(
            f"link window offset={model.t_offset} starts past the nominal "
            f"runtime ({steps} steps): no receive step to flip at")
    return k


def _generate_link(mmap: MemoryMap, raw: np.ndarray, n: int, seed: int,
                   nominal_steps: int, model: FaultModel) -> FaultSchedule:
    """Link-model draws: the same raw stream as ``generate``, the site
    draws mapped onto the link-kind sections' bits and the t draws into
    the receive window."""
    sizes, local_edges, global_starts = _draw_tables(mmap, link=True)
    if not len(sizes):
        raise ValueError(
            "fault model 'link' needs at least one link-kind section "
            "(ir/region.KIND_LINK leaf) in the injectable map; this "
            "benchmark exposes none -- it has no interconnect surface")
    local = (raw[:n] % np.uint64(int(local_edges[-1]))).astype(np.int64)
    li = np.searchsorted(local_edges, local, side="right")
    flat_bits = global_starts[li] + (local - (local_edges[li] - sizes[li]))
    k = link_steps(model, nominal_steps)
    draws = (raw[n:] % np.uint64(k)).astype(np.int64)
    if model.t_period > 0:
        t = (model.t_offset + draws * model.t_period).astype(np.int32)
    else:
        t = draws.astype(np.int32)
    leaf_id, lane, word, bit, sec_idx = mmap.decode(flat_bits)
    return FaultSchedule(leaf_id, lane, word, bit, t,
                         sec_idx.astype(np.int32), seed, model=model,
                         gen_stream_n=n, gen_steps=max(nominal_steps, 1))


def generate_stratified(mmap: MemoryMap, n_per_section: int, seed: int,
                        nominal_steps: int,
                        model: Optional[FaultModel] = None) -> FaultSchedule:
    """``n_per_section`` seeded draws into each non-link section, section
    by section; each section's sub-stream is keyed by a draw from the
    master seed.  ``model`` expands the rows into flip groups as in
    ``generate`` (keyed by the master seed)."""
    if model is not None and model.kind == "link":
        raise ValueError(
            "stratified allocation contradicts the 'link' fault model: "
            "link draws target ONLY the link-kind sections (use "
            "generate() with the link model instead)")
    keys = splitmix_fill(seed, len(mmap.sections))
    section_start = np.cumsum([0] + [s.bits for s in mmap.sections])
    flat_parts, t_parts = [], []
    for idx, sec in enumerate(mmap.sections):
        if sec.kind == "link":
            # Keys stay indexed by global section position, so the other
            # strata's sub-streams do not move.
            continue
        raw = splitmix_fill(int(keys[idx]), 2 * n_per_section)
        offs = (raw[:n_per_section] % np.uint64(sec.bits)).astype(np.int64)
        t_parts.append((raw[n_per_section:]
                        % np.uint64(max(nominal_steps, 1))).astype(np.int32))
        flat_parts.append(section_start[idx] + offs)
    leaf_id, lane, word, bit, sec_idx = mmap.decode(
        np.concatenate(flat_parts))
    sched = FaultSchedule(leaf_id, lane, word, bit, np.concatenate(t_parts),
                          sec_idx.astype(np.int32), seed)
    if model is None or model.kind == "single":
        return sched
    return _expand(mmap, sched, model, seed, nominal_steps)


def generate_stratified_total(mmap: MemoryMap, total: int, seed: int,
                              nominal_steps: int,
                              model: Optional[FaultModel] = None
                              ) -> FaultSchedule:
    """A stratified schedule sized by a total budget: ``max(1, total //
    n_sections)`` draws a section.  A realized size more than 10 % off
    ``total`` prints a one-line warning."""
    n_sections = sum(1 for s in mmap.sections if s.kind != "link")
    n_per = max(1, total // max(n_sections, 1))
    realized = n_per * n_sections
    if total > 0 and abs(realized - total) > 0.10 * total:
        print(f"warning: stratified budget {total} realized as {realized} "
              f"rows ({n_sections} sections x {n_per}/section, "
              f"{100.0 * abs(realized - total) / total:.0f}% off the "
              "requested budget)", file=sys.stderr)
    return generate_stratified(mmap, n_per, seed, nominal_steps, model=model)
