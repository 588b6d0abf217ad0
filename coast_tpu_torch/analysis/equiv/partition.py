"""Propagation-equivalence partition over the fault-site space.

The counterpart of ``coast_tpu/analysis/equiv/partition.py``.  A seeded
campaign draws sites ``(leaf, lane, word, bit, t)`` uniformly over the
injectable bits; most draws land in state whose downstream dataflow
provably carries any single-bit corruption to the same classification.
This pass reads the shared walk of the captured protected step
(:func:`~coast_tpu_torch.analysis.propagation.walker.analyze_step`) and
derives, per memory-map section, a *merge mode*: which site coordinates
provably cannot change the outcome class.

  * ``FREE`` (class = leaf): an unconsumed shared leaf whose only use is
    an equality-compare cone in ``check()`` (the ``golden`` matrix: any
    flipped bit turns exactly one compare, SDC whatever the lane, word,
    bit and t), or an unconsumed, unwritten replicated leaf.
  * ``LT`` (class = leaf x t): a replicated leaf voted before any read
    (the ``load_addr`` sync), or one the step never writes (the flipped
    lane survives verbatim to the region-boundary sync).
  * ``LTW`` (class = leaf x t x word): a written replicated leaf whose
    value flows only through structural operators between its flip and a
    sanctioned vote or its commit: the word is overwritten (masked) or
    reaches a voter (detected), as a function of ``(t, word)``.
  * ``EXH`` (class = the site itself): every value-fed leaf, shared
    consumed leaves, leaves behind a live single-lane extraction, and
    every replicated leaf of a region with kernel guards, CFCSS or
    single-lane function scopes.

Every site whose ``t`` lies at or past the fault-free halt step joins one
global ``dead`` class: the run has halted before the flip would fire.

The modes, ``clean_steps``, class keys, representatives and weights equal
the reference's.  The fingerprints are the port's own: a cone entry is an
aten operator and its output shape (``aten.add.Tensor(2, 3)``, shapes of
the two-row capture), so a partition fingerprint never equals the
reference's.  The partition is validated differentially: a reduced
campaign's weighted distribution equals the exhaustive one's
(``tests/test_torch_equiv.py``).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional

import numpy as np
import torch

from coast_tpu_torch.analysis.lint.capture import Trip
from coast_tpu_torch.analysis.propagation.walker import (analyze_step,
                                                         node_entry)

__all__ = ["MODE_FREE", "MODE_LT", "MODE_LTW", "MODE_EXH", "MODE_NAMES",
           "TRAIN_FALLBACK", "SectionSignature", "EquivPartition",
           "analyze_equivalence", "section_fingerprints"]

# Merge modes, coarsest first.  The class key keeps only the coordinates
# the mode names.
MODE_FREE = 0      # class = (leaf,)
MODE_LT = 1        # class = (leaf, t)
MODE_LTW = 2       # class = (leaf, t, word)
MODE_EXH = 3       # class = (leaf, t, word, bit, lane) -- no merge

MODE_NAMES = ("free", "lt", "ltw", "exhaustive")

#: ``EquivPartition.fallback_reason`` of a training region: the outcome
#: class of a train SDC depends on the numeric value of the flip (a
#: low-mantissa weight flip self-heals where an exponent bit diverges), so
#: no merge mode but the dead class is sound and every section is
#: exhaustive.
TRAIN_FALLBACK = ("train_probe outcome semantics are bit-value-dependent; "
                  "all sections forced exhaustive")


@dataclasses.dataclass(frozen=True)
class SectionSignature:
    """One memory-map section's propagation signature."""

    name: str
    kind: str
    leaf_id: int
    lanes: int
    words: int
    replicated: bool
    written: bool
    consumed: bool
    value_fed: bool
    pre_voted: bool
    step_voted: bool
    mode: int                  # MODE_* merge decision
    fingerprint: str           # sha256 over signature + dataflow cone

    @property
    def mode_name(self) -> str:
        return MODE_NAMES[self.mode]


@dataclasses.dataclass
class EquivPartition:
    """The derived partition: per-section signatures and the site
    classifier the injection stack consumes."""

    benchmark: str
    num_clones: int
    clean_steps: int
    signatures: Dict[str, SectionSignature]
    fingerprint: str           # sha over all section fps + clean_steps
    # Non-None when every section was forced exhaustive (TRAIN_FALLBACK);
    # the dead class still merges.
    fallback_reason: Optional[str] = None

    def _mode_table(self) -> np.ndarray:
        n = max((s.leaf_id for s in self.signatures.values()),
                default=-1) + 1
        table = np.full(n + 1, MODE_EXH, np.int8)
        for sig in self.signatures.values():
            table[sig.leaf_id] = sig.mode
        return table

    def class_keys(self, sched) -> np.ndarray:
        """int64 [n, 5] class-key rows for a FaultSchedule; equal rows are
        provably outcome-equivalent sites."""
        n = len(sched)
        leaf = np.asarray(sched.leaf_id, np.int64)
        lane = np.asarray(sched.lane, np.int64)
        word = np.asarray(sched.word, np.int64)
        bit = np.asarray(sched.bit, np.int64)
        t = np.asarray(sched.t, np.int64)
        modes = self._mode_table()[np.clip(leaf, 0, None)]
        keys = np.stack([leaf, t, word, bit, lane], axis=1)
        keys[modes == MODE_FREE, 1:] = -2
        keys[modes == MODE_LT, 2:] = -3
        keys[modes == MODE_LTW, 3:] = -4
        # Sites at or past the fault-free halt step never fire: one dead
        # class.
        keys[t >= self.clean_steps] = -1
        # Draws outside the footprint (t < 0) keep their full identity:
        # the runner buckets them as cache_invalid.
        neg = t < 0
        if neg.any():
            keys[neg] = np.stack([leaf, t, word, bit, lane], axis=1)[neg]
        assert keys.shape == (n, 5)
        return keys

    def reduce(self, sched):
        """One seeded representative per realized class: a FaultSchedule
        of the first-drawn site of each class, with ``class_weight`` = the
        draws it stands for.  Rows keep schedule order."""
        from coast_tpu_torch.inject.schedule import FaultSchedule
        keys = self.class_keys(sched)
        _, first, counts = np.unique(keys, axis=0, return_index=True,
                                     return_counts=True)
        order = np.argsort(first, kind="stable")
        rep = first[order]
        weights = counts[order].astype(np.int64)
        return FaultSchedule(
            *(np.ascontiguousarray(getattr(sched, f)[rep])
              for f in ("leaf_id", "lane", "word", "bit", "t",
                        "section_idx")),
            sched.seed, model=sched.model, class_weight=weights,
            equiv_sha=self.fingerprint)

    def summary(self) -> Dict[str, object]:
        return {
            "benchmark": self.benchmark,
            "num_clones": self.num_clones,
            "clean_steps": self.clean_steps,
            "fingerprint": self.fingerprint,
            **({"fallback_reason": self.fallback_reason}
               if self.fallback_reason else {}),
            "sections": {
                name: {"mode": sig.mode_name,
                       "fingerprint": sig.fingerprint}
                for name, sig in sorted(self.signatures.items())},
        }


def _cone_entries(trip: Trip, env, live, name: str, out: List[str]) -> None:
    """Trip-order ``op(shape)`` entries of the live nodes whose output
    provenance includes ``name``: the leaf's dataflow cone, the raw
    material of its fingerprint."""
    for i, node in enumerate(trip.nodes):
        if live is not None and i not in live:
            continue
        for j, vid in enumerate(node.outs):
            val = env.get(vid)
            if val is not None and name in val.deps:
                out.append(node_entry(node, j))
                break


# Operators an indicator value passes through in an equality-compare cone.
_IND_OK = frozenset({"sum", "any", "add", "_to_copy", "expand", "view",
                     "_unsafe_view", "reshape", "squeeze", "permute"})


def _check_transparent(check: Optional[Trip], name: str) -> bool:
    """True when ``check()``'s consumption of shared leaf ``name`` is an
    equality-compare indicator cone: leaf -> ``eq``/``ne`` against an
    untainted operand -> {sum, any, add, _to_copy, views} -> E.  A
    completed run with one flipped bit anywhere in the leaf then yields
    E >= 1 (SDC for every site), or, if the leaf never reaches E, success
    for every site.  Anything else is opaque."""
    if check is None or name not in check.state_in:
        return False
    raw, ind = "raw", "ind"
    env = {check.state_in[name]: raw}
    for node in check.nodes:
        tainted = [env[v] for v in node.ins if v in env]
        if not tainted:
            continue
        if node.packet in ("eq", "ne"):
            if raw in tainted and len(tainted) == 1:
                for v in node.outs:
                    env[v] = ind
                continue
            return False
        if raw in tainted or node.packet not in _IND_OK:
            return False
        for v in node.outs:
            env[v] = ind
    return True


def _clean_steps(prog) -> int:
    """First step index at which the fault-free run is halted, on the
    program's own device: the flip window's hard edge."""
    with torch.no_grad():
        rec = prog.run(None)
    return int(rec["steps"])


def analyze_equivalence(prog, closed=None, facts=None) -> EquivPartition:
    """Derive the propagation-equivalence partition of ``prog``'s fault-site
    space.  ``closed`` forwards already captured trips; ``facts`` a whole
    shared-walk result (:func:`analyze_step`)."""
    cfg = prog.cfg
    region = prog.region
    n = cfg.num_clones
    if facts is None:
        facts = analyze_step(prog, closed=closed, track_paths=False)
    taint = facts.taint
    written, consumed = facts.written, facts.consumed
    clean_steps = _clean_steps(prog)

    signatures: Dict[str, SectionSignature] = {}
    for leaf_id, (name, kind, lanes, words) in enumerate(
            prog.injectable_sections()):
        replicated = bool(prog.replicated.get(name, kind == "cfcss"))
        is_written = name in written
        is_consumed = name in consumed
        value_fed = name in taint.value_fed
        pre_voted = bool(prog.pre_sync.get(name, False))
        step_voted = bool(prog.step_sync.get(name, False))

        if facts.train_fallback:
            mode = MODE_EXH
        elif replicated:
            if (facts.cfcss or facts.guards or facts.fn_unsafe
                    or kind == "cfcss" or name in facts.lane_flagged):
                mode = MODE_EXH
            elif pre_voted:
                # Repaired (TMR) or latched (DWC) before any read.
                mode = MODE_LT
            elif not is_written:
                mode = MODE_FREE if not is_consumed else MODE_LT
            elif not value_fed:
                mode = MODE_LTW
            else:
                mode = MODE_EXH
        else:
            if not is_consumed and not is_written \
                    and _check_transparent(facts.check_closed, name):
                mode = MODE_FREE
            else:
                mode = MODE_EXH

        cone: List[str] = []
        for w in facts.walks:
            _cone_entries(w.trip, w.walker.env, w.live, name, cone)
        if facts.check_closed is not None:
            cone.append("|check|")
            _cone_entries(facts.check_closed, facts.check_walker.env, None,
                          name, cone)
        h = hashlib.sha256()
        h.update(repr((name, kind, lanes, words, replicated, is_written,
                       is_consumed, value_fed, pre_voted, step_voted,
                       MODE_NAMES[mode], n, clean_steps)).encode())
        h.update("|".join(cone).encode())
        signatures[name] = SectionSignature(
            name=name, kind=kind, leaf_id=leaf_id, lanes=lanes,
            words=words, replicated=replicated, written=is_written,
            consumed=is_consumed, value_fed=value_fed,
            pre_voted=pre_voted, step_voted=step_voted, mode=mode,
            fingerprint=h.hexdigest())

    overall = hashlib.sha256()
    overall.update(str(clean_steps).encode())
    for name in sorted(signatures):
        overall.update(name.encode())
        overall.update(signatures[name].fingerprint.encode())
    return EquivPartition(
        benchmark=region.name, num_clones=n, clean_steps=clean_steps,
        signatures=signatures, fingerprint=overall.hexdigest(),
        fallback_reason=TRAIN_FALLBACK if facts.train_fallback else None)


def section_fingerprints(prog, partition: Optional[EquivPartition] = None
                         ) -> Dict[str, str]:
    """Per-section propagation fingerprints: the delta-campaign identity
    the journal header records.  A section whose fingerprint is unchanged
    across a rebuild has the same dataflow cone, sync coverage and merge
    mode, so its recorded outcomes remain valid."""
    if partition is None:
        partition = analyze_equivalence(prog)
    return {name: sig.fingerprint
            for name, sig in partition.signatures.items()}
