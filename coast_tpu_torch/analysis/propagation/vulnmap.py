"""Static fault-propagation vulnerability map: ACE-style verdicts per
(section, bit class), before any campaign runs.

The counterpart of ``coast_tpu/analysis/propagation/vulnmap.py``, over the
port's shared walk of the captured protected step (:class:`StepFacts`).
Three verdicts are provable per memory-map section from the walk alone:

  * ``masked`` -- the leaf is dead state (it never influences another
    leaf, a flag or the check() verdict), so every injected bit is un-ACE.
  * ``detected-bounded`` -- every path a corrupted word can take to a step
    output crosses a sanctioned voter, guard or boundary sync: TMR
    corrects it, DWC latches it, the boundary sync witnesses it.
  * ``sdc-possible`` -- an unvoted escape path exists (value-fed
    arithmetic, a shared leaf every lane sees alike, a check()-read oracle
    leaf, per-lane guards or CFCSS, single-lane scopes), reported with a
    witness dataflow path.  This is where injection budget belongs.

Soundness contract: a section this pass calls ``masked`` or
``detected-bounded`` shows no silent-data-corruption outcome in a
campaign (:func:`crossvalidate_counts`).  Training regions take the
equivalence pass's typed fallback (``TRAIN_FALLBACK``): their outcome
classes depend on the bit's value, so every section is ``sdc-possible``.

Bit classes: a float32 leaf gets sign / exponent / mantissa, every 32-bit
integer leaf (uint32 words carried as int32 included) one ``word`` class.
Each row carries ``bits`` (lanes x words x class width) and ``ace_bits``
(the bits that can affect the outcome, scaled by the live share of the
flip window: sites at or past the fault-free halt step never fire).

Witness paths are the port's own vocabulary: the taint walk's
``aten.op(shape)`` entries, else the leaf's live dataflow cone over the
captured trips in trip order (then the check() cone), its first 8
entries.  They never equal the reference's jaxpr entries.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from coast_tpu_torch.analysis.propagation.walker import (StepFacts,
                                                         analyze_step)

__all__ = ["VERDICT_MASKED", "VERDICT_DETECTED", "VERDICT_SDC",
           "VERDICTS", "VulnRow", "VulnerabilityMap",
           "analyze_propagation", "crossvalidate_counts"]

VERDICT_MASKED = "masked"
VERDICT_DETECTED = "detected-bounded"
VERDICT_SDC = "sdc-possible"
#: Worst-last ordering: a section's verdict is the worst over its bit
#: classes, and the budget allocator sorts sdc-possible first.
VERDICTS = (VERDICT_MASKED, VERDICT_DETECTED, VERDICT_SDC)

_CLASS_BITS = {"word": 32, "sign": 1, "exponent": 8, "mantissa": 23}
_F32_CLASSES = ("sign", "exponent", "mantissa")
_WORD_CLASSES = ("word",)
#: Cone witnesses keep this many entries.
_CONE_MAX = 8


@dataclasses.dataclass(frozen=True)
class VulnRow:
    """One (section, bit-class) cell of the static vulnerability map."""

    section: str
    kind: str
    bit_class: str            # word | sign | exponent | mantissa
    verdict: str              # masked | detected-bounded | sdc-possible
    reason: str
    witness: Tuple[str, ...]  # dataflow path for sdc-possible, else ()
    bits: int                 # lanes x words x class width
    ace_bits: int             # bits that can affect the outcome

    def to_dict(self) -> Dict[str, object]:
        doc: Dict[str, object] = {
            "section": self.section, "kind": self.kind,
            "bit_class": self.bit_class, "verdict": self.verdict,
            "reason": self.reason, "bits": self.bits,
            "ace_bits": self.ace_bits,
        }
        if self.witness:
            doc["witness"] = list(self.witness)
        return doc


@dataclasses.dataclass
class VulnerabilityMap:
    """Per-section x per-bit-class static verdicts for one protected
    program, plus the ACE accounting the budget allocator reads."""

    benchmark: str
    num_clones: int
    clean_steps: int
    nominal_steps: int
    live_fraction: float
    rows: Dict[str, List[VulnRow]]       # section -> bit-class rows
    fallback_reason: Optional[str] = None
    #: Cross-shard influence reach, present iff the region's
    #: ``meta['shard_of']`` names a shard per section: leaf -> {reach,
    #: shards_reached, cross_shard}, the transitive closure of
    #: :attr:`StepFacts.out_taint` over steps.  Under vote-then-exchange a
    #: grid leaf's influence dies at the halo's commit vote (``cross_shard``
    #: false); under exchange-then-vote it ships raw through the unvoted
    #: commit and reaches the neighbour shard (``cross_shard`` true).
    shard_reach: Optional[Dict[str, Dict[str, object]]] = None

    def section_verdicts(self) -> Dict[str, str]:
        """Worst verdict per section (the budget unit)."""
        rank = {v: i for i, v in enumerate(VERDICTS)}
        return {name: max((r.verdict for r in rows), key=rank.get)
                for name, rows in self.rows.items()}

    def verdict(self, section: str) -> str:
        return self.section_verdicts()[section]

    def counts(self) -> Dict[str, int]:
        out = {v: 0 for v in VERDICTS}
        for v in self.section_verdicts().values():
            out[v] += 1
        return out

    def ace_summary(self) -> Dict[str, int]:
        total = ace = covered = exposed = 0
        for rows in self.rows.values():
            for r in rows:
                total += r.bits
                ace += r.ace_bits
                if r.verdict == VERDICT_DETECTED:
                    covered += r.ace_bits
                elif r.verdict == VERDICT_SDC:
                    exposed += r.ace_bits
        return {"total_bits": total, "ace_bits": ace,
                "detected_bounded_ace_bits": covered,
                "sdc_possible_ace_bits": exposed}

    def summary(self) -> Dict[str, object]:
        return {
            "benchmark": self.benchmark,
            "num_clones": self.num_clones,
            "clean_steps": self.clean_steps,
            "nominal_steps": self.nominal_steps,
            "live_fraction": round(self.live_fraction, 6),
            **({"fallback_reason": self.fallback_reason}
               if self.fallback_reason else {}),
            "verdict_counts": self.counts(),
            "ace": self.ace_summary(),
            **({"shard_reach": self.shard_reach}
               if self.shard_reach is not None else {}),
            "sections": {
                name: {"verdict": self.section_verdicts()[name],
                       "kind": rows[0].kind if rows else "?",
                       "bit_classes": [r.to_dict() for r in rows]}
                for name, rows in sorted(self.rows.items())},
        }

    def format(self) -> str:
        lines = [f"--- static vulnerability map: {self.benchmark} "
                 f"(N={self.num_clones}, live "
                 f"{100 * self.live_fraction:.0f}% of the flip window) ---"]
        verdicts = self.section_verdicts()
        for name in sorted(self.rows):
            rows = self.rows[name]
            ace = sum(r.ace_bits for r in rows)
            bits = sum(r.bits for r in rows)
            lines.append(f"  {name:<18} {verdicts[name]:<17} "
                         f"ace {ace}/{bits} bits  [{rows[0].kind}]")
            for r in rows:
                if r.verdict == VERDICT_SDC and r.witness:
                    lines.append(f"      {r.bit_class}: "
                                 + " -> ".join(r.witness))
        if self.shard_reach:
            crossers = sorted(n for n, d in self.shard_reach.items()
                              if d.get("cross_shard"))
            lines.append("  cross-shard reach: "
                         + (", ".join(crossers) if crossers
                            else "none (blast radius bounded per shard)"))
        c = self.counts()
        lines.append(f"  verdicts: {c[VERDICT_SDC]} sdc-possible, "
                     f"{c[VERDICT_DETECTED]} detected-bounded, "
                     f"{c[VERDICT_MASKED]} masked")
        return "\n".join(lines)

    def write_json(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.summary(), fh, indent=1, sort_keys=True)
            fh.write("\n")


def _bit_classes(dtype: Optional[torch.dtype]) -> Sequence[str]:
    return _F32_CLASSES if dtype == torch.float32 else _WORD_CLASSES


def _shard_reach(facts: StepFacts, shard_of: Mapping[str, Optional[int]]
                 ) -> Dict[str, Dict[str, object]]:
    """Transitive closure of the per-step influence edges, attributed to
    shards.  ``reach[leaf]`` is every leaf whose committed value a
    surviving corruption of ``leaf`` can eventually change; ``cross_shard``
    is True when that set holds a section of another shard than the
    source's own."""
    names = set(facts.out_taint)
    for srcs in facts.out_taint.values():
        names |= srcs
    adj: Dict[str, set] = {n: set() for n in names}
    for dst, srcs in facts.out_taint.items():
        for src in srcs:
            adj.setdefault(src, set()).add(dst)
    reach = {n: set(dsts) for n, dsts in adj.items()}
    changed = True
    while changed:
        changed = False
        for n in reach:
            step = set()
            for m in reach[n]:
                step |= reach.get(m, set())
            if not step <= reach[n]:
                reach[n] |= step
                changed = True
    out: Dict[str, Dict[str, object]] = {}
    for name in sorted(reach):
        own = shard_of.get(name)
        shards = sorted({shard_of.get(d) for d in reach[name]
                         if shard_of.get(d) is not None})
        doc: Dict[str, object] = {
            "reach": sorted(reach[name]),
            "shards_reached": shards,
        }
        if own is not None:
            doc["cross_shard"] = any(s != own for s in shards)
        out[name] = doc
    return out


def analyze_propagation(prog, closed=None, facts: Optional[StepFacts] = None,
                        partition=None) -> VulnerabilityMap:
    """Derive the static vulnerability map of ``prog``.

    ``closed``/``facts`` forward already captured trips / a shared walk
    (one walk serves the lint, the partition and this map); ``partition``
    forwards an :class:`~coast_tpu_torch.analysis.equiv.EquivPartition`
    whose ``clean_steps`` (one fault-free run on the program's device)
    then is not measured again."""
    from coast_tpu_torch.analysis.equiv.partition import (TRAIN_FALLBACK,
                                                          _clean_steps,
                                                          _cone_entries)
    region = prog.region
    if facts is None:
        facts = analyze_step(prog, closed=closed)
    clean_steps = (partition.clean_steps if partition is not None
                   else _clean_steps(prog))
    nominal = max(int(region.nominal_steps), 1)
    live_fraction = max(0.0, min(1.0, clean_steps / nominal))

    # Each region leaf's dtype, from its image on the CPU.
    dtypes = {k: v.dtype
              for k, v in region.init(torch.device("cpu")).items()}
    witnesses = getattr(facts.taint, "witness", {})

    def cone_witness(name: str) -> Tuple[str, ...]:
        cone: List[str] = []
        for w in facts.walks:
            _cone_entries(w.trip, w.walker.env, w.live, name, cone)
            if len(cone) >= _CONE_MAX:
                break
        if not cone and facts.check_closed is not None:
            cone.append("|check|")
            _cone_entries(facts.check_closed, facts.check_walker.env, None,
                          name, cone)
        return tuple(cone[:_CONE_MAX])

    def witness_of(name: str) -> Tuple[str, ...]:
        return tuple(witnesses.get(name, ())) or cone_witness(name)

    rows: Dict[str, List[VulnRow]] = {}
    for name, kind, lanes, words in prog.injectable_sections():
        replicated = bool(prog.replicated.get(name, kind == "cfcss"))
        check_read = name in facts.check_reads

        witness: Tuple[str, ...] = ()
        if facts.train_fallback:
            # Outcome classes depend on the flipped bit's value, so no
            # static masking or detection bound is sound.
            verdict, reason = VERDICT_SDC, TRAIN_FALLBACK
            witness = witness_of(name)
        elif replicated:
            if facts.cfcss or kind == "cfcss":
                verdict = VERDICT_SDC
                reason = ("CFCSS signature dataflow reads raw lane "
                          "values; detection is value-dependent")
                witness = witness_of(name)
            elif facts.guards:
                verdict = VERDICT_SDC
                reason = ("per-lane guards read raw replica values and "
                          "trip value-dependently")
                witness = witness_of(name)
            elif facts.fn_unsafe:
                verdict = VERDICT_SDC
                reason = ("single-lane function scope consumes raw lane "
                          "values (skipLibCalls/cloneAfterCall SPOF)")
                witness = witness_of(name)
            elif name in facts.lane_flagged:
                verdict = VERDICT_SDC
                reason = ("a live single-lane extraction consumes this "
                          "leaf's replicas outside a sanctioned voter")
                witness = witness_of(name)
            elif prog.pre_sync.get(name, False):
                verdict = VERDICT_DETECTED
                reason = ("pre-step vote repairs (TMR) or latches (DWC) "
                          "the flip before any read")
            elif name not in facts.written:
                verdict = VERDICT_DETECTED
                reason = ("unwritten replica: the flipped lane survives "
                          "verbatim, so the region-boundary sync "
                          "witnesses any divergence")
            elif name not in facts.taint.value_fed:
                verdict = VERDICT_DETECTED
                reason = ("structural routing only: every surviving word "
                          "reaches a sanctioned vote verbatim; "
                          "overwritten words are masked to the clean "
                          "outcome")
            else:
                verdict = VERDICT_SDC
                reason = ("value-fed: the flipped value enters arithmetic "
                          "that can mask or transform bits before any "
                          "voter (the crc shift-out / phase "
                          "predicate-steering class)")
                witness = witness_of(name)
        elif name not in facts.consumed and not check_read:
            verdict = VERDICT_MASKED
            reason = ("dead state: never influences another leaf, a "
                      "flag, or the check() verdict -- every bit is "
                      "un-ACE")
        else:
            verdict = VERDICT_SDC
            reason = ("shared state: corruption enters every lane "
                      "identically, so no replica disagreement exists "
                      "to vote on"
                      + ("; read by check() (oracle corruption "
                         "classifies as SDC)" if check_read else ""))
            witness = witness_of(name)

        section_rows: List[VulnRow] = []
        for bc in _bit_classes(dtypes.get(name)):
            bits = int(lanes) * int(words) * _CLASS_BITS[bc]
            ace = 0 if verdict == VERDICT_MASKED \
                else int(round(bits * live_fraction))
            note = reason
            if facts.train_fallback and bc == "mantissa":
                note = (reason + "; low-mantissa flips may re-converge "
                        "(train_self_heal) where the same word's "
                        "exponent bit persists -- the pinned "
                        "counterexample")
            section_rows.append(VulnRow(
                section=name, kind=kind, bit_class=bc, verdict=verdict,
                reason=note, witness=witness, bits=bits, ace_bits=ace))
        rows[name] = section_rows

    shard_of = (region.meta or {}).get("shard_of")
    return VulnerabilityMap(
        benchmark=region.name,
        num_clones=facts.num_clones,
        clean_steps=clean_steps,
        nominal_steps=nominal,
        live_fraction=live_fraction,
        rows=rows,
        fallback_reason=(TRAIN_FALLBACK if facts.train_fallback
                         else None),
        shard_reach=(_shard_reach(facts, shard_of)
                     if shard_of is not None else None))


def crossvalidate_counts(vmap: VulnerabilityMap,
                         section_counts: Mapping[str, Mapping[str, int]],
                         sdc_keys: Sequence[str] = ("sdc", "train_sdc"),
                         ) -> List[str]:
    """Soundness cross-validation against a campaign's per-section outcome
    distributions: ``section_counts`` maps section -> {class name: count}.
    Returns one violation string per section whose static verdict rules out
    silent corruption (``masked`` or ``detected-bounded``) but whose counts
    show some; an empty list is the proof obligation."""
    verdicts = vmap.section_verdicts()
    violations: List[str] = []
    for name, counts in sorted(section_counts.items()):
        verdict = verdicts.get(name)
        if verdict is None or verdict == VERDICT_SDC:
            continue
        recorded = sum(int(counts.get(k, 0)) for k in sdc_keys)
        if recorded:
            violations.append(
                f"{vmap.benchmark}:{name}: static verdict {verdict!r} "
                f"but the recorded campaign shows {recorded} "
                "silent-corruption outcome(s)")
    return violations
