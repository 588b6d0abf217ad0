"""CampaignSpec: the one campaign-identity vocabulary of the port.

The counterpart of ``coast_tpu/inject/spec.py``, kept field for field and
key for key: a journal header the port writes must equal the reference's
(``tests/test_torch_journal.py`` holds them equal), so a journal resumes
under either package.  Two encodings exist on disk:

  * ``run_header_fields()`` emits the journal's absent-means-default
    subset (``fault_model``/``stop_when`` omitted at their defaults, and
    placed by the runner at their historical header positions);
  * ``to_item()`` emits the fleet queue-item dict (``fault_model`` always
    present, ``stop_when`` an explicit null, ``delta_from`` only when
    set), which the fleet (:mod:`coast_tpu_torch.fleet`) enqueues.

``from_item`` / ``from_header`` invert the two encodings.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

__all__ = ["CampaignSpec", "SpecError", "FAULT_MODEL_DEFAULT",
           "COLLECT_DEFAULT", "PLACEMENT_DEFAULT", "FUSE_DEFAULT",
           "header_collect", "header_placement", "header_fuse"]

#: The journal-evolution default: an absent ``fault_model`` key means
#: the historical single-bit flip (journals and queue items written
#: before the key existed carry none).
FAULT_MODEL_DEFAULT = "single"

#: Same evolution rule for the collection mode: an absent ``collect``
#: key means the historical dense per-row fetch.
COLLECT_DEFAULT = "dense"

#: Same evolution rule for the voter placement (sharded benchmarks'
#: factory knob): an absent ``placement`` key means the registry build
#: -- vote-then-exchange (``"compute"``).  Journals and queue items
#: written before the knob existed stay byte-identical and still
#: open/resume.
PLACEMENT_DEFAULT = "compute"

#: Same evolution rule for the fused protected-step engine: an absent
#: ``fuse`` key means the historical unfused interpreter loop.  The
#: fused path is pinned bit-identical, but the *program* the campaign
#: measured (op counts, kernel schedule, MFU attribution) differs, so
#: fuse mode is campaign identity -- resuming a journal under the other
#: engine is refused typed rather than silently blending measurements.
FUSE_DEFAULT = False


class SpecError(ValueError):
    """A malformed campaign spec (bad n, unknown fault model, equiv over
    a flip-group model, unparseable stop condition, delta misuse)."""


@dataclasses.dataclass(frozen=True)
class CampaignSpec:
    """One campaign's identity, in canonical normalized form.

    Field semantics (shared verbatim by the journal header, the queue
    item, and the delta identity):

    ``benchmark``
        Registry name or restricted-C source path.
    ``n``
        Requested injections.  For equivalence-reduced campaigns this is
        the EFFECTIVE count; the physical representative count is a
        property of the partition, not of the identity.
    ``opt_passes``
        Protection flags (opt CLI string) -- the protection-config
        source.  The journal header pins the derived ``config_sha``
        instead; the queue item carries the flags so a worker can
        rebuild the program.
    ``section`` / ``seed`` / ``start_num`` / ``batch_size`` / ``unroll``
        As everywhere else.  ``batch_size`` is volatile for resume
        (journal ``_VOLATILE_KEYS``) but part of the queue item.
    ``fault_model``
        ``FaultModel.spec()`` string; ``"single"`` is the default and is
        OMITTED from journal headers (absent-means-single rule).
    ``equiv``
        Equivalence reduction on/off.  The journal header carries the
        derived partition fingerprint block instead of the flag; the
        flag is what a worker needs to rebuild the runner.
    ``stop_when``
        Canonical ``StopWhen.spec()`` string or None.  Part of resume
        identity (an early-stopped journal's rows are a prefix chosen BY
        the condition).
    ``throttle_s``
        Operator rate limit; fleet-item-only, never identity.
    ``delta_from``
        Path to a completed equiv run journal to splice unchanged
        sections from.  Fleet-item-only (the CI's delta items); never
        part of the journal header (a delta campaign's output is a
        plain run result).
    ``static_budget``
        Delta campaigns only: allocate the per-section convergence
        budget by the static vulnerability map
        (``analysis/propagation``) -- ``sdc-possible``
        sections re-inject first and statically-proven sections run
        under a relaxed ``min_done`` floor.  Fleet-item-only like
        ``delta_from`` (it shapes HOW the delta spends budget, not what
        the result means); joins the item dict only when set, so every
        pre-existing item stays byte-identical.
    ``placement``
        Voter placement of a sharded benchmark (the stencil's
        ``make_region(placement=...)`` knob): ``"compute"`` (default;
        vote-then-exchange -- the registry build) or ``"link"``
        (exchange-then-vote).  Campaign identity: the two placements are
        DIFFERENT programs (different halo leaf shape, different blast
        radius), so resuming one under the other must refuse with a
        typed error naming the knob.  Absent-means-compute everywhere,
        so every pre-placement journal and queue item stays
        byte-identical.
    ``collect``
        Result-collection mode: ``"dense"`` (default; every row's
        outcome columns cross the host boundary, the historical
        behavior) or ``"sparse"`` (device-resident loop: flip sites
        regenerate on device, only per-batch histograms plus the
        compacted interesting rows come back).  Campaign identity: a
        sparse journal's batch records are histogram + interesting-row
        records, so resuming one under dense (or vice versa) must
        refuse.  Absent-means-dense everywhere (journals, queue items,
        and logs written before the mode existed stay byte-identical).
    """

    benchmark: str
    n: int
    seed: int = 0
    opt_passes: str = "-TMR"
    section: str = "memory"
    batch_size: int = 4096
    start_num: int = 0
    fault_model: str = FAULT_MODEL_DEFAULT
    equiv: bool = False
    stop_when: Optional[str] = None
    unroll: int = 1
    throttle_s: float = 0.0
    delta_from: Optional[str] = None
    collect: str = COLLECT_DEFAULT
    static_budget: bool = False
    placement: str = PLACEMENT_DEFAULT

    # -- validation ----------------------------------------------------------
    def validate(self) -> "CampaignSpec":
        """Raise :class:`SpecError` (or the parser's own typed error) on
        a spec no campaign could run.  Returns self so call sites can
        chain.  Validation happens at the BOUNDARY (enqueue, CLI parse,
        baseline load) so a bad spec fails its author, not a worker an
        hour later."""
        if self.n <= 0:
            raise SpecError(f"campaign wants n={self.n} injections; "
                            "need > 0")
        if self.fault_model != FAULT_MODEL_DEFAULT:
            from coast_tpu_torch.inject.schedule import FaultModel
            FaultModel.parse(self.fault_model)   # ValueError on typos
            if self.equiv:
                raise SpecError(
                    "equiv=True needs the single-bit fault model")
        if self.stop_when:
            from coast_tpu_torch.obs.convergence import StopWhen
            StopWhen.parse(self.stop_when)       # StopWhenError on typos
        if self.delta_from and not self.equiv:
            raise SpecError(
                "delta_from needs equiv=True: the equivalence partition "
                "supplies the per-section fingerprints a delta diffs")
        if self.collect not in ("dense", "sparse"):
            raise SpecError(
                f"unknown collect mode {self.collect!r}; one of "
                "'dense', 'sparse'")
        if self.placement not in ("compute", "link"):
            raise SpecError(
                f"unknown voter placement {self.placement!r}; one of "
                "'compute' (vote-then-exchange), 'link' "
                "(exchange-then-vote)")
        if self.delta_from and self.collect != COLLECT_DEFAULT:
            raise SpecError(
                "delta_from campaigns are dense by construction (the "
                "spliced rows are exact per-row journal records); drop "
                "collect='sparse'")
        if self.static_budget and not (self.delta_from and self.stop_when):
            raise SpecError(
                "static_budget allocates a DELTA campaign's per-section "
                "convergence budget; it needs delta_from AND stop_when")
        return self

    # -- parsed accessors ----------------------------------------------------
    def fault_model_parsed(self):
        """FaultModel instance, or None for the single-bit default (the
        shape CampaignRunner(fault_model=) takes)."""
        if self.fault_model == FAULT_MODEL_DEFAULT:
            return None
        from coast_tpu_torch.inject.schedule import FaultModel
        return FaultModel.parse(self.fault_model)

    def stop_when_parsed(self):
        """StopWhen instance, or None."""
        if not self.stop_when:
            return None
        from coast_tpu_torch.obs.convergence import StopWhen
        return StopWhen.parse(self.stop_when)

    # -- queue-item encoding (fleet/queue.py) --------------------------------
    def to_item(self) -> Dict[str, object]:
        """The fleet queue item dict, bit-compatible with the historical
        ``item_spec`` output: same keys, same order, same explicit-null
        conventions -- enqueue ids sha the sorted JSON of this dict, so
        its shape IS on-disk compatibility.  ``delta_from`` joins only
        when set, keeping every pre-delta item byte-identical."""
        doc: Dict[str, object] = {
            "benchmark": str(self.benchmark),
            "opt_passes": str(self.opt_passes),
            "section": str(self.section), "n": int(self.n),
            "seed": int(self.seed), "start_num": int(self.start_num),
            "batch_size": int(self.batch_size),
            "fault_model": str(self.fault_model),
            "equiv": bool(self.equiv),
            "stop_when": self.stop_when if self.stop_when else None,
            "unroll": int(self.unroll),
            "throttle_s": float(self.throttle_s),
        }
        if self.delta_from:
            doc["delta_from"] = str(self.delta_from)
        if self.static_budget:
            # Joins only when set (like delta_from): pre-existing item
            # dicts -- and their sha'd enqueue ids -- stay byte-identical.
            doc["static_budget"] = True
        if self.collect != COLLECT_DEFAULT:
            # Joins only when sparse (like delta_from): enqueue ids sha
            # the item dict, so every pre-sparse item stays byte-
            # identical.
            doc["collect"] = str(self.collect)
        if self.placement != PLACEMENT_DEFAULT:
            # Joins only when non-default (same byte-identity argument).
            doc["placement"] = str(self.placement)
        return doc

    @classmethod
    def from_item(cls, spec: Dict[str, object]) -> "CampaignSpec":
        """Inverse of :meth:`to_item`, tolerant of absent keys (items
        enqueued by older code lack the newer ones)."""
        return cls(
            benchmark=str(spec["benchmark"]),
            n=int(spec["n"]),
            seed=int(spec.get("seed", 0)),
            opt_passes=str(spec.get("opt_passes", "-TMR")),
            section=str(spec.get("section", "memory")),
            batch_size=int(spec.get("batch_size", 4096)),
            start_num=int(spec.get("start_num", 0)),
            fault_model=str(spec.get("fault_model",
                                     FAULT_MODEL_DEFAULT)),
            equiv=bool(spec.get("equiv", False)),
            stop_when=spec.get("stop_when") or None,
            unroll=int(spec.get("unroll", 1)),
            throttle_s=float(spec.get("throttle_s", 0.0) or 0.0),
            delta_from=spec.get("delta_from") or None,
            collect=str(spec.get("collect", COLLECT_DEFAULT)
                        or COLLECT_DEFAULT),
            static_budget=bool(spec.get("static_budget", False)),
            placement=header_placement(spec),
        )

    # -- journal-header encoding (inject/journal.py) -------------------------
    def run_header_fields(self) -> Dict[str, object]:
        """The spec-owned fields of a ``mode: "run"`` journal header, in
        the header's historical key order (headers are serialized
        without sort_keys, so order is byte parity): seed, n, start_num,
        batch_size.  ``fault_model`` and ``stop_when`` are deliberately
        NOT here -- the runner places them at their historical header
        positions, and both follow absent-means-default evolution rules
        (:func:`header_fault_model`)."""
        return {"seed": int(self.seed), "n": int(self.n),
                "start_num": int(self.start_num),
                "batch_size": int(self.batch_size)}

    @classmethod
    def from_header(cls, header: Dict[str, object],
                    opt_passes: str = "-TMR",
                    section: str = "memory") -> "CampaignSpec":
        """Extract the identity vocabulary from a ``mode: "run"``
        journal header.  The header pins ``config_sha`` rather than the
        opt flag string (and carries no section), so those two are
        caller-supplied when known; everything else -- including the
        absent-means-default rules for ``fault_model``/``stop_when`` and
        equiv-block presence -- decodes here, the one place the rules
        are spelled."""
        return cls(
            benchmark=str(header.get("benchmark")),
            n=int(header.get("n", 0)),
            seed=int(header.get("seed", 0)),
            opt_passes=opt_passes,
            section=section,
            batch_size=int(header.get("batch_size", 4096)),
            start_num=int(header.get("start_num", 0)),
            fault_model=header_fault_model(header),
            equiv=bool(header.get("equiv")),
            stop_when=header.get("stop_when") or None,
            collect=header_collect(header),
            placement=header_placement(header),
        )

    # -- delta identity (analysis/equiv/delta.py) ----------------------------
    def delta_identity(self) -> Dict[str, object]:
        """The spec-owned half of delta-splice identity: the keys that
        must match between a delta base journal and the current campaign
        for the recorded outcomes to be reusable at all.  (``mode`` and
        ``strategy`` are header-level facts outside the spec; the
        protection config is deliberately absent -- the config changing
        is the whole point of a delta.)"""
        doc = {"benchmark": str(self.benchmark), "seed": int(self.seed),
               "n": int(self.n), "start_num": int(self.start_num),
               "fault_model": str(self.fault_model)}
        if self.placement != PLACEMENT_DEFAULT:
            # A placement change is a different REGION (different leaf
            # shapes, different blast radius), not just a different
            # protection config: spliced outcomes would be meaningless.
            # Only-when-set keeps every pre-placement identity dict --
            # and its comparisons -- byte-identical.
            doc["placement"] = str(self.placement)
        return doc


def header_fault_model(header: Dict[str, object]) -> str:
    """The fault-model journal-evolution rule, spelled once: an absent
    ``fault_model`` header key means the historical single-bit model."""
    return str(header.get("fault_model", FAULT_MODEL_DEFAULT)
               or FAULT_MODEL_DEFAULT)


def header_collect(header: Dict[str, object]) -> str:
    """The collection-mode evolution rule, spelled once: an absent
    ``collect`` header key means the historical dense per-row fetch."""
    return str(header.get("collect", COLLECT_DEFAULT) or COLLECT_DEFAULT)


def header_placement(header: Dict[str, object]) -> str:
    """The voter-placement evolution rule, spelled once: an absent
    ``placement`` key means the registry build -- vote-then-exchange
    (``"compute"``).  Pre-placement journals and queue items decode (and
    resume) unchanged."""
    return str(header.get("placement", PLACEMENT_DEFAULT)
               or PLACEMENT_DEFAULT)


def header_fuse(header: Dict[str, object]) -> bool:
    """The fused-engine evolution rule, spelled once: an absent ``fuse``
    key means the historical unfused interpreter loop.  Pre-fusion
    journals and queue items decode (and resume) unchanged."""
    return bool(header.get("fuse", FUSE_DEFAULT))
