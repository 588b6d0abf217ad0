"""Finding/report model of the replication-integrity linter.

The port's copy of ``coast_tpu/analysis/lint/findings.py``: the same
rule ids, severities, loci, report JSON and baseline files.

The reference refuses to emit a binary when its post-pass checks fail
(verifyCloningSuccess, cloning.cpp:2305-2376, gated by ``-noCloneOpsCheck``;
SoR verification exits -1).  The linter reports *structured* findings
instead -- ``(rule id, severity, locus, message)`` -- so the same result
can gate ``opt`` (exit nonzero on errors), be exported as JSON next to
``-dumpModule``, and be baselined/suppressed for incremental adoption
(the FuzzyFlow/FastFlip workflow of PAPERS.md: per-cutout findings you
triage once and pin).

Severities:

  * ``error`` -- redundancy is broken or contradicts the config; gating.
  * ``warning`` -- suspicious but not provably wrong (e.g. an extra vote).
  * ``note``  -- accepted by configuration (the ``skipLibCalls`` SPOF
    allowlist); the SPOF report's "known single points of failure".

Suppression/baseline file: a JSON doc ``{"suppress": [<fingerprint>...]}``
where a fingerprint is ``benchmark:rule:locus`` (the stable identity of a
finding, deliberately excluding the message text; benchmark-scoped so a
baseline written for one program cannot mask the same-named error in
another).  ``LintReport.write_baseline`` emits one from the current
findings; ``apply_baseline`` marks matching findings suppressed so they
stop gating without being deleted from the report.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterable, List, Set

SEVERITIES = ("error", "warning", "note")


@dataclasses.dataclass
class Finding:
    """One linter finding."""

    rule: str              # e.g. "lane-collapse", "voter-coverage"
    severity: str          # error | warning | note
    locus: str             # leaf/eqn locus, e.g. "leaf:buf" / "eqn:reduce_sum"
    message: str
    suppressed: bool = False

    def to_dict(self) -> Dict[str, object]:
        return {"rule": self.rule, "severity": self.severity,
                "locus": self.locus, "message": self.message,
                "suppressed": self.suppressed}

    def format(self) -> str:
        sup = " [suppressed]" if self.suppressed else ""
        return f"{self.severity}{sup}: [{self.rule}] {self.locus}: " \
               f"{self.message}"


@dataclasses.dataclass
class LintReport:
    """All findings for one protected program."""

    benchmark: str
    strategy: str
    findings: List[Finding] = dataclasses.field(default_factory=list)
    # Which passes ran (provenance / coverage / survival): honest scope
    # reporting -- a clean report that skipped survival is not a clean
    # survival report.
    passes_run: List[str] = dataclasses.field(default_factory=list)

    def add(self, rule: str, severity: str, locus: str, message: str) -> None:
        if severity not in SEVERITIES:
            raise ValueError(f"bad severity {severity!r}")
        self.findings.append(Finding(rule, severity, locus, message))

    def extend(self, other: "LintReport") -> None:
        self.findings.extend(other.findings)
        for p in other.passes_run:
            if p not in self.passes_run:
                self.passes_run.append(p)

    # -- gating ---------------------------------------------------------
    def errors(self) -> List[Finding]:
        return [f for f in self.findings
                if f.severity == "error" and not f.suppressed]

    @property
    def ok(self) -> bool:
        return not self.errors()

    def counts(self) -> Dict[str, int]:
        out = {s: 0 for s in SEVERITIES}
        for f in self.findings:
            if not f.suppressed:
                out[f.severity] += 1
        out["suppressed"] = sum(1 for f in self.findings if f.suppressed)
        return out

    # -- baseline / suppression -----------------------------------------
    def fingerprint_of(self, f: Finding) -> str:
        """Benchmark-scoped stable identity: generic loci (``hlo:select``
        and friends) repeat across programs, so an un-scoped fingerprint
        from one benchmark would silently suppress a NEW error anywhere
        else."""
        return f"{self.benchmark}:{f.rule}:{f.locus}"

    def apply_baseline(self, fingerprints: Set[str]) -> None:
        for f in self.findings:
            if self.fingerprint_of(f) in fingerprints:
                f.suppressed = True

    def write_baseline(self, path: str) -> None:
        write_baseline_set([self], path)

    # -- serialization ---------------------------------------------------
    def sorted_findings(self) -> List[Finding]:
        """Findings in deterministic artifact order: stable sort by
        ``rule:locus``, so exports diff cleanly in CI even when pass
        internals reorder their emission (dict/walk order is an
        implementation detail; the artifact's order must not be).
        Ties (same rule+locus, different message) keep emission order --
        the sort is stable."""
        return sorted(self.findings, key=lambda f: (f.rule, f.locus))

    def to_dict(self) -> Dict[str, object]:
        return {
            "benchmark": self.benchmark,
            "strategy": self.strategy,
            "passes_run": list(self.passes_run),
            "counts": self.counts(),
            "ok": self.ok,
            "findings": [f.to_dict() for f in self.sorted_findings()],
        }

    def write_json(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_dict(), fh, indent=1)
            fh.write("\n")

    def format(self, include_notes: bool = True) -> str:
        c = self.counts()
        lines = [f"=== lint {self.benchmark} [{self.strategy}] "
                 f"({', '.join(self.passes_run) or 'no passes'}): "
                 f"{c['error']} error(s), {c['warning']} warning(s), "
                 f"{c['note']} note(s), {c['suppressed']} suppressed ==="]
        for f in self.findings:
            if f.severity == "note" and not include_notes:
                continue
            lines.append("  " + f.format())
        return "\n".join(lines)


class ReplicationLintError(Exception):
    """Raised by gating call sites (opt's -noCloneOpsCheck default, the
    CampaignRunner pre-flight) when a lint report carries unsuppressed
    errors -- the analogue of verifyCloningSuccess's refusal to emit."""

    def __init__(self, report: LintReport):
        self.report = report
        super().__init__(report.format(include_notes=False))


def write_baseline_set(reports: Iterable[LintReport], path: str) -> None:
    """One baseline covering several reports, each finding fingerprinted
    under its own report's benchmark (NOT a merged report's placeholder
    name -- merging first would lose the scoping)."""
    fps: Set[str] = set()
    for r in reports:
        fps.update(r.fingerprint_of(f) for f in r.findings)
    with open(path, "w") as fh:
        json.dump({"suppress": sorted(fps)}, fh, indent=1)
        fh.write("\n")


def load_baseline(path: str) -> Set[str]:
    with open(path) as fh:
        doc = json.load(fh)
    if not isinstance(doc, dict) or not isinstance(
            doc.get("suppress"), list):
        raise ValueError(f"{path}: not a lint baseline "
                         '(expected {"suppress": [...]})')
    return set(str(s) for s in doc["suppress"])


def merge_reports(reports: Iterable[LintReport],
                  benchmark: str = "<multi>",
                  strategy: str = "<multi>") -> LintReport:
    out = LintReport(benchmark=benchmark, strategy=strategy)
    for r in reports:
        out.extend(r)
    return out
