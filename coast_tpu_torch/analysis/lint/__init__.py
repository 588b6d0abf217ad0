"""Replication-integrity linter: does the protected program still carry
its redundancy?

The counterpart of ``coast_tpu/analysis/lint``, with its rule names,
severities, loci, report JSON and baseline files.  Two levels:

  * :mod:`provenance` -- static lane-provenance rules over the captured
    protected step (:mod:`capture`: the aten operations of one fault-free
    run's trips on the CPU): lane-collapse, SPOF, voter coverage against
    the ProtectionConfig, unreplicated imports;
  * :mod:`survival` -- checks of the program the port runs: every tagged
    vote reaches a voter (K1/K2 site records on the card), the semantic
    lane probe, the segmented CSE fingerprint.

Entry points::

    from coast_tpu_torch.analysis import lint
    report = lint.lint_program(prog)              # both levels
    report = lint.lint_program(prog, survival=False)   # static only
    lint.check(prog)        # raise ReplicationLintError on errors

CLI: ``python -m coast_tpu_torch.analysis.lint -TMR matrixMultiply crc16``
(``__main__.py``; ``--all`` sweeps the benchmark REGISTRY).
``propagation=True`` adds the third static pass, the lane-isolation
noninterference prover (``analysis/propagation``): each refuted leak is an
``isolation-leak`` error finding with its counterexample path.
"""

from __future__ import annotations

from typing import Optional, Set

from coast_tpu_torch.analysis.lint.findings import (Finding, LintReport,
                                                    ReplicationLintError,
                                                    load_baseline,
                                                    merge_reports)
from coast_tpu_torch.analysis.lint.provenance import (expected_sync_classes,
                                                      lint_provenance,
                                                      trace_step)
from coast_tpu_torch.analysis.lint.survival import lint_survival

__all__ = ["Finding", "LintReport", "ReplicationLintError", "check",
           "expected_sync_classes", "lint_program", "lint_provenance",
           "lint_survival", "load_baseline", "merge_reports", "trace_step"]


def lint_program(prog, provenance: bool = True, survival: bool = True,
                 strategy: Optional[str] = None,
                 baseline: Optional[Set[str]] = None,
                 closed=None, propagation: bool = False,
                 facts=None) -> LintReport:
    """Run the requested lint levels over a ProtectedProgram.  ``closed``
    forwards already captured trips (:func:`trace_step`; callers that
    also dump the step capture once and share).

    ``propagation`` adds the lane-isolation noninterference prover
    (:func:`~coast_tpu_torch.analysis.propagation.prove_isolation`); each
    refuted leak lands as an ``isolation-leak`` error finding carrying its
    counterexample path, so the standard gates (``opt``,
    ``CampaignRunner(preflight=)``) cover it.  ``facts`` forwards an
    already built shared walk (``analyze_step``), so callers that also
    build the vulnerability map walk once."""
    name = strategy or f"N={prog.cfg.num_clones}"
    report = LintReport(benchmark=prog.region.name, strategy=name)
    replicated = prog.cfg.num_clones > 1 and prog._any_replicated
    if closed is None and facts is not None:
        closed = facts.closed
    if closed is None and replicated and (provenance or survival
                                          or propagation):
        closed = trace_step(prog)
    if provenance:
        lint_provenance(prog, report, closed=closed)
    if survival:
        lint_survival(prog, report, closed=closed)
    if propagation:
        from coast_tpu_torch.analysis.propagation import prove_isolation
        report.passes_run.append("propagation")
        proof = prove_isolation(prog, closed=closed, facts=facts,
                                strategy=name)
        for leak in proof.leaks:
            report.add(
                "isolation-leak", "error", f"output:{leak.output}",
                f"noninterference refuted: {leak.source} reaches step "
                f"output '{leak.output}' without a sanctioned vote "
                "(counterexample: " + " -> ".join(leak.path) + ")")
        if proof.total_leak_paths > len(proof.leaks):
            report.add(
                "isolation-leak", "error", "output:<more>",
                f"{proof.total_leak_paths - len(proof.leaks)} further "
                "leak path(s) suppressed from the report")
    if baseline:
        report.apply_baseline(baseline)
    return report


def check(prog, provenance: bool = True, survival: bool = True,
          baseline: Optional[Set[str]] = None,
          propagation: bool = False) -> LintReport:
    """Gate: lint and raise :class:`ReplicationLintError` on any
    unsuppressed error finding (the refuse-to-emit analogue)."""
    report = lint_program(prog, provenance=provenance, survival=survival,
                          baseline=baseline, propagation=propagation)
    if not report.ok:
        raise ReplicationLintError(report)
    return report
