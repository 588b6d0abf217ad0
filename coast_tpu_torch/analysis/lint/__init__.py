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
(``__main__.py``; ``--all`` sweeps the benchmark REGISTRY).  The
reference's third pass, the lane-isolation prover (``propagation=``), is
ROADMAP Queue A item 17c and raises ``NotImplementedError`` here.
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

#: What the isolation prover's refusal names.
PROPAGATION_ITEM = ("the lane-isolation prover is not ported yet; see "
                    "ROADMAP Queue A item 17c")


def lint_program(prog, provenance: bool = True, survival: bool = True,
                 strategy: Optional[str] = None,
                 baseline: Optional[Set[str]] = None,
                 closed=None, propagation: bool = False) -> LintReport:
    """Run the requested lint levels over a ProtectedProgram.  ``closed``
    forwards already captured trips (:func:`trace_step`; callers that
    also dump the step capture once and share)."""
    if propagation:
        raise NotImplementedError(PROPAGATION_ITEM)
    name = strategy or f"N={prog.cfg.num_clones}"
    report = LintReport(benchmark=prog.region.name, strategy=name)
    replicated = prog.cfg.num_clones > 1 and prog._any_replicated
    if closed is None and replicated and (provenance or survival):
        closed = trace_step(prog)
    if provenance:
        lint_provenance(prog, report, closed=closed)
    if survival:
        lint_survival(prog, report, closed=closed)
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
