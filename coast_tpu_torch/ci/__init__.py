"""Protection-regression CI: campaign analysis cheap enough to gate merges.

The port's copy of ``coast_tpu/ci``: the same pipeline, artifact and exit
codes, with every build and campaign on a device (the card unless the
caller passes ``device="cpu"`` / ``-d cpu``).

Every ingredient existed before this package; none had been composed
into one verb.  Equivalence classes cut physical injections ~10-26x
(:mod:`coast_tpu_torch.analysis.equiv`), delta campaigns re-inject only
the sections whose dataflow fingerprint changed (``run_delta``),
``--stop-when`` bounds each campaign by Wilson-CI width
(:mod:`coast_tpu_torch.obs.convergence`), and the fleet runs campaigns in
parallel workers behind a persistent compile cache
(:mod:`coast_tpu_torch.fleet`).  Composed, they make FastFlip's
(arXiv:2403.13989) end-game practical: a per-commit fault-injection
verdict in minutes, not campaign-hours, with FuzzyFlow-style
(arXiv:2306.16178) differential discipline -- the reduced delta run is
only trusted because its splice base records exhaustive-equivalent
ground truth.

The pipeline (``python -m coast_tpu_torch ci``, see docs/ci.md):

  1. **baseline** -- run the target campaigns once (equivalence-reduced,
     journaled) and commit the artifact: per-target counts, per-section
     dataflow fingerprints, and the journal records a later delta can
     splice from.
  2. **check** -- rebuild each target from the CURRENT tree, diff its
     section fingerprints against the baseline, enqueue one DELTA item
     per target on a fleet queue (re-injecting only changed sections,
     each convergence-bounded per section), drain it through fleet
     workers sharing the compile cache, and compare the resulting
     classification distribution against the baseline's: per-class
     Wilson intervals must overlap, and a new or vanished outcome class
     is drift by definition.  Exit codes are typed: 0 pass, 1 drift,
     2 infrastructure failure.
  3. **refresh** -- check, then overwrite the baseline with the
     refreshed artifact when (and only when) the check passed.

Identity throughout is the one shared
:class:`~coast_tpu_torch.inject.spec.CampaignSpec` vocabulary: the
baseline stores specs in their queue-item encoding, the queue items ARE that
encoding, and the journals the deltas splice from validate against the
same fields.
"""

from __future__ import annotations

from coast_tpu_torch.ci.baseline import (BASELINE_FORMAT,
                                         BASELINE_VERSION, load_baseline,
                                         materialize_journal, target_id,
                                         write_baseline)
from coast_tpu_torch.ci.engine import (EXIT_DRIFT, EXIT_INFRA, EXIT_PASS,
                                       CiInfraError, CiReport, TargetReport,
                                       build_baseline, check_baseline,
                                       default_specs)

__all__ = [
    "BASELINE_FORMAT", "BASELINE_VERSION", "load_baseline",
    "write_baseline", "materialize_journal", "target_id",
    "CiInfraError", "CiReport", "TargetReport", "build_baseline",
    "check_baseline", "default_specs",
    "EXIT_PASS", "EXIT_DRIFT", "EXIT_INFRA",
]
