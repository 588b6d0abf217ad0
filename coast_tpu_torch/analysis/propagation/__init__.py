"""Static fault-propagation analysis over the captured protected step.

The counterpart of ``coast_tpu/analysis/propagation``: one shared
fault-propagation walk of the captured trips (:mod:`walker`) feeds the
equivalence partition (``analysis/equiv``) and the two passes here:

  * :mod:`vulnmap` -- the ACE-style **static vulnerability map**: each
    (memory-map section, bit class) gets a verdict -- ``masked``,
    ``detected-bounded`` or ``sdc-possible`` with a witness dataflow path
    -- cross-validated against campaign distributions;
  * :mod:`isolation` -- the **lane-isolation noninterference prover**:
    flips in replica lanes cannot flow into other lanes, shared state or
    step flags except through sanctioned voted commits; refutations carry
    counterexample paths, and :func:`seeded_voter_bypass` is the generic
    seeded regression.

Wired as: the ``opt`` build gate and ``-propOut=``, ``python -m
coast_tpu_torch.analysis.lint --propagation``, ``CampaignRunner(preflight=
"propagation")``, the delta-campaign budget allocator
(``run_delta(static_budget=True)``) and the advisor's ``static_seed``.
"""

from __future__ import annotations

from coast_tpu_torch.analysis.propagation.walker import (StepFacts,
                                                         TraceTaint,
                                                         analyze_step,
                                                         cross_lane_sites)
from coast_tpu_torch.analysis.propagation.vulnmap import (
    VERDICT_DETECTED, VERDICT_MASKED, VERDICT_SDC, VERDICTS, VulnRow,
    VulnerabilityMap, analyze_propagation, crossvalidate_counts)
from coast_tpu_torch.analysis.propagation.isolation import (
    IsolationProof, Leak, prove_isolation, seeded_voter_bypass)

__all__ = ["StepFacts", "TraceTaint", "analyze_step", "cross_lane_sites",
           "VERDICT_MASKED", "VERDICT_DETECTED", "VERDICT_SDC", "VERDICTS",
           "VulnRow", "VulnerabilityMap", "analyze_propagation",
           "crossvalidate_counts", "IsolationProof", "Leak",
           "prove_isolation", "seeded_voter_bypass"]
