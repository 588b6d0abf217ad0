"""Static fault-propagation analysis over the captured protected step.

The counterpart of ``coast_tpu/analysis/propagation``.  The shared
fault-propagation walker (:mod:`walker`) is ported: one walk of the
captured trips feeds the equivalence partition (``analysis/equiv``).  The
static vulnerability map (``vulnmap``) and the lane-isolation prover
(``isolation``) that consume the same :class:`StepFacts` are ROADMAP Queue
A item 17c: importing either from this package, or any of their names, or
calling :func:`analyze_propagation`, raises ``NotImplementedError``.
"""

from __future__ import annotations

from coast_tpu_torch.analysis.propagation.walker import (StepFacts,
                                                         TraceTaint,
                                                         analyze_step,
                                                         cross_lane_sites)

__all__ = ["StepFacts", "TraceTaint", "analyze_step", "cross_lane_sites",
           "analyze_propagation"]

#: What the refusals of the unported consumers name.
PROPAGATION_ITEM = ("the static vulnerability map and the lane-isolation "
                    "prover are not ported yet; see ROADMAP Queue A item "
                    "17c")

# The reference's names that the two unported modules bring.
_LATER = frozenset({
    "vulnmap", "isolation", "VERDICT_MASKED", "VERDICT_DETECTED",
    "VERDICT_SDC", "VERDICTS", "VulnRow", "VulnerabilityMap",
    "crossvalidate_counts", "IsolationProof", "Leak", "prove_isolation",
    "seeded_voter_bypass"})


def analyze_propagation(*args, **kwargs):
    """The static vulnerability map: ROADMAP Queue A item 17c."""
    raise NotImplementedError(PROPAGATION_ITEM)


def __getattr__(name: str):
    if name in _LATER:
        raise NotImplementedError(PROPAGATION_ITEM)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
