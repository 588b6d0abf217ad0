"""Fault-site equivalence analysis: inject one representative per
propagation class.

The counterpart of ``coast_tpu/analysis/equiv``:

  * :mod:`partition` -- the static pass: read the shared walk of the
    captured protected step (``analysis/propagation/walker.py``), derive a
    per-section propagation signature and partition the fault-site space
    (leaf x lane x word x bit x step) into classes whose members provably
    classify alike;
  * :mod:`delta` -- delta campaigns: the per-section fingerprints a
    journal header records let a later run re-inject only the sections
    whose propagation changed, splicing the recorded outcomes of the rest.

The reduced campaign's weighted distribution equals the exhaustive one's
(``tests/test_torch_equiv.py``; the reference's record is
``artifacts/equiv_study.json``).
"""

from __future__ import annotations

from coast_tpu_torch.analysis.equiv.partition import (TRAIN_FALLBACK,
                                                      EquivPartition,
                                                      SectionSignature,
                                                      analyze_equivalence,
                                                      section_fingerprints)
from coast_tpu_torch.analysis.equiv.delta import (DeltaMismatchError,
                                                  DeltaPlan, load_delta_base,
                                                  plan_delta)

__all__ = ["EquivPartition", "SectionSignature", "analyze_equivalence",
           "section_fingerprints", "DeltaMismatchError", "DeltaPlan",
           "load_delta_base", "plan_delta", "TRAIN_FALLBACK"]
