"""The port's equivalence partition over the second half of the registry,
TMR and DWC.

For each registry name and strategy the partition's ``clean_steps``, its
section count and its count of each merge mode equal the reference's
recorded sweep (``artifacts/lint_sweep.json``, ``benchmarks[name]
[strategy]["equiv"]``).  The partition fingerprints are the port's own
(aten cone entries) and are not compared.  The registry is split over two
files so ``--dist loadfile`` spreads the sweep.
"""

import json
import os

import pytest
import torch

from coast_tpu_torch.analysis.equiv import analyze_equivalence
from coast_tpu_torch.models import REGISTRY
from coast_tpu_torch.passes.strategies import DWC, TMR

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = sorted(REGISTRY)
SWEEP = os.path.join(REPO, "artifacts", "lint_sweep.json")


@pytest.fixture(scope="module")
def recorded():
    with open(SWEEP) as fh:
        return json.load(fh)["benchmarks"]


@pytest.mark.parametrize("strategy", ["TMR", "DWC"])
@pytest.mark.parametrize("name", NAMES[18:])
def test_partition_equals_the_recorded_sweep(name, strategy, recorded):
    make = {"TMR": TMR, "DWC": DWC}[strategy]
    part = analyze_equivalence(make(REGISTRY[name](), device="cpu"))
    want = recorded[name][strategy]["equiv"]
    modes = {}
    for sig in part.signatures.values():
        modes[sig.mode_name] = modes.get(sig.mode_name, 0) + 1
    assert part.clean_steps == want["clean_steps"]
    assert len(part.signatures) == want["sections"]
    assert modes == want["modes"]
