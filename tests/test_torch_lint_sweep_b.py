"""The port's linter over the second half of the registry, TMR and DWC.

For each registry name and strategy the provenance and survival findings,
as a set of ``(rule, severity, locus)``, equal the reference's recorded
sweep (``artifacts/lint_sweep.json``, ``benchmarks[name][strategy]
["findings"]``; its ``equiv`` block is the equivalence partition's,
held by ``test_torch_equiv_sweep_a.py`` / ``_b.py``, and its
``propagation`` block the isolation prover's, ROADMAP Queue A item
17c).  The registry is split over two files so ``--dist loadfile``
spreads the sweep.
"""

import json
import os

import pytest
import torch

from coast_tpu_torch.analysis import lint
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
def test_findings_equal_the_recorded_sweep(name, strategy, recorded):
    make = {"TMR": TMR, "DWC": DWC}[strategy]
    report = lint.lint_program(make(REGISTRY[name](), device="cpu"),
                               strategy=strategy)
    assert report.passes_run == ["provenance", "survival"]
    got = {(f.rule, f.severity, f.locus) for f in report.findings}
    want = {(f["rule"], f["severity"], f["locus"])
            for f in recorded[name][strategy]["findings"]}
    assert got == want
    assert report.ok == recorded[name][strategy]["ok"]
