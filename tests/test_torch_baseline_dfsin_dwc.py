"""chstone_dfsin of the port against the JAX reference under DWC, in a
file of its own beside ``test_torch_baseline_dfsin.py`` (TMR and the
checks that take no strategy), so that ``--dist loadfile`` runs the two
JAX campaigns' compiles on two workers.  The checks are
``tests/test_torch_baseline.py``'s."""

import pytest
import torch

from test_torch_baseline import Results, check_campaign, check_fused

torch.set_num_threads(1)

NAMES = ("chstone_dfsin",)


@pytest.fixture(scope="module")
def ref():
    return Results()


@pytest.mark.parametrize("strategy", ["DWC"])
@pytest.mark.parametrize("name", NAMES)
def test_campaign_parity(name, strategy, ref):
    check_campaign(name, strategy, ref)


@pytest.mark.parametrize("strategy", ["DWC"])
@pytest.mark.parametrize("name", NAMES)
def test_fused_equals_unfused(name, strategy, ref):
    check_fused(name, strategy, ref)
