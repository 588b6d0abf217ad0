"""chstone dfadd, dfmul and dfdiv of the port against the JAX reference,
in a file of their own, so that ``--dist loadfile`` runs them beside the
other BASELINE files.  The checks are ``tests/test_torch_baseline.py``'s,
with the JAX results computed once for the module."""

import pytest
import torch

from test_torch_baseline import (STRATEGIES, Results, check_campaign,
                                 check_dataflow, check_final_state,
                                 check_fused, check_init_image,
                                 check_sections_and_schedule)

torch.set_num_threads(1)

NAMES = ("chstone_dfadd", "chstone_dfmul", "chstone_dfdiv")


@pytest.fixture(scope="module")
def ref():
    return Results()


@pytest.mark.parametrize("name", NAMES)
def test_init_image_equal(name, ref):
    check_init_image(name, ref)


@pytest.mark.parametrize("name", NAMES)
def test_declared_dataflow_equals_reference_analysis(name, ref):
    check_dataflow(name, ref)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("name", NAMES)
def test_sections_schedule_and_plan_equal(name, strategy, ref):
    check_sections_and_schedule(name, strategy, ref)


@pytest.mark.parametrize("name", NAMES)
def test_fault_free_final_state_equals_reference_and_oracle(name, ref):
    check_final_state(name, ref)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("name", NAMES)
def test_campaign_parity(name, strategy, ref):
    check_campaign(name, strategy, ref)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("name", NAMES)
def test_fused_equals_unfused(name, strategy, ref):
    check_fused(name, strategy, ref)
