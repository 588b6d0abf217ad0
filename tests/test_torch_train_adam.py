"""The protected training step with Adam (train_mlp_adam) of the port
against the JAX reference: the checks of ``tests/test_torch_train.py`` on
the Adam region (image, dataflow, golden trajectory within ``RTOL`` and
``ATOL``, the step from the reference's image, fault-free rows, seeded
flips, the class distributions of 256-row seed-11 campaigns, the FLOPs
table).  The reference documents a host-dependent residual on its
``-DWC`` Adam build (a clean row lands ulps off its golden and reads
``train_self_heal``); the port's step is elementwise in a fixed order, so
its clean DWC rows read ``success``.
"""

import pytest
import torch

from coast_tpu_torch.inject import classify as cls
from coast_tpu_torch.models import REGISTRY
from test_torch_train import (STRATEGIES, check_distribution_overlaps,
                              check_fault_free, check_flops, check_golden,
                              check_image_and_dataflow,
                              check_steps_from_reference_image,
                              check_tmr_repairs, code_of, flip, port_prog)

torch.set_num_threads(1)

OPTIMIZER = "adam"
NAME = "train_mlp_adam"


@pytest.fixture(scope="module")
def regions():
    from coast_tpu.models import REGISTRY as JREGISTRY
    return REGISTRY[NAME](), JREGISTRY[NAME]()


def test_image_and_dataflow_equal_reference():
    check_image_and_dataflow(OPTIMIZER, NAME)


def test_golden_trajectory_matches_reference(regions):
    check_golden(OPTIMIZER, regions[1])


def test_steps_from_reference_image(regions):
    check_steps_from_reference_image(*regions)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_fault_free_rows_clean(strategy, regions):
    check_fault_free(regions[0], strategy)


def test_dwc_fault_free_never_false_alarms(regions):
    """The reference's DWC-Adam invariant: no detection latch, a clean
    loss trajectory, success (or train_self_heal)."""
    prog = port_prog(regions[0], "DWC")
    rec = prog.run_batch(batch=4)
    assert rec["done"].all() and not rec["dwc_fault"].any()
    assert (rec["train_probe"] == 0).all()
    assert (cls.classify(rec, prog.output_words) == cls.SUCCESS).all()


def test_tmr_repairs_both_seeds(regions):
    """Adam's normalised step absorbs a bit-1 weight flip before the
    commit compares the lanes (the reference's records agree), so the
    seeds here are a mid-mantissa and an exponent bit."""
    check_tmr_repairs(regions[0], bits=(20, 30))


def test_seeded_flips_unprotected(regions):
    """The reference's outcomes of the same flips: bit 1 absorbed, a
    mid-mantissa bit self-heals, an exponent bit persists."""
    prog = port_prog(regions[0], "unprotected")
    rec = flip(prog, "w1", bit=1, t=4)
    assert rec["errors"] == 0 and code_of(rec, prog) == cls.SUCCESS
    rec = flip(prog, "w1", bit=20, t=4)
    assert rec["errors"] > 0 and rec["train_probe"] == 0
    assert code_of(rec, prog) == cls.TRAIN_SELF_HEAL
    rec = flip(prog, "w1", bit=30, t=4)
    assert rec["errors"] > 0 and rec["train_probe"] == 2
    assert code_of(rec, prog) == cls.TRAIN_SDC


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_class_distributions_overlap_reference(strategy, regions):
    got = check_distribution_overlaps(*regions, strategy)
    if strategy in ("TMR", "selective"):
        assert got.counts["corrected"] > 0


def test_flops_overhead_equals_reference(regions):
    check_flops(*regions)
    f = regions[0].meta["train"]["flops"]
    assert f["update"] == 5 * 92
