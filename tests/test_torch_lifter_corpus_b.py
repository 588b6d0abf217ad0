"""The corpus re-derivation matrix on the port (second half), and four
models held against the reference's own ``lift_step`` of the JAX twin:
see ``test_torch_lifter_corpus_a.py``."""

import pytest
import torch

from coast_tpu_torch.models import REGISTRY
from test_torch_lifter_corpus_a import (HALF_B, MATRIX, campaign_params,
                                        check_campaign, check_kinds, relift)

torch.set_num_threads(1)


@pytest.mark.parametrize("model", HALF_B)
def test_corpus_kinds_derive(model):
    check_kinds(model)


@pytest.mark.parametrize("model", campaign_params(HALF_B))
def test_corpus_campaign_identical(model):
    check_campaign(model)


@pytest.mark.parametrize("model", ["matrixMultiply", "crc16", "quicksort",
                                   "nestedCalls"])
def test_lifted_layout_equals_the_references_lift(model):
    """The port's lifted kinds, nominal_steps and max_steps equal the
    reference's ``lift_step`` of the JAX twin, with the same annotations
    and without the hand's max_steps (so both measure their own)."""
    from coast_tpu.frontend import lift_step as jlift_step
    from coast_tpu.models import REGISTRY as JREG
    from coast_tpu_torch.frontend import lift_step
    jhand, hand = JREG[model](), REGISTRY[model]()
    ann = MATRIX[model]
    want = jlift_step(model, jhand.step, jhand.init, done=jhand.done,
                      annotations={a: jhand.spec[a] for a in ann},
                      functions=jhand.functions)
    got = lift_step(model, hand.step, hand.init, done=hand.done,
                    annotations={a: hand.spec[a] for a in ann},
                    functions=hand.functions, device="cpu")
    assert {k: v.kind for k, v in got.spec.items()} \
        == {k: v.kind for k, v in want.spec.items()}
    assert (got.nominal_steps, got.max_steps) \
        == (want.nominal_steps, want.max_steps)
    assert list(got.spec) == list(want.spec)
    assert relift(hand, ann).nominal_steps == hand.nominal_steps


def test_lifted_crc16_fused_equals_the_fused_hand_region():
    """The lifted crc16 builds the fused plan and its fused campaign equals
    the fused hand region's (chip_smoke 29b on the host)."""
    import numpy as np

    from coast_tpu_torch import TMR
    from coast_tpu_torch.inject.campaign import CampaignRunner
    hand = REGISTRY["crc16"]()
    prog = TMR(relift(hand, MATRIX["crc16"]), device="cpu", fuse_step=True)
    assert prog._fuse_plan is not None
    a = CampaignRunner(TMR(hand, device="cpu", fuse_step=True)).run(
        512, seed=1, batch_size=512)
    b = CampaignRunner(prog).run(512, seed=1, batch_size=512)
    for col in ("codes", "errors", "corrected", "steps"):
        np.testing.assert_array_equal(getattr(a, col), getattr(b, col))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host")
    return torch.device("cuda")


@pytest.mark.cuda
def test_relifted_flagship_family_on_the_card(cuda):
    """chip_smoke 29a at a reduced size: matrixMultiply256 re-lifted with
    the corpus annotations, its TMR campaign on the card through K1 equal
    to the hand region's."""
    import numpy as np

    from coast_tpu_torch import TMR
    from coast_tpu_torch.inject.campaign import CampaignRunner
    from coast_tpu_torch.ops import hopper_voters
    hand = REGISTRY["matrixMultiply256"]()
    lifted = relift(hand, MATRIX["matrixMultiply256"], device="cuda")
    want = CampaignRunner(TMR(hand)).run(256, seed=1, batch_size=128)
    before = hopper_voters.LAUNCHES
    got = CampaignRunner(TMR(lifted)).run(256, seed=1, batch_size=128)
    assert hopper_voters.LAUNCHES > before
    for col in ("codes", "errors", "corrected", "steps"):
        np.testing.assert_array_equal(getattr(got, col), getattr(want, col))


def check_own_golden(device: str, rows: int) -> None:
    """matrixMultiply256 lifted with the lifter's own check and output (the
    golden made by a one-row fault-free run on ``device``): fault-free
    rows at the campaign's batch read 0 errors, and the TMR codes equal
    the hand region's on every row injected neither into ``golden`` (the
    hand check's reference, which the lifter's check does not read) nor
    ``order_sensitive`` (a mantissa flip of first/second/acc: a subnormal
    the voters read as zero may stay in the compared image), success on
    the ``golden`` rows."""
    import numpy as np

    from coast_tpu_torch import TMR
    from coast_tpu_torch.frontend import lift_step
    from coast_tpu_torch.inject.campaign import CampaignRunner
    from coast_tpu_torch.ir.region import rows as row_mask
    from coast_tpu_torch.models.mm256 import order_sensitive
    hand = REGISTRY["matrixMultiply256"]()
    lifted = lift_step(
        "mm256_own", hand.step, hand.init, done=hand.done,
        annotations={a: hand.spec[a] for a in MATRIX["matrixMultiply256"]},
        meta={"store_slice": hand.meta["store_slice"]}, device=device)
    lifted.spec = {k: lifted.spec[k] for k in hand.spec}
    assert lifted.max_steps == hand.max_steps
    dev = torch.device(device)
    state = {k: v.unsqueeze(0).expand(rows, *v.shape).clone()
             for k, v in lifted.init(dev).items()}
    halted = torch.zeros(rows, dtype=torch.bool, device=dev)
    with torch.no_grad():
        for t in range(lifted.max_steps):
            new = {**state, **lifted.step(state, t)}
            state = {k: torch.where(row_mask(halted, v), state[k], v)
                     for k, v in new.items()}
            halted = halted | lifted.done(state)
        assert bool(halted.all())
        assert not lifted.check(state).any()
    prog = TMR(lifted, device=device)
    got = CampaignRunner(prog).run(rows, seed=1, batch_size=rows)
    want = CampaignRunner(TMR(hand, device=device)).run(rows, seed=1,
                                                        batch_size=rows)
    sched = got.schedule
    on_golden = np.array([prog.leaf_order[i] == "golden"
                          for i in np.asarray(sched.leaf_id)])
    same = ~on_golden & ~order_sensitive(prog.leaf_order, sched.leaf_id,
                                         sched.bit)
    assert on_golden.any() and same.any()
    np.testing.assert_array_equal(got.codes[same], want.codes[same])
    assert not got.codes[on_golden].any()


def test_lifters_own_golden_on_a_float_program():
    """chip_smoke 29a' on the host."""
    check_own_golden("cpu", 64)


@pytest.mark.cuda
def test_lifters_own_golden_on_the_card(cuda):
    """chip_smoke 29a' at a reduced size: the golden made on the card,
    compared at batch 128."""
    check_own_golden("cuda", 128)
