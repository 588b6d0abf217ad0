"""The corpus re-derivation matrix on the port (first half): the
counterpart of ``tests/test_lifter_corpus.py``.

``lift_step`` re-derives the registry's hand-written regions from their
step/init/done/check/output alone, with the reference's annotations
(``MATRIX``, unchanged): every leaf's kind must derive equal to the
port's hand spec, with equal ``nominal_steps``, and the 96-row TMR
campaign at seed 3 equals the hand region's (the reference's slow set
keeps its ``slow`` mark).  The matrix is split over two files, so
``--dist loadfile`` spreads it; ``test_torch_lifter_corpus_b.py`` holds
the second half and the four models also held against the reference's
own ``lift_step`` of the JAX twin.

A model whose leaves derived differently from the reference's jaxpr walk
would stand in ``PINNED`` with the kind the port derives and the reason
(ROADMAP Queue C); none does: the port's steps write their leaves with
the partial updates (``slice_scatter``, ``select_scatter``) and the
select-free word wrap the reference's steps have.
"""

import numpy as np
import pytest
import torch

from coast_tpu_torch import TMR
from coast_tpu_torch.frontend import lift_step
from coast_tpu_torch.inject.campaign import CampaignRunner
from coast_tpu_torch.models import REGISTRY

torch.set_num_threads(1)

# The reference's matrix (tests/test_lifter_corpus.py), unchanged.
MATRIX = {
    "cache_test": (),
    "chstone_dfadd": (),
    "chstone_dfdiv": (),
    "chstone_dfmul": (),
    "chstone_motion": (),
    "chstone_sha": (),
    "helloWorld": (),
    "simpleTMR": (),
    "whetstone": (),
    "matrixMultiply": ("first", "second"),
    "matrixMultiply256": ("first", "second"),
    "crc16": ("msg",),
    "quicksort": ("array",),
    "sha256": ("h",),
    "aes": ("block", "cipher", "rk"),
    "simd": ("v",),
    "scalarize": ("x", "y"),
    "trivial": ("ret",),
    "crazyCF": ("acc",),
    "towersOfHanoi": ("sp",),
    "schedule2": ("counts", "next_id", "i"),
    "chstone_blowfish": ("i",),
    "chstone_dfsin": ("term", "x2"),
    "chstone_jpeg": ("pred", "i"),
    "chstone_mips": ("pc", "n_inst", "hi", "lo"),
    "chstone_adpcm": ("accumd", "enc_s", "dec_s", "i"),
    "chstone_gsm": ("l_acf", "p", "larc", "scal"),
    "nestedCalls": ("acc",),
    "rtos_app": ("ring", "uart", "seed", "depth"),
}

_SLOW_CAMPAIGN = {"chstone_jpeg", "chstone_gsm", "chstone_adpcm",
                  "chstone_mips", "whetstone", "matrixMultiply256",
                  "chstone_dfsin", "chstone_sha"}

# model -> {leaf: (kind the port derives, why)}: leaves the port's
# capture derives differently from the reference's jaxpr walk (ROADMAP
# Queue C).  Empty: every model derives the reference's kinds.
PINNED = {}


def relift(hand, annotated, device="cpu"):
    annotations = {leaf: hand.spec[leaf] for leaf in annotated}
    meta = ({"store_slice": hand.meta["store_slice"]}
            if "store_slice" in hand.meta else None)
    lifted = lift_step(
        hand.name + "_lifted", hand.step, hand.init, done=hand.done,
        check=hand.check, output=hand.output, max_steps=hand.max_steps,
        annotations=annotations, default_xmr=hand.default_xmr,
        functions=hand.functions, meta=meta, device=device)
    lifted.spec = {k: lifted.spec[k] for k in hand.spec}
    return lifted


def check_kinds(model):
    hand = REGISTRY[model]()
    lifted = relift(hand, MATRIX[model])
    derived = {k: v.kind for k, v in lifted.spec.items()}
    expected = {k: v.kind for k, v in hand.spec.items()}
    for leaf, (kind, _) in PINNED.get(model, {}).items():
        assert derived[leaf] == kind != expected[leaf], leaf
        expected[leaf] = kind
    assert derived == expected
    assert lifted.nominal_steps == hand.nominal_steps
    assert len(MATRIX[model]) <= len(hand.spec) / 2 or len(hand.spec) <= 4


def check_campaign(model):
    hand = REGISTRY[model]()
    lifted = relift(hand, MATRIX[model])
    rh = CampaignRunner(TMR(hand, device="cpu")).run(96, seed=3,
                                                     batch_size=96)
    rl = CampaignRunner(TMR(lifted, device="cpu")).run(96, seed=3,
                                                       batch_size=96)
    np.testing.assert_array_equal(rh.codes, rl.codes)
    np.testing.assert_array_equal(rh.errors, rl.errors)
    np.testing.assert_array_equal(rh.steps, rl.steps)
    assert rh.counts == rl.counts


def campaign_params(models):
    for model in models:
        marks = [pytest.mark.slow] if model in _SLOW_CAMPAIGN else []
        yield pytest.param(model, marks=marks, id=model)


# The halves, balanced by campaign time on the driver's runner
# (chstone_blowfish, quicksort and cache_test take the longest).
HALF_B = [m for m in sorted(MATRIX)[1::2]
          if m not in ("cache_test", "quicksort")]
HALF_A = [m for m in sorted(MATRIX) if m not in HALF_B]


@pytest.mark.parametrize("model", HALF_A)
def test_corpus_kinds_derive(model):
    check_kinds(model)


@pytest.mark.parametrize("model", campaign_params(HALF_A))
def test_corpus_campaign_identical(model):
    check_campaign(model)


def test_matrix_is_the_reference_matrix():
    import sys
    import os
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_lifter_corpus import MATRIX as REF
    assert MATRIX == REF
    assert len(MATRIX) >= len(REGISTRY) // 2
