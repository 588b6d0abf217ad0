"""Inline C programs of ``tests/test_c_lifter.py``, part a of four
(every fourth case from the first, by name): each lifted by both packages
and compared as ``tests/test_torch_c_lifter.py`` sets out."""

import pytest

from test_torch_c_lifter import (INLINE, NO_CAMPAIGN,  # noqa: F401
                                 check_campaign, check_image_and_output,
                                 check_layout, check_refusal, tmp_root)

CASES = sorted(INLINE)[0::4]


@pytest.mark.parametrize("case", CASES)
def test_refused_or_lifted_alike(case, tmp_root):
    check_refusal(case, tmp_root)


@pytest.mark.parametrize("case", CASES)
def test_leaves_steps_and_meta(case, tmp_root):
    check_layout(case, tmp_root)


@pytest.mark.parametrize("case", CASES)
def test_image_and_output(case, tmp_root):
    check_image_and_output(case, tmp_root)


@pytest.mark.parametrize("strategy", ["TMR", "DWC"])
@pytest.mark.parametrize("case", [c for c in CASES if c not in NO_CAMPAIGN])
def test_campaign(case, strategy, tmp_root):
    check_campaign(case, tmp_root, strategy)
