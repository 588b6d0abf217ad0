"""The fuzz tier's parity for seeds 4-7 (``test_torch_c_fuzz_ref.py``
sets it out), a file of its own so that neither runs long."""

import pytest

pytest.importorskip("pycparser")

from test_torch_c_fuzz_ref import (                          # noqa: E402
    test_lifted_output_equals_the_reference as _parity)


@pytest.mark.parametrize("seed", range(4, 8))
def test_lifted_output_equals_the_reference(seed, tmp_path):
    _parity(seed, tmp_path)
