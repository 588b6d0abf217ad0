"""The lint, the advisor and a harness ``.c`` entry on the sources of
``tests/c_sources``, against the reference's (``test_torch_c_lifter_cli.py``
holds ``opt`` and the supervisor)."""

import pytest

pytest.importorskip("pycparser")

from test_torch_c_lifter import FILES                       # noqa: E402
from test_torch_c_lifter_cli import _call                   # noqa: E402


@pytest.mark.parametrize("case", sorted(FILES))
def test_lint_cli_on_a_c_source_as_the_reference(case):
    from coast_tpu.analysis.lint.__main__ import main as jlint
    from coast_tpu_torch.analysis.lint.__main__ import main as lint
    argv = ["-TMR", FILES[case], "--no-survival"]
    want = _call(jlint, argv)
    got = _call(lint, argv, device="cpu")
    assert got[:2] == want[:2]
    assert got[0] == 0


def test_advisor_cli_on_a_c_source_as_the_reference():
    from coast_tpu.analysis.advisor import main as jadvise
    from coast_tpu_torch.analysis.advisor import main as advise
    argv = [FILES["crc16"], "-e", "512", "-t", "0.02", "--no-validate"]
    want = _call(jadvise, argv)
    got = _call(advise, argv + ["-d", "cpu"])
    assert got[:2] == want[:2]
    assert got[0] == 0


def test_harness_c_entry_prints_as_the_reference():
    from coast_tpu.testing.harness import run_combo as jcombo
    from coast_tpu_torch.testing.harness import (expand_benchmarks,
                                                 run_combo)
    rows = expand_benchmarks({"benchmarks": [{"path": FILES["mm9"]}]})
    assert rows == [(FILES["mm9"], None, None)]
    for combo in ("-TMR", "-DWC"):
        assert run_combo(FILES["mm9"], combo, device="cpu") == \
            jcombo(FILES["mm9"], combo)
