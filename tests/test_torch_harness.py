"""The port's flag-matrix harness (``coast_tpu_torch/testing/harness.py``),
the counterpart of ``tests/test_harness.py``, on the CPU.

Each cell's ``C: E: F: T:`` stdout equals the reference ``opt``'s for the
same argv; the ``.c`` refusal names its ROADMAP item, an unknown driver
is refused, every ``fast.yml`` driver has its port; the inline configs (``FAST``, ``FULL``: the card's machine may
lack PyYAML) equal ``yaml.safe_load`` of ``unittest/cfg/fast.yml`` and
``full.yml``.
"""

import contextlib
import io
import os

import pytest
import torch

from coast_tpu_torch.testing import harness
from coast_tpu_torch.testing.harness import (HarnessError,
                                             expand_benchmarks, run_combo,
                                             run_config, run_drivers)

torch.set_num_threads(1)

CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "unittest", "cfg")


def _ref_combo(bench, passes):
    from coast_tpu.testing.harness import run_combo as jrun_combo
    return jrun_combo(bench, passes)


def test_fast_matrix():
    cfg = {"benchmarks": [{"path": "matrixMultiply", "re": "E: 0"}],
           "OPT_PASSES": ["", "-DWC", "-TMR"]}
    assert run_config(cfg, quiet=True, device="cpu") == 3


def test_expand_suites():
    from coast_tpu_torch.models import CHSTONE, REGISTRY
    rows = expand_benchmarks({"benchmarks": [{"path": "chstone"}]})
    assert [r[0] for r in rows] == list(CHSTONE)
    rows = expand_benchmarks({"benchmarks": [{"path": "all"}]})
    assert len(rows) == len(REGISTRY)
    with pytest.raises(HarnessError):
        expand_benchmarks({"benchmarks": [{"path": "noSuchBench"}]})
    with pytest.raises(HarnessError, match="non-empty list"):
        expand_benchmarks({"benchmarks": [{"path": "crc16", "passes": []}]})


def test_regex_mismatch_fails():
    cfg = {"benchmarks": [{"path": "crc16", "re": "THIS WILL NOT MATCH"}],
           "OPT_PASSES": ["-TMR"]}
    with pytest.raises(HarnessError, match="Could not match"):
        run_config(cfg, quiet=True, device="cpu")


def test_combo_cell_runs_clean():
    rc, out = run_combo("crc16", "-TMR -noMemReplication", device="cpu")
    assert rc == 0 and "E: 0" in out


FULL_PASSES = harness.FULL["OPT_PASSES"]


@pytest.mark.parametrize("passes", FULL_PASSES, ids=[p or "none"
                                                     for p in FULL_PASSES])
@pytest.mark.parametrize("bench", ["matrixMultiply", "crc16"])
def test_cell_stdout_equals_the_reference(bench, passes):
    assert run_combo(bench, passes, device="cpu") == _ref_combo(bench,
                                                                passes)


@pytest.mark.parametrize("bench", ["quicksort", "cache_test", "crazyCF",
                                   "rtos_mm"])
def test_more_cells_equal_the_reference(bench):
    for passes in ("", "-DWC -noLoadSync", "-TMR -countErrors"):
        assert run_combo(bench, passes, device="cpu") \
            == _ref_combo(bench, passes)


def test_passes_override_column():
    cfg = {"benchmarks": [{"path": "crc16", "re": "E: 0",
                           "passes": ["-TMR", "-DWC"]},
                          {"path": "matrixMultiply", "re": "E: 0"}],
           "OPT_PASSES": ["-TMR"]}
    assert run_config(cfg, quiet=True, device="cpu") == 3


def test_c_entry_refused_naming_its_item():
    """A ``.c`` entry whose source is not there: the reference's
    HarnessError (a present one expands to itself, see
    tests/test_torch_c_lifter.py)."""
    from coast_tpu.testing.harness import HarnessError as JHarnessError
    from coast_tpu.testing.harness import expand_benchmarks as jexpand
    cfg = {"benchmarks": [{"path": "tests/mm/mm.c"}]}
    with pytest.raises(JHarnessError) as want:
        jexpand(cfg)
    with pytest.raises(HarnessError) as got:
        expand_benchmarks(cfg)
    assert str(got.value) == str(want.value)
    assert "No benchmark source at 'tests/mm/mm.c'" in str(got.value)


@pytest.mark.parametrize("name", ["no_such_smoke"])
def test_missing_driver_refused_naming_its_item(name):
    # Every reference driver is ported; a name the port does not have is
    # refused with the harness's own error, before any driver runs.
    cfg = {"drivers": [{"module": "resume_smoke"}, {"module": name}]}
    with pytest.raises(HarnessError, match=f"no driver named '{name}'"):
        run_drivers(cfg, quiet=True, device="cpu")


def test_driver_tier_runs_fuzz():
    cfg = {"drivers": [{"module": "fuzz", "args": ["-n", "2", "-seed", "7"]}]}
    assert run_drivers(cfg, quiet=True, device="cpu") == 1


@pytest.mark.parametrize("name,inline", [("fast.yml", "FAST"),
                                         ("full.yml", "FULL")])
def test_inline_configs_equal_the_files(name, inline):
    import yaml
    with open(os.path.join(CFG, name)) as f:
        assert getattr(harness, inline) == yaml.safe_load(f)


def test_main_runs_a_config_file(tmp_path):
    cfg = tmp_path / "c.yml"
    cfg.write_text("benchmarks:\n  - path: crc16\n    re: 'E: 0'\n"
                   "OPT_PASSES:\n  - ''\n  - '-TMR'\n")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert harness.main([str(cfg), "--quiet", "-d", "cpu"]) == 0
        assert harness.main([str(tmp_path / "none.yml"), "-d", "cpu"]) == 1
    out = buf.getvalue()
    assert "2 cells passed" in out and "does not exist" in out


def test_main_refuses_fast_yml_naming_the_missing_drivers():
    # No driver of fast.yml is missing any more: each resolves to a
    # ported module with a main (the tier itself is not run here).
    import importlib
    import yaml
    with open(os.path.join(CFG, "fast.yml")) as f:
        names = [d["module"] for d in yaml.safe_load(f)["drivers"]]
    assert names and set(names) <= set(harness.PORTED_DRIVERS)
    for name in names:
        mod = importlib.import_module(f"coast_tpu_torch.testing.{name}")
        assert callable(mod.main), name
