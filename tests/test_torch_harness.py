"""The port's flag-matrix harness (``coast_tpu_torch/testing/harness.py``),
the counterpart of ``tests/test_harness.py``, on the CPU.

Each cell's ``C: E: F: T:`` stdout equals the reference ``opt``'s for the
same argv; the ``.c`` and missing-driver refusals name their ROADMAP
items; the inline configs (``FAST``, ``FULL``: the card's machine may
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
    with pytest.raises(HarnessError, match="item 17d"):
        expand_benchmarks({"benchmarks": [{"path": "tests/mm/mm.c"}]})


@pytest.mark.parametrize("name,item", sorted(harness.LATER_DRIVERS.items()))
def test_missing_driver_refused_naming_its_item(name, item):
    with pytest.raises(HarnessError, match=f"item {item}$"):
        run_drivers({"drivers": [{"module": name}]}, quiet=True,
                    device="cpu")


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
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = harness.main([os.path.join(CFG, "fast.yml"), "--quiet",
                           "-d", "cpu"])
    assert rc == 1 and "item 19" in buf.getvalue()
