"""The port's MWTF report and fault-model sweep
(``coast_tpu_torch/scripts/mwtf_report.py``) against the reference's
``scripts/mwtf_report.py``, on the CPU, on the same seeds.

The integer regions' campaigns are the reference's count for count, and
so is everything of the ``vs_unprotected_*`` comparisons that the counts
and steps decide (error-rate ratios, class intervals, drift); the
runtime ratio and the MWTF ratio are each package's own timing.  The
port's counts of the 20,000-row campaigns equal the reference's record
(``artifacts/mwtf_report.json``), which the card smoke holds the card's
counts to.  The reference's ``profile=True`` counter reads
``jax.core.Jaxpr``, which jax 0.9 removed: these tests set that one
attribute to ``jax.extend.core.Jaxpr`` for their duration.
"""

import json
import os

import pytest
import torch

from coast_tpu_torch import DWC, TMR, unprotected
from coast_tpu_torch.inject.campaign import CampaignRunner
from coast_tpu_torch.models import REGISTRY
from coast_tpu_torch.scripts import mwtf_report

torch.set_num_threads(1)

STRATS = ("unprotected", "DWC", "TMR")
RECORD = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "artifacts", "mwtf_report.json")
# The keys of a vs_unprotected_* block that each package's clock decides.
TIMED = ("runtime_x", "mwtf")


@pytest.fixture
def jaxpr_attr(monkeypatch):
    """The reference's op counter reads ``jax.core.Jaxpr``."""
    import jax
    import jax.extend
    monkeypatch.setattr(jax.core, "Jaxpr", jax.extend.core.Jaxpr,
                        raising=False)


def both(tmp_path, argv):
    """The port's record and the reference's for the same arguments."""
    from scripts import mwtf_report as ref
    got, want = tmp_path / "port.json", tmp_path / "ref.json"
    assert mwtf_report.main(argv + ["--cpu", "--out", str(got)]) == 0
    assert ref.main(argv + ["--cpu", "--out", str(want)]) == 0
    return json.loads(got.read_text()), json.loads(want.read_text())


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_mwtf_integer_rows_equal_the_reference(tmp_path, jaxpr_attr, fused):
    argv = ["-n", "256", "--benchmarks", "mm,crc16"]
    got, want = both(tmp_path, argv + (["--fuse-step"] if fused else []))
    assert got["n_per_campaign"] == want["n_per_campaign"] == 256
    assert got["device"]["device"] == "cpu" and "backend" not in got
    assert got["device"]["torch"] == torch.__version__
    assert sorted(got["benchmarks"]) == ["crc16", "matrixMultiply"]
    for name, row in got["benchmarks"].items():
        ref = want["benchmarks"][name]
        assert sorted(row) == sorted(ref)
        assert row["campaigns"] == ref["campaigns"]
        assert sorted(row["seconds_per_run"]) == sorted(STRATS)
        assert all(v > 0 for v in row["seconds_per_run"].values())
        assert sorted(row["stages"]) == sorted(ref["stages"])
        assert row["injections_per_sec"] == ref["injections_per_sec"] == {}
        assert ref["flops_overhead_source"] == "measured-jaxpr"
        assert row["flops_overhead_source"] == "measured-capture"
        assert row["flops_overhead"]["unprotected"] == 1.0
        assert sorted(row["flops_overhead"]) == sorted(ref["flops_overhead"])
        assert sorted(row["mfu"]) == sorted(ref["mfu"])
        for strat in ("DWC", "TMR"):
            vs, vs_ref = (row[f"vs_unprotected_{strat}"],
                          ref[f"vs_unprotected_{strat}"])
            assert sorted(vs) == sorted(vs_ref)
            for key in vs:
                if key not in TIMED:
                    assert vs[key] == vs_ref[key], (name, strat, key)


def test_model_sweep_equals_the_reference(tmp_path):
    argv = ["--model-sweep", "-n", "256", "--benchmarks", "mm", "--models",
            "single;multibit:k=2;cluster:span=4,k=2"]
    got, want = both(tmp_path, argv)
    for key in ("metric", "benchmark", "n_per_campaign", "seed", "classes"):
        assert got[key] == want[key], key
    assert got["device"]["device"] == "cpu"
    assert len(got["models"]) == 3
    for row, ref in zip(got["models"], want["models"]):
        assert (row["model"], row["kind"], row["sites"]) == (
            ref["model"], ref["kind"], ref["sites"])
        for strat in STRATS:
            cell, cell_ref = row["strategies"][strat], ref["strategies"][strat]
            assert cell["counts"] == cell_ref["counts"]
            assert cell["rates"] == cell_ref["rates"]
    assert got["degradation"] == want["degradation"]
    assert all(fam["monotone_uncorrected"]
               for fams in got["degradation"].values()
               for fam in fams.values())


def test_model_sweep_refuses_a_bad_model(tmp_path, capsys):
    assert mwtf_report.main(["--model-sweep", "--cpu", "--models",
                             "single;multibit:k=0", "--out",
                             str(tmp_path / "x.json")]) == 2
    assert "bad --models entry" in capsys.readouterr().err
    assert not (tmp_path / "x.json").exists()


@pytest.mark.parametrize("name", ["matrixMultiply", "crc16"])
def test_the_record_counts_are_the_ports(name):
    """The reference's record is seed-determined: its 20,000-row campaigns
    (``artifacts/mwtf_report.json``) are the port's on the CPU."""
    with open(RECORD) as fh:
        recorded = json.load(fh)["benchmarks"][name]["campaigns"]
    region = REGISTRY[name]()
    for strat, make in zip(STRATS, (unprotected, DWC, TMR)):
        res = CampaignRunner(make(region, device="cpu"),
                             strategy_name=strat).run(20_000, seed=2026,
                                                      batch_size=20_000)
        want = recorded[strat]
        assert all(res.counts[k] == want.get(k, 0) for k in res.counts), (
            strat, res.counts, want)


def test_runtime_is_timed_on_the_programs_device():
    prog = TMR(REGISTRY["crc16"](), device="cpu")
    seconds = mwtf_report._runtime_s(prog, reps=3)
    assert 0 < seconds < 5


def test_wilson_half_and_strict_json_equal_the_reference():
    from scripts import mwtf_report as ref
    for p, n in ((0.0, 256), (0.3, 4096), (1.0, 10), (0.5, 0)):
        assert mwtf_report._wilson_half(p, n) == ref._wilson_half(p, n)
    assert mwtf_report.SWEEP_MODELS == ref.SWEEP_MODELS
    assert mwtf_report.BENCH_ALIASES == ref.BENCH_ALIASES
    assert [mwtf_report._j(v) for v in (float("nan"), float("inf"), 1.23456,
                                        3)] == ["nan", "inf", 1.2346, 3]


def test_without_a_card_the_report_refuses_rather_than_run_on_the_cpu(
        tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        mwtf_report.main(["-n", "8", "--out", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()
