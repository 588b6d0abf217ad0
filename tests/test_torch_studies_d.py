"""The port's training campaign and C-fuzz sweep
(``coast_tpu_torch/scripts/train_campaign.py``, ``c_fuzz_sweep.py``)
against the reference's scripts, on the CPU, and the import rule of
``coast_tpu_torch/scripts``.

``kind_table`` of a seeded campaign gives the reference's injections a
leaf kind exactly (the schedules are the same) and its train classes by
the train regions' rule (converged classes pooled, 95 % Wilson intervals
overlapping).  The fault-free differential holds on the port for all
four strategies and the Adam variant, and its witness, the final
weights, equals the reference's unprotected weights within the train
tolerance (the reference's own TMR and DWC fault-free rows are not clean
on every host, so its sha is not the port's to match).  The sweep's
record carries the audit fields ``tests/test_c_fuzz.py`` reads from the
reference's record, under the port's generator and envelope, and a
resume runs only the seeds it has not recorded.
"""

import ast
import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from coast_tpu_torch import DWC, TMR, unprotected
from coast_tpu_torch.inject.campaign import CampaignRunner
from coast_tpu_torch.obs.convergence import interval_table, intervals_overlap
from coast_tpu_torch.scripts import c_fuzz_sweep, train_campaign
from coast_tpu_torch.train import make_train_region, selective_xmr

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "coast_tpu_torch", "scripts")
ROWS, SEED = 256, 42
RTOL, ATOL = 1e-5, 1e-7          # the train regions' stated tolerance


def port_prog(region, strategy):
    if strategy == "selective-xMR":
        return selective_xmr(region, device="cpu")
    return {"unprotected": unprotected, "DWC": DWC,
            "TMR": TMR}[strategy](region, device="cpu")


@pytest.fixture(scope="module")
def kind_tables():
    from coast_tpu import unprotected as junprotected
    from coast_tpu.inject.campaign import CampaignRunner as JRunner
    from coast_tpu.train import make_train_region as jmake
    from coast_tpu.train import selective_xmr as jselective
    from scripts import train_campaign as ref
    region, jregion = make_train_region("sgd"), jmake("sgd")
    out = {}
    for strat, jmk in (("unprotected", junprotected),
                       ("selective-xMR", jselective)):
        runner = CampaignRunner(port_prog(region, strat),
                                strategy_name=strat)
        res = runner.run(ROWS, seed=SEED, batch_size=128)
        jrunner = JRunner(jmk(jregion), strategy_name=strat)
        jres = jrunner.run(ROWS, seed=SEED, batch_size=128)
        out[strat] = (train_campaign.kind_table(res, runner),
                      ref.kind_table(jres, jrunner))
    return out


@pytest.mark.parametrize("strat", ["unprotected", "selective-xMR"])
def test_kind_table_against_the_reference(kind_tables, strat):
    got, want = kind_tables[strat]
    assert sorted(got) == sorted(want)
    for kind, row in got.items():
        ref = want[kind]
        assert row["injections"] == ref["injections"], kind
        n = row["injections"]
        mine = {"train_sdc": row["train_sdc"],
                "converged": row["train_self_heal"] + row["corrected"]}
        theirs = {"train_sdc": ref["train_sdc"],
                  "converged": ref["train_self_heal"] + ref["corrected"]}
        mine["other"] = n - sum(mine.values())
        theirs["other"] = n - sum(theirs.values())
        a, b = interval_table(mine), interval_table(theirs)
        for k in a:
            assert intervals_overlap(a[k], b[k]), (strat, kind, row, ref)


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_fault_free_differential(optimizer):
    from coast_tpu import unprotected as junprotected
    from coast_tpu.ops.bitflip import noop_fault as jnoop
    from coast_tpu.train import make_train_region as jmake
    region = make_train_region(optimizer)
    strats = ("unprotected", "DWC", "selective-xMR", "TMR")
    shas = {s: train_campaign._fault_free_sha(port_prog(region, s))
            for s in strats}
    assert len(set(shas.values())) == 1, shas
    witness = unprotected(region, device="cpu").run()["output"]
    assert hashlib.sha256(witness.numpy().view(np.uint32).tobytes()
                          ).hexdigest() == shas["unprotected"]
    theirs = np.asarray(junprotected(jmake(optimizer)).run(jnoop())[
        "output"])
    np.testing.assert_allclose(witness.numpy().view(np.float32),
                               theirs.view(np.float32), rtol=RTOL, atol=ATOL)


def test_train_campaign_bars_and_record(tmp_path, capsys):
    out = tmp_path / "train.json"
    assert train_campaign.main(["-d", "cpu", "-n", str(ROWS), "--batch",
                                "128", "--out", str(out)]) == 0
    record = json.loads(out.read_text())
    with open(os.path.join(ROOT, "artifacts", "train_campaign.json")) as fh:
        recorded = json.load(fh)
    assert sorted(record) == sorted(set(recorded) - {"backend"}
                                    | {"device"})
    assert record["device"]["device"] == "cpu"
    assert sorted(record["strategies"]) == sorted(recorded["strategies"])
    assert sorted(record["differential"]) == sorted(
        recorded["differential"])
    assert record["differential"]["fault_free_trajectory_bit_identical"]
    assert record["differential"]["adam_variant_bit_identical"]
    for strat, row in record["strategies"].items():
        assert sorted(row) == sorted(recorded["strategies"][strat])
        assert row["flops_overhead"] == \
            recorded["strategies"][strat]["flops_overhead"]
    unprot = record["strategies"]["unprotected"]["counts"]
    assert unprot["train_sdc"] and unprot["train_self_heal"]
    sel = record["selective_vs_tmr"]
    assert sel["persistent_sdc_coverage_recovery"] >= 0.5
    assert sel["flops_fraction_of_tmr"] < 2 / 3
    assert sorted(record["kind_attribution"]) == ["selective-xMR",
                                                  "unprotected"]
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["parity"] is True and printed["wrote"] == str(out)


@pytest.mark.skipif(shutil.which("gcc") is None, reason="gcc not available")
def test_c_fuzz_sweep_record_and_resume(tmp_path, capsys):
    pytest.importorskip("pycparser")
    out = tmp_path / "sweep.json"
    argv = ["--start", "0", "--chunk", "1", "-d", "cpu", "--out", str(out)]
    assert c_fuzz_sweep.main(argv + ["-n", "2"]) == 0
    first = capsys.readouterr()
    art = json.loads(out.read_text())
    # The audit fields tests/test_c_fuzz.py reads from the reference's.
    assert art["generator"] == "coast_tpu_torch/testing/c_fuzz.py"
    assert isinstance(art["envelope_sha"], str) and art["envelope_sha"]
    assert art["ranges"] and all(
        isinstance(lo, int) and isinstance(hi, int) and lo < hi
        for lo, hi in art["ranges"])
    assert art["n_pass"] >= 1
    assert isinstance(art["failures"], list)
    with open(c_fuzz_sweep.GEN_SRC, "rb") as fh:
        assert art["envelope_sha"] == hashlib.sha256(fh.read()).hexdigest(
        )[:16]
    assert (art["ranges"], art["n_pass"], art["failures"]) == ([[0, 2]], 2,
                                                              [])
    assert [ln.split(":")[0] for ln in first.err.splitlines()
            if ln.startswith("# seed")] == ["# seed 0", "# seed 1"]
    assert json.loads(first.out.strip().splitlines()[-1]) == {
        "envelope_sha": art["envelope_sha"], "n_pass": 2, "n_fail": 0,
        "ranges": [[0, 2]]}
    # A resume runs only the seed it has not recorded.
    assert c_fuzz_sweep.main(argv + ["-n", "3"]) == 0
    again = capsys.readouterr()
    assert [ln.split(":")[0] for ln in again.err.splitlines()
            if ln.startswith("# seed")] == ["# seed 2"]
    art = json.loads(out.read_text())
    assert (art["ranges"], art["n_pass"]) == ([[0, 3]], 3)


def test_c_fuzz_sweep_never_merges_the_references_record(tmp_path, capsys):
    out = tmp_path / "sweep.json"
    shutil.copy(os.path.join(ROOT, "artifacts", "c_fuzz_sweep.json"), out)
    recorded = json.loads(out.read_text())
    assert recorded["envelope_sha"] != c_fuzz_sweep.envelope_sha()
    # No seed left to run: the record restarts empty under the port's
    # generator, and the reference's 350 seeds are not counted.
    assert c_fuzz_sweep.main(["--start", "0", "-n", "0", "-d", "cpu",
                              "--out", str(out)]) == 0
    assert "prior record invalidated" in capsys.readouterr().err
    art = json.loads(out.read_text())
    assert (art["generator"], art["ranges"], art["n_pass"]) == (
        "coast_tpu_torch/testing/c_fuzz.py", [], 0)


def test_c_fuzz_sweep_ranges_equal_the_reference():
    from scripts import c_fuzz_sweep as ref
    for ranges in ([], [[0, 5]], [[5, 9], [0, 5]], [[0, 3], [2, 7], [9, 12]],
                   [[4, 6], [0, 1], [1, 4]]):
        assert c_fuzz_sweep.merge_ranges([list(r) for r in ranges]) == \
            ref.merge_ranges([list(r) for r in ranges])
        for seed in range(14):
            assert c_fuzz_sweep.covered(ranges, seed) == ref.covered(ranges,
                                                                     seed)


def imported_modules(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_study_imports_jax_the_reference_or_its_scripts():
    studies = sorted(f for f in os.listdir(SCRIPTS) if f.endswith(".py"))
    assert studies == ["__init__.py", "c_fuzz_sweep.py",
                       "classification_parity.py", "common.py",
                       "fidelity_study.py", "mwtf_report.py",
                       "train_campaign.py"]
    for name in studies:
        for mod in imported_modules(os.path.join(SCRIPTS, name)):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "coast_tpu", "scripts"), (
                name, mod)
    with open(os.path.join(SCRIPTS, "zero_to_aha.sh")) as fh:
        shell = fh.read()
    assert "jax" not in shell and "coast_tpu." not in shell
    assert "coast_tpu_torch" in shell
    code = ("import sys\n"
            "import coast_tpu_torch.scripts.mwtf_report, "
            "coast_tpu_torch.scripts.fidelity_study, "
            "coast_tpu_torch.scripts.classification_parity, "
            "coast_tpu_torch.scripts.train_campaign, "
            "coast_tpu_torch.scripts.c_fuzz_sweep\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'coast_tpu', 'scripts')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


@pytest.mark.parametrize("module,argv", [
    ("fidelity_study", []), ("train_campaign", ["-n", "8"]),
    ("c_fuzz_sweep", ["-n", "1"])])
def test_without_a_card_a_study_refuses_rather_than_run_on_the_cpu(
        tmp_path, module, argv):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    import importlib
    mod = importlib.import_module(f"coast_tpu_torch.scripts.{module}")
    out = tmp_path / "x.json"
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        mod.main(argv + ["--out", str(out)])
    assert not out.exists()


def test_device_block_and_default_record_paths():
    from coast_tpu_torch import device
    from coast_tpu_torch.scripts import common
    assert common.device_block(torch.device("cpu")) == {
        "torch": torch.__version__, "device": "cpu", "name": None,
        "power_limit": None}
    assert common.default_out("x.json") == os.path.join(
        ROOT, "build", "studies", "x.json")
    line = device.card_line()
    if shutil.which("nvidia-smi") is None:
        assert line is None
    else:
        assert line is None or ", " in line
