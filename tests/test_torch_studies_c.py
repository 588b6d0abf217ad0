"""The port's fidelity study and the CPU leg of its classification
parity (``coast_tpu_torch/scripts/fidelity_study.py``,
``classification_parity.py``) against the reference's scripts, on the
CPU, on the same seeds.

``run_study(budget=3500, seed=11)`` (as ``tests/test_fidelity.py`` calls
the reference's) gives the reference's section tables and the same
verdicts on C1-C4.  The parity study's CPU leg gives the reference's
codes, errors and steps on matrixMultiply and crc16, and on
matrixMultiply256 outside the rows whose f32 rounding order the two
frameworks may take differently (``models/mm256.order_sensitive``).
"""

import json

import numpy as np
import pytest
import torch

from coast_tpu_torch.scripts import classification_parity as parity
from coast_tpu_torch.scripts import fidelity_study

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def studies():
    from scripts.fidelity_study import run_study
    return (fidelity_study.run_study(budget=3500, seed=11, device="cpu"),
            run_study(budget=3500, seed=11))


def test_fidelity_sections_equal_the_reference(studies):
    got, want = studies
    assert got["sections"] == want["sections"]
    for key in ("metric", "benchmark", "budget_per_program", "seed"):
        assert got[key] == want[key]
    assert got["device"]["device"] == "cpu" and "backend" not in got
    assert sorted(got["campaign_seconds_same_n"]) == ["TMR", "unprotected"]


@pytest.mark.parametrize("check", ["C1", "C2", "C3", "C4"])
def test_fidelity_verdicts_equal_the_reference(studies, check):
    got, want = studies
    mine = next(c for c in got["checks"] if c["name"].startswith(check))
    theirs = next(c for c in want["checks"] if c["name"].startswith(check))
    assert mine["name"] == theirs["name"]
    assert mine["pass"] == theirs["pass"] is True
    if check != "C3":           # C3's detail carries each package's runtime
        assert mine["detail"] == theirs["detail"]
    assert got["all_pass"] == want["all_pass"] is True


def test_fidelity_helpers_equal_the_reference(studies):
    from scripts import fidelity_study as ref
    for k, n in ((0, 0), (0, 500), (17, 500), (500, 500)):
        assert fidelity_study.wilson95(k, n) == ref.wilson95(k, n)
    for prog in ("unprotected", "TMR"):
        table = studies[0]["sections"][prog]
        assert fidelity_study.population_harm_rate(table) == \
            ref.population_harm_rate(table)


def test_fidelity_cli_writes_its_record(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("COAST_FIDELITY_BUDGET", "700")
    out = tmp_path / "fid.json"
    assert fidelity_study.main(["-d", "cpu", "--out", str(out)]) == 0
    record = json.loads(out.read_text())
    assert record["budget_per_program"] == 700 and record["all_pass"]
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(printed) == ["all_pass", "budget_per_program", "checks",
                               "device", "metric"]


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    from scripts import classification_parity as ref
    npz = tmp_path_factory.mktemp("parity") / "ref.npz"
    ref.run_leg("cpu", 256, 1024, str(npz))
    return parity.run_leg("cpu", 256, 1024), dict(np.load(npz))


@pytest.mark.parametrize("name", parity.BENCHMARKS)
def test_parity_cpu_leg_equals_the_reference(legs, name):
    got, want = legs
    exempt = got[f"{name}_exempt"]
    if name != "matrixMultiply256":
        assert not exempt.any()
    for field in parity.FIELDS:
        a, b = got[f"{name}_{field}"], want[f"{name}_{field}"]
        assert a.shape == b.shape == (256,)
        np.testing.assert_array_equal(a[~exempt], b[~exempt])


def fake_leg(diff_at=None, name="matrixMultiply256", exempt_at=()):
    leg = {}
    for bench in parity.BENCHMARKS:
        for field in parity.FIELDS:
            leg[f"{bench}_{field}"] = np.zeros(8, np.int32)
        ex = np.zeros(8, bool)
        if bench == "matrixMultiply256":
            ex[list(exempt_at)] = True
        leg[f"{bench}_exempt"] = ex
    if diff_at is not None:
        leg[f"{name}_codes"] = leg[f"{name}_codes"].copy()
        leg[f"{name}_codes"][diff_at] = 2
    return leg


@pytest.mark.parametrize("name,row,exempt,ok", [
    ("matrixMultiply256", 3, (3,), True),
    ("matrixMultiply256", 3, (4,), False),
    ("matrixMultiply", 5, (), False),
    ("crc16", 0, (), False),
])
def test_parity_names_every_differing_row(name, row, exempt, ok):
    cpu = fake_leg(exempt_at=exempt)
    card = fake_leg(diff_at=row, name=name, exempt_at=exempt)
    got_ok, rows = parity.compare_legs(cpu, card)
    assert got_ok is ok
    block = rows[name]
    assert block["codes"] == {"identical": False, "n": 8, "first_diff": row}
    assert block["errors"]["identical"] and block["steps"]["identical"]
    assert (block["exempt_rows"], block["differing_rows"]) == (
        ([row], []) if ok else ([], [row]))
    assert parity.compare_legs(cpu, cpu) == (True, {
        b: {**{f: {"identical": True, "n": 8} for f in parity.FIELDS},
            "exempt_rows": [], "differing_rows": []}
        for b in parity.BENCHMARKS})


def test_parity_leg_cli_and_its_refusal_without_a_card(tmp_path):
    npz = tmp_path / "cpu.npz"
    assert parity.main(["--leg", "cpu", "-n", "16", "--npz", str(npz)]) == 0
    leg = np.load(npz)
    assert str(leg["device"]) == "cpu"
    assert leg["matrixMultiply_codes"].shape == (16,)
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the card leg can run")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        parity.main(["-n", "16", "--out", str(tmp_path / "p.json")])
    assert not (tmp_path / "p.json").exists()
