"""``python -m coast_tpu_torch <verb>`` (``coast_tpu_torch/__main__.py``),
the counterpart of ``coast_tpu/__main__.py``: each verb reaches its
module CLI (``ci`` and ``serve`` too: no verb is left for a later
slice), and an unknown verb is refused as the reference refuses it."""

import json
import subprocess
import sys

import pytest
import torch

import coast_tpu_torch.__main__ as pkg_main
from coast_tpu_torch.__main__ import main

torch.set_num_threads(1)


def test_help_and_no_verb(capsys):
    assert main(["--help"]) == 0
    assert "python -m coast_tpu_torch slo" in capsys.readouterr().err
    assert main([]) == 2


@pytest.mark.parametrize("verb,prog", [("ci", "ci check"),
                                       ("serve", "serve")])
def test_later_verbs_exit_2_naming_their_item(verb, prog, capsys):
    # Both verbs are ported: each forwards to its module CLI, whose
    # --help exits 0, and no verb is refused as a later item.
    with pytest.raises(SystemExit) as e:
        main(prog.split() + ["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert f"usage: python -m coast_tpu_torch {prog}" in out
    assert "--device" in out
    assert not hasattr(pkg_main, "LATER_VERBS")


def test_unknown_verb_refused_as_the_reference(capsys):
    from coast_tpu.__main__ import main as jmain
    assert main(["frob"]) == 2
    err = capsys.readouterr().err
    assert jmain(["frob"]) == 2
    assert err.replace("coast_tpu_torch", "coast_tpu") \
        == capsys.readouterr().err


def test_slo_verb(tmp_path, capsys):
    doc = tmp_path / "s.json"
    doc.write_text(json.dumps({"injections": 100, "success": 99, "sdc": 1}))
    assert main(["slo", "report", "--spec", "sdc_rate<=0.5",
                 "--input", str(doc)]) == 0
    assert main(["slo", "check", "--spec", "sdc_rate<=0.001",
                 "--input", str(doc)]) == 1
    assert "SLO verdict: page" in capsys.readouterr().out


def test_profile_verb(tmp_path):
    out = tmp_path / "p.json"
    assert main(["profile", "--target", "crc16|-TMR", "-t", "64",
                 "--batch-size", "32", "-d", "cpu", "--out", str(out)]) == 0
    blk = json.loads(out.read_text())["targets"]["crc16|-TMR"]
    assert blk["profile"]["dispatches"] == 2


def test_analysis_verb(tmp_path, capsys):
    from coast_tpu_torch.inject import supervisor
    assert supervisor.main(["-f", "crc16", "-t", "32", "-d", "cpu",
                            "-l", str(tmp_path)]) == 0
    logs = sorted(p for p in tmp_path.iterdir() if p.suffix == ".json")
    capsys.readouterr()
    assert main(["analysis", str(logs[0])]) == 0
    assert "crc16" in capsys.readouterr().out


def test_opt_and_fleet_verbs(tmp_path, capsys):
    assert main(["opt"]) == 2
    assert "usage: python -m coast_tpu_torch.opt" in capsys.readouterr().err
    q = str(tmp_path / "q")
    assert main(["fleet", "enqueue", "--queue", q, "-f", "crc16", "-t",
                 "8"]) == 0
    assert main(["fleet", "status", "--queue", q]) == 0
    out = capsys.readouterr().out
    assert json.loads(out[out.index("{"):])["queue"]["pending"] == 1


def test_module_entry_runs_as_a_process(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "coast_tpu_torch", "serve"],
        capture_output=True, text=True, timeout=120)
    # The serve CLI's own refusal: no benchmark named.
    assert proc.returncode == 2
    assert "the following arguments are required: benchmark" in proc.stderr
