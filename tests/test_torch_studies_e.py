"""The port's one-command workflow (``coast_tpu_torch/scripts/
zero_to_aha.sh``) on the CPU: protect and run ``tests/c_sources/mm9.c``,
force one fault, a seeded campaign with a reference-format log and the
port's analysis of that log, every step with ``-d cpu``, ending in exit 0
with its records under ``build/studies/``."""

import json
import os
import re
import shutil
import subprocess

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKFLOW = os.path.join(ROOT, "coast_tpu_torch", "scripts", "zero_to_aha.sh")


def test_zero_to_aha_on_the_cpu():
    got = subprocess.run(["sh", WORKFLOW, "-d", "cpu",
                          "tests/c_sources/mm9.c", "64"], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    logdir = re.search(r"^logs in: (\S+)$", got.stdout, re.M)
    try:
        assert got.returncode == 0, got.stdout[-2000:] + got.stderr[-3000:]
        assert logdir and logdir.group(1).startswith("build/studies/")
        for step in range(1, 5):
            assert f"== {step}. " in got.stdout, step
        assert "E: 0" in got.stdout                       # opt -countErrors
        log = os.path.join(ROOT, logdir.group(1), "mm9_TMR_memory.json")
        with open(log) as fh:
            assert fh.readline().strip() == os.path.realpath(
                os.path.join(ROOT, "tests", "c_sources", "mm9.c"))
        with open(log) as fh:
            fh.readline()
            assert len(json.load(fh)) == 64
        assert "error rate" in got.stdout                  # the analysis
    finally:
        if logdir:
            shutil.rmtree(os.path.join(ROOT, logdir.group(1)),
                          ignore_errors=True)


def test_zero_to_aha_refuses_another_device():
    got = subprocess.run(["sh", WORKFLOW, "-d", "tpu"], cwd=ROOT,
                         capture_output=True, text=True, timeout=60)
    assert got.returncode == 2
    assert "-d takes cpu or cuda" in got.stderr
