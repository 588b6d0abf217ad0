"""A run's last line, the check, its control and its faults.

Each run here skips ``run.py``'s look for a card and drives the rest of a
run on the CPU at a small size (``harness.run_cell`` with traffic
overrides).  The fault tests break the timed path underneath and see
``correct`` come out false."""

import json
import os
import subprocess
import sys

import pytest
import torch

from perfbench import control, harness

SMALL = {"mm9-tmr-fused.single": dict(batch=256, campaign_n=512,
                                      schedules=2),
         "mm9-tmr-fused.multibit4": dict(batch=256, campaign_n=512,
                                         schedules=2),
         "mm9-tmr-fused.single-dense": dict(batch=256, campaign_n=512,
                                            schedules=2),
         "mm1024-tmr.single": dict(batch=2, campaign_n=2, schedules=2)}
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _run(bench, cell, seed=2 ** 31 + 99, seconds=0.3):
    return harness.run_cell(bench, cell, seed, seconds, False, device="cpu",
                            overrides=SMALL[cell])[0]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_last_line_shape(bench, cell):
    out = _run(bench, cell)
    assert list(out) == KEYS              # checks last, no breakdown
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    assert set(out["metrics"]) == {"inj_per_s", "setup_s"}   # CPU: no peak
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert out["checks"] == {"rows_differ": {"value": 0, "limit": 0},
                             "count_diff": {"value": 0, "limit": 0}}
    json.dumps(out)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_fails(bench, cell):
    """The reference in the program's place, in the precision below the
    configuration's, fails the check on every seed."""
    rows = control.readings(bench, cell, [1, 2, 2 ** 31 + 3],
                            torch.device("cpu"), overrides=SMALL[cell],
                            log=lambda *_: None)
    for row in rows:
        assert row["program"] == {"rows_differ": 0, "count_diff": 0}
        assert row["control"]["rows_differ"] > harness.LIMITS["rows_differ"]


def _step_unchanged(self, pstate, flags, t):
    return pstate, flags


def _half_batch(run_batch):
    def inner(self, fault=None, *a, **kw):
        rec = run_batch(self, fault, *a, **kw)
        half = next(iter(rec.values())).shape[0] // 2
        return {k: (torch.cat([v[:half], v[:half]])[:v.shape[0]]
                    if isinstance(v, torch.Tensor) and v.dim() else v)
                for k, v in rec.items()}
    return inner


def _altered_answer(classify):
    def inner(rec, output_words):
        code = classify(rec, output_words).clone()
        code[0] = (code[0] + 1) % 3
        return code
    return inner


FAULTS = ["step_unchanged", "half_batch", "altered_answer"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", ["mm9-tmr-fused.single",
                                  "mm9-tmr-fused.single-dense",
                                  "mm1024-tmr.single"])
def test_a_broken_timed_path_is_not_correct(bench, monkeypatch, cell, fault):
    from coast_tpu_torch.inject import classify as cls
    from coast_tpu_torch.passes.dataflow_protection import ProtectedProgram
    if fault == "step_unchanged":
        monkeypatch.setattr(ProtectedProgram, "step", _step_unchanged)
    elif fault == "half_batch":
        monkeypatch.setattr(ProtectedProgram, "run_batch",
                            _half_batch(ProtectedProgram.run_batch))
    else:
        monkeypatch.setattr(cls, "classify", _altered_answer(cls.classify))
    out = _run(bench, cell)
    assert out["correct"] is False
    assert any(v["value"] > v["limit"] for v in out["checks"].values())


def test_no_card_no_result(tmp_path):
    """Without a card run.py exits non-zero and prints nothing on stdout,
    never falling back to the CPU."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    root = harness.__file__.rsplit("/", 2)[0]
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "mm1024-tmr.single", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=root, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_run_on_the_card(card, bench):
    """The one command on the card: a short traced run of the smallest
    cell's shape, with the card named."""
    root = harness.__file__.rsplit("/", 2)[0]
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "mm9-tmr-fused.single", "--seed", "5", "--seconds", "2",
         "--trace", "1"], cwd=root, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["busy_s"] > 0
    assert list(out)[-1] == "checks"


test_run_on_the_card = pytest.mark.cuda(test_run_on_the_card)
