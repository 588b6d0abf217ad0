"""Campaign parity of the PyTorch port against the JAX reference, and the
port's package rules.

``CampaignRunner(prog).run(256, seed=3, batch_size=64)`` of the port must
give the reference's codes, errors, corrected and steps arrays and counts
dict: exact on mm and crc16 under every strategy, exact on the mm256 family
outside the rows a float32 summation order may decide
(``mm256.order_sensitive``).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import coast_tpu
import coast_tpu_torch as ct
from coast_tpu.inject.campaign import CampaignRunner as JCampaignRunner
from coast_tpu.models import crc16 as jcrc16
from coast_tpu.models import mm as jmm
from coast_tpu.models import mm256 as jmm256
from coast_tpu_torch.inject.campaign import CampaignRunner
from coast_tpu_torch.models import crc16, mm, mm256

# The suite runs under xdist, several workers to a host: one intra-op
# thread per worker keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REGIONS = {
    "mm": (jmm.make_region, mm.make_region),
    "mm256_64": (lambda: jmm256.make_region(side=64, block=16),
                 lambda: mm256.make_region(side=64, block=16)),
    "mm256_128_bf16": (
        lambda: jmm256.make_region(side=128, block=32, bf16_matmul=True),
        lambda: mm256.make_region(side=128, block=32, bf16_matmul=True)),
    "crc16": (jcrc16.make_region, crc16.make_region),
}
STRATEGIES = {"unprotected": (coast_tpu.unprotected, ct.unprotected),
              "DWC": (coast_tpu.DWC, ct.DWC),
              "TMR": (coast_tpu.TMR, ct.TMR)}
COLUMNS = ("codes", "errors", "corrected", "steps")
CASES = ([(r, s, 256) for r in ("mm", "crc16") for s in sorted(STRATEGIES)]
         + [(r, s, 256) for r in ("mm256_64", "mm256_128_bf16")
            for s in ("DWC", "TMR")]
         + [("mm", "TMR", 200), ("mm256_64", "DWC", 200)])   # ragged tail


@pytest.mark.parametrize("region,strategy,n", CASES)
def test_campaign_parity(region, strategy, n):
    jr, tr = (f() for f in REGIONS[region])
    js, ts = STRATEGIES[strategy]
    ref = JCampaignRunner(js(jr)).run(n, seed=3, batch_size=64)
    prog = ts(tr, device="cpu")
    res = CampaignRunner(prog, device="cpu").run(n, seed=3, batch_size=64)
    assert res.n == ref.n == n
    assert res.benchmark == ref.benchmark
    assert res.strategy == ref.strategy
    for col in ("leaf_id", "lane", "word", "bit", "t"):
        np.testing.assert_array_equal(getattr(res.schedule, col),
                                      getattr(ref.schedule, col))
    exempt = np.zeros(n, bool)
    if region.startswith("mm256"):
        exempt = mm256.order_sensitive(prog.leaf_order, res.schedule.leaf_id,
                                       res.schedule.bit)
    for col in COLUMNS:
        np.testing.assert_array_equal(
            getattr(res, col)[~exempt], getattr(ref, col)[~exempt],
            err_msg=f"{col} (exempt rows {np.nonzero(exempt)[0]})")
    assert list(res.counts) == list(ref.counts)
    assert "cache_invalid" in res.counts
    if all(np.array_equal(getattr(res, c), getattr(ref, c)) for c in COLUMNS):
        assert res.counts == ref.counts
    else:
        # Only exempt rows may move, each one class at most.
        moved = int((res.codes != ref.codes).sum())
        assert sum(abs(res.counts[k] - ref.counts[k])
                   for k in ref.counts) <= 2 * moved
    assert res.injections_per_sec > 0


def record_grid(output_words):
    """Every combination of the record fields classify reads."""
    import itertools
    rows = list(itertools.product(
        (-1, 0, 1, output_words, output_words + 1), (0, 2),
        *([(False, True)] * 5)))
    cols = np.array(rows, dtype=np.int64).T
    rec = {"errors": cols[0], "corrected": cols[1]}
    for k, c in zip(("done", "dwc_fault", "cfc_fault", "assert_fault",
                     "stack_fault"), cols[2:]):
        rec[k] = c.astype(bool)
    rec["errors"] = rec["errors"].astype(np.int32)
    rec["corrected"] = rec["corrected"].astype(np.int32)
    return rec


def test_classify_precedence_matches_reference():
    from coast_tpu.inject import classify as jcls
    from coast_tpu_torch.inject import classify as cls
    rec = record_grid(81)
    ref = np.asarray(jcls.classify(rec, 81))
    got = cls.classify({k: torch.from_numpy(v) for k, v in rec.items()}, 81)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert set(ref.tolist()) == {0, 1, 2, 3, 4, 5, 6, 7}


def test_class_tables_and_histograms_match_reference():
    from coast_tpu.inject import classify as jcls
    from coast_tpu_torch.inject import classify as cls
    for name in ("NUM_CLASSES", "CLASS_NAMES", "BASE_CLASS_NAMES",
                 "DUE_CLASSES", "SDC_CLASSES", "COMPLETED_CLASSES", "SUCCESS",
                 "CORRECTED", "SDC", "DUE_ABORT", "DUE_TIMEOUT", "INVALID",
                 "DUE_STACK_OVERFLOW", "DUE_ASSERT", "TRAIN_SELF_HEAL",
                 "TRAIN_SDC"):
        assert getattr(cls, name) == getattr(jcls, name), name
    codes = np.random.default_rng(2).integers(0, 10, 500).astype(np.int32)
    weights = np.random.default_rng(3).random(500) * 4
    np.testing.assert_array_equal(
        cls.histogram(torch.from_numpy(codes)).numpy(),
        np.asarray(jcls.histogram(codes)))
    np.testing.assert_array_equal(cls.completed_mask(codes),
                                  jcls.completed_mask(codes))
    for w in (None, weights):
        np.testing.assert_array_equal(cls.weighted_histogram(codes, w),
                                      jcls.weighted_histogram(codes, w))
    binc = np.bincount(codes % 8, minlength=10)
    for train in (False, True):
        assert (cls.counts_dict(binc, train)
                == jcls.counts_dict(binc, train))


def test_start_num_resumes_the_same_stream():
    prog = ct.TMR(mm.make_region(), device="cpu")
    runner = CampaignRunner(prog)
    whole = runner.run(96, seed=5, batch_size=32)
    tail = runner.run(32, seed=5, batch_size=32, start_num=64)
    np.testing.assert_array_equal(tail.schedule.t, whole.schedule.t[64:])
    np.testing.assert_array_equal(tail.codes, whole.codes[64:])


def test_runner_device_must_match_program():
    prog = ct.TMR(mm.make_region(), device="cpu")
    with pytest.raises(ValueError):
        CampaignRunner(prog, device="cuda:0")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid")
    region = mm.make_region()
    with pytest.raises(RuntimeError, match="cuda"):
        CampaignRunner(ct.TMR(region))
    with pytest.raises(RuntimeError, match="cuda"):
        region.run_unprotected()


def test_port_imports_no_jax_and_nothing_of_coast_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import coast_tpu_torch\n"
        "for m in pkgutil.walk_packages(coast_tpu_torch.__path__,\n"
        "                               'coast_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'coast_tpu')\n"
        "             or m.startswith(('jax.', 'coast_tpu.')))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
