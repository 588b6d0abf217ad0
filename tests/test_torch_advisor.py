"""The port's selective-hardening advisor (``analysis/advisor.py``), the
counterparts of the reference's ``tests/test_advisor.py`` and of its two
advisor tests in ``tests/test_propagation.py``.

On integer regions (matrixMultiply, quicksort, crc16) the port's campaign
codes equal the reference's, so ``advise`` gives the reference's ranked
``LeafHarm`` counts, protect list and ``config_text`` bit for bit.  Every
campaign runs on the CPU here (``device="cpu"``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from coast_tpu_torch import TMR
from coast_tpu_torch.analysis.advisor import (_selective_region,
                                              _sor_closure, advise, main)
from coast_tpu_torch.ir.region import KIND_RO
from coast_tpu_torch.models import REGISTRY, mm

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def region():
    return mm.make_region()


@pytest.fixture(scope="module")
def advice(region):
    return advise(region, budget=2048, target_harm=0.02, batch_size=1024,
                  device="cpu")


def harms_of(adv):
    return [(h.name, h.injections, h.sdc, h.due, h.invalid, h.words)
            for h in adv.ranked]


@pytest.mark.parametrize("name,budget", [("matrixMultiply", 512),
                                         ("quicksort", 256),
                                         ("crc16", 512)])
def test_advice_equals_the_reference(name, budget):
    from coast_tpu.analysis.advisor import advise as jadvise
    from coast_tpu.models import REGISTRY as JREG
    kw = dict(budget=budget, target_harm=0.02, batch_size=budget,
              validate=False)
    got = advise(REGISTRY[name](), device="cpu", **kw)
    want = jadvise(JREG[name](), **kw)
    assert harms_of(got) == harms_of(want)
    assert got.protect == want.protect
    assert got.config_text == want.config_text
    assert (got.protected_words, got.total_words) \
        == (want.protected_words, want.total_words)
    assert got.baseline_rate == want.baseline_rate
    assert got.format() == want.format()


def test_ro_leaves_never_protected(advice, region):
    for name in advice.protect:
        assert region.spec[name].kind != KIND_RO
    assert "golden" not in advice.protect


def test_selective_config_is_verifier_legal(advice, region):
    TMR(_selective_region(region, frozenset(advice.protect)),
        device="cpu")  # no raise


def test_closure_pulls_mutable_sources_and_ctrl(region):
    from coast_tpu_torch.passes.verification import analyze
    closed = _sor_closure(region, analyze(region), frozenset({"results"}))
    assert {"results", "acc", "i", "phase"} <= closed
    assert _sor_closure(region, analyze(region), frozenset()) == frozenset()


def test_validation_improves_harm_rate(advice):
    def rate(s):
        return (s["sdc"] + s["due_abort"] + s["due_timeout"]
                + s["invalid"]) / s["injections"]
    assert advice.achieved is not None and advice.full is not None
    assert rate(advice.achieved) < rate(advice.baseline)
    assert rate(advice.achieved) <= rate(advice.baseline) / 2


def test_generous_target_protects_less(region):
    kw = dict(budget=2048, batch_size=1024, validate=False, device="cpu")
    adv = advise(region, target_harm=0.5, **kw)
    full = advise(region, target_harm=0.0, **kw)
    assert set(adv.protect) <= set(full.protect)
    assert len(adv.protect) < len(full.protect)


def test_config_text_shape(advice):
    txt = advice.config_text
    assert txt.startswith("#")
    assert "cloneGlbls=" in txt and "ignoreGlbls=" in txt
    assert "golden" in txt.split("ignoreGlbls=")[1]


def test_report_format(advice):
    out = advice.format()
    assert "selective-hardening advice" in out
    assert "unprotected harm rate" in out
    assert "selective TMR harm rate" in out
    assert "full TMR harm rate" in out


def test_stratified_schedule_equal_allocation(region):
    from coast_tpu_torch.inject.campaign import CampaignRunner
    from coast_tpu_torch.inject.schedule import generate_stratified
    from coast_tpu_torch.passes.strategies import unprotected

    runner = CampaignRunner(unprotected(region, device="cpu"))
    sched = generate_stratified(runner.mmap, 64, seed=5,
                                nominal_steps=region.nominal_steps)
    assert (np.bincount(sched.section_idx) == 64).all()
    for sec in runner.mmap.sections:
        rows = sched.leaf_id == sec.leaf_id
        assert (sched.lane[rows] < sec.lanes).all()
        assert (sched.word[rows] < sec.words).all()
        assert (sched.bit[rows] < 32).all()
    again = generate_stratified(runner.mmap, 64, seed=5,
                                nominal_steps=region.nominal_steps)
    assert (again.word == sched.word).all() and (again.t == sched.t).all()
    other = generate_stratified(runner.mmap, 64, seed=6,
                                nominal_steps=region.nominal_steps)
    assert not (other.word == sched.word).all()


def test_stratified_measures_small_leaves(region):
    adv = advise(region, budget=1024, validate=False, device="cpu")
    by_name = {h.name: h for h in adv.ranked}
    assert by_name["i"].injections == by_name["first"].injections
    assert by_name["i"].injections >= 16
    lo, hi = by_name["i"].harm_ci95
    assert 0.0 <= lo <= hi <= 1.0 and hi - lo < 0.5


@pytest.mark.parametrize("bench", [
    "crc16", "towersOfHanoi", "schedule2", "simd", "crazyCF", "trivial",
    "simpleTMR", "helloWorld", "nestedCalls",
])
def test_advisor_sweep_builds_everywhere(bench):
    """Whatever the greedy picks, the selective program builds."""
    region = REGISTRY[bench]()
    adv = advise(region, budget=128, validate=False, batch_size=128,
                 device="cpu")
    TMR(_selective_region(region, frozenset(adv.protect)),
        device="cpu")  # no raise
    assert adv.ranked
    for h in adv.ranked:
        assert 0 <= h.harm <= h.injections


@pytest.mark.parametrize("bench", ["matrixMultiply", "quicksort"])
def test_cost_aware_never_larger_footprint(bench):
    region = REGISTRY[bench]()
    kw = dict(budget=512, target_harm=0.25, batch_size=512, validate=False,
              device="cpu")
    default = advise(region, **kw)
    cheap = advise(region, cost_aware=True, **kw)
    assert cheap.protected_words <= default.protected_words
    assert cheap.protect
    protected = set(cheap.protect)
    total_words = sum(h.words for h in cheap.ranked)
    resid = sum((h.words / total_words) * h.harm_rate
                for h in cheap.ranked if h.name not in protected)
    floor = sum((h.words / total_words) * h.harm_rate
                for h in cheap.ranked
                if region.spec[h.name].kind == KIND_RO)
    assert resid <= max(kw["target_harm"], floor) + 1e-9


def test_static_seeded_ranking_matches_at_quarter_budget():
    """The static-seeded probe at a quarter of the budget gives the full
    budget's ranking on mm, and the pure campaign's protect set."""
    kw = dict(validate=False, device="cpu")
    quarter = advise(mm.make_region(), budget=2048, static_seed=True, **kw)
    full = advise(mm.make_region(), budget=8192, static_seed=True, **kw)
    pure = advise(mm.make_region(), budget=8192, **kw)
    assert quarter.protect == full.protect
    assert sorted(quarter.protect) == sorted(pure.protect)
    assert quarter.static_verdicts["golden"] == "sdc-possible"
    assert pure.static_verdicts is None


def dead_golden_region():
    region = mm.make_region()
    old_check = region.check
    golden = region.init(torch.device("cpu"))["golden"].clone()

    def new_check(state):
        s2 = dict(state)
        s2["golden"] = golden.to(state["golden"].device).expand_as(
            state["golden"])
        return old_check(s2)

    return dataclasses.replace(region, check=new_check)


def test_static_seed_skips_masked_leaves():
    adv = advise(dead_golden_region(), budget=1024, validate=False,
                 static_seed=True, device="cpu")
    assert adv.static_verdicts["golden"] == "masked"
    by_name = {h.name: h for h in adv.ranked}
    assert by_name["golden"].injections == 0
    assert "golden" not in adv.protect
    assert all(h.injections > 0 for h in adv.ranked if h.name != "golden")
    assert sum(h.injections for h in adv.ranked) >= 1024 * 0.8


def test_cli(tmp_path, capsys):
    out = tmp_path / "functions.config"
    assert main(["matrixMultiply", "-e", "512", "-t", "0.5",
                 "--no-validate", "-o", str(out), "-d", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "selective-hardening advice: matrixMultiply" in text
    adv = advise(mm.make_region(), budget=512, target_harm=0.5,
                 validate=False, device="cpu")
    assert out.read_text() == adv.config_text
    assert adv.format() in text


def test_cli_refuses_c_sources_naming_item_17d(capsys):
    """A ``.c`` program that is not there: the reference's exit (2) and
    message; an unknown name stays a usage error."""
    from coast_tpu.analysis.advisor import main as jmain
    with pytest.raises(SystemExit) as want:
        jmain(["prog.c"])
    want_err = capsys.readouterr().err.strip().splitlines()[-1]
    with pytest.raises(SystemExit) as got:
        main(["prog.c", "-d", "cpu"])
    got_err = capsys.readouterr().err.strip().splitlines()[-1]
    assert got.value.code == want.value.code == 2
    assert got_err.split("error:")[1] == want_err.split("error:")[1]
    assert "file prog.c does not exist" in got_err
    with pytest.raises(SystemExit):
        main(["nonesuch", "-d", "cpu"])
