"""Delta campaigns of the port (``CampaignRunner.run_delta``,
``analysis/equiv/delta.py``, ``--delta-from``), the counterparts of the
reference's delta tests in ``tests/test_equiv.py``.

A no-op rebuild re-injects no row; a one-section edit (golden's check
consumption gains ``^ 0`` before its compare) re-injects exactly golden's
rows and gives the base's counts; a base without the representatives
record splices by position only when the schedule sha proves it; the typed
refusals carry the reference's messages; per-section ``stop_when``
converges each re-injected section on its own; the CLI runs it; and the
static budget (the vulnerability map) orders the re-injected sections and
records its verdicts (its spend against the reference's is held in
``tests/test_torch_propagation.py``).

Across packages: the fingerprints are each package's own, so a delta
whose base the reference wrote re-injects every row (and still gives the
base's counts).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from coast_tpu_torch import TMR
from coast_tpu_torch.analysis.equiv import (DeltaMismatchError,
                                            section_fingerprints)
from coast_tpu_torch.analysis.equiv.delta import load_delta_base, plan_delta
from coast_tpu_torch.inject.campaign import CampaignRunner
from coast_tpu_torch.inject.schedule import generate
from coast_tpu_torch.models import mm
from coast_tpu_torch.obs.convergence import StopWhen

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mm_tmr():
    return TMR(mm.make_region(), device="cpu")


@pytest.fixture(scope="module")
def mm_tmr_equiv(mm_tmr):
    return CampaignRunner(mm_tmr, strategy_name="TMR", equiv=True)


def edited_region():
    """The one-section edit: golden is xor'ed with 0 before its compare, so
    only golden's cone (and fingerprint) changes."""
    region = mm.make_region()
    old_check = region.check

    def new_check(state):
        state2 = dict(state)
        state2["golden"] = state["golden"] ^ 0
        return old_check(state2)

    return dataclasses.replace(region, check=new_check)


def test_delta_noop_rebuild_reinjects_zero(mm_tmr_equiv, tmp_path):
    jpath = str(tmp_path / "base.journal")
    base = mm_tmr_equiv.run(2048, seed=3, batch_size=512, journal=jpath)
    rebuilt = CampaignRunner(TMR(mm.make_region(), device="cpu"),
                             strategy_name="TMR", equiv=True)
    beats = []
    res = rebuilt.run_delta(2048, jpath, seed=3, batch_size=512,
                            progress=lambda d, c: beats.append(d))
    assert res.delta["changed_sections"] == []
    assert res.delta["reinjected_rows"] == 0
    assert res.delta["reused_rows"] == base.physical_n
    assert res.counts == base.counts
    assert np.array_equal(res.codes, base.codes)
    assert res.n == 2048 and res.physical_n == base.physical_n
    assert "delta" in res.summary() and beats == [base.physical_n]


def test_delta_one_section_edit_reinjects_exactly_it(mm_tmr_equiv,
                                                     tmp_path):
    jpath = str(tmp_path / "base2.journal")
    base = mm_tmr_equiv.run(2048, seed=3, batch_size=512, journal=jpath)
    edited = CampaignRunner(TMR(edited_region(), device="cpu"),
                            strategy_name="TMR", equiv=True)
    old_fp = section_fingerprints(mm_tmr_equiv.prog,
                                  mm_tmr_equiv.equiv_partition)
    new_fp = section_fingerprints(edited.prog, edited.equiv_partition)
    assert {k for k in new_fp if new_fp[k] != old_fp[k]} == {"golden"}
    res = edited.run_delta(2048, jpath, seed=3, batch_size=512)
    assert res.delta["changed_sections"] == ["golden"]
    golden_id = edited.equiv_partition.signatures["golden"].leaf_id
    reinjected = res.delta["reinjected_rows"]
    assert reinjected == int(
        (np.asarray(res.schedule.leaf_id) == golden_id).sum())
    assert res.delta["reused_rows"] + reinjected == res.physical_n
    assert set(res.delta["sections"]) == {"golden"}
    # The edit is a no-op in value: the base's distribution.
    assert res.counts == base.counts


def test_delta_positional_fallback_validates_schedule_sha(mm_tmr_equiv,
                                                          tmp_path):
    jpath = str(tmp_path / "norec.journal")
    base = mm_tmr_equiv.run(1024, seed=3, batch_size=256, journal=jpath)
    with open(jpath) as fh:
        lines = fh.read().splitlines()
    kept = [ln for ln in lines
            if json.loads(ln).get("kind") != "equiv_schedule"]
    with open(jpath, "w") as fh:
        fh.write("\n".join(kept) + "\n")
    res = mm_tmr_equiv.run_delta(1024, jpath, seed=3, batch_size=256)
    assert res.delta["reinjected_rows"] == 0
    assert np.array_equal(res.codes, base.codes)
    edited = CampaignRunner(TMR(edited_region(), device="cpu"),
                            strategy_name="TMR", equiv=True)
    with pytest.raises(DeltaMismatchError):
        edited.run_delta(1024, jpath, seed=3, batch_size=256)
    # Same row count, other rows: the sha alone refuses the splice.
    header, _, base_out, base_rows = load_delta_base(jpath)
    part = mm_tmr_equiv.equiv_partition
    sched = part.reduce(generate(mm_tmr_equiv.mmap, 1024, 3, 18))
    shifted = dataclasses.replace(sched,
                                  bit=(np.asarray(sched.bit) + 1) % 32)
    fps = {name: sig.fingerprint for name, sig in part.signatures.items()}
    names = {sig.leaf_id: name for name, sig in part.signatures.items()}
    current = {k: header.get(k) for k in
               ("mode", "benchmark", "strategy", "seed", "n", "start_num")}
    with pytest.raises(DeltaMismatchError, match="equiv_schedule"):
        plan_delta(header, None, base_out, base_rows, current, fps,
                   shifted, names, base_path=jpath)


def ref_delta_error(fn):
    from coast_tpu.analysis.equiv import DeltaMismatchError as JDelta
    with pytest.raises(JDelta) as err:
        fn()
    return str(err.value)


def test_delta_typed_refusals(mm_tmr, mm_tmr_equiv, tmp_path):
    """Each refusal is the reference's, message for message (paths
    aside: each package reads its own journal)."""
    from coast_tpu import TMR as JTMR
    from coast_tpu.inject.campaign import CampaignRunner as JRunner
    from coast_tpu.models import mm as jmm
    jrunner = JRunner(JTMR(jmm.make_region()), strategy_name="TMR",
                      equiv=True)

    def both(make_base, call):
        got_path, want_path = (str(tmp_path / f"{tag}.journal")
                               for tag in ("port", "ref"))
        make_base(mm_tmr_equiv, CampaignRunner(mm_tmr, strategy_name="TMR"),
                  got_path)
        make_base(jrunner, JRunner(jrunner.prog, strategy_name="TMR"),
                  want_path)
        with pytest.raises(DeltaMismatchError) as got:
            call(mm_tmr_equiv, got_path)
        want = ref_delta_error(lambda: call(jrunner, want_path))
        assert str(got.value).replace(got_path, "J") \
            == want.replace(want_path, "J")
        for p in (got_path, want_path):
            (tmp_path / p).unlink()

    def equiv_base(runner, plain, path):
        runner.run(512, seed=3, batch_size=256, journal=path)

    def plain_base(runner, plain, path):
        plain.run(512, seed=3, batch_size=256, journal=path)

    def torn_base(runner, plain, path):
        runner.run(512, seed=3, batch_size=256, journal=path)
        with open(path) as fh:
            keep = [ln for ln in fh.read().splitlines()
                    if json.loads(ln).get("kind") != "batch"]
        with open(path, "w") as fh:
            fh.write("\n".join(keep) + "\n")

    def delta(seed):
        return lambda r, p: r.run_delta(512, p, seed=seed, batch_size=256)

    both(equiv_base, delta(4))          # another seed
    both(plain_base, delta(3))          # no fingerprint block
    both(torn_base, delta(3))           # missing rows
    with pytest.raises(ValueError, match="equiv=True"):
        CampaignRunner(mm_tmr, strategy_name="TMR").run_delta(
            512, str(tmp_path / "x"), seed=3)
    with pytest.raises(ValueError, match="dense"):
        CampaignRunner(mm_tmr, strategy_name="TMR", collect="sparse",
                       equiv=mm_tmr_equiv.equiv_partition).run_delta(
            512, str(tmp_path / "x"), seed=3)


def test_delta_per_section_stop_when(mm_tmr_equiv, tmp_path):
    jpath = str(tmp_path / "base4.journal")
    mm_tmr_equiv.run(4096, seed=3, batch_size=512, journal=jpath)
    edited = CampaignRunner(TMR(edited_region(), device="cpu"),
                            strategy_name="TMR", equiv=True)
    stop = StopWhen.parse("sdc:0.2;min=32")
    res = edited.run_delta(4096, jpath, seed=3, batch_size=64,
                           stop_when=stop)
    conv = res.convergence
    assert set(conv["per_section"]) == {"golden"}
    assert conv["stop_when"] == stop.spec()
    assert conv["stopped"] is True
    dropped = res.delta["dropped_rows"]
    assert dropped > 0
    assert res.physical_n == (res.delta["reused_rows"]
                              + res.delta["reinjected_rows"] - dropped)
    assert len(res.codes) == res.physical_n
    assert res.n == int(res.schedule.class_weight.sum())


def test_static_budget_names_item_17c(mm_tmr_equiv, tmp_path, capsys):
    """Item 17c landed: the static budget records the map's verdicts and
    re-injects the changed sdc-possible section under the full floor; the
    supervisor flag needs --delta-from and --stop-when, as the
    reference's does."""
    from coast_tpu_torch.inject import supervisor
    jpath = str(tmp_path / "sb.journal")
    mm_tmr_equiv.run(1024, seed=3, batch_size=512, journal=jpath)
    edited = CampaignRunner(TMR(edited_region(), device="cpu"),
                            strategy_name="TMR", equiv=True)
    stop = StopWhen.parse("sdc:0.2;min=64")
    res = edited.run_delta(1024, jpath, seed=3, batch_size=64,
                           stop_when=stop, static_budget=True)
    sb = res.delta["static_budget"]
    assert sb["verdicts"]["golden"] == "sdc-possible"
    assert sb["verdicts"]["results"] == "detected-bounded"
    assert sb["order"] == ["golden"] and "relaxed_min" not in sb
    plain = edited.run_delta(1024, jpath, seed=3, batch_size=64,
                             stop_when=stop)
    assert "static_budget" not in plain.delta
    assert plain.counts == res.counts
    with pytest.raises(SystemExit) as exc:
        supervisor.main(["-f", "matrixMultiply", "-t", "8", "-d", "cpu",
                         "--delta-from", "x.journal", "--static-budget"])
    assert exc.value.code == -1
    assert "needs --delta-from AND --stop-when" in capsys.readouterr().err


def test_delta_from_through_the_cli(tmp_path, capsys):
    from coast_tpu_torch.inject import supervisor
    jpath = str(tmp_path / "cli.journal")
    base = ["-f", "matrixMultiply", "-O=-TMR", "-t", "1024", "--seed", "3",
            "--batch-size", "256", "-d", "cpu", "-q"]
    assert supervisor.main([*base, "--equiv", "--journal", jpath]) == 0
    first = capsys.readouterr().out
    assert supervisor.main([*base, "--delta-from", jpath]) == 0
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if ln.startswith("{"))
    summary = eval(line, {"inf": float("inf")})   # the printed summary
    assert summary["delta"]["reinjected_rows"] == 0
    assert summary["delta"]["changed_sections"] == []
    first_summary = eval(next(ln for ln in first.splitlines()
                              if ln.startswith("{")), {"inf": float("inf")})
    assert {k: summary[k] for k in ("success", "corrected", "sdc")} == \
        {k: first_summary[k] for k in ("success", "corrected", "sdc")}
    # A base without the fingerprint block exits 1 with the typed error.
    plain = str(tmp_path / "plain.journal")
    assert supervisor.main([*base, "--journal", plain]) == 0
    capsys.readouterr()
    assert supervisor.main([*base, "--delta-from", plain]) == 1
    assert "section-fingerprint block" in capsys.readouterr().err


def test_cross_package_delta_reinjects_every_row(mm_tmr_equiv, tmp_path):
    """The reference's fingerprints hash jaxpr primitives, the port's aten
    operators: every section counts as changed."""
    from coast_tpu import TMR as JTMR
    from coast_tpu.inject.campaign import CampaignRunner as JRunner
    from coast_tpu.models import mm as jmm
    jpath = str(tmp_path / "ref.journal")
    base = JRunner(JTMR(jmm.make_region()), strategy_name="TMR",
                   equiv=True).run(1024, seed=3, batch_size=256,
                                   journal=jpath)
    res = mm_tmr_equiv.run_delta(1024, jpath, seed=3, batch_size=256)
    assert res.delta["reused_rows"] == 0
    assert res.delta["reinjected_rows"] == res.physical_n == base.physical_n
    assert sorted(res.delta["changed_sections"]) == sorted(
        mm_tmr_equiv.equiv_partition.signatures)
    assert res.counts == {k: int(v) for k, v in base.counts.items()}
