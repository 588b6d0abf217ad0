"""The port's protection-regression CI (``coast_tpu_torch/ci``) against the
reference's (``coast_tpu/ci``), on the CPU.

The committed ``artifacts/ci_baseline.json`` (written by the reference)
checks clean under the port: every row is re-injected, because its
section fingerprints are the reference's (and predate this jax) while the
port's are its own (a cone entry is an aten operator), and the counts
equal the baseline's.  Baselines cross packages both ways; a no-op check
of the port's own baseline re-injects nothing; the seeded weakening (the
``program_hook`` that drops the TMR commit vote) gives the reference's
verdict; the isolation pre-gate under the seeded voter bypass drifts with
the reference's leak outputs and skips the rest; an identity mismatch is
infra (exit 2); and the CLI's baseline -> check -> refresh cycle runs
through ``python -m coast_tpu_torch ci``, once with two worker processes.
"""

import json
import os
import re

import pytest
import torch

from coast_tpu_torch.ci import baseline as pbase
from coast_tpu_torch.ci import engine as pengine
from coast_tpu_torch.inject.spec import CampaignSpec as PSpec

torch.set_num_threads(1)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = os.path.join(REPO_ROOT, "artifacts", "ci_baseline.json")

# The committed targets: rows each baseline journal holds (its
# equivalence representatives), all re-injected by the port.
COMMITTED_ROWS = {"crc16|-DWC|memory|s7": 13, "crc16|-TMR|memory|s7": 13,
                  "matrixMultiply|-DWC|memory|s7": 535,
                  "matrixMultiply|-TMR|memory|s7": 546}

SMALL = (("matrixMultiply", "-TMR"), ("crc16", "-DWC"))


def _specs(spec_cls, n=512):
    return [spec_cls(bench, n, seed=7, opt_passes=opt, batch_size=256,
                     equiv=True) for bench, opt in SMALL]


def _weaken(prog):
    """The seeded protection-weakening edit of both packages' smoke
    drivers: drop the TMR store-data commit vote."""
    if prog.region.name == "matrixMultiply" \
            and prog.step_sync.get("results"):
        prog.step_sync["results"] = False


def _copy(doc):
    return json.loads(json.dumps(doc))


@pytest.fixture(scope="module")
def port_doc():
    return pengine.build_baseline(_specs(PSpec), device="cpu")


@pytest.fixture(scope="module")
def ref_doc():
    from coast_tpu.ci import engine as jengine
    from coast_tpu.inject.spec import CampaignSpec as JSpec
    return jengine.build_baseline(_specs(JSpec))


def _summary(report):
    """What both packages' reports must agree on, target by target."""
    return {t.target: {"drift": t.drift,
                       "changed": list(t.changed_sections),
                       "reused": t.reused_rows,
                       "reinjected": t.reinjected_rows,
                       "n": t.n, "counts": dict(t.counts),
                       "drift_lines": t.drift_lines()}
            for t in report.targets}


# -- the committed, reference-written baseline --------------------------------

def test_committed_baseline_checks_clean_reinjecting_every_row():
    doc = pbase.load_baseline(COMMITTED)
    report = pengine.check_baseline(doc, device="cpu")
    assert report.exit_code == pengine.EXIT_PASS
    assert {t.target: t.reinjected_rows for t in report.targets} \
        == COMMITTED_ROWS
    for t in report.targets:
        assert t.reused_rows == 0 and t.dropped_rows == 0
        assert t.counts == t.base_counts == doc["targets"][t.target][
            "counts"], t.target
        assert t.n == t.base_n == 2048
    # The refreshed artifact carries the port's provenance and loads in
    # the reference.
    refreshed = report.refreshed
    assert refreshed["torch"] == torch.__version__
    assert refreshed["device"] == "cpu"
    assert "jax" not in refreshed


def test_committed_baseline_loads_with_the_reference_fields():
    from coast_tpu.ci.baseline import load_baseline as jload
    doc = pbase.load_baseline(COMMITTED)
    assert doc == jload(COMMITTED)
    assert "jax" in doc and "backend" in doc      # metadata, not refused
    assert set(doc["targets"]) == set(COMMITTED_ROWS)


@pytest.mark.parametrize("doc", [{"format": "something-else"},
                                 {"format": "coast-ci-baseline",
                                  "version": 2, "targets": {"t": {}}},
                                 {"format": "coast-ci-baseline",
                                  "version": 1, "targets": {}}])
def test_malformed_baseline_refused_as_the_reference(tmp_path, doc):
    from coast_tpu.ci.baseline import BaselineError as JError
    from coast_tpu.ci.baseline import load_baseline as jload
    path = tmp_path / "bl.json"
    path.write_text(json.dumps(doc))
    with pytest.raises(pbase.BaselineError) as mine:
        pbase.load_baseline(str(path))
    with pytest.raises(JError) as theirs:
        jload(str(path))
    assert str(mine.value) == str(theirs.value)


# -- baselines across packages ------------------------------------------------

def test_port_baseline_equals_the_reference_outside_fingerprints(port_doc,
                                                                 ref_doc):
    assert set(port_doc["targets"]) == set(ref_doc["targets"])
    assert port_doc["device"] == "cpu" and "jax" not in port_doc
    for tid, mine in port_doc["targets"].items():
        theirs = ref_doc["targets"][tid]
        for key in ("spec", "strategy", "config_sha", "n", "physical_n",
                    "counts"):
            assert mine[key] == theirs[key], (tid, key)
        assert set(mine["section_fingerprints"]) \
            == set(theirs["section_fingerprints"])
        # Same rows (site columns and codes); the header's fingerprints
        # and partition hash are each package's own.
        assert mine["journal"][1:] == theirs["journal"][1:], tid


def test_reference_baseline_checked_by_the_port(ref_doc):
    report = pengine.check_baseline(ref_doc, device="cpu")
    assert report.exit_code == pengine.EXIT_PASS
    for t in report.targets:
        assert t.counts == t.base_counts, t.target
        assert t.reused_rows == 0          # fingerprints are per package
        assert t.reinjected_rows > 0


def test_port_baseline_checked_by_the_reference(port_doc):
    from coast_tpu.ci import engine as jengine
    report = jengine.check_baseline(_copy(port_doc))
    assert report.exit_code == jengine.EXIT_PASS
    for t in report.targets:
        assert t.counts == t.base_counts, t.target
        assert t.reused_rows == 0 and t.reinjected_rows > 0


def test_noop_check_of_own_baseline_reinjects_nothing(port_doc):
    report = pengine.check_baseline(port_doc, device="cpu")
    assert report.exit_code == pengine.EXIT_PASS
    for t in report.targets:
        assert t.reinjected_rows == 0 and t.changed_sections == []
        assert t.counts == t.base_counts
    # The refreshed artifact is itself a clean splice base.
    again = pengine.check_baseline(report.refreshed, device="cpu")
    assert again.exit_code == pengine.EXIT_PASS
    assert not any(t.reinjected_rows for t in again.targets)


# -- verdicts -----------------------------------------------------------------

def test_weakened_build_gives_the_reference_verdict(port_doc, ref_doc):
    from coast_tpu.ci import engine as jengine
    mine = pengine.check_baseline(port_doc, program_hook=_weaken,
                                  device="cpu")
    theirs = jengine.check_baseline(ref_doc, program_hook=_weaken)
    assert mine.exit_code == theirs.exit_code == pengine.EXIT_DRIFT
    assert _summary(mine) == _summary(theirs)
    mm = next(t for t in mine.targets
              if t.target.startswith("matrixMultiply|"))
    crc = next(t for t in mine.targets if t.target.startswith("crc16|"))
    assert mm.drift and mm.changed_sections and mm.reinjected_rows
    assert not crc.drift and crc.reinjected_rows == 0
    assert mine.format().splitlines()[-1] \
        == "ci: 2 target(s); protection-regression DRIFT"


def test_program_hook_needs_the_in_process_worker(port_doc):
    with pytest.raises(pengine.CiInfraError, match="in-process worker"):
        pengine.check_baseline(port_doc, program_hook=_weaken, workers=2,
                               device="cpu")


_LEAK = re.compile(r"^\[(\w+)\] .* -> output '(\w+)'")


def _gate_doc(spec_cls):
    """Two protected targets and one unprotected one (whose proof holds
    vacuously): the gate reads only spec, n and counts."""
    targets = {}
    for bench, opt in SMALL + (("crc16", ""),):
        spec = spec_cls(bench, 512, seed=7, opt_passes=opt, equiv=True)
        targets[pbase.target_id(spec)] = {
            "spec": spec.to_item(), "n": 512, "counts": {"success": 512}}
    return {"targets": targets}


def test_isolation_pregate_under_voter_bypass():
    from coast_tpu.analysis.propagation import \
        seeded_voter_bypass as jbypass
    from coast_tpu.ci import engine as jengine
    from coast_tpu_torch.analysis.propagation import seeded_voter_bypass
    doc = _gate_doc(PSpec)
    with seeded_voter_bypass():
        mine = pengine.check_baseline(doc, device="cpu")
    with jbypass():
        theirs = jengine.check_baseline(_copy(doc))
    assert mine.exit_code == theirs.exit_code == pengine.EXIT_DRIFT
    for m, j in zip(mine.targets, theirs.targets):
        assert (m.target, m.drift, m.comparison) \
            == (j.target, j.drift, j.comparison)
        # The paths run through each package's own operators; the leak
        # kind and the output each reaches are the same.
        assert sorted(_LEAK.match(l).groups() for l in m.isolation_leaks) \
            == sorted(_LEAK.match(l).groups() for l in j.isolation_leaks)
        assert m.reinjected_rows == m.n == 0
    by_target = {t.target: t for t in mine.targets}
    assert by_target["crc16||memory|s7"].comparison == {
        "skipped": "isolation pre-gate failed on another target; no "
                   "campaign ran"}
    assert by_target["crc16||memory|s7"].drift_lines() == [
        "isolation pre-gate failed on another target; no campaign ran"]
    assert all(by_target[t].isolation_leaks
               and by_target[t].drift_lines()[0].startswith("isolation: ")
               for t in ("matrixMultiply|-TMR|memory|s7",
                         "crc16|-DWC|memory|s7"))
    # No campaign ran, so the refreshed document is the old targets.
    assert set(mine.refreshed["targets"]) == set(doc["targets"])


def test_identity_mismatch_is_infra(port_doc):
    doc = _copy(port_doc)
    tid = sorted(doc["targets"])[0]
    doc["targets"][tid]["spec"]["seed"] = 99     # not the journal's
    with pytest.raises(pengine.CiInfraError):
        pengine.check_baseline(doc, device="cpu")


def test_target_verdict_per_section_equals_the_reference():
    """The fabricated early-stop case of ``tests/test_ci.py``: the pooled
    mix drifts, the per-section comparison does not, in both packages."""
    from coast_tpu.ci.engine import _target_verdict as jverdict
    block = {"n": 2048, "counts": {"success": 1024, "sdc": 1024}}
    result = {
        "injections": 1280,
        "counts": {"success": 256, "sdc": 1024},
        "delta": {"dropped_rows": 768,
                  "sections": {"b": {"base_n": 1024,
                                     "base_counts": {"success": 1024},
                                     "n": 256,
                                     "counts": {"success": 256}}}},
    }
    drifting = _copy(result)
    drifting["delta"]["sections"]["b"]["counts"] = {"success": 200,
                                                    "sdc": 56}
    drifting["counts"] = {"success": 1224, "sdc": 56}
    for res, want in ((result, False), (drifting, True)):
        mine = pengine._target_verdict("t", block, res, 1.96)
        assert mine == jverdict("t", block, res, 1.96)
        assert mine[0] is want


def test_report_json_and_format_equal_the_reference():
    from coast_tpu.ci.engine import CiReport as JReport
    from coast_tpu.ci.engine import TargetReport as JTarget
    from coast_tpu.ci.engine import _target_verdict as jverdict
    block = {"n": 512, "counts": {"success": 500, "sdc": 12}}
    result = {"injections": 512, "counts": {"success": 400, "sdc": 112},
              "delta": {}}
    kw = dict(target="mm|-TMR|memory|s7", changed_sections=["results"],
              reused_rows=10, reinjected_rows=20, dropped_rows=0,
              base_n=512, n=512, base_counts=block["counts"],
              counts=result["counts"], seconds=1.5,
              stage_seconds={"dispatch": 1.0})
    drift, cmp_, sec = pengine._target_verdict("t", block, result, 1.96)
    mine = pengine.CiReport([pengine.TargetReport(
        drift=drift, comparison=cmp_, section_comparisons=sec, **kw)], {})
    jdrift, jcmp, jsec = jverdict("t", block, result, 1.96)
    theirs = JReport([JTarget(drift=jdrift, comparison=jcmp,
                              section_comparisons=jsec, **kw)], {})
    assert mine.format() == theirs.format()
    assert json.dumps(mine.to_json(), sort_keys=True) \
        == json.dumps(theirs.to_json(), sort_keys=True)
    assert mine.exit_code == pengine.EXIT_DRIFT


# -- the compile cache's seam -------------------------------------------------

def test_compile_cache_program_hook(tmp_path):
    from coast_tpu_torch.fleet import CompileCache
    seen = []

    def hook(prog):
        seen.append(prog.region.name)
        _weaken(prog)

    cache = CompileCache(str(tmp_path / "c"), device="cpu",
                         program_hook=hook)
    prog, strategy = cache.program("matrixMultiply", "-TMR")
    assert strategy == "TMR" and seen == ["matrixMultiply"]
    assert prog.step_sync["results"] is False
    assert cache.program("matrixMultiply", "-TMR")[0] is prog
    assert seen == ["matrixMultiply"]            # memoized: applied once
    plain = CompileCache(str(tmp_path / "c"), device="cpu")
    assert plain.program("matrixMultiply", "-TMR")[0].step_sync["results"]


# -- the CLI ------------------------------------------------------------------

def test_cli_baseline_check_refresh_cycle(tmp_path, capsys):
    from coast_tpu_torch.__main__ import main as pkg_main
    bl = str(tmp_path / "bl.json")
    assert pkg_main(["ci", "baseline", "--baseline", bl, "-t", "256",
                     "--batch-size", "128", "--target",
                     "matrixMultiply|-TMR", "-d", "cpu"]) == 0
    doc = pbase.load_baseline(bl)
    assert list(doc["targets"]) == ["matrixMultiply|-TMR|memory|s7"]
    assert doc["device"] == "cpu"
    out = str(tmp_path / "ref.json")
    report = str(tmp_path / "report.json")
    assert pkg_main(["ci", "check", "--baseline", bl, "--out", out,
                     "--workers", "2", "--report-json", report,
                     "-d", "cpu"]) == 0
    assert pbase.load_baseline(out)["targets"].keys() \
        == doc["targets"].keys()
    rep = json.loads(open(report).read())
    assert rep["verdict"] == "pass"
    assert [t["reinjected_rows"] for t in rep["targets"]] == [0]
    before = os.path.getmtime(bl)
    assert pkg_main(["ci", "refresh", "--baseline", bl, "-d", "cpu"]) == 0
    assert os.path.getmtime(bl) >= before
    pbase.load_baseline(bl)
    assert "protection unchanged: PASS" in capsys.readouterr().out


def test_cli_infra_exits(tmp_path, capsys):
    from coast_tpu_torch.ci.__main__ import main as ci_main
    assert ci_main(["check", "--baseline", str(tmp_path / "nope.json"),
                    "-d", "cpu"]) == pengine.EXIT_INFRA
    bl = tmp_path / "bl.json"
    bl.write_text(json.dumps({"format": "something-else"}))
    assert ci_main(["check", "--baseline", str(bl), "-d", "cpu"]) \
        == pengine.EXIT_INFRA
    assert ci_main(["baseline", "--baseline", str(bl), "--target", "|x",
                    "-d", "cpu"]) == pengine.EXIT_INFRA
    err = capsys.readouterr().err
    assert "cannot read baseline" in err and "bad --target" in err


def test_cli_identity_mismatch_exits_2(tmp_path, port_doc, capsys):
    from coast_tpu_torch.ci.__main__ import main as ci_main
    doc = _copy(port_doc)
    for block in doc["targets"].values():
        block["spec"]["n"] = 1024               # not the journal's n
    bl = str(tmp_path / "bl.json")
    pbase.write_baseline(doc, bl)
    assert ci_main(["check", "--baseline", bl, "--no-isolation-gate",
                    "-d", "cpu"]) == pengine.EXIT_INFRA
    assert "did not complete" in capsys.readouterr().err


def test_cuda_refused_without_a_card(tmp_path, capsys):
    from coast_tpu_torch.ci.__main__ import main as ci_main
    if torch.cuda.is_available():
        pytest.skip("a card is visible: -d cuda would run")
    assert ci_main(["check", "--baseline", COMMITTED]) \
        == pengine.EXIT_INFRA
    assert "Error," in capsys.readouterr().err
