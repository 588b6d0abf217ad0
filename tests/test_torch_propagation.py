"""The port's static fault-propagation analysis (``analysis/propagation``)
against the reference's, the counterparts of ``tests/test_propagation.py``.

* Vulnerability map: on mm and crc16 TMR/DWC and train_mlp TMR the port's
  map gives the live reference's section verdicts, reasons, bit classes,
  bits and ACE bits; witnesses are the port's own (``aten.op(shape)``
  entries), compared for presence and shape only.
* Soundness: no section the map calls masked or detected-bounded shows SDC
  in ``artifacts/equiv_study.json`` or ``artifacts/train_campaign.json``,
  nor in a live campaign on a dead leaf; the train fallback.
* Isolation: the proof holds on clean builds, is vacuous without
  replication, and the seeded voter bypass is refuted, unfused and fused.
* Wiring: the lint pass and its CLI, the pre-flight, ``opt -propOut``, the
  spec's ``static_budget``, the static-budget delta's block and spend
  against the reference's on the same campaign and seed, the supervisor
  flag's refusal, and the stencil's cross-shard reach.

Every test runs on the CPU; both packages are built in the same process.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from coast_tpu_torch import DWC, TMR
from coast_tpu_torch.analysis.equiv import analyze_equivalence
from coast_tpu_torch.analysis.equiv.partition import MODE_EXH
from coast_tpu_torch.analysis.propagation import (VERDICT_DETECTED,
                                                  VERDICT_MASKED, VERDICT_SDC,
                                                  analyze_propagation,
                                                  analyze_step,
                                                  crossvalidate_counts,
                                                  prove_isolation,
                                                  seeded_voter_bypass)
from coast_tpu_torch.inject import classify as cls
from coast_tpu_torch.inject.campaign import CampaignRunner
from coast_tpu_torch.models import REGISTRY, mm
from coast_tpu_torch.passes.strategies import unprotected

torch.set_num_threads(1)

ARTIFACTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "artifacts")

BUILDS = {
    "mm_tmr": ("matrixMultiply", "TMR"),
    "mm_dwc": ("matrixMultiply", "DWC"),
    "crc16_tmr": ("crc16", "TMR"),
    "crc16_dwc": ("crc16", "DWC"),
    "train_mlp_tmr": ("train_mlp", "TMR"),
}
MAKE = {"TMR": TMR, "DWC": DWC}


def port_prog(name, strategy, **kw):
    return MAKE[strategy](REGISTRY[name](), device="cpu", **kw)


def ref_prog(name, strategy, **kw):
    import coast_tpu
    from coast_tpu.models import REGISTRY as JREG
    return getattr(coast_tpu, strategy)(JREG[name](), **kw)


@pytest.fixture(scope="module")
def mm_tmr():
    return port_prog("matrixMultiply", "TMR")


@pytest.fixture(scope="module")
def mm_tmr_map(mm_tmr):
    return analyze_propagation(mm_tmr)


def rows_of(vmap):
    return {name: [(r.kind, r.bit_class, r.verdict, r.reason, r.bits,
                    r.ace_bits, bool(r.witness)) for r in rows]
            for name, rows in vmap.rows.items()}


# -- the vulnerability map -------------------------------------------------

@pytest.mark.parametrize("build", sorted(BUILDS))
def test_map_equals_the_reference(build):
    from coast_tpu.analysis.propagation import \
        analyze_propagation as janalyze
    name, strategy = BUILDS[build]
    got = analyze_propagation(port_prog(name, strategy))
    want = janalyze(ref_prog(name, strategy))
    assert rows_of(got) == rows_of(want)
    assert got.section_verdicts() == want.section_verdicts()
    assert got.ace_summary() == want.ace_summary()
    for key in ("benchmark", "num_clones", "clean_steps", "nominal_steps",
                "live_fraction", "fallback_reason", "shard_reach"):
        assert getattr(got, key) == getattr(want, key), key
    summary = got.summary()
    assert set(summary) == set(want.summary())
    assert "static vulnerability map" in got.format()


def test_mm_tmr_verdicts(mm_tmr_map):
    verdicts = mm_tmr_map.section_verdicts()
    assert {n for n, v in verdicts.items() if v == VERDICT_SDC} \
        == {"golden", "phase"}
    for name in ("acc", "first", "second", "results", "i"):
        assert verdicts[name] == VERDICT_DETECTED, (name, verdicts)
    assert mm_tmr_map.counts()[VERDICT_MASKED] == 0
    assert mm_tmr_map.fallback_reason is None


def test_crc16_value_fed_register_sdc_possible():
    for strategy in ("TMR", "DWC"):
        vmap = analyze_propagation(port_prog("crc16", strategy))
        assert vmap.verdict("crc") == VERDICT_SDC
        assert vmap.verdict("msg") == VERDICT_DETECTED


def test_sdc_possible_rows_carry_witness_paths(mm_tmr_map):
    for name in ("golden", "phase"):
        rows = mm_tmr_map.rows[name]
        assert all(r.witness for r in rows), name
    # phase's witness is the taint walk's: it starts at the leaf and ends
    # at the value-feeding consumer, marked "!".
    phase = mm_tmr_map.rows["phase"][0].witness
    assert phase[0] == "phase" and phase[-1].endswith("!")
    assert all(e.startswith("aten.") for e in phase[1:])
    # golden never feeds the step: its witness is the check() cone, at
    # most 8 entries.
    golden = mm_tmr_map.rows["golden"][0].witness
    assert golden[0] == "|check|" and 1 < len(golden) <= 8
    assert not any(r.witness for r in mm_tmr_map.rows["results"])


def test_verdicts_consistent_with_equiv_modes():
    """sdc-possible on a replicated section <=> the partition refused to
    merge it: both read one shared walk."""
    for name, strategy in (("matrixMultiply", "TMR"),
                           ("matrixMultiply", "DWC"),
                           ("crc16", "TMR"), ("crc16", "DWC")):
        prog = port_prog(name, strategy)
        facts = analyze_step(prog)
        part = analyze_equivalence(prog, facts=facts)
        verdicts = analyze_propagation(prog, facts=facts,
                                       partition=part).section_verdicts()
        for sec, sig in part.signatures.items():
            if sig.replicated:
                assert (verdicts[sec] == VERDICT_SDC) \
                    == (sig.mode == MODE_EXH), (name, sec)


def test_bit_classes(mm_tmr_map):
    rows = mm_tmr_map.rows["results"]
    assert [r.bit_class for r in rows] == ["word"]
    assert rows[0].bits == 3 * 81 * 32
    # uint32 words carried as int32 tensors stay one word class.
    region = REGISTRY["sha256"]()
    unsigned = [n for n, s in region.spec.items() if s.unsigned]
    assert unsigned
    vmap = analyze_propagation(TMR(region, device="cpu"))
    for name in unsigned:
        if name in vmap.rows:
            assert [r.bit_class for r in vmap.rows[name]] == ["word"]


def test_ace_accounting(mm_tmr_map):
    ace = mm_tmr_map.ace_summary()
    assert ace["total_bits"] == sum(
        r.bits for rows in mm_tmr_map.rows.values() for r in rows)
    assert ace["ace_bits"] <= ace["total_bits"]
    assert ace["detected_bounded_ace_bits"] + ace["sdc_possible_ace_bits"] \
        <= ace["ace_bits"] + 1
    assert 0.0 < mm_tmr_map.live_fraction <= 1.0
    assert mm_tmr_map.clean_steps > 0


def dead_golden_region():
    """mm with a check that never reads the golden leaf: the oracle is a
    constant, so the leaf is dead state."""
    region = mm.make_region()
    old_check = region.check
    golden = region.init(torch.device("cpu"))["golden"].clone()

    def new_check(state):
        s2 = dict(state)
        s2["golden"] = golden.to(state["golden"].device).expand_as(
            state["golden"])
        return old_check(s2)

    return dataclasses.replace(region, check=new_check)


def test_dead_state_is_masked():
    vmap = analyze_propagation(TMR(dead_golden_region(), device="cpu"))
    assert vmap.verdict("golden") == VERDICT_MASKED
    assert all(r.ace_bits == 0 and not r.witness
               for r in vmap.rows["golden"])
    assert vmap.verdict("phase") == VERDICT_SDC


def test_masked_soundness_live():
    """No flip into the dead leaf ever leaves SUCCESS."""
    prog = TMR(dead_golden_region(), device="cpu")
    vmap = analyze_propagation(prog)
    runner = CampaignRunner(prog, strategy_name="TMR")
    res = runner.run(1200, seed=11, batch_size=400)
    lids = np.asarray(res.schedule.leaf_id)
    golden_id = {s.name: s.leaf_id for s in runner.mmap.sections}["golden"]
    codes = res.codes[lids == golden_id]
    assert len(codes) > 0 and (codes == cls.SUCCESS).all()
    assert vmap.verdict("golden") == VERDICT_MASKED


# -- soundness against the recorded campaigns ------------------------------

def test_soundness_pinned_against_equiv_study():
    with open(os.path.join(ARTIFACTS, "equiv_study.json")) as fh:
        study = json.load(fh)
    checked = 0
    for bench, row in study["targets"].items():
        for strategy, cell in row.items():
            vmap = analyze_propagation(port_prog(bench, strategy))
            assert crossvalidate_counts(vmap, cell["section_counts"]) == []
            assert vmap.section_verdicts() == cell["propagation_verdicts"]
            checked += 1
    assert checked >= 4
    total_sdc = sum(
        c.get("sdc", 0)
        for row in study["targets"].values() for cell in row.values()
        for c in cell["section_counts"].values())
    assert total_sdc > 0


def test_crossvalidate_reports_a_violation(mm_tmr_map):
    got = crossvalidate_counts(mm_tmr_map, {"results": {"sdc": 2},
                                            "golden": {"sdc": 9}})
    assert len(got) == 1 and "results" in got[0] and "2" in got[0]


@pytest.fixture(scope="module")
def train_map():
    return analyze_propagation(port_prog("train_mlp", "TMR"))


def test_soundness_pinned_against_train_campaign(train_map):
    from coast_tpu_torch.analysis.equiv import TRAIN_FALLBACK
    with open(os.path.join(ARTIFACTS, "train_campaign.json")) as fh:
        rec = json.load(fh)
    assert train_map.fallback_reason == TRAIN_FALLBACK
    verdicts = train_map.section_verdicts()
    assert all(v == VERDICT_SDC for v in verdicts.values())
    kinds = {name: rows[0].kind for name, rows in train_map.rows.items()}
    persistent = 0
    for strategy, attribution in rec["kind_attribution"].items():
        for kind, cell in attribution.items():
            if cell.get("train_sdc", 0):
                persistent += cell["train_sdc"]
                hit = [n for n, k in kinds.items() if k == kind]
                assert all(verdicts[n] == VERDICT_SDC for n in hit)
    assert persistent > 0


def test_train_counterexample_pins_sdc_possible_bit_classes(train_map):
    """The same (leaf, lane, word, t) of a weight lands in different
    outcome classes by bit, so w1 is sdc-possible in every f32 class."""
    rows = train_map.rows["w1"]
    assert sorted(r.bit_class for r in rows) \
        == ["exponent", "mantissa", "sign"]
    assert all(r.verdict == VERDICT_SDC for r in rows)
    assert "train_self_heal" in rows[[r.bit_class for r in rows].index(
        "mantissa")].reason
    prog = unprotected(REGISTRY["train_mlp"](), device="cpu")

    def probe_at(bit):
        rec = prog.run({"leaf_id": prog.leaf_order.index("w1"), "lane": 0,
                        "word": 0, "bit": bit, "t": 4})
        assert int(rec["errors"]) > 0
        return int(rec["train_probe"])

    assert probe_at(1) < 2 and probe_at(30) == 2


# -- the isolation prover --------------------------------------------------

def test_isolation_holds_on_clean_builds():
    for strategy in ("TMR", "DWC"):
        for name in ("matrixMultiply", "crc16"):
            proof = prove_isolation(port_prog(name, strategy),
                                    strategy=strategy)
            assert proof.holds and not proof.vacuous
            assert proof.leaks == [] and proof.total_leak_paths == 0
            assert proof.voted_commits
            assert "HOLDS" in proof.format()


def test_isolation_vacuous_without_replication():
    proof = prove_isolation(unprotected(mm.make_region(), device="cpu"))
    assert proof.holds and proof.vacuous
    assert "vacuously" in proof.format()


def test_voted_commits_equal_the_reference():
    from coast_tpu.analysis.propagation import \
        prove_isolation as jprove
    for name, strategy in BUILDS.values():
        got = prove_isolation(port_prog(name, strategy))
        want = jprove(ref_prog(name, strategy))
        assert got.voted_commits == want.voted_commits, (name, strategy)
        assert got.assumptions == want.assumptions


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("name", ["matrixMultiply", "crc16"])
def test_seeded_voter_bypass_caught_with_counterexample_path(name, fused):
    for strategy in ("TMR", "DWC"):
        with seeded_voter_bypass():
            bad = port_prog(name, strategy, fuse_step=fused)
            proof = prove_isolation(bad, strategy=strategy)
        assert not proof.holds, strategy
        assert proof.leaks and proof.total_leak_paths > 0
        for leak in proof.leaks:
            assert leak.path and leak.output
            assert leak.rule in ("spof", "lane-collapse")
            assert leak.path[0] == leak.source
        assert "LEAK" in proof.format()
        # The bypass restores: a fresh build proves again.
        assert prove_isolation(port_prog(name, strategy,
                                         fuse_step=fused)).holds


def test_bypassed_build_runs_lane_zero_unvoted():
    """Under the bypass a TMR flip of lane 0 reaches the output uncorrected
    and unflagged; after it, the same flip is corrected again."""
    from coast_tpu_torch.ops import hopper_voters, voters
    fault = {"leaf_id": 0, "lane": 0, "word": 3, "bit": 5, "t": 0}
    before = hopper_voters.vote_sites
    with seeded_voter_bypass():
        assert hopper_voters.vote_sites is not before
        rec = port_prog("crc16", "TMR").run(fault)
        assert int(rec["corrected"]) == 0
    assert hopper_voters.vote_sites is before
    assert voters.lane_view.__name__ == "lane_view"
    rec = port_prog("crc16", "TMR").run(fault)
    assert int(rec["corrected"]) > 0 and int(rec["errors"]) == 0


# -- wiring ----------------------------------------------------------------

def test_lint_propagation_pass_reports_leaks():
    from coast_tpu_torch.analysis import lint
    with seeded_voter_bypass():
        bad = port_prog("matrixMultiply", "TMR")
        rep = lint.lint_program(bad, survival=False, propagation=True)
    assert "propagation" in rep.passes_run
    assert any(f.rule == "isolation-leak" and f.severity == "error"
               for f in rep.findings)
    assert not rep.ok
    clean = lint.lint_program(port_prog("matrixMultiply", "TMR"),
                              survival=False, propagation=True)
    assert clean.ok and clean.passes_run == ["provenance", "propagation"]


def test_lint_default_passes_unchanged(mm_tmr):
    from coast_tpu_torch.analysis import lint
    assert lint.lint_program(mm_tmr, survival=False).passes_run \
        == ["provenance"]


def test_preflight_propagation_gates():
    from coast_tpu_torch.analysis.lint import ReplicationLintError
    CampaignRunner(port_prog("matrixMultiply", "TMR"),
                   preflight="propagation")
    with seeded_voter_bypass():
        bad = port_prog("matrixMultiply", "TMR")
        with pytest.raises(ReplicationLintError) as ei:
            CampaignRunner(bad, preflight="propagation")
    assert "isolation-leak" in str(ei.value)


def test_opt_propout_writes_artifact(tmp_path, capsys):
    from coast_tpu.opt import main as jmain
    from coast_tpu_torch.opt import main
    out, ref = tmp_path / "prop.json", tmp_path / "ref.json"
    assert main(["-TMR", f"-propOut={out}", "matrixMultiply"],
                device="cpu") == 0
    assert jmain(["-TMR", f"-propOut={ref}", "matrixMultiply"]) == 0
    capsys.readouterr()
    doc, want = json.loads(out.read_text()), json.loads(ref.read_text())
    assert doc["isolation"]["holds"] is True
    assert {k: v for k, v in doc["isolation"].items()} \
        == want["isolation"]
    got_map, want_map = doc["vulnerability_map"], want["vulnerability_map"]
    for sec in (got_map, want_map):
        for cell in sec["sections"].values():
            for row in cell["bit_classes"]:
                row["witness"] = bool(row.get("witness"))
    assert got_map == want_map
    assert got_map["sections"]["golden"]["verdict"] == VERDICT_SDC


def test_lint_cli_propagation(tmp_path, capsys):
    from coast_tpu_torch.analysis.lint.__main__ import main
    out = tmp_path / "lint.json"
    assert main(["-TMR", "matrixMultiply", "--propagation", "--no-survival",
                 "--json", str(out)], device="cpu") == 0
    doc = json.loads(out.read_text())
    assert "matrixMultiply:TMR" in doc["propagation"]
    assert doc["reports"][0]["passes_run"] == ["provenance", "propagation"]
    assert "static vulnerability map" in capsys.readouterr().out


def test_spec_static_budget_roundtrip_and_refusal():
    from coast_tpu.inject.spec import CampaignSpec as JSpec
    from coast_tpu_torch.inject.spec import CampaignSpec, SpecError
    s = CampaignSpec("matrixMultiply", 64, equiv=True, delta_from="b.j",
                     stop_when="sdc:0.02;min=256",
                     static_budget=True).validate()
    item = s.to_item()
    assert item["static_budget"] is True
    assert CampaignSpec.from_item(item) == s
    assert item == JSpec.from_item(item).validate().to_item()
    plain = CampaignSpec("matrixMultiply", 64)
    assert "static_budget" not in plain.to_item()
    assert CampaignSpec.from_item(plain.to_item()).static_budget is False
    with pytest.raises(SpecError):
        CampaignSpec("matrixMultiply", 64, static_budget=True).validate()
    with pytest.raises(SpecError):
        CampaignSpec("matrixMultiply", 64, equiv=True, delta_from="b.j",
                     static_budget=True).validate()


def check_edit(region, fields):
    """``region`` whose check sees each of ``fields`` xor'ed with 0."""
    old_check = region.check

    def new_check(state):
        s2 = dict(state)
        for f in fields:
            s2[f] = state[f] ^ 0
        return old_check(s2)

    return dataclasses.replace(region, check=new_check)


def both_deltas(tmp_path, fields, n, stop, base_batch, batch):
    """The static-budget delta of the edited mm in each package, against
    each package's own base journal of the same campaign and seed."""
    import jax.numpy as jnp
    from coast_tpu.inject.campaign import CampaignRunner as JRunner
    from coast_tpu.models import mm as jmm
    from coast_tpu.obs.convergence import StopWhen as JStop
    from coast_tpu_torch.obs.convergence import StopWhen

    def jedit():
        region = jmm.make_region()
        old_check = region.check

        def new_check(state):
            s2 = dict(state)
            for f in fields:
                s2[f] = state[f] ^ jnp.uint32(0)
            return old_check(s2)
        return dataclasses.replace(region, check=new_check)

    import coast_tpu
    out = {}
    for pkg, base_prog, edited_prog, runner_cls, sw in (
            ("port", TMR(mm.make_region(), device="cpu"),
             TMR(check_edit(mm.make_region(), fields), device="cpu"),
             CampaignRunner, StopWhen.parse(stop)),
            ("ref", coast_tpu.TMR(jmm.make_region()),
             coast_tpu.TMR(jedit()), JRunner, JStop.parse(stop))):
        jpath = str(tmp_path / f"{pkg}.journal")
        runner_cls(base_prog, strategy_name="TMR", equiv=True).run(
            n, seed=3, batch_size=base_batch, journal=jpath)
        edited = runner_cls(edited_prog, strategy_name="TMR", equiv=True)
        out[pkg] = (
            edited.run_delta(n, jpath, seed=3, batch_size=batch,
                             stop_when=sw),
            edited.run_delta(n, jpath, seed=3, batch_size=batch,
                             stop_when=sw, static_budget=True))
    return out


def test_static_budget_spends_less_on_proven_sections(tmp_path):
    """At the same stop condition the static prior cuts physical
    injections on a changed detected-bounded section (a quartered floor)
    while recording the same zero SDC: the reference's block and spend."""
    out = both_deltas(tmp_path, ["results"], 4096, "sdc:0.05;min=256",
                      1024, 64)
    (plain, seeded), (jplain, jseeded) = out["port"], out["ref"]
    assert plain.delta["changed_sections"] == ["results"]
    sb = seeded.delta["static_budget"]
    assert sb == jseeded.delta["static_budget"]
    assert sb["verdicts"]["results"] == VERDICT_DETECTED
    assert sb["verdicts"]["golden"] == VERDICT_SDC
    assert sb["order"] == ["results"]
    assert sb["relaxed_min"] == {"results": 64}
    assert seeded.physical_n < plain.physical_n
    assert (seeded.physical_n, plain.physical_n) \
        == (jseeded.physical_n, jplain.physical_n)
    assert seeded.counts == jseeded.counts
    for res in (plain, seeded):
        assert res.delta["sections"]["results"]["counts"].get("sdc", 0) == 0
    assert "static_budget" not in plain.delta


def test_static_budget_orders_sdc_possible_first(tmp_path):
    out = both_deltas(tmp_path, ["results", "phase"], 1024,
                      "sdc:0.05;min=64", 512, 256)
    (_, seeded), (_, jseeded) = out["port"], out["ref"]
    assert sorted(seeded.delta["changed_sections"]) == ["phase", "results"]
    sb = seeded.delta["static_budget"]
    assert sb == jseeded.delta["static_budget"]
    assert sb["order"] == ["phase", "results"]
    assert seeded.physical_n == jseeded.physical_n


def test_supervisor_static_budget_flag_requires_delta_and_stop(capsys):
    from coast_tpu_torch.inject import supervisor
    for argv in (["-f", "matrixMultiply", "--static-budget", "-t", "8"],
                 ["-f", "matrixMultiply", "--delta-from", "b.journal",
                  "--static-budget", "-t", "8"]):
        with pytest.raises(SystemExit) as exc:
            supervisor.parse_command_line(argv)
        assert exc.value.code == -1
        assert "needs --delta-from AND --stop-when" \
            in capsys.readouterr().err


def test_supervisor_static_budget_runs(tmp_path, capsys):
    from coast_tpu_torch.inject import supervisor
    jpath = str(tmp_path / "base.journal")
    base = ["-f", "matrixMultiply", "-O=-TMR", "-t", "512", "--seed", "3",
            "--batch-size", "256", "-d", "cpu", "-q"]
    assert supervisor.main([*base, "--equiv", "--journal", jpath]) == 0
    capsys.readouterr()
    assert supervisor.main([*base, "--delta-from", jpath, "--stop-when",
                            "sdc:0.05;min=128", "--static-budget"]) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")][-1]
    delta = eval(line, {"inf": float("inf")})["delta"]   # the summary
    assert delta["changed_sections"] == []
    assert delta["static_budget"]["verdicts"]["phase"] == VERDICT_SDC


@pytest.mark.parametrize("placement", ["compute", "link"])
def test_stencil_shard_reach_matches_the_placement(placement):
    """The walker's reach closure: under vote-then-exchange a grid's
    influence stays in its shard, under exchange-then-vote it crosses --
    the reference's closure on the region's leaves."""
    from coast_tpu.analysis.propagation import \
        analyze_propagation as janalyze
    from coast_tpu.models import resolve_region as jresolve
    from coast_tpu_torch.models import resolve_region
    import coast_tpu
    vmap = analyze_propagation(TMR(resolve_region(
        "stencil", placement=placement), device="cpu"))
    want = janalyze(coast_tpu.TMR(jresolve("stencil", placement=placement)))
    for grid in ("grid0", "grid1"):
        assert vmap.shard_reach[grid]["cross_shard"] is (placement == "link")
    leaves = set(vmap.rows)
    for name in leaves & set(want.shard_reach):
        got, ref = vmap.shard_reach[name], want.shard_reach[name]
        assert set(got["reach"]) & leaves == set(ref["reach"]) & leaves
        assert got.get("cross_shard") == ref.get("cross_shard"), name
    assert vmap.section_verdicts() == want.section_verdicts()


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host")
    return torch.device("cuda")


FLIP = {"leaf_id": 0, "lane": 0, "word": 3, "bit": 5, "t": 0}


@pytest.mark.cuda
def test_bypass_skips_k1_on_the_card(cuda):
    """Under the bypass a card build launches no K1 and a lane-0 flip goes
    uncorrected; the proof of that build is refuted.  After the context
    the same build launches K1 again and repairs the flip."""
    from coast_tpu_torch.ops import hopper_voters
    with seeded_voter_bypass():
        prog = TMR(REGISTRY["crc16"](), device=cuda)
        before = hopper_voters.LAUNCHES
        rec = prog.run(FLIP)
        assert hopper_voters.LAUNCHES == before
        assert int(rec["corrected"]) == 0
        assert not prove_isolation(prog).holds
    prog = TMR(REGISTRY["crc16"](), device=cuda)
    before = hopper_voters.LAUNCHES
    rec = prog.run(FLIP)
    assert hopper_voters.LAUNCHES > before
    assert int(rec["corrected"]) > 0 and int(rec["errors"]) == 0


@pytest.mark.cuda
def test_bypass_skips_k2_on_the_card(cuda):
    """The same for K2 on a fused build."""
    from coast_tpu_torch.ops import hopper_commit
    with seeded_voter_bypass():
        prog = TMR(REGISTRY["crc16"](), device=cuda, fuse_step=True)
        before = hopper_commit.LAUNCHES
        rec = prog.run(FLIP)
        assert hopper_commit.LAUNCHES == before
        assert int(rec["corrected"]) == 0
        assert not prove_isolation(prog).holds
    prog = TMR(REGISTRY["crc16"](), device=cuda, fuse_step=True)
    before = hopper_commit.LAUNCHES
    rec = prog.run(FLIP)
    assert hopper_commit.LAUNCHES > before
    assert int(rec["corrected"]) > 0 and int(rec["errors"]) == 0
