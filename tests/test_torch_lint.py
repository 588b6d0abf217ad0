"""The port's replication-integrity linter against the reference's.

Each seeded mutant of the reference's ``tests/test_lint.py`` is built on
both packages and caught with the same findings, as sets of ``(rule,
severity, locus)``: the dropped voter, the extra voter, hand-collapsed
lanes, lane averaging, segmented dedup (static and full), the unreplicated
import and the skipLibCalls SPOF note.  Also ported: baseline round-trip
and scoping, the JSON export, ``check``, the ``preflight`` gate, the opt
gate with ``-lintOut`` and the ``-dumpModule`` formats, the lint CLI, the
training regions, and ``expected_sync_classes`` across the knobs.

Messages may differ where the reference quotes its compiled module: the
``hlo-voter-missing`` and ``segment-cse`` rules count what the port runs
(voter site records; distinct aten operations), so only their rule,
severity and locus are compared.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from coast_tpu_torch.analysis import lint
from coast_tpu_torch.analysis.lint import capture
from coast_tpu_torch.analysis.lint.findings import ReplicationLintError
from coast_tpu_torch.ir.region import (KIND_CTRL, KIND_MEM, KIND_REG,
                                       LeafSpec, Region)
from coast_tpu_torch.models import REGISTRY
from coast_tpu_torch.ops import indexing, voters
from coast_tpu_torch.passes.strategies import DWC, TMR, unprotected

torch.set_num_threads(1)


def keys(report):
    return {(f.rule, f.severity, f.locus) for f in report.findings}


def port_tmr(name, **kw):
    return TMR(REGISTRY[name](), device="cpu", **kw)


def ref_tmr(name, **kw):
    from coast_tpu import TMR as JTMR
    from coast_tpu.models import REGISTRY as JREG
    return JTMR(JREG[name](), **kw)


def ref_lint(prog, **kw):
    from coast_tpu.analysis import lint as jlint
    return jlint.lint_program(prog, **kw)


# -- the seeded mutants, each built on both packages --------------------------

def mutate_dropped(prog):
    prog.step_sync["results"] = False
    return prog


def mutate_extra(prog):
    prog.step_sync["results"] = True
    return prog


def collapse_port(prog):
    orig = prog.step

    def bad_step(pstate, flags, t):
        new_state, flags = orig(pstate, flags, t)
        crc = new_state["crc"]
        return {**new_state, "crc": crc[:, 0].unsqueeze(1).expand(
            crc.shape).contiguous()}, flags

    prog.step = bad_step
    return prog


def collapse_ref(prog):
    import jax.numpy as jnp
    orig = prog.step

    def bad_step(pstate, flags, t):
        new_state, flags = orig(pstate, flags, t)
        return {**new_state, "crc": jnp.broadcast_to(
            new_state["crc"][0], new_state["crc"].shape)}, flags

    prog.step = bad_step
    return prog


def average_port(prog):
    orig = prog.step

    def avg_step(pstate, flags, t):
        new_state, flags = orig(pstate, flags, t)
        crc = new_state["crc"]
        avg = (torch.sum(crc, dim=1) // 3).to(crc.dtype)
        return {**new_state, "crc": avg.unsqueeze(1).expand(
            crc.shape).contiguous()}, flags

    prog.step = avg_step
    return prog


def average_ref(prog):
    import jax.numpy as jnp
    orig = prog.step

    def avg_step(pstate, flags, t):
        new_state, flags = orig(pstate, flags, t)
        avg = jnp.sum(new_state["crc"], axis=0) // 3
        return {**new_state, "crc": jnp.broadcast_to(
            avg, new_state["crc"].shape)}, flags

    prog.step = avg_step
    return prog


def dedup_port(prog):
    """Every replica computed from lane 0's state.  The reference's step
    returns every leaf, so its stacked bodies also carry the unwritten
    leaves; the port's step returns the written ones, and the mutant adds
    the rest."""
    def bad_run_lanes(region_state, t, batch):
        outs = []
        for _ in range(prog.cfg.num_clones):
            lane = {k: (v[:, 0] if prog.replicated[k] else v)
                    for k, v in region_state.items()}
            outs.append({**lane, **prog._raw_step(lane, t)})
        return ({k: torch.stack([o[k] for o in outs], dim=1)
                 for k in outs[0] if prog.replicated[k]}, [])

    prog._run_lanes = bad_run_lanes
    return prog


def dedup_ref(prog):
    import jax.numpy as jnp

    def bad_run_lanes(pstate, t):
        step = prog.region.bound_step()
        outs = []
        for _ in range(prog.cfg.num_clones):
            lane_state = {k: (v[0] if prog.replicated[k] else v)
                          for k, v in pstate.items()}
            outs.append(step(lane_state, t))
        return ({k: jnp.stack([o[k] for o in outs]) for k in outs[0]},
                jnp.zeros((0,), jnp.bool_))

    prog._run_lanes = bad_run_lanes
    return prog


MUTANTS = {
    # name -> (build args, port mutation, reference mutation, lint kwargs)
    "dropped_voter": (("matrixMultiply", {}), mutate_dropped, mutate_dropped,
                      {"survival": False}),
    "extra_voter": (("matrixMultiply", {"no_store_data_sync": True}),
                    mutate_extra, mutate_extra, {"survival": False}),
    "hand_collapsed_lanes": (("crc16", {}), collapse_port, collapse_ref,
                             {"survival": False}),
    "lane_averaging": (("crc16", {}), average_port, average_ref,
                       {"survival": False}),
    "segmented_dedup_static": (("crc16", {"segmented": True}), dedup_port,
                               dedup_ref, {"survival": False}),
    "segmented_dedup_full": (("crc16", {"segmented": True}), dedup_port,
                             dedup_ref, {}),
    "skip_lib_note": (("nestedCalls", {"skip_lib_calls": ("fold",)}),
                      lambda p: p, lambda p: p, {"survival": False}),
    "healthy_segmented": (("crc16", {"segmented": True}), lambda p: p,
                          lambda p: p, {}),
}


@pytest.mark.parametrize("case", sorted(MUTANTS))
def test_seeded_mutant_caught_like_the_reference(case):
    (name, kw), port_mut, ref_mut, lint_kw = MUTANTS[case]
    got = lint.lint_program(port_mut(port_tmr(name, **kw)), **lint_kw)
    want = ref_lint(ref_mut(ref_tmr(name, **kw)), **lint_kw)
    assert keys(got) == keys(want)
    assert got.ok == want.ok
    if case != "healthy_segmented" and case != "skip_lib_note":
        assert keys(got)


def shared_import_regions():
    """The reference's unreplicated-import region and the port's twin."""
    import jax.numpy as jnp
    from coast_tpu.ir.region import (KIND_CTRL as J_CTRL, KIND_MEM as J_MEM,
                                     KIND_REG as J_REG, LeafSpec as JSpec,
                                     Region as JRegion)
    from coast_tpu.passes.verification import analyze as janalyze
    ref = JRegion(
        name="shared_import",
        init=lambda: {"sh": jnp.int32(1), "r": jnp.int32(0),
                      "i": jnp.int32(0)},
        step=lambda s, t: {"sh": s["sh"] + 1, "r": s["r"] + s["sh"],
                           "i": s["i"] + 1},
        done=lambda s: s["i"] >= 4, check=lambda s: jnp.int32(0),
        output=lambda s: s["r"].reshape(1).astype(jnp.uint32),
        nominal_steps=4, max_steps=8,
        spec={"sh": JSpec(J_MEM, xmr=False),
              "r": JSpec(J_REG, no_verify=True), "i": JSpec(J_CTRL)})

    def init(device):
        return {k: torch.tensor(v, dtype=torch.int32, device=device)
                for k, v in (("sh", 1), ("r", 0), ("i", 0))}

    port = Region(
        name="shared_import", init=init,
        step=lambda s, t: {"sh": s["sh"] + 1, "r": s["r"] + s["sh"],
                           "i": s["i"] + 1},
        done=lambda s: s["i"] >= 4,
        check=lambda s: torch.zeros_like(s["i"]),
        output=lambda s: s["r"].reshape(-1, 1),
        nominal_steps=4, max_steps=8,
        spec={"sh": LeafSpec(KIND_MEM, xmr=False),
              "r": LeafSpec(KIND_REG, no_verify=True),
              "i": LeafSpec(KIND_CTRL)},
        meta={"dataflow": janalyze(ref)})
    return port, ref


def test_seeded_unreplicated_import_caught_like_the_reference():
    from coast_tpu import TMR as JTMR
    port_region, ref_region = shared_import_regions()
    port, ref = TMR(port_region, device="cpu"), JTMR(ref_region)
    assert lint.lint_program(port, survival=False).ok
    assert ref_lint(ref, survival=False).ok
    for prog in (port, ref):
        orig = prog.step

        def bad_step(pstate, flags, t, orig=orig):
            new_state, flags = orig(pstate, flags, t)
            return {**new_state, "sh": pstate["sh"] + 1}, flags

        prog.step = bad_step
    got = lint.lint_program(port, survival=False)
    want = ref_lint(ref, survival=False)
    assert keys(got) == keys(want) == {
        ("unreplicated-import", "error", "leaf:sh")}


# -- coverage reads the capture, not the declaration ---------------------------

def test_voter_coverage_reads_the_captured_tags(monkeypatch):
    """A vote dropped at run time (its site never voted) fails coverage
    although ``sync_tags()`` still declares it."""
    from coast_tpu_torch.ops import hopper_voters
    prog = port_tmr("matrixMultiply")
    real = hopper_voters.vote_sites
    dropped = "store_data:results"

    def dropping(sites, n):
        kept = [s for s in sites if s.tag != dropped]
        voted, mis = real(kept, n) if kept else ([], None)
        it = iter(voted)
        return ([s.lanes[:, 0] if s.tag == dropped else next(it)
                 for s in sites], mis)

    monkeypatch.setattr(hopper_voters, "vote_sites", dropping)
    report = lint.lint_program(prog, survival=False)
    assert ("store_data", "results") in prog.sync_tags()
    assert ("voter-coverage", "error", "leaf:results") in keys(report)


def test_tag_hook_adds_no_operator_outside_a_capture(monkeypatch):
    """With no capture active, a trip dispatches the same torch operators
    as a build whose tag functions are identities."""
    def ops_of_trip(prog):
        pstate, flags = prog.init_pstate(2)
        lines = []
        with torch.no_grad(), capture._Stream(lines):
            prog.step(pstate, flags, 0)
        return [name for name, _ in lines]

    for name, kw in (("matrixMultiply", {}), ("crc16", {"fuse_step": True}),
                     ("nestedCalls", {"ignore_fns": ("fold",)}),
                     ("rtos_mm", {})):
        with_hook = ops_of_trip(port_tmr(name, **kw))
        assert not any("coast_lint" in op for op in with_hook)
        with monkeypatch.context() as m:
            for mod in (voters, indexing):
                m.setattr(mod, "tag", lambda x, name: x)
            m.setattr(voters, "tag_lanes", lambda x, klass: x)
            m.setattr(voters, "sync_tag", lambda x, klass, leaf: x)
            without = ops_of_trip(port_tmr(name, **kw))
        assert with_hook == without


def test_capture_refuses_a_tensor_off_the_cpu():
    with capture.recording():
        with pytest.raises(RuntimeError, match="CPU"):
            voters.tag(torch.empty(1, device="meta"), voters.TAG_VOTER)


# -- healthy builds ------------------------------------------------------------

KNOBS = [{}, {"no_store_data_sync": True}, {"no_load_sync": True},
         {"no_store_addr_sync": True}, {"no_mem_replication": True},
         {"segmented": True}, {"count_errors": False},
         {"count_syncs": True}]


@pytest.mark.parametrize("overrides", KNOBS, ids=[
    ",".join(k) or "default" for k in KNOBS])
def test_voter_coverage_clean_and_classes_equal_across_knobs(overrides):
    from coast_tpu import DWC as JDWC, TMR as JTMR
    from coast_tpu.analysis.lint.provenance import (
        expected_sync_classes as jexpected)
    from coast_tpu.models import REGISTRY as JREG
    for make, jmake in ((TMR, JTMR), (DWC, JDWC)):
        prog = make(REGISTRY["matrixMultiply"](), device="cpu", **overrides)
        report = lint.lint_program(prog, survival=False)
        assert report.ok, report.format()
        jprog = jmake(JREG["matrixMultiply"](), **overrides)
        assert (lint.expected_sync_classes(prog.region, prog.cfg)
                == jexpected(jprog.region, jprog.cfg))


def test_unprotected_has_nothing_to_lint():
    report = lint.lint_program(unprotected(REGISTRY["crc16"](),
                                           device="cpu"))
    assert report.ok and not report.findings


# -- baseline, JSON, gating ------------------------------------------------------

def test_baseline_suppression_roundtrip(tmp_path):
    prog = mutate_dropped(port_tmr("matrixMultiply"))
    report = lint.lint_program(prog, survival=False)
    assert not report.ok
    path = tmp_path / "baseline.json"
    report.write_baseline(str(path))
    base = lint.load_baseline(str(path))
    again = lint.lint_program(prog, survival=False, baseline=base)
    assert again.ok and again.counts()["suppressed"] >= 1


def test_baseline_is_benchmark_scoped(tmp_path):
    path = tmp_path / "mm.json"
    lint.lint_program(mutate_dropped(port_tmr("matrixMultiply")),
                      survival=False).write_baseline(str(path))
    base = lint.load_baseline(str(path))
    assert any(fp.startswith("matrixMultiply:") for fp in base)
    other = lint.lint_program(mutate_dropped(port_tmr("matrixMultiply256")),
                              survival=False, baseline=base)
    assert not other.ok


def test_json_export(tmp_path):
    report = lint.lint_program(port_tmr("crc16"), survival=False)
    out = tmp_path / "lint.json"
    report.write_json(str(out))
    doc = json.loads(out.read_text())
    assert doc["benchmark"] == "crc16" and doc["ok"] is True
    assert doc["passes_run"] == ["provenance"]


def test_check_raises_on_errors():
    with pytest.raises(ReplicationLintError, match="voter-coverage"):
        lint.check(mutate_dropped(port_tmr("matrixMultiply")),
                   survival=False)


def test_campaign_preflight_gates():
    from coast_tpu_torch.inject.campaign import CampaignRunner
    CampaignRunner(port_tmr("crc16"), preflight="static")
    CampaignRunner(port_tmr("crc16"), preflight="survival")
    with pytest.raises(ReplicationLintError):
        CampaignRunner(mutate_dropped(port_tmr("matrixMultiply")),
                       preflight="static")
    with pytest.raises(ReplicationLintError):
        CampaignRunner(average_port(port_tmr("crc16")), preflight="static")
    # Item 17c landed: True, "full" and "propagation" add the isolation
    # prover, which refuses a build whose votes are bypassed.
    from coast_tpu_torch.analysis.propagation import seeded_voter_bypass
    for value in (True, "full", "propagation"):
        CampaignRunner(port_tmr("crc16"), preflight=value)
        with seeded_voter_bypass():
            with pytest.raises(ReplicationLintError, match="isolation-leak"):
                CampaignRunner(port_tmr("crc16"), preflight=value)
    rep = lint.lint_program(port_tmr("crc16"), propagation=True)
    assert rep.passes_run == ["provenance", "survival", "propagation"]
    assert rep.ok


@pytest.mark.parametrize("unroll", [0, 1, 2, 4])
def test_campaign_unroll_is_clamped_and_changes_no_record(unroll):
    from coast_tpu_torch.inject.campaign import CampaignRunner
    base = CampaignRunner(port_tmr("crc16")).run(96, seed=5, batch_size=48)
    runner = CampaignRunner(port_tmr("crc16"), unroll=unroll)
    assert runner.unroll == max(1, unroll)
    res = runner.run(96, seed=5, batch_size=48)
    assert res.counts == base.counts
    np.testing.assert_array_equal(res.codes, base.codes)
    prog = port_tmr("crc16")
    fault = {"leaf_id": 1, "lane": 0, "word": 0, "bit": 3, "t": 2}
    a, b = prog.run(fault), prog.run(fault, unroll=unroll)
    assert all(torch.equal(a[k], b[k]) for k in a)


# -- the opt and lint CLIs -------------------------------------------------------

def test_opt_gate_and_lint_out(tmp_path, capsys):
    from coast_tpu_torch.opt import main as opt_main
    out = tmp_path / "findings.json"
    assert opt_main(["-TMR", f"-lintOut={out}", "crc16"], device="cpu") == 0
    assert json.loads(out.read_text())["ok"] is True
    assert opt_main(["-TMR", "-noCloneOpsCheck", "crc16"],
                    device="cpu") == 0
    capsys.readouterr()


def test_opt_gate_refuses_a_broken_build(monkeypatch, capsys):
    """The gate runs on the program opt builds: a build whose commit vote
    is lost is refused unless -noCloneOpsCheck is given."""
    from coast_tpu_torch import opt as opt_mod
    from coast_tpu_torch.passes import strategies
    real = strategies.TMR

    def broken(region, **kw):
        return mutate_dropped(real(region, **kw))

    monkeypatch.setattr(strategies, "TMR", broken)
    assert opt_mod.main(["-TMR", "matrixMultiply"], device="cpu") == 1
    err = capsys.readouterr().err
    assert "voter-coverage" in err and "-noCloneOpsCheck" in err
    assert opt_mod.main(["-TMR", "-noCloneOpsCheck", "matrixMultiply"],
                        device="cpu") == 0
    capsys.readouterr()


def test_opt_dump_module_formats(capsys, tmp_path):
    from coast_tpu_torch.opt import main as opt_main
    assert opt_main(["-TMR", "-dumpModule", "trivial"], device="cpu") == 0
    out = capsys.readouterr().out
    assert "trip t=0" in out and "coast_lint.tag" in out
    assert opt_main(["-TMR", "-dumpModule=jaxpr", "trivial"],
                    device="cpu") == 0
    assert "coast:voter" in capsys.readouterr().out
    assert opt_main(["-TMR", "-dumpModule=hlo", "trivial"],
                    device="cpu") == 0
    out = capsys.readouterr().out
    assert "dispatch stream" in out and "K1 plain version" in out
    assert opt_main(["-TMR", "-dumpModule=bogus", "trivial"],
                    device="cpu") == 2
    # Item 17c landed: -propOut writes the map and the proof.
    prop = tmp_path / "p.json"
    assert opt_main(["-TMR", f"-propOut={prop}", "trivial"],
                    device="cpu") == 0
    doc = json.loads(prop.read_text())
    assert doc["isolation"]["holds"] is True
    assert doc["vulnerability_map"]["benchmark"] == "trivial"


def test_lint_cli(tmp_path, capsys):
    from coast_tpu_torch.analysis.lint.__main__ import main as lint_main
    out = tmp_path / "lint.json"
    assert lint_main(["-TMR", "crc16", "--no-survival", "--json", str(out)],
                     device="cpu") == 0
    doc = json.loads(out.read_text())
    assert doc["strategy"] == "TMR" and doc["reports"][0]["ok"] is True
    assert doc["reports"][0]["passes_run"] == ["provenance"]
    base = tmp_path / "b.json"
    assert lint_main(["-DWC", "matrixMultiply", "crc16", "--write-baseline",
                      str(base), "--device", "cpu"]) == 0
    assert "matrixMultiply:lane-probe:leaf:i" in json.loads(
        base.read_text())["suppress"]
    assert lint_main(["-TMR", "crc16", "--baseline", str(base)],
                     device="cpu") == 0
    assert lint_main(["-TMR", "nonesuch"], device="cpu") == 2
    # Item 17c landed: --propagation adds the prover and prints the map.
    capsys.readouterr()
    assert lint_main(["-TMR", "crc16", "--propagation"], device="cpu") == 0
    assert "static vulnerability map: crc16" in capsys.readouterr().out


def test_lint_cli_prints_like_the_reference(capsys):
    """The report text of a finding-free and a noted build is the
    reference's, line for line."""
    from coast_tpu.analysis.lint.__main__ import main as jlint_main
    from coast_tpu_torch.analysis.lint.__main__ import main as lint_main
    argv = ["-DWC", "crc16", "matrixMultiply", "--no-survival"]
    assert lint_main(argv, device="cpu") == 0
    got = capsys.readouterr().out
    assert jlint_main(argv) == 0
    assert got == capsys.readouterr().out


# -- training regions --------------------------------------------------------------

def train_progs(strategy, optimizer, **overrides):
    from coast_tpu import DWC as JDWC, TMR as JTMR
    from coast_tpu.train import mlp as jmlp
    from coast_tpu_torch.train import mlp
    region, jregion = (mlp.make_train_region(optimizer),
                       jmlp.make_train_region(optimizer))
    if strategy == "SELX":
        return (mlp.selective_xmr(region, device="cpu", **overrides),
                jmlp.selective_xmr(jregion, **overrides))
    make, jmake = {"TMR": (TMR, JTMR), "DWC": (DWC, JDWC)}[strategy]
    return make(region, device="cpu", **overrides), jmake(jregion,
                                                          **overrides)


@pytest.mark.parametrize("strategy,optimizer", [
    ("TMR", "sgd"), ("DWC", "sgd"), ("SELX", "sgd"), ("TMR", "adam")])
def test_train_region_lint_equals_the_reference(strategy, optimizer):
    prog, jprog = train_progs(strategy, optimizer)
    got = lint.lint_program(prog)
    want = ref_lint(jprog)
    assert got.ok and keys(got) == keys(want)
    if strategy == "SELX":
        assert ("spof", "note", "fn:grad_step") in keys(got)


def test_train_expected_sync_classes():
    from coast_tpu_torch.train.mlp import make_train_region
    region = make_train_region("adam")
    cfg = TMR(region, device="cpu").cfg
    exp = lint.expected_sync_classes(region, cfg)
    for leaf in ("w1", "b1", "w2", "b2"):
        assert exp[leaf] == {"param"}
    for leaf in ("m_w1", "v_w1", "m_b2", "v_b2"):
        assert exp[leaf] == {"opt_state"}
    assert exp["x"] == set()
    exp2 = lint.expected_sync_classes(
        region, dataclasses.replace(cfg, no_store_data_sync=True))
    assert exp2["w1"] == set() and exp2["v_w1"] == set()
    with pytest.raises(ValueError, match="store_slice hint"):
        TMR(region, device="cpu", no_store_data_sync=True)


@pytest.mark.parametrize("leaf,klass", [("w2", "param"),
                                        ("m_w1", "opt_state")])
def test_train_dropped_commit_vote_caught(leaf, klass):
    prog, jprog = train_progs("SELX", "sgd")
    for p in (prog, jprog):
        assert p.step_sync[leaf]
        p.step_sync[leaf] = False
    got = lint.lint_program(prog, survival=False)
    assert keys(got) == keys(ref_lint(jprog, survival=False))
    assert any(leaf in f.locus and klass in f.message for f in got.errors())
