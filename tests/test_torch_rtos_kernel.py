"""The preemptive RTOS kernel targets (rtos_mm, rtos_kUser) of the port
against the JAX reference.

In one process, for both targets: the init image, the unprotected
trajectory and the golden equal the reference's; the declared dataflow
equals the reference's ``analyze()``; the canonical config
(``rtos/kernel.config`` plus ``rtos/Makefile``'s lists) resolves every
function, leaf and sync table as the reference does; the reference's
seeded guard cases (canary and saved-SP flips -> DUE_STACK_OVERFLOW, a
ready flip -> DUE_ASSERT, an unused-fill flip benign) give the same
records; TMR and DWC campaigns, unfused and fused, dense and sparse, give
the reference's codes, errors, corrected, steps and ``sync_count`` on
every row; ``-s stack`` gives the reference's summary and logs through
both supervisors; the opt CLI exits as the reference's does.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import coast_tpu_torch as ct
from coast_tpu_torch.inject import classify as cls
from coast_tpu_torch.inject import supervisor
from coast_tpu_torch.inject.campaign import CampaignRunner
from coast_tpu_torch.interop import state_to_numpy
from coast_tpu_torch.ir.region import KIND_MEM, KIND_STACK, LeafSpec
from coast_tpu_torch.models import REGISTRY, model_source
from coast_tpu_torch.passes.verification import analyze
from coast_tpu_torch.rtos import campaign as rtos_campaign
from coast_tpu_torch.rtos.kernel import CANARY, SP_MAX, SP_MIN, STACK_WORDS
from test_torch_corpus import check_programs
from test_torch_supervisor import (FIXED_TS, assert_logs_equal, drive,
                                   ref_main, summary_of)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "rtos", "kernel.config")
TARGETS = ("rtos_mm", "rtos_kUser")
STRATEGIES = ("TMR", "DWC")
RECORD_KEYS = ("errors", "corrected", "steps", "sync_count", "done",
               "dwc_fault", "cfc_fault", "stack_fault", "assert_fault",
               "output")
FAULT_KEYS = ("leaf_id", "lane", "word", "bit", "t")
# The reference's seeded guard cases (tests/test_rtos_kernel.py), as
# (leaf, lane, word, bit, t).
CANARY_FLIP = ("stacks", 2, STACK_WORDS, 7, 11)     # task 1's canary
SP_FLIP = ("tcb_sp", 0, 1, 20, 9)
READY_FLIP = ("ready", 1, 0, 4, 5)
FILL_FLIP = ("stacks", 1, 14, 3, 30)
GUARD_CASES = (CANARY_FLIP, SP_FLIP, READY_FLIP, FILL_FLIP)


def _jprog(name, num_clones, **kw):
    """The reference's canonical build (its campaign script's), with
    ``kw`` replacing config fields."""
    import coast_tpu
    from scripts.rtos_campaign import canonical_prog
    base = canonical_prog(name, num_clones)
    if not kw:
        return base
    return coast_tpu.protect(base.region,
                             dataclasses.replace(base.cfg, **kw))


def _tprog(name, num_clones, **kw):
    return rtos_campaign.canonical_prog(name, num_clones, "cpu", **kw)


def _cols(prog, rows):
    cols = {k: [] for k in FAULT_KEYS}
    for leaf, *rest in rows:
        for k, v in zip(FAULT_KEYS, (prog.leaf_order.index(leaf), *rest)):
            cols[k].append(v)
    return {k: np.asarray(v, np.int32) for k, v in cols.items()}


def _jrecords(jprog, cols):
    import jax
    import jax.numpy as jnp
    out = jax.jit(jax.vmap(jprog.run))(
        {k: jnp.asarray(v) for k, v in cols.items()})
    return {k: np.asarray(out[k]) for k in RECORD_KEYS}


def _trecords(tprog, cols):
    out = tprog.run_batch(cols)
    return {k: out[k].numpy() for k in RECORD_KEYS}


def _assert_records_equal(got, want, what):
    for k in RECORD_KEYS:
        g, w = np.ascontiguousarray(got[k]), np.ascontiguousarray(want[k])
        if w.dtype == np.uint32:
            w = w.view(np.int32)
        assert g.shape == w.shape, (what, k)
        bad = (g != w).reshape(len(g), -1).any(axis=1)
        assert not bad.any(), \
            f"{what} {k} differs on rows {np.flatnonzero(bad)[:10].tolist()}"


# -- the regions -------------------------------------------------------------

@pytest.mark.parametrize("name", TARGETS)
def test_region_equals_reference(name):
    import jax
    from coast_tpu.models import REGISTRY as JREGISTRY
    from coast_tpu.passes.verification import analyze as janalyze
    region, jregion = REGISTRY[name](), JREGISTRY[name]()
    want, got = janalyze(jregion), analyze(region)
    assert (got.written, got.deps, got.load_addr, got.store_addr) == (
        want.written, want.deps, want.load_addr, want.store_addr)
    assert list(region.spec) == list(jregion.spec)
    for k, spec in region.spec.items():
        w = jregion.spec[k]
        assert (spec.kind, spec.xmr, spec.inject, spec.no_verify,
                spec.canary_word) == (w.kind, w.xmr, w.inject, w.no_verify,
                                      w.canary_word), k
    assert sorted(region.functions) == sorted(jregion.functions)
    assert region.meta["rtos_sections"] == jregion.meta["rtos_sections"]
    assert (region.nominal_steps, region.max_steps) == (
        jregion.nominal_steps, jregion.max_steps)
    assert region.graph.names == jregion.graph.names
    assert region.graph.edges == jregion.graph.edges
    image = state_to_numpy(region.init("cpu"), region)
    for k, v in jax.jit(jregion.init)().items():
        np.testing.assert_array_equal(image[k], np.asarray(v), err_msg=k)
    final = region.run_unprotected("cpu")
    port_np = state_to_numpy(final, region)
    for k, v in jax.jit(jregion.run_unprotected)().items():
        np.testing.assert_array_equal(port_np[k], np.asarray(v), err_msg=k)
    # The golden: the port's own unprotected output equals the
    # reference's, so the self-check of the final state is 0.
    one = {k: v.unsqueeze(0) for k, v in final.items()}
    np.testing.assert_array_equal(
        region.output(one)[0].numpy().view(np.uint32),
        np.asarray(jregion.output(jax.jit(jregion.run_unprotected)())))
    assert int(region.check(one)[0]) == 0
    assert model_source(name).endswith(
        os.path.join("coast_tpu_torch", "models", "rtos_kernel.py"))


@pytest.mark.parametrize("name", TARGETS)
def test_canonical_scope_and_tables_equal(name):
    for n in (3, 2):
        for fused in (False, True):
            jprog = _jprog(name, n, fuse_step=fused)
            tprog = _tprog(name, n, fuse_step=fused)
            assert tprog.fn_scope == jprog.fn_scope
            check_programs(jprog, tprog)
    tprog = _tprog(name, 3)
    assert tprog.fn_scope["queue_send"] == "protected_lib"
    assert tprog.fn_scope["rng_next"] == "skip_lib"
    assert tprog.fn_scope["clampi"] == "ignored"
    assert not tprog.replicated["uart"] and tprog.replicated["stacks"]
    assert tprog._sync_class_of("stacks") == "stack"
    assert ("stack", "stacks") in tprog.sync_tags()
    if name == "rtos_kUser":
        for fn in ("push_frame", "pop_frame", "pick_next"):
            assert tprog.fn_scope[fn] == "replicated"


def test_canary_word_metadata_and_errors():
    region = REGISTRY["rtos_mm"]()
    spec = region.spec["stacks"]
    assert spec.kind == KIND_STACK and spec.canary_word == 0
    assert int(region.init("cpu")["stacks"][0, spec.canary_word]) == CANARY
    assert SP_MIN >= 1 and SP_MAX + 4 <= STACK_WORDS
    with pytest.raises(ValueError, match="canary_word"):
        LeafSpec(KIND_MEM, canary_word=0)
    from coast_tpu.ir.region import LeafSpec as JLeafSpec
    with pytest.raises(ValueError) as want:
        JLeafSpec(KIND_MEM, canary_word=0)
    with pytest.raises(ValueError) as got:
        LeafSpec(KIND_MEM, canary_word=0)
    assert str(got.value) == str(want.value)
    assert LeafSpec(KIND_STACK, canary_word=3).canary_word == 3


# -- fault-free runs and the guard cases ------------------------------------

@pytest.mark.parametrize("name", TARGETS)
def test_golden_clean_all_strategies(name):
    region = REGISTRY[name]()
    for prog in (ct.unprotected(region, device="cpu"), _tprog(name, 2),
                 _tprog(name, 3), _tprog(name, 3, fuse_step=True)):
        rec = prog.run_batch(batch=3)
        assert (rec["errors"] == 0).all() and rec["done"].all()
        assert not rec["stack_fault"].any()
        assert not rec["assert_fault"].any()
        assert (rec["steps"] == region.nominal_steps).all()
        codes = cls.classify(rec, prog.output_words)
        assert (codes == cls.SUCCESS).all()


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("name", TARGETS)
def test_guard_cases_like_reference(name, strategy):
    n = 3 if strategy == "TMR" else 2
    cases = [c for c in GUARD_CASES if c[1] < n]
    jprog = _jprog(name, n)
    want = _jrecords(jprog, _cols(jprog, cases))
    for fused in (False, True):
        tprog = _tprog(name, n, fuse_step=fused)
        _assert_records_equal(_trecords(tprog, _cols(tprog, cases)), want,
                              f"{name} {strategy} fused={fused}")


def _one(prog, case):
    rec = _trecords(prog, _cols(prog, [case]))
    return {k: v[0] for k, v in rec.items()}


@pytest.mark.parametrize("fused", (False, True))
def test_guard_classes_on_rtos_mm(fused):
    """The reference's targeted flips under the canonical TMR build: TMR
    cannot mask detection, as the reference's replicated kernel hook."""
    prog = _tprog("rtos_mm", 3, fuse_step=fused)
    rec = _one(prog, CANARY_FLIP)
    assert rec["stack_fault"] and not rec["done"]
    assert _one(prog, SP_FLIP)["stack_fault"]
    rec = _one(prog, READY_FLIP)
    assert rec["assert_fault"] and not rec["stack_fault"]
    rec = _one(prog, FILL_FLIP)
    assert rec["errors"] == 0 and rec["done"] and not rec["stack_fault"]
    codes = cls.classify(prog.run_batch(_cols(prog, GUARD_CASES)),
                         prog.output_words).tolist()
    assert codes[:3] == [cls.DUE_STACK_OVERFLOW, cls.DUE_STACK_OVERFLOW,
                         cls.DUE_ASSERT]
    assert codes[3] in (cls.SUCCESS, cls.CORRECTED)


def test_classify_precedence_guard_codes():
    base = {"errors": torch.tensor([3]), "corrected": torch.tensor([1]),
            "steps": torch.tensor([5]), "done": torch.tensor([False]),
            "dwc_fault": torch.tensor([True]),
            "cfc_fault": torch.tensor([False]),
            "stack_fault": torch.tensor([False]),
            "assert_fault": torch.tensor([False])}
    t = torch.tensor([True])
    assert int(cls.classify(base, 100)) == cls.DUE_ABORT
    assert int(cls.classify({**base, "assert_fault": t}, 100)) \
        == cls.DUE_ASSERT
    assert int(cls.classify({**base, "assert_fault": t, "stack_fault": t},
                            100)) == cls.DUE_STACK_OVERFLOW
    assert int(cls.classify({**base, "stack_fault": t,
                             "errors": torch.tensor([-1])}, 100)) \
        == cls.INVALID


def test_scheduler_trace_equal_across_lanes():
    """Fault-free TMR: the voted scheduler trace equals the unprotected
    run's."""
    region = REGISTRY["rtos_mm"]()
    unprot = region.run_unprotected("cpu")
    rec = _tprog("rtos_mm", 3).run(return_state=True)
    assert torch.equal(rec["final_state"]["sched_trace"],
                       unprot["sched_trace"])


# -- campaigns ---------------------------------------------------------------

ROWS, SEED, BATCH = 192, 42, 96


@pytest.fixture(scope="module")
def reference_records():
    """The reference's records of every row of the port's seeded
    campaign schedule, with ``-countSyncs``, per (target, strategy)."""
    memo = {}

    def get(name, strategy):
        if (name, strategy) not in memo:
            n = 3 if strategy == "TMR" else 2
            sched = CampaignRunner(_tprog(name, n)).run(
                ROWS, seed=SEED, batch_size=ROWS).schedule
            cols = {k: np.asarray(getattr(sched, k), np.int32)
                    for k in FAULT_KEYS}
            memo[name, strategy] = (
                cols, _jrecords(_jprog(name, n, count_syncs=True), cols))
        return memo[name, strategy]
    return get


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("name", TARGETS)
def test_campaign_records_equal_reference(name, strategy, reference_records):
    """Codes, errors, corrected and steps of the port's campaigns (unfused
    and fused, dense and sparse) and ``sync_count`` of its records equal
    the reference's on every row."""
    import jax
    from coast_tpu.inject import classify as jcls
    cols, want = reference_records(name, strategy)
    n = 3 if strategy == "TMR" else 2
    words = want["output"].shape[1]
    want_codes = np.asarray(jax.vmap(lambda r: jcls.classify(r, words))(
        {k: jax.numpy.asarray(v) for k, v in want.items()}))
    assert {cls.DUE_STACK_OVERFLOW, cls.DUE_ASSERT} <= set(want_codes)
    for fused in (False, True):
        tprog = _tprog(name, n, fuse_step=fused, count_syncs=True)
        _assert_records_equal(_trecords(tprog, cols), want,
                              f"{name} {strategy} fused={fused}")
        dense = CampaignRunner(tprog, strategy_name=strategy).run(
            ROWS, seed=SEED, batch_size=BATCH)
        np.testing.assert_array_equal(dense.codes, want_codes)
        for col in ("errors", "corrected", "steps"):
            np.testing.assert_array_equal(
                getattr(dense, col), want[col].astype(np.int32), err_msg=col)
        sparse = CampaignRunner(tprog, strategy_name=strategy,
                                collect="sparse").run(
            ROWS, seed=SEED, batch_size=BATCH)
        assert sparse.counts == dense.counts
        rows = sparse.interesting_rows
        np.testing.assert_array_equal(rows,
                                      np.flatnonzero(dense.codes > 1))
        for col in ("codes", "errors", "corrected", "steps"):
            np.testing.assert_array_equal(getattr(sparse, col),
                                          getattr(dense, col)[rows])


def test_campaign_categories_and_due_sub_buckets():
    """The category table of the rtos campaign: stack-overflow DUEs on
    stack and TCB leaves, assert DUEs on scheduler structures, the
    sub-buckets summing into the DUE bucket."""
    prog = _tprog("rtos_mm", 3)
    runner = CampaignRunner(prog, strategy_name="TMR")
    res = runner.run(256, seed=42, batch_size=128)
    table = rtos_campaign.category_table(res, runner.mmap,
                                         prog.region.meta["rtos_sections"])
    assert set(table) == {"stack", "tcb", "task_data"}
    assert sum(row["injections"] for row in table.values()) == res.n
    assert table["task_data"]["due_stack_overflow"] == 0
    assert table["task_data"]["due_assert"] == 0
    subs = rtos_campaign.due_sub_buckets(res.counts)
    assert sum(subs.values()) == res.due
    lid = np.asarray(res.schedule.leaf_id)
    names = dict(enumerate(prog.leaf_order))
    so = {names[int(i)] for i in lid[res.codes == cls.DUE_STACK_OVERFLOW]}
    asserts = {names[int(i)] for i in lid[res.codes == cls.DUE_ASSERT]}
    assert so and so <= {"stacks", "tcb_sp"}
    assert asserts and asserts <= {"ready", "slices", "cur"}


def test_campaign_cli(tmp_path, capsys):
    out = tmp_path / "rtos.json"
    rc = rtos_campaign.main(["-n", "256", "--batch", "128", "--device",
                             "cpu", "--out", str(out)])
    assert rc == 0
    assert out.exists() and (tmp_path / "rtos_log.json").exists()
    printed = capsys.readouterr().out
    assert '"due_sub_buckets"' in printed
    # The per-symbol table is the port's parser's, over the written log.
    from coast_tpu_torch.analysis import json_parser as jp
    table = jp.section_stats([jp.read_json_file(
        str(tmp_path / "rtos_log.json"))])
    assert json.loads(out.read_text())["per_symbol"] == json.loads(
        json.dumps(table))
    assert jp.format_section_stats(table) in printed


# -- the supervisor's -s stack and the opt CLI ------------------------------

KL = ["-cloneFns=task_mm,task_crc,task_idle", "-protectedLibFn=queue_send",
      "-cloneGlbls=qbuf,stacks", f"-configFile={CONFIG}"]
STACK_CAMPAIGNS = {
    "mm_tmr_canonical": ["-f", "rtos_mm", "-O", " ".join(["-TMR", *KL]),
                         "-s", "stack", "-t", "96", "--batch-size", "48",
                         "--seed", "4", "--log-format", "ndjson"],
    "kuser_dwc_fused": ["-f", "rtos_kUser", "-O", "-DWC -fuseStep", "-s",
                        "stack", "-t", "64", "--batch-size", "64",
                        "--seed", "2"],
}


@pytest.fixture
def timestamps(monkeypatch):
    """Both packages' log timestamps fixed (the reference's imported here,
    so the file's card tests run without JAX)."""
    from coast_tpu.inject import logs as jlogs
    from coast_tpu_torch.inject import logs
    monkeypatch.setattr(logs, "_timestamp", lambda: FIXED_TS)
    monkeypatch.setattr(jlogs, "_timestamp", lambda: FIXED_TS)


@pytest.mark.parametrize("case", sorted(STACK_CAMPAIGNS))
def test_stack_section_through_both_supervisors(case, tmp_path, capsys,
                                               timestamps):
    argv = STACK_CAMPAIGNS[case]
    got = drive(supervisor.main, argv, tmp_path / "port", capsys)
    want = drive(ref_main, argv, tmp_path / "ref", capsys)
    assert summary_of(got) == summary_of(want)
    for key in ("due_stack_overflow", "due_assert", "due_abort",
                "due_timeout"):
        assert key in summary_of(got)
    fmt = argv[argv.index("--log-format") + 1] \
        if "--log-format" in argv else "json"
    assert_logs_equal(tmp_path / "port", tmp_path / "ref", fmt)


def test_stack_section_draws_kernel_stacks():
    prog = _tprog("rtos_mm", 3)
    assert supervisor.section_filter(prog, "stack") == ["stacks"]


def test_opt_cli_canonical_kernel_invocation(capsys):
    from coast_tpu_torch.opt import main as opt_main
    rc = opt_main(["-TMR", "-countErrors", *KL, "rtos_mm"], device="cpu")
    assert rc == 0
    assert "E: 0" in capsys.readouterr().out


def test_opt_cli_stack_overflow_exit(capsys):
    """A canary flip through the CLI reports the hook line, as the
    reference's does."""
    from coast_tpu.opt import main as jopt_main
    from coast_tpu_torch.opt import main as opt_main
    argv = ["-TMR", "-countErrors", f"-inject=stacks:2:{STACK_WORDS}:7:11",
            "rtos_mm"]
    assert opt_main(argv, device="cpu") == 134
    got = capsys.readouterr()
    assert "stack overflow" in got.err
    assert jopt_main(argv) == 134
    assert capsys.readouterr().err.splitlines()[-1] \
        == got.err.splitlines()[-1]


def test_opt_cli_prints_like_reference(capsys, tmp_path):
    from coast_tpu.opt import main as jopt_main
    from coast_tpu_torch.opt import main as opt_main
    argv = ["-TMR", "-countSyncs", "-ExitMarker", "-SmallProfile",
            "-noCloneOpsCheck", "rtos_kUser"]
    assert opt_main(argv, device="cpu") == 0
    got = capsys.readouterr().out
    assert jopt_main(argv) == 0
    assert got == capsys.readouterr().out
    # -lintOut writes the gate's report, -propOut the vulnerability map
    # and the isolation proof (item 17c).
    out = tmp_path / "x.json"
    assert opt_main(["-TMR", f"-lintOut={out}", "rtos_mm"],
                    device="cpu") == 0
    assert json.loads(out.read_text())["ok"] is True
    capsys.readouterr()
    prop = tmp_path / "p.json"
    assert opt_main(["-TMR", f"-propOut={prop}", "rtos_mm"],
                    device="cpu") == 0
    doc = json.loads(prop.read_text())
    assert doc["isolation"]["holds"] is True
    # Kernel guards read raw lanes: every replicated section is
    # sdc-possible, as the recorded sweep says.
    assert doc["vulnerability_map"]["verdict_counts"]["sdc-possible"] > 0


OTHER_CONFIGS = {
    "unprotected": {"num_clones": 1},
    "tmr_no_mem_replication": {"num_clones": 3, "no_mem_replication": True},
    "tmr_segmented": {"num_clones": 3, "segmented": True},
    "tmr_no_syncs": {"num_clones": 3, "no_store_data_sync": True,
                     "no_load_sync": True},
    "tmr_cfcss_fused": {"num_clones": 3, "cfcss": True, "fuse_step": True},
    "dwc_cfcss": {"num_clones": 2, "cfcss": True},
}


@pytest.mark.parametrize("case", sorted(OTHER_CONFIGS))
def test_other_builds_equal_reference(case):
    """rtos_kUser outside its canonical config: the guards beside
    unprotected, -noMemReplication (the stacks single-copy), -s, no store
    or load syncs and CFCSS give the reference's records and sync tags."""
    import coast_tpu
    from test_torch_corpus import reference_sync_tags
    cfg = {**OTHER_CONFIGS[case], "count_syncs": True}
    from coast_tpu.models import REGISTRY as JREGISTRY
    jprog = coast_tpu.protect(JREGISTRY["rtos_kUser"](),
                              coast_tpu.ProtectionConfig(**cfg))
    tprog = ct.protect(REGISTRY["rtos_kUser"](), ct.ProtectionConfig(**cfg),
                       device="cpu")
    assert tprog.sync_tags() == reference_sync_tags(jprog)
    sched = CampaignRunner(tprog).run(160, seed=9, batch_size=160).schedule
    cols = {k: np.asarray(getattr(sched, k), np.int32) for k in FAULT_KEYS}
    cols = {k: np.concatenate([v, _cols(tprog, GUARD_CASES[:2])[k]])
            for k, v in cols.items()}
    _assert_records_equal(_trecords(tprog, cols), _jrecords(jprog, cols),
                          case)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host; K1 and K2 run only on the "
                    "card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", TARGETS)
def test_canonical_campaign_on_card(cuda, name):
    """The canonical TMR build on the card, unfused and fused: K1 (and K2
    fused) launched, fault-free rows clean, the records of a seeded
    campaign equal the host's on every row, both guard classes hit."""
    from coast_tpu_torch.ops import hopper_commit, hopper_voters
    host = CampaignRunner(_tprog(name, 3)).run(512, seed=42, batch_size=256)
    for fused in (False, True):
        prog = rtos_campaign.canonical_prog(name, 3, cuda, fuse_step=fused)
        codes = cls.classify(prog.run_batch(batch=64), prog.output_words)
        assert (codes == cls.SUCCESS).all()
        k1, k2 = hopper_voters.LAUNCHES, hopper_commit.LAUNCHES
        res = CampaignRunner(prog).run(512, seed=42, batch_size=256)
        assert hopper_voters.LAUNCHES > k1
        assert (hopper_commit.LAUNCHES > k2) == fused
        for col in ("codes", "errors", "corrected", "steps"):
            np.testing.assert_array_equal(getattr(res, col),
                                          getattr(host, col), err_msg=col)
        assert res.counts["due_stack_overflow"] and res.counts["due_assert"]
