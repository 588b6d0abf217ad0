"""towersOfHanoi, ``LeafSpec.stack`` and ``-protectStack`` of the port
against the JAX reference.

towersOfHanoi gets ``tests/test_torch_corpus.py``'s checks (init image,
dataflow, sections, sync tables and tags, final state, 64-row TMR and
DWC campaigns with no exemption, fused = unfused).  Its frame stack is
the only ``LeafSpec(stack=True)`` state of the registry, so the
``-protectStack`` checks run on it too: under ``protect_stack=True`` and
``no_store_data_sync=True`` the sync tables, the ``stack`` sync tags,
the 64-row records and the ``-countSyncs`` counts equal the reference's,
the reference's own stack-protection scenarios give the same records,
and ``-s stack`` through both supervisors gives equal summaries and logs.
"""

import numpy as np
import pytest
import torch

import coast_tpu_torch as ct
from coast_tpu_torch.inject import supervisor
from coast_tpu_torch.inject.campaign import CampaignRunner
from coast_tpu_torch.models import REGISTRY
from test_torch_baseline import (BATCH, COLUMNS, ROWS, SEED, STRATEGIES,
                                 Results, check_campaign, check_dataflow)
from test_torch_corpus import (check_final_state, check_fused,
                               check_init_image, check_programs,
                               check_sections_and_schedule,
                               check_step_dtypes)
from test_torch_supervisor import (assert_logs_equal, drive,  # noqa: F401
                                   fixed_timestamps, ref_main, summary_of)

torch.set_num_threads(1)

NAME = "towersOfHanoi"
STACK_LEAVES = ("st_num", "st_f", "st_t", "st_a", "st_stage", "sp")
# The configs of the reference's -protectStack tests (test_instrument.py).
PROTECTED = {"protect_stack": True, "no_store_data_sync": True}
RECORD_KEYS = ("errors", "corrected", "steps", "sync_count", "done",
               "dwc_fault", "output")


@pytest.fixture(scope="module")
def ref():
    return Results()


def test_init_image_equal(ref):
    check_init_image(NAME, ref)


def test_declared_dataflow_equals_reference_analysis(ref):
    check_dataflow(NAME, ref)
    check_step_dtypes(NAME)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_sections_schedule_and_plan_equal(strategy, ref):
    check_sections_and_schedule(NAME, strategy, ref)


def test_fault_free_final_state_equals_reference_and_oracle(ref):
    check_final_state(NAME, ref)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_campaign_parity(strategy, ref):
    check_campaign(NAME, strategy, ref)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_fused_equals_unfused(strategy, ref):
    check_fused(NAME, strategy, ref)


# -- LeafSpec.stack and -protectStack ---------------------------------------

def test_stack_leaves_are_the_frame_stack(ref):
    region = REGISTRY[NAME]()
    assert tuple(n for n, s in region.spec.items() if s.stack) \
        == STACK_LEAVES
    assert {n: s.stack for n, s in region.spec.items()} == {
        n: s.stack for n, s in ref.region(NAME).spec.items()}
    # A field on any kind, apart from the rtos kernel's KIND_STACK.
    assert ct.LeafSpec(ct.KIND_REG, stack=True).stack
    assert ct.ProtectionConfig(protect_stack=True).protect_stack


@pytest.mark.parametrize("fused", (False, True))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_protect_stack_tables_and_tags_equal(strategy, fused, ref):
    """The sync tables, the ``stack`` sync tags of one step and the fused
    plan, with and without ``-noStoreDataSync``."""
    import coast_tpu
    for cfg in (PROTECTED, {"protect_stack": True}):
        jprog = getattr(coast_tpu, strategy)(ref.region(NAME),
                                             fuse_step=fused, **cfg)
        tprog = getattr(ct, strategy)(REGISTRY[NAME](), device="cpu",
                                      fuse_step=fused, **cfg)
        check_programs(jprog, tprog)
        for name in STACK_LEAVES:
            assert tprog.step_sync[name]
            assert tprog._sync_class_of(name) == "stack"
    tags = getattr(ct, strategy)(REGISTRY[NAME](), device="cpu",
                                 fuse_step=fused, **PROTECTED).sync_tags()
    assert {leaf for klass, leaf in tags if klass == "stack"} \
        == set(STACK_LEAVES)
    assert ("store_data", "disk_pos") not in tags


def test_protect_stack_forces_step_sync():
    """The reference's test_protect_stack_forces_step_sync."""
    region = REGISTRY[NAME]()
    base = ct.TMR(region, device="cpu", no_store_data_sync=True)
    prot = ct.TMR(region, device="cpu", **PROTECTED)
    assert not base.step_sync["st_t"]
    assert prot.step_sync["st_t"]
    assert not prot.step_sync["disk_pos"]


def _stack_fault(prog, t):
    return {"leaf_id": prog.leaf_order.index("st_t"), "lane": 1, "word": 2,
            "bit": 0, "t": t}


def test_protect_stack_scenarios_like_reference(ref):
    """The reference's DWC early-detection and TMR correction scenarios
    (a flipped frame word at step 40): the same records."""
    import coast_tpu
    import jax
    unprot = {"no_store_data_sync": True, "no_load_sync": True,
              "no_store_addr_sync": True}
    cases = (("DWC", unprot), ("DWC", {**unprot, "protect_stack": True}),
             ("TMR", PROTECTED))
    recs = []
    for strategy, cfg in cases:
        jprog = getattr(coast_tpu, strategy)(ref.region(NAME), **cfg)
        tprog = getattr(ct, strategy)(REGISTRY[NAME](), device="cpu", **cfg)
        got = tprog.run(_stack_fault(tprog, 40))
        want = jax.jit(jprog.run)({k: jax.numpy.int32(v) for k, v in
                                   _stack_fault(jprog, 40).items()})
        for key in RECORD_KEYS:
            np.testing.assert_array_equal(
                got[key].numpy(),
                np.asarray(want[key]).astype(got[key].numpy().dtype),
                err_msg=f"{strategy} {cfg} {key}")
        recs.append(got)
    plain, prot, tmr = recs
    assert bool(prot["dwc_fault"]) and int(prot["steps"]) <= 41
    assert int(plain["steps"]) > int(prot["steps"])
    assert int(tmr["errors"]) == 0 and bool(tmr["done"])
    assert int(tmr["corrected"]) >= 1


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_protect_stack_campaign_and_sync_counts(strategy, ref):
    """64 rows (seed 3) under ``-protectStack -noStoreDataSync``: every
    record equal to the reference's, fused equal to unfused; then the
    first 32 rows again with ``-countSyncs``, ``sync_count`` included."""
    import coast_tpu
    import jax
    from coast_tpu.inject.campaign import CampaignRunner as JRunner
    jprog = getattr(coast_tpu, strategy)(ref.region(NAME), **PROTECTED)
    want = JRunner(jprog, strategy_name=strategy).run(
        ROWS, seed=SEED, batch_size=BATCH)
    for fused in (False, True):
        tprog = getattr(ct, strategy)(REGISTRY[NAME](), device="cpu",
                                      fuse_step=fused, **PROTECTED)
        got = CampaignRunner(tprog, strategy_name=strategy).run(
            ROWS, seed=SEED, batch_size=BATCH)
        for col in COLUMNS:
            np.testing.assert_array_equal(getattr(got, col),
                                          getattr(want, col), err_msg=col)
        assert got.counts == want.counts
    cfg = {**PROTECTED, "count_syncs": True}
    jprog = getattr(coast_tpu, strategy)(ref.region(NAME), **cfg)
    tprog = getattr(ct, strategy)(REGISTRY[NAME](), device="cpu", **cfg)
    sched = got.schedule
    cols = {k: np.asarray(getattr(sched, k)[:32], np.int32)
            for k in ("leaf_id", "lane", "word", "bit", "t")}
    rec = tprog.run_batch(cols)
    jrec = jax.jit(jax.vmap(jprog.run))(
        {k: jax.numpy.asarray(v) for k, v in cols.items()})
    for key in RECORD_KEYS:
        np.testing.assert_array_equal(
            rec[key].numpy(),
            np.asarray(jrec[key]).astype(rec[key].numpy().dtype),
            err_msg=key)
    assert (rec["sync_count"] > 0).all()


# -s stack through both supervisors, with and without the protection.
STACK_CAMPAIGNS = {
    "tmr_protect_stack": ["-f", NAME, "-O", "-TMR -protectStack", "-s",
                          "stack", "-t", "64", "--batch-size", "64",
                          "--seed", "3", "--log-format", "ndjson"],
    "dwc_protect_stack_no_store_sync": [
        "-f", NAME, "-O", "-DWC -protectStack -noStoreDataSync", "-s",
        "stack", "-t", "48", "--batch-size", "24", "--seed", "5"],
    "tmr_fused_stack": ["-f", NAME, "-O", "-TMR -fuseStep", "-s", "stack",
                        "-t", "40", "--batch-size", "40", "--seed", "2",
                        "--log-format", "reference"],
}


@pytest.mark.parametrize("case", sorted(STACK_CAMPAIGNS))
def test_stack_section_campaign_equals_the_reference(case, tmp_path,
                                                     capsys):
    argv = STACK_CAMPAIGNS[case]
    got = drive(supervisor.main, argv, tmp_path / "port", capsys)
    want = drive(ref_main, argv, tmp_path / "ref", capsys)
    assert summary_of(got) == summary_of(want)
    fmt = argv[argv.index("--log-format") + 1] \
        if "--log-format" in argv else "json"
    assert_logs_equal(tmp_path / "port", tmp_path / "ref", fmt)


def test_stack_section_draws_only_frames():
    prog = ct.TMR(REGISTRY[NAME](), device="cpu", protect_stack=True)
    assert supervisor.section_filter(prog, "stack") == list(STACK_LEAVES)
    mm = ct.TMR(REGISTRY["matrixMultiply"](), device="cpu")
    with pytest.raises(SystemExit):
        supervisor.section_filter(mm, "stack")
