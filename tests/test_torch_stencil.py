"""The sharded halo-exchange stencil of the port against the JAX reference.

Against the JAX twin built in the same process, under both voter
placements (``compute``: vote-then-exchange; ``link``:
exchange-then-vote): the init image, spec, meta and declared dataflow;
the fault-free trajectory step by step, and against the numpy golden;
the sync tables, sync tags and fused plan; the ``link``/memory draw
partition of the schedule and the device generator on the stencil map;
the run records of TMR and DWC under single, cluster and link faults
(n=128, seed 7, batch 64), unfused and fused, equal on every row; the
recorded containment study (``artifacts/stencil_campaign.json``); the
placement as journal identity across the two packages; and
``run_distributed`` over meshes of 1 to 6 logical shards.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import coast_tpu_torch as ct
from coast_tpu_torch.inject.campaign import CampaignRunner
from coast_tpu_torch.inject.journal import (JournalMismatchError,
                                            PlacementMismatchError)
from coast_tpu_torch.inject.mem import MemoryMap
from coast_tpu_torch.inject.schedule import (FaultModel, generate,
                                             generate_stratified,
                                             generate_stratified_total)
from coast_tpu_torch.interop import state_to_numpy
from coast_tpu_torch.ir.region import KIND_LINK, LeafSpec
from coast_tpu_torch.models import resolve_region, stencil
from coast_tpu_torch.parallel.mesh import Mesh, make_mesh
from test_torch_corpus import check_programs

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(ROOT, "artifacts", "stencil_campaign.json")
COLUMNS = ("codes", "errors", "corrected", "steps")
MODELS = ("single", "cluster(span=4,k=3)", "link")
N, SEED, BATCH = 128, 7, 64


def jregion(placement):
    from coast_tpu.models import resolve_region as jresolve
    return jresolve("stencil", placement=placement)


def link_leaves(mmap):
    return {s.leaf_id for s in mmap.sections if s.kind == "link"}


# -- the region ---------------------------------------------------------------

@pytest.mark.parametrize("placement", stencil.PLACEMENTS)
def test_region_contract_equals_reference(placement):
    from coast_tpu.passes.verification import analyze as janalyze
    from coast_tpu_torch.passes.verification import analyze
    region, jr = resolve_region("stencil", placement=placement), \
        jregion(placement)
    assert region.name == jr.name == f"stencil[{placement}]"
    assert (region.nominal_steps, region.max_steps, region.default_xmr) == \
        (jr.nominal_steps, jr.max_steps, jr.default_xmr)
    image = state_to_numpy(region.init("cpu"), region)
    for name, want in jr.init().items():
        want = np.asarray(want)
        assert image[name].dtype == want.dtype, name
        np.testing.assert_array_equal(image[name], want, err_msg=name)
    for name, spec in jr.spec.items():
        got = region.spec[name]
        for field in ("kind", "xmr", "inject", "no_verify", "stack",
                      "unvoted_crossing"):
            assert getattr(got, field) == getattr(spec, field), (name, field)
    meta = {k: v for k, v in region.meta.items()
            if k not in ("golden_full", "dataflow")}
    assert meta == {k: v for k, v in jr.meta.items() if k != "golden_full"}
    np.testing.assert_array_equal(region.meta["golden_full"],
                                  jr.meta["golden_full"])
    want, got = janalyze(jr), analyze(region)
    assert (got.written, got.deps, got.load_addr, got.store_addr) == \
        (want.written, want.deps, want.load_addr, want.store_addr)
    assert region.graph is None and jr.graph is None


@pytest.mark.parametrize("placement", stencil.PLACEMENTS)
def test_fault_free_trajectory_equals_reference_and_golden(placement):
    """Every leaf after every step equals the reference step's, and the
    final grids are the golden trajectory's columns."""
    import jax
    region, jr = resolve_region("stencil", placement=placement), \
        jregion(placement)
    state = {k: v.unsqueeze(0) for k, v in region.init("cpu").items()}
    jstate = jr.init()
    jstep = jax.jit(jr.step)
    for t in range(region.nominal_steps):
        state = {**state, **region.step(state, t)}
        jstate = jstep(jstate, t)
        got = state_to_numpy({k: v[0] for k, v in state.items()}, region)
        for name, want in jstate.items():
            np.testing.assert_array_equal(got[name], np.asarray(want),
                                          err_msg=f"{name} at step {t}")
    assert bool(region.done(state)[0]) and int(region.check(state)[0]) == 0
    golden = stencil.golden_trajectory()
    H, W = stencil.H, stencil.W
    out = region.output(state)[0].numpy().view(np.uint32)
    np.testing.assert_array_equal(out[:H * W].reshape(H, W), golden[:, :W])
    np.testing.assert_array_equal(out[H * W:].reshape(H, W), golden[:, W:])


@pytest.mark.parametrize("placement", stencil.PLACEMENTS)
def test_halo_leaf_declares_the_wire(placement):
    region = stencil.make_region(placement)
    spec = region.spec["halo"]
    assert spec.kind == KIND_LINK and spec.xmr is False
    assert spec.unvoted_crossing == (placement == "link")
    want = ((stencil.R_LINK, stencil.SHARDS, stencil.H)
            if placement == "link" else (stencil.SHARDS, stencil.H))
    assert tuple(region.init("cpu")["halo"].shape) == want


def test_unknown_placement_and_knob_refused():
    from coast_tpu.models import resolve_region as jresolve
    with pytest.raises(ValueError, match="placement"):
        stencil.make_region("bogus")
    with pytest.raises(ValueError, match="placement"):
        resolve_region("stencil", placement="bogus")
    for resolve in (resolve_region, jresolve):
        with pytest.raises(TypeError):
            resolve("matrixMultiply", placement="link")
    with pytest.raises(TypeError):
        resolve_region("stencil", shards=4)


def test_unvoted_crossing_on_a_replicated_leaf_is_a_build_error():
    """Both engines refuse the declaration on a leaf that resolves to a
    replicated scope, with the same message."""
    import coast_tpu
    from coast_tpu.ir.region import LeafSpec as JLeafSpec
    region, jr = stencil.make_region("link"), jregion("link")
    bad = dataclasses.replace(region, spec={
        **region.spec, "halo": LeafSpec(KIND_LINK, xmr=True, unsigned=True,
                                        unvoted_crossing=True)})
    jbad = dataclasses.replace(jr, spec={
        **jr.spec, "halo": JLeafSpec("link", xmr=True,
                                     unvoted_crossing=True)})
    with pytest.raises(ValueError) as got:
        ct.TMR(bad, device="cpu")
    with pytest.raises(ValueError) as want:
        coast_tpu.TMR(jbad)
    assert str(got.value) == str(want.value)
    assert "unvoted_crossing" in str(got.value)
    # Unprotected, nothing is replicated: the declaration is legal.
    assert ct.unprotected(bad, device="cpu").replicated["halo"] is False


@pytest.mark.parametrize("placement", stencil.PLACEMENTS)
@pytest.mark.parametrize("strategy", ("TMR", "DWC"))
def test_programs_equal_reference(placement, strategy):
    """Memory map, sync tables, the sync tags of one step (no
    ``sor_crossing`` on the unvoted halo) and the fused plan."""
    import coast_tpu
    for fused in (False, True):
        tprog = getattr(ct, strategy)(
            resolve_region("stencil", placement=placement), device="cpu",
            fuse_step=fused)
        check_programs(getattr(coast_tpu, strategy)(
            jregion(placement), fuse_step=fused), tprog)
        assert (("sor_crossing", "halo") in tprog.sync_tags()) == (
            placement == "compute")
        assert tprog.forced_sync == frozenset({"halo"})
        if fused:
            assert tprog._fuse_plan is not None


# -- the draw partition and the device generator ------------------------------

def port_and_ref_maps(placement):
    import coast_tpu
    from coast_tpu.inject.mem import MemoryMap as JMemoryMap
    return (MemoryMap(ct.TMR(resolve_region("stencil", placement=placement),
                             device="cpu")),
            JMemoryMap(coast_tpu.TMR(jregion(placement))))


@pytest.mark.parametrize("spec", ("single", "multibit(k=4)",
                                  "cluster(span=4,k=3)",
                                  "burst(window=8,rate=0.5)",
                                  "link(offset=1,period=2)", "link"))
@pytest.mark.parametrize("placement", stencil.PLACEMENTS)
def test_schedule_partition_equals_reference(placement, spec):
    """Memory models never draw the link sections, the link model draws
    only them (in the receive window when it has one), and every column
    equals the reference's stream."""
    from coast_tpu.inject.schedule import FaultModel as JFaultModel
    from coast_tpu.inject.schedule import generate as jgenerate
    mmap, jmap = port_and_ref_maps(placement)
    steps = 2 * stencil.N_ITERS
    sched = generate(mmap, 256, 5, steps, model=FaultModel.parse(spec))
    want = jgenerate(jmap, 256, 5, steps, model=JFaultModel.parse(spec))
    for f in ("leaf_id", "lane", "word", "bit", "t", "section_idx"):
        np.testing.assert_array_equal(getattr(sched, f), getattr(want, f))
    on_link = np.isin(sched.leaf_id, sorted(link_leaves(mmap)))
    if spec.startswith("link"):
        assert on_link.all()
        if "period" in spec:
            assert np.all(np.asarray(sched.t) % 2 == 1)
    else:
        assert not on_link.any()
        assert len(set(sched.leaf_id.tolist())) > 1


def test_stratified_skips_link_sections():
    from coast_tpu.inject.schedule import \
        generate_stratified as jgenerate_stratified
    mmap, jmap = port_and_ref_maps("compute")
    steps = 2 * stencil.N_ITERS
    sched = generate_stratified(mmap, 4, 0, steps)
    want = jgenerate_stratified(jmap, 4, 0, steps)
    np.testing.assert_array_equal(sched.leaf_id, want.leaf_id)
    np.testing.assert_array_equal(sched.t, want.t)
    assert not np.isin(sched.leaf_id, sorted(link_leaves(mmap))).any()
    n_nonlink = sum(1 for s in mmap.sections if s.kind != "link")
    assert len(sched.leaf_id) == 4 * n_nonlink
    total = generate_stratified_total(mmap, 4 * n_nonlink, 0, steps)
    assert len(total.leaf_id) == 4 * n_nonlink
    with pytest.raises(ValueError, match="link"):
        generate_stratified(mmap, 4, 0, steps, model=FaultModel.link())


@pytest.mark.parametrize("spec", ("single", "cluster(span=4,k=3)",
                                  "link(offset=1,period=2)"))
@pytest.mark.parametrize("placement", stencil.PLACEMENTS)
def test_device_generator_on_the_stencil_map(placement, spec):
    from coast_tpu_torch.inject.device_gen import DeviceScheduleGen
    mmap, _ = port_and_ref_maps(placement)
    steps = 2 * stencil.N_ITERS
    model = FaultModel.parse(spec)
    want = generate(mmap, 193, 11, steps, model=model).device_arrays()
    got = DeviceScheduleGen(mmap, steps, model, "cpu").rows_np(
        11, 193, np.arange(193))
    for key in ("leaf_id", "lane", "word", "bit", "t"):
        np.testing.assert_array_equal(np.asarray(want[key]), got[key],
                                      err_msg=key)


def test_runner_takes_the_region_link_window():
    import coast_tpu
    from coast_tpu.inject.campaign import CampaignRunner as JRunner
    from coast_tpu.inject.schedule import FaultModel as JFaultModel
    prog = ct.TMR(stencil.make_region(), device="cpu")
    runner = CampaignRunner(prog, fault_model=FaultModel.link())
    assert runner.fault_model == FaultModel.link(offset=1, period=2)
    jrunner = JRunner(coast_tpu.TMR(jregion("compute")),
                      fault_model=JFaultModel.link())
    assert runner.fault_model.spec() == jrunner.fault_model.spec()
    # An explicit window is kept; a region without the meta key keeps the
    # bare model.
    assert CampaignRunner(prog, fault_model=FaultModel.link(0, 3)
                          ).fault_model.spec() == "link(offset=0,period=3)"


# -- run records --------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_records():
    """The reference's records of every (placement, strategy, model) cell,
    computed once."""
    import coast_tpu
    from coast_tpu.inject.campaign import CampaignRunner as JRunner
    from coast_tpu.inject.schedule import FaultModel as JFaultModel
    out = {}
    for placement in stencil.PLACEMENTS:
        for strategy in ("TMR", "DWC"):
            jprog = getattr(coast_tpu, strategy)(jregion(placement))
            for spec in MODELS:
                out[placement, strategy, spec] = JRunner(
                    jprog, fault_model=JFaultModel.parse(spec)).run(
                    N, seed=SEED, batch_size=BATCH)
    return out


@pytest.mark.parametrize("spec", MODELS)
@pytest.mark.parametrize("fused", (False, True), ids=("unfused", "fused"))
@pytest.mark.parametrize("strategy", ("TMR", "DWC"))
@pytest.mark.parametrize("placement", stencil.PLACEMENTS)
def test_records_equal_reference(placement, strategy, fused, spec,
                                 reference_records):
    prog = getattr(ct, strategy)(
        resolve_region("stencil", placement=placement), device="cpu",
        fuse_step=fused)
    res = CampaignRunner(prog, fault_model=FaultModel.parse(spec)).run(
        N, seed=SEED, batch_size=BATCH)
    want = reference_records[placement, strategy, spec]
    for col in COLUMNS:
        np.testing.assert_array_equal(getattr(res, col), getattr(want, col),
                                      err_msg=col)
    assert res.counts == want.counts


def test_containment_study_equals_the_recorded_artifact():
    """The port's study on the CPU gives the recorded counts, SDC sections,
    blast radii, soundness violations (none: every SDC lies in a section
    the static vulnerability map calls sdc-possible), two-shard ledgers
    and the containment block: every key of the artifact."""
    with open(ARTIFACT) as f:
        art = json.load(f)
    doc = stencil.containment_study(device="cpu", n=art["n"],
                                    seed=art["seed"])
    assert doc["ok"], doc["failures"]
    assert doc["containment"] == art["containment"]
    assert doc["models"] == art["models"]
    assert doc["mesh"] == art["mesh"]
    for placement, pl in art["placements"].items():
        for spec, cell in pl["cells"].items():
            got = doc["placements"][placement]["cells"][spec]
            assert set(got) == set(cell), (placement, spec)
            for key in ("counts", "sdc", "sdc_by_section", "blast_radius",
                        "soundness_violations", "sharded_parity", "mesh"):
                assert got[key] == cell[key], (placement, spec, key)
    c = doc["containment"]
    assert c["compute_placement_cross_shard_sdc"] == 0
    assert c["compute_placement_link_sdc"] == N
    assert c["link_placement_link_sdc"] == 0
    assert c["link_placement_cross_shard_sdc"] > 0


@pytest.mark.parametrize("collect", ("dense", "sparse"))
def test_sharded_summary_carries_the_mesh_ledger(collect):
    prog = ct.TMR(stencil.make_region(), device="cpu")
    res = CampaignRunner(prog, mesh=make_mesh(2, device="cpu"),
                         strategy_name="TMR", collect=collect).run(
        64, seed=7, batch_size=32)
    block = res.summary()["mesh"]
    assert block["devices"] == 2 and block["axes"] == {"data": 2}
    n_interesting = (len(res.interesting_rows) if collect == "sparse"
                     else int(np.sum(res.codes > 1)))
    assert sum(block["per_shard_interesting"]) == n_interesting > 0
    base = CampaignRunner(prog, strategy_name="TMR").run(64, seed=7,
                                                         batch_size=32)
    assert "mesh" not in base.summary()


# -- placement is campaign identity -------------------------------------------

@pytest.mark.parametrize("writer", ("port", "reference"))
def test_journal_placement_across_packages(writer, tmp_path):
    """A link-placement journal written by either package records the
    placement, resumes under the other package's link build to the same
    records, and refuses a compute build with the typed error."""
    import coast_tpu
    from coast_tpu.inject.campaign import CampaignRunner as JRunner
    path = str(tmp_path / "j.ndjson")
    tlink = ct.TMR(stencil.make_region("link"), device="cpu")
    jlink = coast_tpu.TMR(jregion("link"))
    make_w, make_r = ((lambda: CampaignRunner(tlink, strategy_name="TMR"),
                       lambda: JRunner(jlink, strategy_name="TMR"))
                      if writer == "port" else
                      (lambda: JRunner(jlink, strategy_name="TMR"),
                       lambda: CampaignRunner(tlink, strategy_name="TMR")))
    full = make_w().run(128, seed=3, batch_size=32, journal=path)
    with open(path) as f:
        lines = f.readlines()
    assert json.loads(lines[0])["placement"] == "link"
    with open(path, "w") as f:
        f.writelines(lines[:3])           # a kill after two batches
    res = make_r().run(128, seed=3, batch_size=32, journal=path)
    np.testing.assert_array_equal(res.codes, full.codes)
    assert res.counts == full.counts
    with pytest.raises(PlacementMismatchError) as exc:
        CampaignRunner(ct.TMR(stencil.make_region(), device="cpu"),
                       strategy_name="TMR").run(128, seed=3, batch_size=32,
                                                journal=path)
    assert "link" in str(exc.value) and "compute" in str(exc.value)
    assert issubclass(PlacementMismatchError, JournalMismatchError)


def test_preplacement_journal_resumes_as_compute(tmp_path):
    """A compute journal carries no placement key (as every journal written
    before the knob existed), so the reference's resumes under the port's
    compute build, and the port's link build refuses it."""
    import coast_tpu
    from coast_tpu.inject.campaign import CampaignRunner as JRunner
    path = str(tmp_path / "j.ndjson")
    full = JRunner(coast_tpu.TMR(jregion("compute")),
                   strategy_name="TMR").run(64, seed=3, batch_size=32,
                                            journal=path)
    with open(path) as f:
        lines = f.readlines()
    assert "placement" not in json.loads(lines[0])
    with open(path, "w") as f:
        f.writelines(lines[:2])
    res = CampaignRunner(ct.TMR(stencil.make_region(), device="cpu"),
                         strategy_name="TMR").run(64, seed=3, batch_size=32,
                                                  journal=path)
    np.testing.assert_array_equal(res.codes, full.codes)
    assert res.counts == full.counts
    with pytest.raises(PlacementMismatchError):
        CampaignRunner(ct.TMR(stencil.make_region("link"), device="cpu"),
                       strategy_name="TMR").run(64, seed=3, batch_size=32,
                                                journal=path)


# -- the distributed executors ------------------------------------------------

@pytest.mark.parametrize("shards", (1, 2, 3, 4, 6))
def test_run_distributed_over_a_mesh_equals_golden(shards):
    got = stencil.run_distributed(n_devices=shards, device="cpu")
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, stencil.golden_trajectory())


def test_run_distributed_equals_the_reference_executor():
    from coast_tpu.models import stencil as jstencil
    np.testing.assert_array_equal(
        stencil.run_distributed(n_devices=4, device="cpu"),
        jstencil.run_distributed(n_devices=4))
    for n_iters in (1, 3):
        np.testing.assert_array_equal(
            stencil.run_distributed(n_iters, n_devices=2, device="cpu"),
            stencil.golden_trajectory(n_iters))


def test_run_distributed_refuses_an_uneven_split():
    with pytest.raises(ValueError, match="columns"):
        stencil.run_distributed(n_devices=5, device="cpu")
    with pytest.raises(ValueError, match="columns"):
        stencil.run_distributed(mesh=Mesh(["cpu"] * 7))


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host; K1 and K2 run only on the "
                    "card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("placement", stencil.PLACEMENTS)
def test_two_shard_mesh_on_one_card(cuda, placement):
    """A two-shard mesh whose shards both sit on cuda:0: run_distributed
    equals the golden, and the sharded campaign equals the single-device
    one, dense and sparse, on the card (K1 and K2 launched)."""
    from coast_tpu_torch.ops import hopper_commit, hopper_voters
    mesh = Mesh([cuda, cuda])
    np.testing.assert_array_equal(stencil.run_distributed(mesh=mesh),
                                  stencil.golden_trajectory())
    prog = ct.TMR(stencil.make_region(placement), device=cuda,
                  fuse_step=True)
    hopper_voters.LAUNCHES = hopper_commit.LAUNCHES = 0
    base = CampaignRunner(prog).run(N, seed=SEED, batch_size=BATCH)
    assert hopper_voters.LAUNCHES > 0 and hopper_commit.LAUNCHES > 0
    for collect in ("dense", "sparse"):
        res = CampaignRunner(prog, mesh=mesh, collect=collect).run(
            N, seed=SEED, batch_size=BATCH)
        assert res.counts == base.counts
        rows = np.flatnonzero(base.codes > 1)
        codes = res.codes if collect == "sparse" else res.codes[rows]
        np.testing.assert_array_equal(codes, base.codes[rows])
