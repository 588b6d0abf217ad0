"""The port's sharded campaign runner against the reference's.

``coast_tpu_torch.parallel.mesh.ShardedCampaignRunner`` over 8 logical CPU
shards against ``coast_tpu.parallel.mesh.ShardedCampaignRunner`` over the
8 virtual CPU devices of ``tests/conftest.py``, on the same schedules:
codes, counts and the ``mesh`` summary block equal, dense and sparse (the
generated and the resident sparse modes, and the overflow fallback), on a
(4, 2) mesh, with a ragged batch, through ``run_histogram``, on an empty
schedule, on nestedCalls' function-scope wrappers, through
``run_until_errors``, and across a journal cut by one package and resumed
by the other.  Also: ``CampaignRunner(mesh=)`` promotes to the sharded
runner, the mesh and batch rounding rules, and an out-of-memory degrade
that keeps the batch a multiple of the shard count.
"""

import json

import numpy as np
import pytest
import torch

import coast_tpu_torch as ct
from coast_tpu_torch.inject.campaign import CampaignRunner
from coast_tpu_torch.inject.mem import MemoryMap
from coast_tpu_torch.inject.schedule import FaultModel, generate_stratified
from coast_tpu_torch.models import REGISTRY
from coast_tpu_torch.parallel.mesh import (Mesh, ShardedCampaignRunner,
                                           make_mesh)

torch.set_num_threads(1)

COLUMNS = ("codes", "errors", "corrected", "steps")


def jmesh(*args):
    from coast_tpu.parallel.mesh import make_mesh as jmake_mesh
    return jmake_mesh(*args)


def jsharded(jprog, mesh, **kw):
    from coast_tpu.parallel.mesh import ShardedCampaignRunner as JSharded
    return JSharded(jprog, mesh, **kw)


def jprogram(name="matrixMultiply", strategy="TMR", **cfg):
    import coast_tpu
    from coast_tpu.models import REGISTRY as JREGISTRY
    return getattr(coast_tpu, strategy)(JREGISTRY[name](), **cfg)


def tprogram(name="matrixMultiply", strategy="TMR", **cfg):
    return getattr(ct, strategy)(REGISTRY[name](), device="cpu", **cfg)


def assert_same(got, want):
    for col in COLUMNS:
        np.testing.assert_array_equal(getattr(got, col), getattr(want, col),
                                      err_msg=col)
    assert got.counts == want.counts
    if want.interesting_rows is not None:
        np.testing.assert_array_equal(got.interesting_rows,
                                      want.interesting_rows)
    assert got.summary()["mesh"] == want.summary()["mesh"]


def test_mesh_geometry():
    mesh = make_mesh(8, device="cpu")
    assert mesh.size == 8 and mesh.shape == (8,)
    assert mesh.shard_devices() == [torch.device("cpu")] * 8
    grid = make_mesh(8, axis_names=("host", "chip"), shape=(4, 2),
                     device="cpu")
    assert grid.shape == (4, 2) and grid.axis_names == ("host", "chip")
    assert make_mesh(device="cpu").size == 1
    with pytest.raises(ValueError, match="shape"):
        make_mesh(3, shape=(2, 2), device="cpu")
    with pytest.raises(ValueError, match="axis names"):
        Mesh(["cpu", "cpu"], ("host", "chip"))
    with pytest.raises(ValueError, match="one type"):
        Mesh(["cpu", "cuda:0"])
    split = Mesh(["cpu"] * 8, process_count=2, process_index=1)
    assert [s for s, _ in split.local_shards()] == [4, 5, 6, 7]
    with pytest.raises(ValueError, match="processes"):
        Mesh(["cpu"] * 3, process_count=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            make_mesh(1)


@pytest.mark.parametrize("collect", ("dense", "sparse"))
@pytest.mark.parametrize("geometry", ("8", "4x2"))
def test_sharded_equals_the_reference(geometry, collect):
    args = (8,) if geometry == "8" else (8, ("host", "chip"), (4, 2))
    got = CampaignRunner(tprogram(), mesh=make_mesh(*args, device="cpu"),
                         strategy_name="TMR", collect=collect).run(
        240, seed=4, batch_size=240)
    want = jsharded(jprogram(), jmesh(*args), strategy_name="TMR",
                    collect=collect).run(240, seed=4, batch_size=240)
    assert_same(got, want)
    assert sum(got.counts.values()) == 240


def test_sharded_equals_single_device():
    prog = tprogram()
    single = CampaignRunner(prog).run(256, seed=9, batch_size=256)
    sharded = ShardedCampaignRunner(prog, make_mesh(8, device="cpu")).run(
        256, seed=9, batch_size=256)
    for col in COLUMNS:
        np.testing.assert_array_equal(getattr(sharded, col),
                                      getattr(single, col))
    assert sharded.counts == single.counts
    assert "mesh" not in single.summary()


@pytest.mark.parametrize("batch", (64, 3))
def test_ragged_batch_equals_the_reference(batch):
    """A batch that is not a multiple of the shard count floors to one
    (one row a shard at least): 64 stays, 3 becomes 8."""
    runner = ShardedCampaignRunner(tprogram(), make_mesh(8, device="cpu"))
    jrunner = jsharded(jprogram(), jmesh(8))
    assert runner._round_batch(batch) == jrunner._round_batch(batch)
    assert runner._round_batch(100) == 96
    got = runner.run(100, seed=5, batch_size=batch)
    assert_same(got, jrunner.run(100, seed=5, batch_size=batch))
    assert got.n == 100 and sum(got.counts.values()) == 100


@pytest.mark.parametrize("spec", ("single", "multibit(k=3)"))
def test_run_histogram_equals_records_and_reference(spec):
    from coast_tpu.inject.schedule import FaultModel as JFaultModel
    runner = ShardedCampaignRunner(tprogram(), make_mesh(8, device="cpu"),
                                   fault_model=FaultModel.parse(spec))
    hist = runner.run_histogram(100, seed=6, batch_size=64)
    assert hist == runner.run(100, seed=6, batch_size=64).counts
    assert hist == jsharded(jprogram(), jmesh(8),
                            fault_model=JFaultModel.parse(spec)
                            ).run_histogram(100, seed=6, batch_size=64)


def test_empty_schedule():
    runner = ShardedCampaignRunner(tprogram(), make_mesh(8, device="cpu"))
    res = runner.run(0, seed=1)
    assert res.n == 0 and sum(res.counts.values()) == 0
    assert res.summary()["mesh"]["per_shard_interesting"] == [0] * 8
    assert runner.run_histogram(0, seed=1) == jsharded(
        jprogram(), jmesh(8)).run_histogram(0, seed=1)


def test_function_scope_region_equals_the_reference():
    """nestedCalls' cross-lane call-boundary wrappers under the shard
    split: the records equal the reference's sharded and the port's
    single-device runner's."""
    cfg = {"ignore_fns": ("fold",), "protected_lib_fns": ("mix",)}
    prog = tprogram("nestedCalls", **cfg)
    got = ShardedCampaignRunner(prog, make_mesh(4, device="cpu"),
                                strategy_name="TMR").run(32, seed=3,
                                                         batch_size=32)
    want = jsharded(jprogram("nestedCalls", **cfg), jmesh(4),
                    strategy_name="TMR").run(32, seed=3, batch_size=32)
    assert_same(got, want)
    base = CampaignRunner(prog, strategy_name="TMR").run(32, seed=3,
                                                         batch_size=32)
    assert got.counts == base.counts


@pytest.mark.parametrize("case", ("gen", "resident", "overflow",
                                  "dwc_fused_cluster"))
def test_sparse_modes_equal_the_reference(case):
    """The generated sparse mode (a seeded stream), the resident one (a
    stratified schedule, uploaded once and sliced per shard), the dense
    fallback of a shard whose rows overflow its buffer, and a fused DWC
    flip-group campaign."""
    from coast_tpu.inject.mem import MemoryMap as JMemoryMap
    from coast_tpu.inject.schedule import FaultModel as JFaultModel
    from coast_tpu.inject.schedule import \
        generate_stratified as jgenerate_stratified
    strategy, cfg, spec = "TMR", {}, "single"
    if case == "dwc_fused_cluster":
        strategy, cfg, spec = "DWC", {"fuse_step": True}, "cluster(span=4,k=3)"
    prog, jprog = tprogram("crc16", strategy, **cfg), \
        jprogram("crc16", strategy, **cfg)
    kw = {"sparse_capacity": 1} if case == "overflow" else {}
    runner = ShardedCampaignRunner(prog, make_mesh(8, device="cpu"),
                                   collect="sparse",
                                   fault_model=FaultModel.parse(spec), **kw)
    jrunner = jsharded(jprog, jmesh(8), collect="sparse",
                       fault_model=JFaultModel.parse(spec), **kw)
    if case == "resident":
        sched = generate_stratified(MemoryMap(prog), 10, 2,
                                    prog.region.nominal_steps)
        jsched = jgenerate_stratified(JMemoryMap(jprog), 10, 2,
                                      jprog.region.nominal_steps)
        got = runner.run_schedule(sched, batch_size=16)
        want = jrunner.run_schedule(jsched, batch_size=16)
    else:
        got = runner.run(200, seed=8, batch_size=64)
        want = jrunner.run(200, seed=8, batch_size=64)
    assert got.collect == "sparse"
    assert_same(got, want)
    dense = CampaignRunner(prog, fault_model=FaultModel.parse(spec))
    if case == "resident":
        dense = dense.run_schedule(sched, batch_size=16)
    else:
        dense = dense.run(200, seed=8, batch_size=64)
    assert dense.counts == got.counts


def test_run_until_errors_equals_the_reference():
    got = ShardedCampaignRunner(tprogram(), make_mesh(2, device="cpu"),
                                strategy_name="TMR").run_until_errors(
        3, seed=4, batch_size=100, round_to=300)
    want = jsharded(jprogram(), jmesh(2), strategy_name="TMR"
                    ).run_until_errors(3, seed=4, batch_size=100,
                                       round_to=300)
    for col in COLUMNS:
        np.testing.assert_array_equal(getattr(got, col), getattr(want, col))
    assert got.counts == want.counts and got.chunks == want.chunks
    assert ("mesh" in got.summary()) == ("mesh" in want.summary())


def test_campaign_runner_promotes_to_the_sharded_backend():
    prog = tprogram()
    mesh = make_mesh(2, device="cpu")
    runner = CampaignRunner(prog, mesh=mesh, strategy_name="TMR")
    assert type(runner) is ShardedCampaignRunner and runner.mesh is mesh
    assert type(CampaignRunner(prog)) is CampaignRunner
    with pytest.raises(TypeError, match="Mesh"):
        CampaignRunner(prog, mesh="2")
    with pytest.raises(ValueError, match="device"):
        ShardedCampaignRunner(prog, Mesh([torch.device("cuda", 0)]))
    # A mesh spanning processes runs counts only.
    split = Mesh(["cpu"] * 4, process_count=2, process_index=0)
    with pytest.raises(ValueError, match="run_histogram"):
        ShardedCampaignRunner(prog, split).run(16, seed=1)


@pytest.mark.parametrize("writer", ("port", "reference"))
@pytest.mark.parametrize("collect", ("dense", "sparse"))
def test_journal_across_packages(writer, collect, tmp_path):
    """A sharded journal cut after two batches by a kill, resumed by the
    other package's sharded runner: the uninterrupted records, and a mesh
    ledger of the batches the resuming process ran."""
    path = str(tmp_path / "j.ndjson")
    port = ShardedCampaignRunner(tprogram(), make_mesh(8, device="cpu"),
                                 strategy_name="TMR", collect=collect)
    ref = jsharded(jprogram(), jmesh(8), strategy_name="TMR",
                   collect=collect)
    first, second = (port, ref) if writer == "port" else (ref, port)
    full = first.run(320, seed=2, batch_size=64, journal=path)
    with open(path) as f:
        lines = f.readlines()
    header = json.loads(lines[0])
    assert "mesh" not in header and header["batch_size"] == 64
    with open(path, "w") as f:
        f.writelines(lines[:3])
    res = second.run(320, seed=2, batch_size=64, journal=path)
    for col in COLUMNS:
        np.testing.assert_array_equal(getattr(res, col), getattr(full, col))
    assert res.counts == full.counts
    ledger = res.summary()["mesh"]["per_shard_interesting"]
    assert sum(ledger) <= sum(full.summary()["mesh"]["per_shard_interesting"])


@pytest.mark.parametrize("collect", ("dense", "sparse"))
def test_oom_degrades_to_a_multiple_of_the_shards(collect, tmp_path):
    """A batch above 30 rows runs out of memory: the batch (100, rounded
    to 96 for the 8 shards) halves to 48 and 24, each a multiple of the
    shard count; the runner journals the geometry and completes with the
    undegraded records."""
    from coast_tpu_torch.inject.resilience import RetryPolicy
    mesh = make_mesh(8, device="cpu")
    base = ShardedCampaignRunner(tprogram(), mesh).run(200, seed=9,
                                                       batch_size=96)
    runner = ShardedCampaignRunner(
        tprogram(), mesh, collect=collect,
        retry=RetryPolicy(base_delay=0.0, jitter=0.0))
    if collect == "dense":
        orig = runner._dispatch

        def oom_above_30(fault):
            if len(fault["bit"]) > 30:
                raise torch.OutOfMemoryError("CUDA out of memory.")
            return orig(fault)
        runner._dispatch = oom_above_30
    else:
        orig = runner._sparse_dispatch

        def oom_above_30(state, *args):
            if state["batch_size"] > 30:
                raise torch.OutOfMemoryError("CUDA out of memory.")
            return orig(state, *args)
        runner._sparse_dispatch = oom_above_30
    path = str(tmp_path / "oom.ndjson")
    res = runner.run(200, seed=9, batch_size=100, journal=path)
    assert res.counts == base.counts
    rows = np.flatnonzero(base.codes > 1)
    codes = res.codes if collect == "sparse" else res.codes[rows]
    np.testing.assert_array_equal(codes, base.codes[rows])
    assert res.resilience["oom_degrade"] == 2
    with open(path) as f:
        geoms = [json.loads(ln) for ln in f]
    assert [(g["batch_size"], g["lo"]) for g in geoms
            if g.get("kind") == "geometry"] == [(48, 0), (24, 0)]
    assert sum(res.summary()["mesh"]["per_shard_interesting"]) == len(rows)
