"""The port's campaign profiler and roofline (``coast_tpu_torch/obs/
profiler.py``, ``obs/roofline.py``, ``obs/profile_cli.py``) against the
reference's.

The profile block and the ``mfu`` block carry the reference's keys; the
attribution identity ``wall = device_busy + host_gap + host_other`` holds;
records and counts are the same with the profiler on and off, dense and
sparse; the trace's device track holds one ``device:step`` span a
dispatch.  The op counts are held against the live reference: the
reference's counter reads ``jax.core.Jaxpr``, which jax 0.9 removed, so
these tests set that one attribute to ``jax.extend.core.Jaxpr`` for their
duration (nothing under ``coast_tpu/`` changes).  The counts are equal
where the two steps' operations correspond; every other model is pinned
with the port's count and the reason (``PINNED_*``).  ``mfu_block`` gives
the reference's numbers from the same inputs.  One ``cuda`` test holds the
ready event of a profiled campaign on the card.
"""

import json

import numpy as np
import pytest
import torch

from coast_tpu_torch import TMR, DWC, obs
from coast_tpu_torch.inject.campaign import CampaignRunner
from coast_tpu_torch.models import REGISTRY, mm
from coast_tpu_torch.obs import roofline
from coast_tpu_torch.obs.profiler import CampaignProfiler

torch.set_num_threads(1)

COLUMNS = ("codes", "errors", "corrected", "steps")


@pytest.fixture
def jaxpr_attr(monkeypatch):
    """The reference's op counter reads ``jax.core.Jaxpr``."""
    import jax
    import jax.extend
    monkeypatch.setattr(jax.core, "Jaxpr", jax.extend.core.Jaxpr,
                        raising=False)


def identity_holds(prof, wall):
    assert prof["wall_s"] == round(wall, 6)
    assert abs(prof["wall_s"] - prof["device_busy_s"] - prof["host_gap_s"]
               - prof["host_other_s"]) <= 2e-6
    assert prof["host_other_s"] >= 0 and prof["device_busy_s"] > 0


@pytest.mark.parametrize("collect", ["dense", "sparse"])
def test_outputs_identical_with_the_profiler(collect):
    prog = TMR(mm.make_region(), device="cpu")
    off = CampaignRunner(prog, collect=collect).run(300, seed=5,
                                                    batch_size=64)
    runner = CampaignRunner(prog, collect=collect, profile=True)
    on = runner.run(300, seed=5, batch_size=64)
    for col in COLUMNS:
        np.testing.assert_array_equal(getattr(on, col), getattr(off, col))
    assert on.counts == off.counts and off.profile is None
    prof = on.summary()["profile"]
    identity_holds(prof, on.seconds)
    assert prof["dispatches"] == 5 and prof["rows"] == 300
    assert prof["backend"] == "cpu"
    # Exact before rounding: other is what busy and gap leave of the wall.
    p = runner.profiler
    assert p._busy_s + p._gap_s <= on.seconds


def test_profile_blocks_have_the_reference_keys(jaxpr_attr):
    from coast_tpu import TMR as JTMR
    from coast_tpu.inject.campaign import CampaignRunner as JRunner
    from coast_tpu.models import mm as jmm
    want = JRunner(JTMR(jmm.make_region()), profile=True).run(
        256, seed=2, batch_size=64).summary()
    got = CampaignRunner(TMR(mm.make_region(), device="cpu"),
                         profile=True).run(256, seed=2,
                                           batch_size=64).summary()
    assert list(got) == list(want)
    assert list(got["profile"]) == list(want["profile"])
    assert list(got["mfu"]) == list(want["mfu"])
    for key in ("dispatches", "rows", "backend"):
        assert got["profile"][key] == want["profile"][key], key
    for key in ("state_bytes", "lanes", "voter_bytes_per_run", "runs",
                "backend", "peak_gflops", "achieved_mfu"):
        assert got["mfu"][key] == want["mfu"][key], key
    assert got["profile"]["device_seconds_histogram"]["le"] \
        == want["profile"]["device_seconds_histogram"]["le"]


def test_trace_device_track_and_stage_totals():
    tel = obs.Telemetry(enabled=True)
    runner = CampaignRunner(TMR(mm.make_region(), device="cpu"),
                            telemetry=tel, profile=True)
    res = runner.run(256, seed=1, batch_size=64)
    events = obs.to_trace_events(tel)
    device = [e for e in events if e.get("cat") == "device"]
    assert [e["name"] for e in device] == ["device:step"] * 4
    assert {e["tid"] for e in device} == {2}
    assert "device:step" not in res.stages
    assert sum(e["dur"] for e in device) / 1e6 == pytest.approx(
        res.profile["device_busy_s"], abs=1e-5)


def test_hub_gets_the_dispatch_histograms():
    hub = obs.CampaignMetrics()
    CampaignRunner(TMR(mm.make_region(), device="cpu"), metrics=hub,
                   profile=True).run(192, seed=1, batch_size=64)
    snap = hub.snapshot()
    hists = snap["profile"]["histograms"]
    assert hists["dispatch_device_seconds"]["count"] == 3
    assert "coast_campaign_dispatch_device_seconds_bucket" \
        in hub.prometheus()


def test_merged_chunk_campaign_keeps_the_profile():
    runner = CampaignRunner(TMR(mm.make_region(), device="cpu"),
                            profile=True)
    res = runner.run_until_errors(3, seed=0, batch_size=250, round_to=500)
    prof = res.summary()["profile"]
    assert prof["rows"] == res.n and prof["dispatches"] == len(res.chunks)
    assert abs(prof["wall_s"] - prof["device_busy_s"] - prof["host_gap_s"]
               - prof["host_other_s"]) <= 1e-5
    assert res.summary()["mfu"]["runs"] == res.n


def test_train_phase_split_equals_the_reference():
    from coast_tpu.models import REGISTRY as JREG
    from coast_tpu.obs import roofline as jroofline
    for name in ("train_mlp", "matrixMultiply"):
        assert roofline.phase_split(REGISTRY[name]()) \
            == jroofline.phase_split(JREG[name]())


# Every registry name: the counts are held against the live reference.
MODELS = tuple(sorted(REGISTRY))

# Constructs of a step that the reference counts otherwise, by model (the
# useful count prices the port's indexing helpers, its uint32 emulation,
# ``torch.clamp`` and ``%`` by the reference's rules, obs/roofline.py).
_STRIDED = ("the reference's strided slices (x[0::2]) lower to gathers "
            "whose index arithmetic it counts, a mul and an add an element; "
            "the port's strided views count nothing")
_ARGMAX = ("the reference picks its case or task with argmax, one op an "
           "input element; the port selects with where")
_DF64 = ("the port's soft-float carries a 64-bit significand in one int64 "
         "word (models/chstone/df64.py) where the reference's carries two "
         "uint32 halves and counts the ops of each")
_TRAIN = ("the port's products and sums are elementwise in a fixed order "
          "(train/mlp._mm) where the reference's are dot_general and "
          "reduce_sum, and its loss clips with one-sided clamps")
_GATED = ("the reference gates its receive phase on the traced step count "
          "(t % 2, a select of every leaf); the port's step branches on t "
          "in Python and each trip runs one branch")
_TABLES = ("the port's table reads wrap their index once "
           "(indexing.lookup: lt, add, select) where the reference reads "
           "with jnp.take(mode='clip') or a static index")


def _spelled(delta: str) -> str:
    return ("the port's step spells the same function with other "
            f"operations (per trip, port minus reference: {delta})")


# model -> (the port's useful ops a run, why it differs).
PINNED_REGION = {
    "aes": (76472.0, _spelled("xor +368, and +64, ne +32, shift_left "
                              "+32, lt -32, add -32")),
    "cache_test": (110592.0, _spelled("its i // 1024 and i % 1024 floor "
                                      "division and modulo, and its "
                                      "drop-mode writes")),
    "chstone_adpcm": (104600.0, _spelled("mul -70, add -70, clips -8")),
    "chstone_blowfish": (3313930.0, _TABLES),
    "chstone_dfadd": (40256.0, _DF64),
    "chstone_dfdiv": (42560.0, _DF64),
    "chstone_dfmul": (28544.0, _DF64),
    "chstone_dfsin": (788400.0, _DF64),
    "chstone_gsm": (836664.0, _spelled("its saturating adds: add -16, "
                                       "clips -17")),
    "chstone_jpeg": (1213420.0, _spelled("argmax +32 and any +32 for "
                                         "its Huffman decode, select "
                                         "-219, add -189, lt -158")),
    "chstone_mips": (172913.0, _ARGMAX),
    "chstone_motion": (13760.0, _spelled("shift_right -8, select -4, "
                                         "and its % 2")),
    "chstone_sha": (387258.0, _spelled("its byte packing: select +13, "
                                       "and +1, and its floor division")),
    "quicksort": (10813520.0, _STRIDED),
    "rtos_app": (2544.0, _ARGMAX),
    "rtos_kUser": (13380.0, _ARGMAX),
    "rtos_mm": (10752.0, _ARGMAX),
    "schedule2": (156544.0, _spelled("clips -8, lt +3, select +3, "
                                     "add +2, eq -1")),
    "stencil": (6156.0, _GATED),
    "train_mlp": (197424.0, _TRAIN),
    "train_mlp_adam": (234432.0, _TRAIN),
}
_PROG = ("the reference counts prog.run's jaxpr: the while loop's body with "
         "its per-step dense fault-injection selects over every leaf and "
         "its cond, the init broadcast and the final check; the port's "
         "engine applies a fault with one scatter at its fire step, and the "
         "count is its widest captured trip x nominal_steps")
# model -> the port's TMR program ops a run (every one pinned by _PROG).
PINNED_PROGRAM = {
    "aes": 236038.0, "cache_test": 25614336.0, "chstone_adpcm": 526100.0,
    "chstone_blowfish": 31956590.0, "chstone_dfadd": 188800.0,
    "chstone_dfdiv": 195712.0, "chstone_dfmul": 153664.0,
    "chstone_dfsin": 2598120.0, "chstone_gsm": 3322597.0,
    "chstone_jpeg": 7907900.0, "chstone_mips": 1024036.0,
    "chstone_motion": 78592.0, "chstone_sha": 1190928.0, "crazyCF": 15840.0,
    "crc16": 1066.0, "helloWorld": 1836.0, "matrixMultiply": 27198.0,
    "matrixMultiply1024": 13042192144.0,
    "matrixMultiply1024b512": 12966693316.0,
    "matrixMultiply256": 211159312.0, "nestedCalls": 6840.0,
    "quicksort": 43295840.0, "rtos_app": 53376.0, "rtos_kUser": 140520.0,
    "rtos_mm": 107952.0, "scalarize": 20592.0, "schedule2": 680832.0,
    "sha256": 161251.0, "simd": 28800.0, "simpleTMR": 1472.0,
    "stencil": 32352.0, "towersOfHanoi": 423488.0, "train_mlp": 769356.0,
    "train_mlp_adam": 962676.0, "trivial": 31.0, "whetstone": 12416.0,
}


def held(got, want, pin):
    if pin is None:
        assert got == want
    else:
        assert got == pin[0] != want, pin[1]


@pytest.mark.parametrize("model", MODELS)
def test_region_ops_against_the_live_reference(model, jaxpr_attr):
    from coast_tpu.models import REGISTRY as JREG
    from coast_tpu.obs import roofline as jroofline
    held(roofline.region_ops_per_run(REGISTRY[model]()),
         jroofline.region_ops_per_run(JREG[model]()),
         PINNED_REGION.get(model))
    assert roofline.region_state_bytes(REGISTRY[model]()) \
        == jroofline.region_state_bytes(JREG[model]())


@pytest.mark.parametrize("model", MODELS)
def test_program_ops_against_the_live_reference(model, jaxpr_attr):
    import coast_tpu
    from coast_tpu.models import REGISTRY as JREG
    from coast_tpu.obs import roofline as jroofline
    prog = TMR(REGISTRY[model](), device="cpu")
    got = roofline.program_ops_per_run(prog)
    held(got, jroofline.program_ops_per_run(coast_tpu.TMR(JREG[model]())),
         (PINNED_PROGRAM[model], _PROG))
    useful = roofline.region_ops_per_run(prog.region)
    assert roofline.flops_overhead(prog) == got / useful


def test_count_rules():
    from coast_tpu_torch.analysis.lint.capture import capture_fn

    def step(s, t):
        a = s["a"]
        prod = a @ s["b"]                           # 2mnk
        # add 6; a two-sided clamp is the reference's jnp.clip: max, min
        return {"a": (prod + 1).clamp(0, 9),
                "b": s["b"].sum(dim=0, keepdim=True).expand(3, 3)
                + s["b"].transpose(0, 1)}           # reduce 9, add 9
    state = {"a": torch.ones(2, 3), "b": torch.ones(3, 3)}
    trip = capture_fn(step, state)
    assert roofline.count_graph_ops(trip) == 2 * 3 * 6 + 6 + 12 + 9 + 9
    assert roofline.count_graph_ops([trip, trip], while_trip=4) \
        == 4 * roofline.count_graph_ops(trip)


def test_reference_rules_for_the_port_spellings():
    """The uint32 emulation, the indexing helpers and ``%`` count what the
    reference's primitives count."""
    from coast_tpu_torch.analysis.lint.capture import capture_fn
    from coast_tpu_torch.ops import indexing, u32

    def step(s, t):
        w = s["w"]
        wide = w.to(torch.int64) & 0xFFFFFFFF       # emulation: 0
        return {"w": u32.word(wide * 3),            # mul 4, word 0
                "s": u32.lsr(w, 3),                 # one shift a word: 4
                "r": indexing.row_select(s["m"], s["i"]),   # the wrap: 3
                "t": indexing.take_clip(s["m"], s["i"]),    # clip: 0
                "q": wide % 7,                      # jnp.remainder: 7x4+3
                "c": s["i"].clamp(min=0)}           # one-sided: 1
    state = {"w": torch.ones(1, 4, dtype=torch.int32),
             "m": torch.ones(1, 5, 2, dtype=torch.int32),
             "i": torch.tensor([7], dtype=torch.int32)}
    trip = capture_fn(step, state)
    assert roofline.count_graph_ops(trip) == 4 + 4 + 3 + 0 + 31 + 1
    assert {n.price for n in trip.nodes} == {None, 0.0, 1.0}


def test_roofline_cli_by_operator(capsys):
    assert roofline.main(["matrixMultiply"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert (doc["useful_ops_per_run"], doc["program_ops_per_run"]) \
        == (4716.0, PINNED_PROGRAM["matrixMultiply"])
    assert doc["first_trip_ops"] == {
        "aten.add.Tensor": 3.0, "aten.eq.Scalar": 1.0, "aten.lt.Scalar": 2.0,
        "aten.mul.Tensor": 81.0, "aten.sum.dim_IntList": 81.0,
        "aten.where.self": 94.0}


def test_fused_program_counts_the_commits_element_for_element():
    region = mm.make_region()
    for make in (TMR, DWC):
        fused = roofline.program_ops_per_run(make(region, device="cpu",
                                                  fuse_step=True))
        unfused = roofline.program_ops_per_run(make(region, device="cpu"))
        useful = roofline.region_ops_per_run(region)
        # Every lane's step plus the votes: at least lanes x useful.
        assert fused >= make(region, device="cpu").cfg.num_clones * useful
        assert abs(fused - unfused) / unfused < 0.01


def test_mfu_block_equals_the_reference_from_the_same_inputs(jaxpr_attr):
    import coast_tpu
    from coast_tpu.models import mm as jmm
    from coast_tpu.obs import roofline as jroofline
    ops = {"useful": 4716.0, "program": 95613.0}
    kw = dict(runs=4096, device_busy_s=0.5, wall_s=0.625,
              dispatch_gap_fraction=0.125, peak_gflops=1000.0,
              hbm_gbps=3350.0, ops=ops)
    got = roofline.mfu_block(TMR(mm.make_region(), device="cpu"), **kw)
    want = jroofline.mfu_block(coast_tpu.TMR(jmm.make_region()), **kw)
    assert got == want
    assert got["backend"] == "cpu" and got["peak_source"] == "explicit"


def test_resolve_peak_names_the_card(monkeypatch):
    monkeypatch.delenv("COAST_PEAK_GFLOPS", raising=False)
    peak, source = roofline.resolve_peak("NVIDIA H100 80GB HBM3")
    assert peak == 989.4e12 and source.startswith("NVIDIA H100 80GB HBM3")
    assert roofline.resolve_peak("cpu") == (None, "unknown device 'cpu'")
    assert roofline.resolve_peak("NVIDIA A100-SXM4-80GB")[0] is None
    assert roofline.resolve_peak("cpu", peak_gflops=5.0) == (5e9, "explicit")
    monkeypatch.setenv("COAST_PEAK_GFLOPS", "7")
    assert roofline.resolve_peak("cpu") == (7e9, "env:COAST_PEAK_GFLOPS")
    assert roofline.DEFAULT_HBM_GBPS == 3350.0


def test_profiler_lifecycle_and_retry_rebinding():
    prof = CampaignProfiler()
    assert prof.phases == [("step", 1.0)]
    prof.begin(0.0)
    prof.dispatched(0, 64, 1.0, 1.5)
    prof.dispatched(0, 64, 2.0, 2.5)     # a re-dispatch replaces the record
    prof.ready(0, 64, 3.0)
    prof.ready(64, 64, 3.5)              # no dispatch record: skipped
    out = prof.finish(4.0, wall_s=4.0)
    assert (out["device_busy_s"], out["host_gap_s"], out["host_other_s"]) \
        == (1.0, 0.0, 3.0)
    assert out["dispatches"] == 1 and "mfu" not in out


def test_profile_cli_artifact_layout(tmp_path, jaxpr_attr, monkeypatch):
    from coast_tpu.obs import profile_cli as jcli
    from coast_tpu_torch.obs import profile_cli
    argv = ["--target", "matrixMultiply|-TMR", "-t", "256",
            "--batch-size", "64"]
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert jcli.main([*argv, "--out", str(tmp_path / "j.json")]) == 0
    assert profile_cli.main([*argv, "-d", "cpu", "--out",
                             str(tmp_path / "t.json"), "--trace-out",
                             str(tmp_path / "trace.json")]) == 0
    want = json.loads((tmp_path / "j.json").read_text())
    got = json.loads((tmp_path / "t.json").read_text())
    assert sorted(got) == sorted(want)
    assert got["backend"] == want["backend"] == "cpu"
    tid = "matrixMultiply|-TMR"
    assert sorted(got["targets"][tid]) == sorted(want["targets"][tid])
    assert got["targets"][tid]["counts"] == want["targets"][tid]["counts"]
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any(e.get("cat") == "device" for e in trace["traceEvents"])


def test_supervisor_profile_flag(capsys):
    from coast_tpu_torch.inject import supervisor
    assert supervisor.main(["-f", "matrixMultiply", "-O", "-TMR", "-t",
                            "200", "--batch-size", "100", "-d", "cpu",
                            "-q", "--profile"]) == 0
    out = capsys.readouterr().out
    assert "'profile': {'dispatches': 2" in out and "'mfu': {" in out


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a card")
def test_ready_event_on_the_card():
    """On the card the marker is a CUDA event recorded after the batch's
    last launch: the busy window covers the batch's device work."""
    prog = TMR(REGISTRY["matrixMultiply1024"]())
    runner = CampaignRunner(prog, profile=True)
    off = CampaignRunner(prog).run(256, seed=1, batch_size=128)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as tp:
        res = runner.run(256, seed=1, batch_size=128)
        torch.cuda.synchronize()
    kernel_s = sum(e.self_device_time_total for e in tp.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    prof = res.summary()["profile"]
    identity_holds(prof, res.seconds)
    assert prof["backend"] == "gpu" and prof["device_busy_s"] >= kernel_s
    np.testing.assert_array_equal(res.codes, off.codes)
