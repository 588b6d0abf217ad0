"""The port's spans and read counters inside the engine and the campaign
loop, on the profiler's clock (``obs/spans.py``, ``inject/campaign.py``,
``passes/dataflow_protection.py``, ``breakdown.py``).

A 9x9 matrixMultiply campaign under TMR with the fused engine runs dense,
sparse and under ``multibit(k=4)`` on the CPU: its top-level stages cover
the campaign's wall clock, its nested spans sit under their stages, and
its blocking device-to-host reads are counted one by one.  Every trip's
region step and commit group are spans of their own, on both engines and
on CHStone blowfish's 1,171 trips.  A span's time
maps onto ``torch.profiler``'s clock through the recorder's anchors, and
``breakdown.py`` lays spans over device intervals to bill idle time to
the innermost span.
"""

import json

import pytest
import torch

from coast_tpu_torch import TMR, breakdown, obs
from coast_tpu_torch.inject.campaign import SPANS, CampaignRunner
from coast_tpu_torch.inject.schedule import FaultModel, generate
from coast_tpu_torch.models import REGISTRY, mm
from coast_tpu_torch.obs import spans as tspans

torch.set_num_threads(1)

CASES = {"dense": ("dense", "single"), "sparse": ("sparse", "single"),
         "multibit4": ("sparse", "multibit(k=4)")}
# The engine's spans of every trip, nested in ``dispatch``.
TRIP = {"dispatch/step.region", "dispatch/engine.commit"}
NESTED = {
    "dense": {"dispatch/engine.upload", "dispatch/engine.fire_read",
              "dispatch/engine.halt_read", "collect/collect.wait", *TRIP},
    "sparse": {"sparse_setup/setup.columns", "sparse_setup/setup.weights",
               "sparse_setup/setup.upload", "dispatch/engine.fire_read",
               "dispatch/engine.halt_read",
               "dispatch/campaign.sparse_accounting", *TRIP,
               "collect/collect.wait", "collect/collect.unpack"},
}
NESTED["multibit4"] = NESTED["sparse"]


def mm9_campaign(case, rows=300, seed=3, telemetry=None):
    """A runner over the fused mm9 program and one resident schedule of
    ``rows`` draws (the device generator bypassed, as the benchmark's
    schedules are)."""
    collect, spec = CASES[case]
    prog = TMR(mm.make_region(), device="cpu", fuse_step=True)
    runner = CampaignRunner(prog, collect=collect, telemetry=telemetry,
                            fault_model=FaultModel.parse(spec))
    sched = generate(runner.mmap, rows, seed, prog.region.nominal_steps,
                     model=runner.fault_model)
    sched.gen_stream_n = None
    return runner, sched


@pytest.mark.parametrize("case", sorted(CASES))
def test_top_level_stages_cover_the_campaign(case):
    runner, sched = mm9_campaign(case)
    res = runner.run_schedule(sched, batch_size=64)
    top = tspans.top_stages(res.stages)
    assert "account" in top and "dispatch" in top
    covered = sum(top.values())
    assert covered <= res.seconds
    assert res.seconds - covered <= max(0.002, 0.02 * res.seconds)
    nested = {k for k in res.stages if "/" in k}
    assert nested == NESTED[case]
    for key in nested:
        assert 0 <= res.stages[key] <= res.stages[key.split("/")[0]]
    assert "account" in res.summary()["stages"]
    assert not any("/" in k for k in res.summary()["stages"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_reads_are_fire_reads_trips_and_collect_copies(case):
    runner, sched = mm9_campaign(case, rows=150)
    prog, trips = runner.prog, [0]
    step = prog.step

    def counting(*a):
        trips[0] += 1
        return step(*a)

    prog.step = counting
    res = runner.run_schedule(sched, batch_size=64)
    batches = 3
    # The fused mm9 loop is unbounded (max_steps 54 against 18 nominal):
    # one halt read a trip, one fire-plan copy a batch; the dense collect
    # copies once a batch, the sparse one its head and its rows.
    assert not prog._fuse_plan.bounded_scan
    collect_reads = batches * (1 if case == "dense" else 2)
    assert res.transfer["reads"] == batches + trips[0] + collect_reads
    assert prog.host_reads == batches + trips[0]
    assert trips[0] >= batches * prog.region.nominal_steps


def test_disabled_recorder_records_nothing_and_gives_the_same_codes():
    on_runner, sched = mm9_campaign("sparse", rows=200)
    on = on_runner.run_schedule(sched, batch_size=64)
    off_tel = obs.Telemetry(enabled=False)
    off_runner, _ = mm9_campaign("sparse", rows=200, telemetry=off_tel)
    off = off_runner.run_schedule(sched, batch_size=64)
    assert off_tel.events == [] and off.stages == {}
    assert off.counts == on.counts
    assert off.interesting_rows.tolist() == on.interesting_rows.tolist()
    for k in ("codes", "errors", "corrected", "steps"):
        assert getattr(off, k).tolist() == getattr(on, k).tolist()
    # Reads are counted whether or not a recorder runs.
    assert off.transfer == on.transfer


def test_every_campaign_reads_a_clock_anchor():
    tel = obs.Telemetry(enabled=True)
    runner, sched = mm9_campaign("dense", rows=64, telemetry=tel)
    runner.run_schedule(sched, batch_size=64)
    runner.run_schedule(sched, batch_size=64)
    marks = [e for e in tel.events if e.get("name") == "clock_anchor"]
    assert len(marks) == len(tel.anchors) == 3
    assert [tuple(e["args"].values()) for e in marks] == tel.anchors
    # A time maps through the newest anchor at or before it.
    (p0, u0), (p1, u1) = tel.anchors[:2]
    assert tel.to_profiler_ns(p1 / 1e9) == u1
    assert tel.to_profiler_ns((p1 - 1000) / 1e9) == p1 - 1000 - p0 + u0
    assert tel.to_profiler_ns((p0 - 1000) / 1e9) == u0 - 1000


def test_span_maps_onto_the_profilers_clock():
    """A span's start, mapped through ``to_profiler_ns``, lies within 1 ms
    of the start kineto stamps on its ``record_function`` bracket."""
    tel = obs.Telemetry(enabled=True, profiler=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with tel.span("warm_bracket"):
            pass
        tel.anchor()
        with tel.span("mapped_stage"):
            torch.ones(64).sum()
    kineto = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "mapped_stage"]
    span = next(e for e in tel.events if e.get("name") == "mapped_stage")
    assert len(kineto) == 1
    start = kineto[0].start_ns()
    assert abs(tel.to_profiler_ns(span["t0"]) - start) < 1_000_000
    end = start + kineto[0].duration_ns()
    assert abs(tel.to_profiler_ns(span["t1"]) - end) < 1_000_000


def test_trace_export_carries_the_anchors(tmp_path):
    tel = obs.Telemetry(enabled=True)
    runner, sched = mm9_campaign("dense", rows=64, telemetry=tel)
    runner.run_schedule(sched, batch_size=64)
    doc = json.loads(open(obs.write_trace(tel, str(tmp_path / "t.json")))
                     .read())
    assert doc["otherData"]["clock_anchors"] == [list(a)
                                                 for a in tel.anchors]
    # t=0 of the trace is the recorder's origin on the profiler's clock.
    assert doc["baseTimeNanoseconds"] == tel.to_profiler_ns(tel.origin)
    dispatch = next(e for e in doc["traceEvents"]
                    if e.get("name") == "dispatch")
    span = next(e for e in tel.events if e.get("name") == "dispatch")
    unix = doc["baseTimeNanoseconds"] + dispatch["ts"] * 1e3
    assert abs(unix - tel.to_profiler_ns(span["t0"])) < 2_000


def test_sparse_layer_spans_nest_in_their_stages():
    tel = obs.Telemetry(enabled=True)
    runner, sched = mm9_campaign("multibit4", rows=150, telemetry=tel)
    res = runner.run_schedule(sched, batch_size=64)
    assert SPANS[1] == "campaign.sparse_accounting"
    names = [e["name"] for e in tel.events if e["kind"] == "span"]
    assert names.count(SPANS[1]) == names.count("dispatch") == 3
    assert f"dispatch/{SPANS[1]}" in res.stages


def _trip_campaign(program, telemetry=None):
    """A dense campaign of ``program`` (``"mm9-fused"``, ``"mm9-unfused"``
    or ``"blowfish"``, CHStone blowfish under fused TMR at 8 rows: all
    1,171 trips of its key schedule and CFB64 run on the CPU)."""
    if program == "blowfish":
        prog = TMR(REGISTRY["chstone_blowfish"](), device="cpu",
                   fuse_step=True)
        rows, batch = 8, 8
    else:
        prog = TMR(mm.make_region(), device="cpu",
                   fuse_step=program == "mm9-fused")
        rows, batch = 150, 64
    runner = CampaignRunner(prog, collect="dense", telemetry=telemetry)
    sched = generate(runner.mmap, rows, 7, prog.region.nominal_steps,
                     model=runner.fault_model)
    sched.gen_stream_n = None
    return runner.run_schedule(sched, batch_size=batch)


@pytest.mark.parametrize("program", ["mm9-fused", "mm9-unfused",
                                     "blowfish"])
def test_region_step_and_commit_spans_nest_in_dispatch(program):
    """``step.region`` and ``engine.commit`` time every trip's region step
    and commit group on both engines, inside ``dispatch``; switched off,
    the campaign's records are bit-identical."""
    on = _trip_campaign(program)
    assert TRIP <= set(on.stages)
    inner = [on.stages[k] for k in sorted(TRIP)]
    for seconds in inner:
        assert 0 < seconds <= on.stages["dispatch"]
    assert sum(inner) < on.stages["dispatch"]
    off = _trip_campaign(program, telemetry=obs.Telemetry(enabled=False))
    assert off.stages == {} and off.counts == on.counts
    for k in ("codes", "errors", "corrected", "steps"):
        assert getattr(off, k).tolist() == getattr(on, k).tolist()


def test_breakdown_bills_idle_time_to_the_innermost_span():
    spans = [("dispatch", 0, 100), ("dispatch/engine.halt_read", 10, 20),
             ("dispatch/engine.halt_read", 30, 40), ("account", 120, 150)]
    segs = breakdown.innermost_segments(spans)
    assert segs == [(0, 10, "dispatch"),
                    (10, 20, "dispatch/engine.halt_read"),
                    (20, 30, "dispatch"),
                    (30, 40, "dispatch/engine.halt_read"),
                    (40, 100, "dispatch"), (120, 150, "account")]
    busy = breakdown.union([(5, 15), (12, 18), (35, 90), (140, 170)])
    assert busy == [(5, 18), (35, 90), (140, 170)]
    idle = breakdown.idle_by_span(busy, (0, 160), spans)
    want = {"dispatch": 25e-9,                    # 0-5, 20-30, 90-100
            "dispatch/engine.halt_read": 7e-9,    # 18-20, 30-35
            "account": 20e-9,                     # 120-140
            breakdown.NO_SPAN: 20e-9}             # 100-120
    assert set(idle) == set(want)
    for k, v in want.items():
        assert abs(idle[k] - v) < 1e-15, k
    assert abs(sum(idle.values()) - 72e-9) < 1e-15


def test_breakdown_reads_the_recorders_spans_on_the_profilers_clock():
    tel = obs.Telemetry(enabled=True)
    runner, sched = mm9_campaign("dense", rows=64, telemetry=tel)
    mark = tel.mark()
    runner.run_schedule(sched, batch_size=64)
    got = breakdown.span_intervals(tel, mark)
    labels = [name for name, _, _ in got]
    assert "dispatch" in labels and "dispatch/engine.halt_read" in labels
    assert "account" in labels and "collect/collect.wait" in labels
    spans = {e["name"]: e for e in tel.events[mark:] if e["kind"] == "span"}
    a, b = next((a, b) for n, a, b in got if n == "classify")
    assert a == tel.to_profiler_ns(spans["classify"]["t0"])
    assert b == tel.to_profiler_ns(spans["classify"]["t1"])
    for name, a, b in got:
        assert b >= a, name


# What a campaign records, each with its reader: the stages
# (``CampaignResult.stages``, the summary, the benchmark's readers), the
# nested spans (the benchmark's readers, ``breakdown.py``), the clock
# anchors (``to_profiler_ns``, the trace export), ``pad_waste_rows``
# (docs/observability.md).  A retry is counted in ``res.resilience``, the
# journal and the flight recorder, not as a recorder counter.
AUDITED = {
    "span": {"memory_map", "schedule", "sparse_setup", "pad", "dispatch",
             "collect", "account", "classify", "setup.columns",
             "setup.weights", "setup.upload", "engine.upload",
             "engine.fire_read", "engine.halt_read", "step.region",
             "engine.commit", "collect.wait", "collect.unpack",
             "campaign.device_generator",
             "campaign.sparse_accounting"},
    "counter": {"pad_waste_rows"},
    "instant": {"clock_anchor"},
}


class _Transient(Exception):
    pass


@pytest.mark.parametrize("collect", ["dense", "sparse"])
def test_campaign_records_only_what_is_read(collect):
    from coast_tpu_torch.inject.resilience import RetryPolicy
    tel = obs.Telemetry(enabled=True)
    prog = TMR(mm.make_region(), device="cpu", fuse_step=True)
    runner = CampaignRunner(prog, collect=collect, telemetry=tel,
                            retry=RetryPolicy(
                                base_delay=0.0, jitter=0.0,
                                transient_types=(_Transient,)))
    calls = {"n": 0}
    fetch = (runner._sparse_fetch if collect == "sparse"
             else runner._collect)

    def flaky(*a):
        calls["n"] += 1
        if calls["n"] == 2:
            raise _Transient("injected")
        return fetch(*a)

    setattr(runner, "_sparse_fetch" if collect == "sparse" else "_collect",
            flaky)
    res = runner.run(150, seed=4, batch_size=64)
    assert res.resilience["retry_transient"] == 1
    recorded = {}
    for e in tel.events:
        recorded.setdefault(e["kind"], set()).add(e["name"])
    assert set(recorded) <= set(AUDITED)
    for kind, names in recorded.items():
        assert names <= AUDITED[kind], kind
    assert tel.counters == {"pad_waste_rows": 42}
