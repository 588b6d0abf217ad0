"""One run of one cell: set-up, the measured window, the check, the line.

Everything a cell needs is found by name: its entry in ``BENCHMARK.json``
names a configuration (``configs[].file``) and a traffic mix
(``perfbench/traffic/<traffic>.json``); every metric is a reader
``perfbench/metrics/<metric>.py``; the configuration names its plain
reference, ``perfbench/reference/<module>.py``.

The window is a closed loop with one client: campaigns of the traffic's
``campaign_n`` injections, back to back, each one ``CampaignRunner.
run_schedule`` call of the program, until ``--seconds`` have passed; the
last campaign runs to its end.  Once it has closed, the program is freed
and the reference re-executes one campaign of the window, drawn from the
seed, row by row: every record the program returned for it and its class
counts must equal the reference's.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from perfbench import roofline, trace as trace_mod, traffic as traffic_mod
from perfbench.reference import engine

FORBIDDEN = ("jax", "jaxlib", "flax", "coast_tpu")
# Every number the check compares is exact: its limit is 0.
LIMITS = {"rows_differ": 0, "count_diff": 0}


class CellError(Exception):
    """The cell cannot be run as defined."""


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict
    traffic: traffic_mod.Traffic
    chips: int
    end_to_end: List[str]
    per_layer: List[str]
    units: Dict[str, str]


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(bench_path: Path, name: str,
              overrides: Optional[Dict] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    traffic and metric names; ``overrides`` replaces traffic fields (the
    CPU tests' small sizes)."""
    with open(bench_path) as f:
        bench = json.load(f)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise CellError(f"no workload {name!r} in {bench_path}")
    cfg_entry = next(c for c in bench["configs"]
                     if c["name"] == entry["config"])
    with open(bench_path.parent / cfg_entry["file"]) as f:
        config = json.load(f)
    traffic = traffic_mod.load(bench_path.parent / "perfbench",
                               entry["traffic"])
    if overrides:
        traffic = dataclasses.replace(traffic, **overrides)
    return Cell(name=name, config=config, traffic=traffic,
                chips=int(entry["chips"]),
                end_to_end=[m["name"] for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m["name"] for m in bench["per_layer"]
                           if _applies(m, name)],
                units={m["name"]: m["unit"]
                       for m in bench["end_to_end"] + bench["per_layer"]})


def _load_file(path: Path, label: str):
    spec = importlib.util.spec_from_file_location(label, path)
    if spec is None or not path.exists():
        raise CellError(f"missing {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(root: Path, metric: str):
    """``perfbench/metrics/<metric>.py``'s ``read(ctx)``, under the
    checkout ``root``."""
    return _load_file(root / "perfbench" / "metrics" / f"{metric}.py",
                      f"perfbench_metric_{metric.replace('.', '_')}").read


def reference_region(config: Dict, precision: str = "stated"
                     ) -> engine.Region:
    """The configuration's plain reference program."""
    ref = dict(config["reference"])
    module = importlib.import_module(f"perfbench.reference.{ref.pop('module')}")
    return module.make(precision=precision, **ref)


# -- the program under test --------------------------------------------------
def build_program(config: Dict, traffic: traffic_mod.Traffic, device):
    from coast_tpu_torch.inject.campaign import CampaignRunner
    from coast_tpu_torch.inject.schedule import FaultModel
    from coast_tpu_torch.models import REGISTRY
    from coast_tpu_torch.passes import strategies

    strategy = getattr(strategies, config["strategy"])
    prog = strategy(REGISTRY[config["registry"]](), device=device,
                    fuse_step=bool(config["fuse_step"]))
    model = (FaultModel.multibit(traffic.k) if traffic.kind == "multibit"
             else FaultModel.single())
    runner = CampaignRunner(prog, strategy_name=config["strategy"],
                            fault_model=model, collect=traffic.collect)
    return prog, runner


def to_schedule(cols: Dict[str, np.ndarray], traffic: traffic_mod.Traffic,
                seed: int):
    """The program's ``FaultSchedule`` of one drawn campaign."""
    from coast_tpu_torch.inject.schedule import FaultModel, FaultSchedule

    n, sites = cols["t"].shape
    extra, model = None, FaultModel.single()
    if sites > 1:
        model = FaultModel.multibit(traffic.k)
        extra = {k: np.ascontiguousarray(cols[k][:, 1:]).reshape(-1)
                 for k in traffic_mod.SITE_KEYS}
        extra["group"] = np.repeat(np.arange(n, dtype=np.int32), sites - 1)
    base = {k: np.ascontiguousarray(cols[k][:, 0])
            for k in traffic_mod.SITE_KEYS}
    return FaultSchedule(section_idx=cols["section"], seed=int(seed) % 2 ** 63,
                         extra=extra, model=model, **base)


# -- the check ------------------------------------------------------------------
def program_hist(counts: Dict[str, int]) -> np.ndarray:
    return np.array([int(counts.get(name, 0)) for name in engine.CLASS_NAMES],
                    np.int64)


def compare(res, rec: Dict[str, np.ndarray]) -> Dict[str, int]:
    """The numbers the check compares: rows whose record differs from the
    reference's, and the summed class-count difference."""
    ref_hist = engine.histogram(rec["code"])
    count_diff = int(np.abs(program_hist(res.counts) - ref_hist).sum())
    count_diff += abs(int(res.counts.get("cache_invalid", 0)))
    prog = {"code": res.codes, "errors": res.errors,
            "corrected": res.corrected, "steps": res.steps}
    if res.interesting_rows is None:
        if len(res.codes) != len(rec["code"]):
            return {"rows_differ": len(rec["code"]), "count_diff": count_diff}
        bad = np.zeros(len(rec["code"]), bool)
        for k in engine.COLUMNS:
            bad |= np.asarray(prog[k]) != rec[k]
        return {"rows_differ": int(bad.sum()), "count_diff": count_diff}
    # Sparse collect: the program returns the rows outside success and
    # corrected, with their records.
    ref_rows = np.flatnonzero(rec["code"] > engine.CORRECTED)
    got_rows = np.asarray(res.interesting_rows, np.int64)
    common, ia, ib = np.intersect1d(got_rows, ref_rows, return_indices=True)
    differ = len(got_rows) + len(ref_rows) - 2 * len(common)
    bad = np.zeros(len(common), bool)
    for k in engine.COLUMNS:
        bad |= np.asarray(prog[k])[ia] != rec[k][ref_rows[ib]]
    return {"rows_differ": int(differ + bad.sum()), "count_diff": count_diff}


def check_campaign(region: engine.Region, config: Dict,
                   cols: Dict[str, np.ndarray], res, device
                   ) -> Dict[str, int]:
    """Re-execute one campaign with the reference and compare."""
    ref = engine.Reference(region, device)
    faults = {k: cols[k].astype(np.int64) for k in engine.FAULT_KEYS}
    rec = ref.run_blocks(faults, int(config["reference_block_rows"]))
    return compare(res, rec)


# -- device facts ------------------------------------------------------------------
def card_line() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# -- one run -------------------------------------------------------------------
@dataclasses.dataclass
class Ctx:
    """What the metric readers read."""

    cell: Cell
    setup_s: float
    window_s: float
    injections: int
    campaigns: int
    batches: int
    memory_peak_bytes: int
    stages: Dict[str, float]
    transfer: Dict[str, int]
    trace: object = None              # trace.Reduced of a --trace 1 run
    vote_bytes: Dict[str, int] = dataclasses.field(default_factory=dict)


def run_cell(bench_path: Path, name: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t_start: Optional[float] = None,
             overrides: Optional[Dict] = None) -> tuple:
    """One run: the result object (the last line's) and what the check
    covered."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    laps = {"imports": time.perf_counter() - t_start}
    cell = load_cell(bench_path, name, overrides)
    cfg, tr = cell.config, cell.traffic
    dev = torch.device(device)
    # Layout and step count of the configuration, from the reference's
    # leaf table: the traffic draws over every injectable bit.
    ref_region = reference_region(cfg)
    layout = engine.layout(ref_region)
    prog, runner = build_program(cfg, tr, dev)
    laps["program"] = time.perf_counter() - t_start
    sections = [tuple(x) for x in prog.injectable_sections()]
    if sections != layout:
        raise CellError(f"{cfg['registry']}: the program's injectable "
                        f"sections {sections} are not the configuration's "
                        f"{layout}")
    pool = traffic_mod.draw_pool(seed, layout, ref_region.nominal_steps, tr)
    schedules = [to_schedule(cols, tr, seed) for cols in pool]
    laps["schedules"] = time.perf_counter() - t_start
    # Warm-up: one whole campaign at the window's shapes.
    runner.run_schedule(schedules[0], batch_size=tr.batch)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start

    def window():
        results = []
        t0 = time.perf_counter()
        while True:
            results.append(runner.run_schedule(
                schedules[len(results) % len(schedules)],
                batch_size=tr.batch))
            if time.perf_counter() - t0 >= seconds:
                break
        return results, time.perf_counter() - t0

    raw = None
    if trace:
        (results, window_s), raw = trace_mod.record(window, dev)
    else:
        results, window_s = window()
    peak = (int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda"
            else 0)
    bad = forbidden_modules()
    if bad:
        raise CellError(f"modules loaded in the run: {bad}")

    stages: Dict[str, float] = {}
    transfer: Dict[str, int] = {}
    campaign_s = [round(float(res.seconds), 4) for res in results]
    for res in results:
        for k, v in res.stages.items():
            stages[k] = stages.get(k, 0.0) + float(v)
        for k, v in res.transfer.items():
            transfer[k] = transfer.get(k, 0) + int(v)
    batches = len(results) * math.ceil(tr.campaign_n / tr.batch)
    ctx = Ctx(cell=cell, setup_s=setup_s, window_s=window_s,
              injections=sum(int(r.n) for r in results),
              campaigns=len(results), batches=batches,
              memory_peak_bytes=peak, stages=stages, transfer=transfer)
    if raw is not None:
        spans = []
        off = raw["perf_to_device"]
        for e in runner.telemetry.events:
            if e.get("kind") == "span" and e.get("depth") == 0:
                spans.append((str(e["name"]), int(e["t0"] * 1e9) + off,
                              int(e["t1"] * 1e9) + off))
        ctx.trace = trace_mod.reduce(raw["events"], raw["window"], spans)
        steps = np.concatenate([live_steps(res, ref_region.nominal_steps)
                                for res in results])
        ctx.vote_bytes = roofline.campaign_bytes(
            ref_region, bool(cfg["fuse_step"]), steps)
        del raw
    metrics = {}
    for metric in cell.per_layer if trace else cell.end_to_end:
        value = reader(bench_path.parent, metric)(ctx)
        if value is not None:
            metrics[metric] = {"value": value, "unit": cell.units[metric]}

    # The check, once the window has closed and the program is freed.
    pick = int(traffic_mod.rng_of(seed, 1).integers(len(results)))
    checked = results[pick]
    del runner, prog, schedules
    results = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = check_campaign(ref_region, cfg, pool[pick % len(pool)],
                             checked, dev)
    laps["reference"] = time.perf_counter() - t_check
    correct = all(numbers[k] <= LIMITS[k] for k in LIMITS)
    device_block = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                    "kind": (torch.cuda.get_device_name(dev)
                             if dev.type == "cuda" else "cpu"),
                    "count": cell.chips, "memory_peak_bytes": peak}
    if dev.type == "cuda":
        device_block["card"] = card_line()
    out = {"correct": correct, "attempted": ctx.injections,
           "failed": int(numbers["rows_differ"]), "metrics": metrics,
           "device": device_block}
    if ctx.trace is not None:
        device_block["busy_s"] = ctx.trace.busy_s
        device_block["window_s"] = ctx.trace.window_s
        out["breakdown"] = ctx.trace.breakdown()
    out["checks"] = {k: {"value": numbers[k], "limit": LIMITS[k]}
                     for k in LIMITS}
    info = {"campaigns": ctx.campaigns, "campaign_s": campaign_s,
            "checked_campaign": pick,
            "checked_rows": int(checked.n), "window_s": window_s,
            "setup_laps_s": laps}
    return out, info


def live_steps(res, nominal_steps: int) -> np.ndarray:
    """Every row's live steps T: all of them from a dense campaign; from a
    sparse one the returned rows' own, and the nominal runtime for the
    rows it does not return (completed rows, which under TMR run it)."""
    if res.interesting_rows is None:
        return np.asarray(res.steps, np.int64)
    steps = np.full(int(res.n), nominal_steps, np.int64)
    steps[np.asarray(res.interesting_rows, np.int64)] = res.steps
    return steps
