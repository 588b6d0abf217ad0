"""The CI engine: baseline building, delta checking, drift verdicts.

The port's copy of ``coast_tpu/ci/engine.py``, on a device: the card
unless the caller passes ``device="cpu"``.  Every campaign -- the
in-process worker's and each spawned worker's -- runs on the caller's
device, and the isolation pre-gate builds the programs there too.

Both verbs run their campaigns **through the fleet** -- one
:class:`~coast_tpu_torch.fleet.queue.CampaignQueue` item per target,
drained by stock :class:`~coast_tpu_torch.fleet.worker.Worker` processes
behind the shared
:class:`~coast_tpu_torch.fleet.compile_cache.CompileCache` -- so the CI
inherits every fleet property for free: crash-safe journals, lease
requeue, idempotent completion, and one compile per config no matter
how many targets share it.

The check's work unit is a DELTA item: the worker rebuilds the target
from the current tree, diffs its per-section dataflow fingerprints
against the baseline journal's, re-injects ONLY changed sections (each
convergence-bounded on its own when a stop condition is set), splices
everything else from the baseline's recorded rows, and lands a done
record plus a materialized result journal.  The verdict then compares
classification distributions through
:func:`coast_tpu_torch.analysis.json_parser.compare_runs` -- per-class Wilson
intervals must overlap, and a new or vanished outcome class is drift by
definition (a weakened protection often *creates* a class at a rate far
inside a Wilson interval of zero).

Exit codes are typed and script-stable:

  * ``EXIT_PASS`` (0)  -- every target's distribution is consistent
    with the baseline; a refreshed artifact was produced.
  * ``EXIT_DRIFT`` (1) -- at least one target drifted; the per-class
    report names which classes and which sections.
  * ``EXIT_INFRA`` (2) -- the check itself could not run to a verdict
    (build failure, unreadable baseline, identity mismatch, worker
    death).  A mismatched campaign identity -- changed seed/n, a
    changed memory map -- is deliberately infra, not drift: it means
    the baseline no longer describes these targets and must be rebuilt,
    not that the protection regressed.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
from typing import Callable, Dict, List, Optional

from coast_tpu_torch import device as device_mod
from coast_tpu_torch.ci import baseline as base_mod
from coast_tpu_torch.inject.spec import CampaignSpec

__all__ = ["EXIT_PASS", "EXIT_DRIFT", "EXIT_INFRA", "CiInfraError",
           "TargetReport", "CiReport", "default_specs",
           "build_baseline", "check_baseline"]

EXIT_PASS = 0
EXIT_DRIFT = 1
EXIT_INFRA = 2

#: Default convergence bound for check items: each re-injected section
#: stops once its uncorrected-corruption rate is known to +-2% (floored
#: at 256 effective injections so rare classes get a chance to appear).
DEFAULT_STOP_WHEN = "sdc:0.02;min=256"


class CiInfraError(RuntimeError):
    """The CI could not reach a verdict (exit 2): infrastructure or
    identity failure, not a protection regression."""


def default_specs(n: int = 2048, seed: int = 7,
                  batch_size: int = 512) -> List[CampaignSpec]:
    """The repo's own CI target set: the two seed benchmarks whose
    equivalence behavior is differentially validated
    (artifacts/equiv_study.json) x both protection strategies."""
    return [CampaignSpec(bench, n, seed=seed, opt_passes=opt,
                         batch_size=batch_size, equiv=True).validate()
            for bench in ("matrixMultiply", "crc16")
            for opt in ("-DWC", "-TMR")]


# -- fleet plumbing ----------------------------------------------------------

def _safe_name(text: str) -> str:
    return re.sub(r"[^A-Za-z0-9._-]+", "_", text).strip("_")


def _spawn_worker(queue_dir: str, wid: str,
                  device: str) -> subprocess.Popen:
    """One fleet worker subprocess (the `python -m coast_tpu_torch.fleet
    worker` the fleet supervisor itself spawns) on ``device``, resolving
    the same coast_tpu_torch this process runs."""
    import coast_tpu_torch
    pkg_root = os.path.dirname(os.path.dirname(
        os.path.abspath(coast_tpu_torch.__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, "-m", "coast_tpu_torch.fleet", "worker",
         "--queue", queue_dir, "--worker-id", wid, "--device", device],
        env=env)


def _drain(queue, workers: int = 1,
           program_hook: Optional[Callable] = None,
           device=device_mod.DEFAULT) -> None:
    """Drain the queue through fleet workers on ``device``: in-process
    for one worker (the default -- and the only mode that can carry a
    program_hook), subprocesses for more."""
    from coast_tpu_torch.fleet.compile_cache import CompileCache
    from coast_tpu_torch.fleet.worker import Worker
    if workers <= 1:
        cache = CompileCache(queue.cache_dir, device=device,
                             program_hook=program_hook)
        Worker(queue, "ci-w0", cache=cache).drain()
        return
    if program_hook is not None:
        raise CiInfraError(
            "program_hook (the seeded-weakening test seam) needs the "
            "in-process worker; run with workers=1")
    procs = [_spawn_worker(queue.root, f"ci-w{i}", str(device))
             for i in range(workers)]
    rcs = [p.wait() for p in procs]
    if any(rcs):
        raise CiInfraError(
            f"fleet worker(s) exited nonzero: {rcs}")


def _collect_done(queue, wanted: Dict[str, str]) -> Dict[str, Dict]:
    """{target_id: done result} for every enqueued item; failed or
    missing items are a CiInfraError naming each failure."""
    done = {str(rec.get("id")): rec for rec in queue.items("done")}
    failed = {str(rec.get("id")): rec for rec in queue.items("failed")}
    stats = queue.stats()
    out: Dict[str, Dict] = {}
    problems: List[str] = []
    for item_id, tid in wanted.items():
        if item_id in done:
            out[tid] = dict(done[item_id].get("result") or {})
        elif item_id in failed:
            problems.append(
                f"{tid}: {failed[item_id].get('error')}")
        else:
            problems.append(f"{tid}: item {item_id} never completed "
                            f"(queue: {stats})")
    if problems:
        raise CiInfraError(
            "campaign item(s) did not complete:\n  "
            + "\n  ".join(problems))
    return out


# -- baseline ----------------------------------------------------------------

def build_baseline(specs: List[CampaignSpec],
                   queue_dir: Optional[str] = None,
                   workers: int = 1,
                   program_hook: Optional[Callable] = None,
                   log: Callable[[str], None] = lambda s: None,
                   device=device_mod.DEFAULT
                   ) -> Dict[str, object]:
    """Run every spec as a full journaled fleet campaign on ``device``
    and assemble the baseline artifact document."""
    from coast_tpu_torch.fleet.queue import CampaignQueue
    specs = [s.validate() for s in specs]
    with tempfile.TemporaryDirectory(prefix="coast_ci_") as tmp:
        root = queue_dir or os.path.join(tmp, "queue")
        q = CampaignQueue(root)
        wanted: Dict[str, str] = {}
        journal_paths: Dict[str, str] = {}
        for spec in specs:
            tid = base_mod.target_id(spec)
            if tid in journal_paths:
                raise CiInfraError(f"duplicate target {tid!r}")
            item_id = q.enqueue(spec.to_item())
            wanted[item_id] = tid
            journal_paths[tid] = q.journal_path(item_id)
            log(f"# baseline: queued {tid} ({item_id})")
        dev = device_mod.resolve(device)
        _drain(q, workers=workers, program_hook=program_hook, device=dev)
        results = _collect_done(q, wanted)
        targets: Dict[str, Dict[str, object]] = {}
        for spec in specs:
            tid = base_mod.target_id(spec)
            targets[tid] = base_mod.target_block(
                spec, results[tid], journal_paths[tid])
            log(f"# baseline: {tid}: n={targets[tid]['n']} "
                f"physical={targets[tid]['physical_n']}")
        return base_mod.assemble(targets, device=dev.type)


# -- check -------------------------------------------------------------------

@dataclasses.dataclass
class TargetReport:
    """One target's check outcome."""

    target: str
    drift: bool
    changed_sections: List[str]
    reused_rows: int
    reinjected_rows: int
    dropped_rows: int
    base_n: int
    n: int
    base_counts: Dict[str, int]
    counts: Dict[str, int]
    comparison: Dict[str, object]     # pooled compare_runs output
    # Per-changed-section class_comparison blocks -- the verdict's
    # comparison unit whenever early stop dropped rows (see
    # _target_verdict).
    section_comparisons: Dict[str, Dict[str, object]] = \
        dataclasses.field(default_factory=dict)
    cache_event: Optional[str] = None
    # Static isolation pre-gate refutations (counterexample paths); a
    # non-empty list IS drift -- the tree's protection is broken before
    # any injection runs, so no campaign was enqueued for this target.
    isolation_leaks: List[str] = dataclasses.field(default_factory=list)
    # Per-target campaign cost: wall seconds plus the stage breakdown
    # (schedule/pad/dispatch/collect/... seconds) from the worker's done
    # record, so a protection-CI cost regression -- a target whose delta
    # suddenly re-injects everything, a compile that stopped caching --
    # is visible in the verdict artifact, not just in CI latency graphs.
    seconds: float = 0.0
    stage_seconds: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    def drift_lines(self) -> List[str]:
        from coast_tpu_torch.analysis.json_parser import format_drift_lines
        if self.isolation_leaks:
            return [f"isolation: {l}" for l in self.isolation_leaks]
        if self.comparison.get("skipped"):
            return [str(self.comparison["skipped"])]
        if not self.comparison:
            return []
        if self.section_comparisons and self.dropped_rows:
            return [f"section {name}: {d}"
                    for name, cmp_ in sorted(
                        self.section_comparisons.items())
                    for d in format_drift_lines(cmp_)]
        return format_drift_lines(self.comparison)


@dataclasses.dataclass
class CiReport:
    """The whole check's outcome: per-target reports + the refreshed
    baseline document (written on pass)."""

    targets: List[TargetReport]
    refreshed: Dict[str, object]

    @property
    def drift(self) -> bool:
        return any(t.drift for t in self.targets)

    @property
    def exit_code(self) -> int:
        return EXIT_DRIFT if self.drift else EXIT_PASS

    def to_json(self) -> Dict[str, object]:
        def _strict(v):
            # compare_runs ratios can be inf/nan (zero-error baselines);
            # strict-JSON consumers reject bare Infinity, so encode them
            # as strings (the scripts/mwtf_report.py convention).
            if isinstance(v, float) and not math.isfinite(v):
                return "nan" if math.isnan(v) else "inf"
            if isinstance(v, dict):
                return {k: _strict(x) for k, x in v.items()}
            if isinstance(v, list):
                return [_strict(x) for x in v]
            return v

        return {
            "format": "coast-ci-report", "version": 1,
            "verdict": "drift" if self.drift else "pass",
            "targets": [_strict(dataclasses.asdict(t))
                        for t in self.targets],
        }

    def format(self) -> str:
        lines = []
        for t in self.targets:
            state = "DRIFT" if t.drift else (
                "skip" if t.comparison.get("skipped") else "ok")
            changed = (",".join(t.changed_sections)
                       if t.changed_sections else "none")
            lines.append(
                f"{state:>5}  {t.target}  changed={changed}  "
                f"reinjected={t.reinjected_rows}/"
                f"{t.reinjected_rows + t.reused_rows} rows"
                + (f" (early-stop cut {t.dropped_rows})"
                   if t.dropped_rows else "")
                + (f"  [{t.seconds:.2f}s campaign]"
                   if t.seconds else ""))
            for d in t.drift_lines():
                lines.append(f"         {d}")
        verdict = ("protection-regression DRIFT"
                   if self.drift else "protection unchanged: PASS")
        lines.append(f"ci: {len(self.targets)} target(s); {verdict}")
        return "\n".join(lines)


def _stage_seconds(result: Dict[str, object]) -> Dict[str, float]:
    """The done record's campaign stage breakdown (the worker's
    ``res.summary()["stages"]``), seconds only -- the ``overlap``
    fraction is a ratio, not a cost, and stays out of a seconds
    table."""
    stages = (result.get("summary") or {}).get("stages") or {}
    return {str(k): round(float(v), 6) for k, v in sorted(stages.items())
            if k != "overlap"}


def _verdict_summary(name: str, n: int, counts: Dict[str, int]):
    """A json_parser.Summary over OUTCOME classes only (cache_invalid is
    schedule bookkeeping, not an outcome)."""
    from coast_tpu_torch.analysis.json_parser import Summary
    kept = {k: int(v) for k, v in counts.items()
            if k != "cache_invalid"}
    return Summary(name=name, n=int(n), counts=kept, seconds=0.0,
                   mean_steps=0.0)


def _target_verdict(tid: str, block: Dict[str, object],
                    result: Dict[str, object], z: float):
    """(drift, pooled_comparison, section_comparisons) for one target.

    The pooled distributions decide the verdict only when the delta
    covered every row.  When per-section early stop DROPPED rows, the
    pooled mix is biased -- a truncated section's share of the total
    shrank, so pooled rates move even when every section's distribution
    is unchanged -- and the verdict falls back to the per-changed-
    section comparisons run_delta recorded (sound: spliced rows are
    identical by construction, so drift can only originate in changed
    sections)."""
    from coast_tpu_torch.analysis.json_parser import (class_comparison,
                                                      compare_runs)
    cmp_ = compare_runs(
        _verdict_summary(f"{tid} (baseline)", block["n"],
                         block["counts"]),
        _verdict_summary(tid, result.get("injections", 0),
                         result.get("counts") or {}),
        z=z)
    delta = dict(result.get("delta") or {})
    section_cmps: Dict[str, Dict[str, object]] = {}
    for name, row in sorted((delta.get("sections") or {}).items()):
        section_cmps[name] = class_comparison(
            _verdict_summary(f"{name} (baseline)", row["base_n"],
                             row["base_counts"]),
            _verdict_summary(name, row["n"], row["counts"]),
            z=z)
    if int(delta.get("dropped_rows", 0)) and section_cmps:
        drift = any(c["distribution_drift"]
                    for c in section_cmps.values())
    else:
        drift = bool(cmp_["distribution_drift"])
    return drift, cmp_, section_cmps


def _isolation_pregate(targets: Dict[str, object],
                       program_hook: Optional[Callable],
                       log: Callable[[str], None],
                       device=device_mod.DEFAULT
                       ) -> Dict[str, List[str]]:
    """The fast static pre-gate: prove lane-isolation noninterference
    for every target's CURRENT build before any delta campaign is
    enqueued.  A refuted target returns its counterexample paths -- a
    statically-broken protection is a regression no campaign needs to
    measure (and a campaign against it would burn the whole convergence
    budget discovering what the prover shows in milliseconds).  Build
    failures raise :class:`CiInfraError` (any worker would fail the same
    way)."""
    from coast_tpu_torch.analysis.propagation import prove_isolation
    from coast_tpu_torch.inject.supervisor import build_program
    leaks: Dict[str, List[str]] = {}
    for tid in sorted(targets):
        spec = CampaignSpec.from_item(targets[tid]["spec"])
        try:
            prog, strategy = build_program(spec.benchmark,
                                           spec.opt_passes, str(device))
        except SystemExit as e:
            raise CiInfraError(
                f"{tid}: protected-program build failed "
                f"(exit {e.code})") from e
        if program_hook is not None:
            program_hook(prog)
        proof = prove_isolation(prog, strategy=strategy or "unprotected")
        log(f"# isolation pre-gate: {tid}: "
            f"{'HOLDS' if proof.holds else 'LEAK'}")
        if not proof.holds:
            leaks[tid] = [l.format() for l in proof.leaks]
    return leaks


def check_baseline(doc: Dict[str, object],
                   workdir: Optional[str] = None,
                   stop_when: Optional[str] = DEFAULT_STOP_WHEN,
                   workers: int = 1,
                   z: float = 1.96,
                   program_hook: Optional[Callable] = None,
                   static_budget: bool = True,
                   isolation_gate: bool = True,
                   log: Callable[[str], None] = lambda s: None,
                   device=device_mod.DEFAULT
                   ) -> CiReport:
    """Check the current tree against a baseline document.

    First the static isolation pre-gate runs over every target's
    current build (``isolation_gate=False`` disables): a refuted
    noninterference proof is an immediate DRIFT verdict carrying the
    counterexample paths, and no campaign is enqueued.  Then, per
    target: materialize the baseline journal, enqueue a DELTA item
    (``stop_when`` bounding each re-injected section; None disables;
    ``static_budget`` points the convergence budget at the sections the
    static vulnerability map calls ``sdc-possible`` first), drain
    through fleet workers, and compare distributions
    (:func:`_target_verdict`).  Every build and campaign runs on
    ``device``.  Raises :class:`CiInfraError` when any target cannot
    reach a verdict."""
    from coast_tpu_torch.fleet.queue import CampaignQueue, QueueError
    targets = doc["targets"]
    dev = device_mod.resolve(device)
    if isolation_gate:
        leaking = _isolation_pregate(targets, program_hook, log, dev)
        if leaking:
            # The report covers EVERY target: leaking ones drift with
            # their counterexample paths, the rest are explicitly
            # "skipped" (the gate aborts before any campaign, so no
            # distribution verdict exists for them either).
            reports = [
                TargetReport(
                    target=tid, drift=tid in leaking,
                    changed_sections=[],
                    reused_rows=0, reinjected_rows=0, dropped_rows=0,
                    base_n=int(targets[tid]["n"]),
                    n=0, base_counts=dict(targets[tid]["counts"]),
                    counts={},
                    comparison=({} if tid in leaking else
                                {"skipped": "isolation pre-gate failed "
                                 "on another target; no campaign ran"}),
                    isolation_leaks=leaking.get(tid, []))
                for tid in sorted(targets)]
            return CiReport(targets=reports,
                            refreshed=base_mod.assemble(
                                {tid: json.loads(json.dumps(targets[tid]))
                                 for tid in sorted(targets)},
                                device=dev.type))
    with tempfile.TemporaryDirectory(prefix="coast_ci_") as tmp:
        root = workdir or tmp
        q = CampaignQueue(os.path.join(root, "queue"))
        wanted: Dict[str, str] = {}
        journal_paths: Dict[str, str] = {}
        specs: Dict[str, CampaignSpec] = {}
        for tid in sorted(targets):
            block = targets[tid]
            spec = CampaignSpec.from_item(block["spec"])
            base_path = base_mod.materialize_journal(
                block["journal"],
                os.path.join(root, "base", f"{_safe_name(tid)}.journal"))
            item = dataclasses.replace(
                spec, delta_from=base_path, equiv=True,
                stop_when=(stop_when or None),
                static_budget=bool(static_budget and stop_when))
            try:
                item.validate()
            except (ValueError, QueueError) as e:
                raise CiInfraError(f"{tid}: bad check spec: {e}") from e
            item_id = q.enqueue(item.to_item())
            wanted[item_id] = tid
            journal_paths[tid] = q.journal_path(item_id)
            specs[tid] = spec
            log(f"# check: queued {tid} ({item_id})")
        _drain(q, workers=workers, program_hook=program_hook, device=dev)
        results = _collect_done(q, wanted)

        reports: List[TargetReport] = []
        refreshed: Dict[str, Dict[str, object]] = {}
        for tid in sorted(targets):
            block = targets[tid]
            result = results[tid]
            delta = dict(result.get("delta") or {})
            drift, cmp_, section_cmps = _target_verdict(
                tid, block, result, z)
            report = TargetReport(
                target=tid,
                drift=drift,
                changed_sections=list(delta.get("changed_sections")
                                      or []),
                reused_rows=int(delta.get("reused_rows", 0)),
                reinjected_rows=int(delta.get("reinjected_rows", 0)),
                dropped_rows=int(delta.get("dropped_rows", 0)),
                base_n=int(block["n"]),
                n=int(result.get("injections", 0)),
                base_counts=dict(block["counts"]),
                counts={k: int(v) for k, v in
                        (result.get("counts") or {}).items()},
                comparison=cmp_,
                section_comparisons=section_cmps,
                cache_event=result.get("cache_event"),
                seconds=round(float(result.get("seconds", 0.0)), 6),
                stage_seconds=_stage_seconds(result),
            )
            reports.append(report)
            log(f"# check: {tid}: "
                f"{'DRIFT' if report.drift else 'ok'} "
                f"(reinjected {report.reinjected_rows})")
            if report.dropped_rows:
                # A truncated run cannot refresh ground truth: its
                # journal is missing the early-stop-dropped sites, and
                # baking it in would make every future no-op check
                # re-inject them (conservatively, as unmatched sites)
                # forever.  Keep the old block; the target keeps
                # re-checking until a full-coverage run (--stop-when
                # none, or `ci baseline`) rebases it.
                refreshed[tid] = json.loads(json.dumps(block))
            else:
                refreshed[tid] = base_mod.target_block(
                    specs[tid], result, journal_paths[tid])
        return CiReport(targets=reports,
                        refreshed=base_mod.assemble(refreshed,
                                                    device=dev.type))
