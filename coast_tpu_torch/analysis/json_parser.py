"""Campaign-log analysis: the jsonParser.py equivalent.

The port's own copy of ``coast_tpu/analysis/json_parser.py``: the same
names, the same output bytes, and no import of the reference.  A dense
ndjson file is classified by the port's native library
(``csrc/ndjson.cpp``); everything else takes the Python path.

Consumes the structured JSON logs written by
:mod:`coast_tpu_torch.inject.logs` (and the reference's)
(whose per-run dicts follow the reference's ``InjectionLog.getDict`` schema,
supportClasses.py:338-353) and reproduces the reference's analyses
(simulation/platform/jsonParser.py):

  * per-file / per-dir run summaries -- success / SDC "errors" / corrected
    "faults" / DUE (timeout + abort) / invalid counts and percentages
    (``summarizeRuns``, jsonParser.py:148-201);
  * timing -- seconds per injection (``summarizeTiming`` :204-213);
  * A-vs-B comparison -- runtime x, error-rate x, and
    **MWTF = (delta error rate) / (delta runtime)** (``compareRuns``
    :458-506, mwtf :473);
  * per-section error attribution -- which injected section/symbol produced
    which outcome (per-register counts :259-287 + ``examineSymbolInjections``
    :340-455 / elfUtils.py:105-176 rolled into one table, since TPU
    "sections" already are named leaves);
  * injection-time histogram (``pcStats`` :216-230, cycle-count histogram --
    text, no matplotlib dependency);
  * pipeline stage breakdown -- the per-stage wall-clock block
    (schedule/pad/dispatch/collect/classify/serialize) the telemetry
    layer (obs) records into every log's summary, printed
    under the timing line and summed key-wise over directories (the
    streaming writer's ``overlap`` entry is a fraction, rendered on its
    own line and averaged over a directory).  This has no reference
    analogue: at one injection every few seconds the reference never
    needed stage attribution.

``.gz`` logs (the writers' optional gzip container) are decompressed
transparently everywhere a plain log is accepted.

CLI (mirroring ``jsonParser.py logs/ -p | -k fileB | -d dirB``)::

    python -m coast_tpu_torch.analysis run.json            # summarize one file
    python -m coast_tpu_torch.analysis logs/               # summarize a directory
    python -m coast_tpu_torch.analysis a.json -k b.json    # compare A vs B (MWTF)
    python -m coast_tpu_torch.analysis dirA -d dirB        # compare directories
    python -m coast_tpu_torch.analysis run.json -p         # + per-section table
    python -m coast_tpu_torch.analysis run.json -r         # + register-kind table
    python -m coast_tpu_torch.analysis run.json -t         # + trap/timeout counts
    python -m coast_tpu_torch.analysis run.json -c         # + cycle histogram
    python -m coast_tpu_torch.analysis run.json -n -p      # tables only (-n: no
                                                     #   summary block)
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from typing import Dict, Iterable, List, Optional, Tuple

from coast_tpu_torch.obs.spans import top_stages

# Outcome classes, matching coast_tpu_torch.inject.classify codes / CLASS_NAMES.
_CLASSES = ("success", "corrected", "sdc", "due_abort", "due_timeout",
            "invalid", "due_stack_overflow", "due_assert",
            "train_self_heal", "train_sdc")
# DUE bucket membership (classify.DUE_CLASSES): aborts / stack overflows /
# assert fails all count as timeouts in the reference's summary
# (jsonParser.py:165-172; decoder classes decoder.py:67-69).
_DUE_CLASSES = ("due_abort", "due_timeout", "due_stack_overflow",
                "due_assert")
# Uncorrected silent corruption (classify.SDC_CLASSES): the error-rate /
# MWTF numerator.  train_self_heal is deliberately NOT an error -- the
# workload's output (the converged loss) was not corrupted.
_SDC_CLASSES = ("sdc", "train_sdc")
# Codes that ran to completion (reached the result line) and contribute
# to the mean-runtime statistic: success/corrected/sdc plus the train
# refinements of sdc (classify.COMPLETED_CLASSES).
_COMPLETED_CODES = (0, 1, 2, 8, 9)


def _completed_mask(codes):
    import numpy as np
    return np.isin(codes, _COMPLETED_CODES)


def mean_steps_or_nan(step_sum: float, step_n: int, n: int,
                      name: str) -> float:
    """Mean guest runtime over completed runs, or NaN (with a warning)
    for a non-empty campaign that completed none.  The single policy
    point for the zero-clean-runs case: the reference tool crashes here
    (statistics.mean over an empty list raises StatisticsError, its
    otherStats path); we report NaN so comparisons and MWTF propagate
    NaN rather than aborting.  Shared by both log readers and
    scripts/mwtf_report.py."""
    if step_n:
        return step_sum / step_n
    if n:
        print(f"warning: {name}: campaign has no completed runs; "
              "mean runtime (and any MWTF using it) is NaN",
              file=sys.stderr)
        return float("nan")
    return 0.0


def classify_run(run: Dict[str, object]) -> str:
    """Reconstruct the outcome class of one logged run.

    Dispatch on the result sub-dict's discriminating keys, exactly the
    ``InjectionLog.FromDict`` scheme (supportClasses.py:355-389): ``core`` ->
    RunResult, ``timeout`` -> TimeoutResult, ``message`` -> Abort-like,
    ``stackOverflow`` -> StackOverflowResult, ``assertion`` ->
    AssertionFailResult, ``invalid`` -> InvalidResult.  Priority mirrors
    classify.classify (INVALID > stack-overflow > assert > abort >
    timeout).
    """
    res = run.get("result") or {}
    if "invalid" in res:
        return "invalid"
    if "stackOverflow" in res:
        return "due_stack_overflow"
    if "assertion" in res:
        return "due_assert"
    if "trainSdc" in res:
        # Training refinements of SDC (train/): the result dict
        # carries the ordinary RunResult fields (core/runtime/errors)
        # plus the discriminating key, so these branches must sit above
        # the "core" dispatch.
        return "train_sdc"
    if "selfHeal" in res:
        return "train_self_heal"
    if "timeout" in res:
        return "due_timeout"
    if "message" in res:
        return "due_abort"
    if "core" in res:
        errors = int(res.get("errors", 0))
        faults = int(res.get("faults", 0))
        if errors > 0:
            return "sdc"
        if faults > 0:
            return "corrected"
        return "success"
    return "invalid"


@dataclasses.dataclass
class Summary:
    """One file/dir's aggregate, the ``summarizeRuns`` output row."""

    name: str
    n: int
    counts: Dict[str, int]
    seconds: float
    mean_steps: float            # mean guest runtime T over completed runs
    # Per-stage wall-clock breakdown (schedule/pad/dispatch/collect/
    # classify/serialize seconds) recorded by the telemetry layer into
    # each log's summary block; summed key-wise over a directory.  None
    # for logs written before the stages block existed.
    stages: Optional[Dict[str, float]] = None
    # Fault-tolerant-dispatch accounting (retry_transient / retry_wedged /
    # oom_degrade, inject/resilience) from each log's summary
    # block; None for campaigns run without a RetryPolicy.
    resilience: Optional[Dict[str, int]] = None
    # Fault-model axis (inject/schedule.FaultModel.spec()) from the log
    # summary: None for single-bit campaigns (whose logs deliberately
    # omit the key, keeping pre-model byte parity), the spec string for
    # multi-site campaigns, "mixed" when a directory aggregates several
    # models -- rates aggregated across models are rarely meaningful.
    fault_model: Optional[str] = None
    # Equivalence-reduced campaigns (analysis/equiv): ``n``/``counts``
    # are over EFFECTIVE injections (per-run class weights multiplied
    # out); ``physical_n`` is how many representative runs were actually
    # dispatched.  None for exhaustive campaigns (no weight keys in the
    # log), so pre-equiv logs summarize exactly as before.
    physical_n: Optional[int] = None
    # Statistical-convergence block (obs/convergence) from the
    # log summary: the stop condition, whether it tripped (``stopped``),
    # done-vs-planned effective injections, and the per-class Wilson
    # intervals the campaign ended with.  None for campaigns run without
    # ``stop_when`` and for directory aggregates mixing several logs
    # (intervals do not aggregate across campaigns).
    convergence: Optional[Dict[str, object]] = None
    # Measured host<->device traffic ({"up", "down"} bytes) from the log
    # summary's ``transfer_bytes`` block; summed over a directory.  None
    # for logs written before the block existed.
    transfer: Optional[Dict[str, int]] = None
    # Collection mode of the underlying log(s): "sparse" when the rows
    # cover only interesting outcomes (counts come from the summary's
    # device histogram), None/"dense" otherwise, "mixed" for a directory
    # aggregating both.
    collect: Optional[str] = None
    # Device-time attribution + roofline accounting (the
    # CampaignRunner(profile=True) summary blocks): device-busy /
    # host-gap / host-other seconds summing to the campaign wall clock,
    # per-phase device seconds, and the mfu block (achieved vs
    # roofline-predicted MFU, dispatch-gap fraction).  None for
    # unprofiled logs and for directory aggregates (attribution
    # fractions do not aggregate across campaigns).
    profile: Optional[Dict[str, object]] = None
    mfu: Optional[Dict[str, object]] = None
    # Reliability-SLO verdicts (obs/slo.summary_block) from the log
    # summary: per-objective attainment, budget remaining, burn rate,
    # worst verdict.  None for campaigns run without an SLO set and for
    # directory aggregates mixing several logs (a budget verdict
    # describes one campaign's evidence, like the Wilson intervals).
    slo: Optional[Dict[str, object]] = None
    # Serving request-plane block (serve.ServeMetrics.serving_block):
    # request counts / shed rate / strategy mix / live SDC CI from a
    # protected-inference-service log.  None for ordinary campaigns and
    # for directory aggregates mixing several logs (request rates and
    # the live Wilson CI describe one service's window, like slo).
    serving: Optional[Dict[str, object]] = None
    # Sharded-campaign accounting (ShardedCampaignRunner): the mesh
    # geometry the campaign ran on and each shard's interesting-row
    # count.  None for single-device logs and for directory aggregates
    # mixing several logs (a per-shard ledger describes one campaign's
    # batch split, like the convergence intervals).
    mesh: Optional[Dict[str, object]] = None

    @property
    def due(self) -> int:
        # Aborts (and the stack-overflow / assert-fail sub-buckets) also
        # count into the DUE/timeout bucket in the reference's summary
        # (jsonParser.py:165-172).
        return sum(self.counts.get(k, 0) for k in _DUE_CLASSES)

    @property
    def error_rate(self) -> float:
        # Persistent train SDCs count as errors (classify.SDC_CLASSES);
        # for every non-train campaign the extra key is absent/zero, so
        # the pre-training value is unchanged.
        sdc = sum(self.counts.get(k, 0) for k in _SDC_CLASSES)
        return sdc / self.n if self.n else 0.0

    def pct(self, cls: str) -> float:
        return 100.0 * self.counts.get(cls, 0) / self.n if self.n else 0.0

    def seconds_per_injection(self) -> float:
        # summarizeTiming (jsonParser.py:204-213).  Reduced campaigns
        # time the runs that physically dispatched, not the effective
        # injections they stand for.
        denom = self.physical_n if self.physical_n is not None else self.n
        return self.seconds / denom if denom else 0.0

    def format(self) -> str:
        lines = [f"=== {self.name}: {self.n} injections ==="]
        if self.physical_n is not None:
            # Effective vs physical as separate rows: the distribution
            # above is over effective injections; only the class
            # representatives physically ran.
            lines.append(f"  {'effective':<12} {self.n:>8}  (class-weighted)")
            red = self.n / self.physical_n if self.physical_n else 0.0
            lines.append(f"  {'physical':<12} {self.physical_n:>8}  "
                         f"({red:.1f}x equiv reduction)")
        if self.fault_model:
            lines.append(f"  fault model  {self.fault_model}")
        for cls in _CLASSES:
            if cls in ("due_stack_overflow", "due_assert",
                       "train_self_heal", "train_sdc"):
                continue          # printed as sub-count blocks below
            lines.append(f"  {cls:<12} {self.counts.get(cls, 0):>8}  "
                         f"({self.pct(cls):6.2f}%)")
        lines.append(f"  {'due (total)':<12} {self.due:>8}  "
                     f"({100.0 * self.due / self.n if self.n else 0.0:6.2f}%)")
        # The reference summary's three DUE sub-counts (its Timeouts row
        # folds aborts/stack-overflows/assert-fails in, then reports each
        # decoder class; decoder.py:67-69 / jsonParser.py:165-172).
        for label, key in (("aborts", "due_abort"),
                           ("stack overflows", "due_stack_overflow"),
                           ("assert fails", "due_assert")):
            lines.append(f"    {label:<16} {self.counts.get(key, 0):>6}")
        # Silent-training-corruption block (train/): only train
        # campaigns ever populate these classes, so every other summary's
        # text is unchanged.
        heals = self.counts.get("train_self_heal", 0)
        persists = self.counts.get("train_sdc", 0)
        if heals or persists:
            lines.append("  --- silent training corruption ---")
            lines.append(f"    {'self-healed':<16} {heals:>6}  "
                         "(loss re-converged)")
            lines.append(f"    {'persistent SDC':<16} {persists:>6}  "
                         "(weights + loss diverged)")
        lines.append(f"  error rate   {self.error_rate:.6f}")
        lines.append(f"  mean runtime {self.mean_steps:.1f} steps")
        if self.seconds:
            phys = self.physical_n if self.physical_n is not None else self.n
            lines.append(
                f"  {self.seconds_per_injection() * 1e6:.2f} usec per "
                f"injection ({phys / self.seconds:.1f} injections/sec)")
        if self.stages:
            lines.append("  --- stage breakdown ---")
            # 'overlap' is a FRACTION (share of serialization work the
            # streaming writer hid under dispatch), not a seconds
            # bucket: keep it out of the percentage table and print it
            # on its own line.  Nested spans ("<stage>/<span>") lie
            # inside their stage's seconds: the shares are of the top
            # level.
            seconds = {k: v for k, v in top_stages(self.stages).items()
                       if k != "overlap"}
            total = sum(seconds.values()) or 1.0
            for stage, sec in sorted(seconds.items(),
                                     key=lambda kv: -kv[1]):
                lines.append(f"  {stage:<12} {sec:>10.4f}s "
                             f"({100.0 * sec / total:5.1f}%)")
            if "overlap" in self.stages:
                lines.append(f"  serialize overlap: "
                             f"{100.0 * self.stages['overlap']:.1f}% of "
                             "serialization hidden under dispatch")
        if self.transfer:
            # Host<->device traffic alongside the stage seconds it
            # explains -- the sparse-collect mode's headline number.
            up = int(self.transfer.get("up", 0))
            down = int(self.transfer.get("down", 0))
            mode = f" ({self.collect} collect)" if self.collect else ""
            lines.append("  --- host transfer ---")
            lines.append(f"  up   {up:>12} bytes ({up / 1e6:8.2f} MB)"
                         f"{mode}")
            lines.append(f"  down {down:>12} bytes ({down / 1e6:8.2f} MB)")
        if self.profile:
            prof = self.profile
            lines.append("  --- device attribution ---")
            wall = float(prof.get("wall_s") or 0.0) or 1.0

            def _frac(key):
                return 100.0 * float(prof.get(key) or 0.0) / wall

            lines.append(
                f"  device busy  {float(prof.get('device_busy_s', 0)):.4f}s"
                f" ({_frac('device_busy_s'):5.1f}%)   host gap "
                f"{float(prof.get('host_gap_s', 0)):.4f}s "
                f"({_frac('host_gap_s'):5.1f}%)   other "
                f"{float(prof.get('host_other_s', 0)):.4f}s")
            phases = prof.get("per_phase_device_s") or {}
            if phases:
                lines.append("  per-phase device: " + "  ".join(
                    f"{k} {float(v):.4f}s" for k, v in phases.items()))
        if self.mfu:
            mfu = self.mfu

            def _pct(v):
                return f"{100.0 * v:.4g}%" if v is not None else "-"

            lines.append(
                f"  MFU: achieved {_pct(mfu.get('achieved_mfu'))} "
                f"(roofline ceiling {_pct(mfu.get('roofline_mfu'))}, "
                f"dispatch-gap "
                f"{_pct(mfu.get('dispatch_gap_fraction') or 0.0)}, "
                f"flops overhead {mfu.get('flops_overhead')}x)")
        if self.resilience and any(self.resilience.values()):
            # Surface survived dispatch failures: a campaign that retried
            # or degraded its way to completion should say so in the same
            # place its rates are quoted.
            lines.append("  --- resilience ---")
            for key, count in sorted(self.resilience.items()):
                lines.append(f"  {key:<16} {count:>6}")
        if self.convergence:
            conv = self.convergence
            lines.append("  --- convergence ---")
            state = ("STOPPED early" if conv.get("stopped")
                     else "ran to completion")
            lines.append(
                f"  {state} at {conv.get('done_n', '?')}/"
                f"{conv.get('planned_n', '?')} effective injections"
                + (f"  (stop_when {conv['stop_when']})"
                   if conv.get("stop_when") else ""))
            intervals = conv.get("intervals") or {}
            targets = set()
            if conv.get("stop_when"):
                # The spec grammar has ONE owner (StopWhen.parse); an
                # unparseable spec (written by a future version) just
                # loses the target marks, never the summary.
                try:
                    from coast_tpu_torch.obs.convergence import StopWhen
                    targets = set(
                        StopWhen.parse(str(conv["stop_when"])).targets)
                except Exception:      # noqa: BLE001 - cosmetic marks
                    targets = set()
            for cls_name, ci in intervals.items():
                # Rates the reader cares about: every class that
                # occurred, plus the stop targets (whose shrinking
                # zero-count upper bound is the convergence story).
                if not ci.get("count") and cls_name not in targets:
                    continue
                mark = "  <- target" if cls_name in targets else ""
                lines.append(
                    f"  {cls_name:<18} {100.0 * ci.get('rate', 0.0):7.3f}%"
                    f" +-{100.0 * ci.get('half_width', 0.0):6.3f}%"
                    f"  [{100.0 * ci.get('lo', 0.0):.3f}%,"
                    f" {100.0 * ci.get('hi', 0.0):.3f}%]{mark}")
        if self.slo:
            slo = self.slo
            lines.append("  --- slo ---")
            lines.append(f"  verdict {str(slo.get('verdict', '?')):<6}"
                         f" (spec {slo.get('spec')})")
            for oname, row in (slo.get("objectives") or {}).items():
                attained = row.get("attained")
                att = ("yes" if attained is True
                       else "NO" if attained is False else "n/a")
                budget = row.get("budget_remaining_frac")
                burn = row.get("burn_rate")
                lines.append(
                    f"  {oname:<18} {row.get('op', '')}"
                    f"{row.get('target')}"
                    f"  observed {row.get('observed')}"
                    f"  attained {att}"
                    + (f"  budget {100.0 * budget:6.1f}%"
                       if budget is not None else "")
                    + (f"  burn {burn:.2f}x" if burn is not None else "")
                    + f"  [{row.get('verdict')}]")
        if self.mesh:
            mesh = self.mesh
            axes = mesh.get("axes") or {}
            axes_str = " x ".join(f"{k}={v}" for k, v in axes.items()) \
                or "?"
            lines.append("  --- mesh ---")
            lines.append(f"  {mesh.get('devices', '?')} devices"
                         f"  ({axes_str})")
            ledger = mesh.get("per_shard_interesting")
            if ledger is not None:
                total = sum(int(v) for v in ledger) or 1
                lines.append("  interesting rows per shard: " + "  ".join(
                    f"[{i}] {int(v)} ({100.0 * int(v) / total:5.1f}%)"
                    for i, v in enumerate(ledger)))
        if self.serving:
            srv = self.serving
            reqs = srv.get("requests") or {}
            rejected = reqs.get("rejected") or {}
            lines.append("  --- serving ---")
            lines.append(
                f"  requests admitted {reqs.get('admitted', 0)}"
                f"  served {reqs.get('served', 0)}"
                f"  rejected {sum(rejected.values())}"
                f"  ({srv.get('req_per_sec', 0.0)} req/s)")
            mix = srv.get("strategy_mix") or {}
            if mix:
                mix_str = "  ".join(f"{k} {v}"
                                    for k, v in sorted(mix.items()))
                lines.append(
                    f"  strategy mix       {mix_str}"
                    f"  (retries {srv.get('retries', 0)},"
                    f" escalations {srv.get('escalations', 0)})")
            shed = srv.get("shed") or {}
            lines.append(
                f"  shed               "
                f"{100.0 * float(shed.get('shed_rate', 0.0)):7.3f}%"
                f"  ({shed.get('inject_lanes', 0)} inject lanes,"
                f" {shed.get('saturated_dispatches', 0)} saturated"
                " dispatches)")
            leak = srv.get("lane_leak") or {}
            lines.append(
                f"  lane leak          {leak.get('violations', 0)}"
                f" violations / {leak.get('checks', 0)} checks")
            inj = srv.get("inject") or {}
            ci = inj.get("sdc_ci") or {}
            lines.append(
                f"  live sdc           "
                f"{100.0 * float(inj.get('sdc_rate', 0.0)):7.4f}%"
                f" +-{100.0 * float(ci.get('half_width', 0.0)):6.4f}%"
                f"  [{100.0 * float(ci.get('lo', 0.0)):.4f}%,"
                f" {100.0 * float(ci.get('hi', 0.0)):.4f}%]"
                f"  over {inj.get('lanes_done', 0)} injection lanes")
        return "\n".join(lines)


def _sniff_ndjson_head(first_line):
    """The write_ndjson header, or None (shared by the materialising
    reader and the native fast path so the detection rule cannot
    drift)."""
    try:
        head = json.loads(first_line)
    except ValueError:
        return None
    if (isinstance(head, dict) and "summary" in head
            and isinstance(head["summary"], dict)
            and head["summary"].get("format") == "ndjson"):
        return head
    return None


def _open_log(path: str, mode: str = "r"):
    """Open a campaign log, transparently decompressing ``.gz`` files
    (the writers' optional gzip container: ``foo.ndjson.gz`` by
    extension).  Text mode decodes as the writers encoded (ASCII-safe
    JSON)."""
    if path.endswith(".gz"):
        import gzip
        return gzip.open(path, mode if "b" in mode else "rt")
    return open(path, mode)


def read_json_file(path: str) -> Dict[str, object]:
    with _open_log(path) as f:
        first = f.readline()
        nd_head = _sniff_ndjson_head(first)
        if nd_head is not None:
            # write_ndjson bulk log: summary line + one run per line.
            return {"summary": nd_head["summary"],
                    "runs": [json.loads(line) for line in f if line.strip()]}
        try:
            head = json.loads(first)
        except ValueError:
            head = None
        if isinstance(head, dict) and ("runs" in head or "columns" in head):
            # Single-line doc (write_columnar emits one line): the first
            # readline consumed and parsed the whole file already.
            return head
        if head is None and os.path.exists(first.strip()):
            # Reference container (write_reference_json / the reference's
            # own campaign logs): line 1 is the guest-executable path,
            # the rest one bare InjectionLog array (jsonParser.py:121-133).
            return {"summary": {"exec": first.strip()},
                    "runs": json.load(f)}
        f.seek(0)
        doc = json.load(f)
    if not isinstance(doc, dict) or not ("runs" in doc or "columns" in doc):
        raise ValueError(f"{path}: not a coast_tpu campaign log")
    return doc


def _iter_docs(path: str) -> Iterable[Tuple[str, Dict[str, object]]]:
    """Yield (name, doc) campaign logs under ``path``.

    A directory is scanned leniently: stray .json files that are not
    campaign logs are skipped with a warning (a log dir often accumulates
    other tooling's files).  An explicitly named file is strict.
    """
    if os.path.isdir(path):
        for fname in sorted(os.listdir(path)):
            if not fname.endswith((".json", ".json.gz")):
                continue
            try:
                yield fname, read_json_file(os.path.join(path, fname))
            except (ValueError, json.JSONDecodeError) as e:
                print(f"warning: skipping {fname}: {e}", file=sys.stderr)
    else:
        yield os.path.basename(path), read_json_file(path)


def summarize_runs(name: str, docs: Iterable[Dict[str, object]]) -> Summary:
    counts = {cls: 0 for cls in _CLASSES}
    n = 0
    physical = 0
    weighted = False
    seconds = 0.0
    step_sum = 0
    step_n = 0
    stages: Dict[str, float] = {}
    overlaps: List[float] = []
    resilience: Dict[str, int] = {}
    models: set = set()
    collects: set = set()
    transfer: Dict[str, int] = {}
    convergences: List[Dict[str, object]] = []
    profiles: List[Dict[str, object]] = []
    mfus: List[Dict[str, object]] = []
    slos: List[Dict[str, object]] = []
    servings: List[Dict[str, object]] = []
    meshes: List[Dict[str, object]] = []
    for doc in docs:
        head = doc.get("summary") or {}
        if head.get("collect") == "sparse":
            # Sparse-collect log: the class totals live in the summary
            # (the device histogram's counts; counts_histogram is the
            # dict->array bridge); the rows cover ONLY the interesting
            # outcomes, so they feed the runtime statistic (over
            # interesting completed runs, class weights applied exactly
            # as on the dense paths) and the per-section tables, never
            # the counts.
            import numpy as np
            from coast_tpu_torch.inject.classify import counts_histogram
            binc = counts_histogram(head)
            for i, cname in enumerate(_CLASSES):
                counts[cname] += int(binc[i])
            n += int(head.get("injections", 0))
            physical += int(head.get("physical_injections",
                                     head.get("injections", 0)))
            weighted = weighted or ("physical_injections" in head)
            if "columns" in doc:
                codes = np.asarray(doc["columns"]["code"])
                steps = np.asarray(doc["columns"]["steps"])
                w = doc["columns"].get("weight")
                w = (np.asarray(w, np.int64) if w is not None
                     else np.ones(len(codes), np.int64))
                completed = _completed_mask(codes)
                step_sum += int((steps[completed] * w[completed]).sum())
                step_n += int(w[completed].sum())
            else:
                for run in doc.get("runs") or []:
                    res = run.get("result") or {}
                    if "core" in res:
                        rw = int(run.get("weight", 1))
                        step_sum += int(res.get("runtime", 0)) * rw
                        step_n += rw
        elif "columns" in doc:                    # vectorised columnar path
            import numpy as np
            col = doc["columns"]  # type: ignore
            codes = np.asarray(col["code"])
            steps = np.asarray(col["steps"])
            w = col.get("weight")
            if w is not None:
                # Equivalence-reduced log: each representative row is
                # multiplied by its class weight (effective counts).
                weighted = True
                w = np.asarray(w, np.int64)
                binc = np.round(np.bincount(
                    codes, weights=w.astype(np.float64),
                    minlength=len(_CLASSES))).astype(np.int64)
                n += int(w.sum())
                completed = _completed_mask(codes)
                step_sum += int((steps[completed]
                                 * w[completed]).sum())
                step_n += int(w[completed].sum())
            else:
                binc = np.bincount(codes, minlength=len(_CLASSES))
                n += len(codes)
                completed = _completed_mask(codes)
                step_sum += int(steps[completed].sum())
                step_n += int(completed.sum())
            for i, cls in enumerate(_CLASSES):
                counts[cls] += int(binc[i])
            physical += len(codes)
        else:
            runs: List[Dict[str, object]] = doc["runs"]  # type: ignore
            for run in runs:
                cls = classify_run(run)
                w = int(run.get("weight", 1))
                if "weight" in run:
                    weighted = True
                counts[cls] += w
                n += w
                physical += 1
                res = run.get("result") or {}
                if "core" in res:
                    step_sum += int(res.get("runtime", 0)) * w
                    step_n += w
        summary = doc.get("summary") or {}
        seconds += float(summary.get("seconds", 0.0))
        for stage, sec in (summary.get("stages") or {}).items():
            if stage == "overlap":
                continue          # a fraction, not seconds: meaned below
            stages[stage] = stages.get(stage, 0.0) + float(sec)
        ov = (summary.get("stages") or {}).get("overlap")
        if ov is not None:
            overlaps.append(float(ov))
        for key, cnt in (summary.get("resilience") or {}).items():
            resilience[key] = resilience.get(key, 0) + int(cnt)
        models.add(summary.get("fault_model") or "single")
        collects.add(summary.get("collect") or "dense")
        for key, b in (summary.get("transfer_bytes") or {}).items():
            transfer[key] = transfer.get(key, 0) + int(b)
        if summary.get("convergence"):
            convergences.append(summary["convergence"])
        if summary.get("profile"):
            profiles.append(summary["profile"])
        if summary.get("mfu"):
            mfus.append(summary["mfu"])
        if summary.get("slo"):
            slos.append(summary["slo"])
        if summary.get("serving"):
            servings.append(summary["serving"])
        if summary.get("mesh"):
            meshes.append(summary["mesh"])
    if overlaps:
        stages["overlap"] = round(sum(overlaps) / len(overlaps), 4)
    # The fault-model axis: absent key == the single-bit legacy model.
    # A directory mixing models gets the explicit "mixed" marker rather
    # than silently quoting one model's rates under another's name.
    fault_model = None
    if len(models) == 1:
        only = models.pop()
        fault_model = None if only == "single" else only
    elif models:
        fault_model = "mixed"
    collect = None
    if len(collects) == 1:
        only_c = collects.pop()
        collect = None if only_c == "dense" else only_c
    elif collects:
        collect = "mixed"
    return Summary(name=name, n=n, counts=counts, seconds=seconds,
                   mean_steps=mean_steps_or_nan(step_sum, step_n, n, name),
                   stages=stages or None,
                   resilience=resilience or None,
                   fault_model=fault_model,
                   transfer=transfer or None,
                   collect=collect,
                   physical_n=physical if weighted else None,
                   # Wilson intervals describe ONE campaign's sample;
                   # a directory mixing several logs has no aggregate
                   # interval, so only a lone convergence block is kept.
                   # Same rule for the device-attribution blocks.
                   convergence=(convergences[0]
                                if len(convergences) == 1 else None),
                   profile=(profiles[0] if len(profiles) == 1 else None),
                   mfu=(mfus[0] if len(mfus) == 1 else None),
                   slo=(slos[0] if len(slos) == 1 else None),
                   serving=(servings[0]
                            if len(servings) == 1 else None),
                   mesh=(meshes[0] if len(meshes) == 1 else None))


def _summarize_ndjson_native(path: str) -> Optional[Summary]:
    """Fast path for a single write_ndjson file: the port's native library
    (``csrc/ndjson.cpp``, ``coast_ndjson_classify``) re-classifies the rows
    in one C pass, equal to classify_run.  Returns None where the file is
    not the native path's business: not ndjson, a sparse or an
    equivalence-reduced log, or a line that is not InjectionLog-shaped.
    A failed build of the library raises."""
    from coast_tpu_torch import native
    try:
        f = _open_log(path, "rb")
    except OSError:
        return None
    with f:
        head = _sniff_ndjson_head(f.readline())
        if head is None:
            return None
        if "physical_injections" in head["summary"]:
            # Equivalence-reduced log: rows carry class weights the
            # native classifier does not apply -- Python path.
            return None
        if head["summary"].get("collect") == "sparse":
            # Sparse log: the rows are only the interesting subset;
            # counts come from the summary histogram (Python path).
            return None
        try:
            got = native.ndjson_classify_stream(f.read)
        except ValueError:
            return None       # not InjectionLog-shaped: Python parser
    counts, step_sum, step_n, n = got
    name = os.path.basename(path.rstrip("/")) or path
    return Summary(
        name=name,
        n=n,
        counts={cls: int(counts[i]) for i, cls in enumerate(_CLASSES)},
        seconds=float(head["summary"].get("seconds", 0.0)),
        mean_steps=mean_steps_or_nan(step_sum, step_n, n, name),
        stages=head["summary"].get("stages") or None,
        resilience=head["summary"].get("resilience") or None,
        fault_model=head["summary"].get("fault_model") or None,
        transfer=head["summary"].get("transfer_bytes") or None,
        convergence=head["summary"].get("convergence") or None,
        profile=head["summary"].get("profile") or None,
        mfu=head["summary"].get("mfu") or None,
        slo=head["summary"].get("slo") or None,
        serving=head["summary"].get("serving") or None,
        mesh=head["summary"].get("mesh") or None)


def summarize_path(path: str) -> Summary:
    if os.path.isfile(path):
        fast = _summarize_ndjson_native(path)
        if fast is not None:
            return fast
    return summarize_runs(os.path.basename(path.rstrip("/")) or path,
                          (doc for _, doc in _iter_docs(path)))


# -- A-vs-B comparison (compareRuns, jsonParser.py:458-506) ------------------

def class_comparison(base: Summary, new: Summary,
                     z: float = 1.96) -> Dict[str, object]:
    """Per-class Wilson-interval comparison of two summaries: the
    distribution-drift half of :func:`compare_runs` and the verdict
    kernel of the protection-regression CI (:mod:`coast_tpu_torch.ci`).

    Weight-aware by construction: a Summary's counts/n are over
    EFFECTIVE injections (equivalence-reduced logs multiply class
    weights out upstream), and the Wilson arithmetic takes the weighted
    counts as-is -- the same convention as the live convergence tracker.

    Returns ``classes`` ({cls: {base, new, overlap}} interval rows over
    every class either summary populated), ``new_classes`` /
    ``vanished_classes`` (outcome classes with a nonzero count on
    exactly one side -- a protection regression often *creates* a class,
    e.g. sdc under a weakened TMR, at rates far inside a Wilson interval
    of zero), and ``distribution_drift`` (any non-overlapping class, or
    any new/vanished class)."""
    from coast_tpu_torch.obs.convergence import interval_table, intervals_overlap
    # One ensure= union keeps every row's denominator consistent: an
    # absent class is observed-zero out of THAT summary's own trials.
    names = tuple(sorted(set(base.counts) | set(new.counts)))
    base_tab = interval_table(base.counts, z, ensure=names)
    new_tab = interval_table(new.counts, z, ensure=names)
    classes: Dict[str, object] = {}
    new_classes: List[str] = []
    vanished: List[str] = []
    for cls_name in names:
        b = base_tab[cls_name]
        m = new_tab[cls_name]
        if not b["count"] and m["count"]:
            new_classes.append(cls_name)
        if b["count"] and not m["count"]:
            vanished.append(cls_name)
        classes[cls_name] = {"base": b, "new": m,
                             "overlap": intervals_overlap(b, m)}
    drift = (bool(new_classes) or bool(vanished)
             or any(not row["overlap"] for row in classes.values()))
    return {"classes": classes, "new_classes": new_classes,
            "vanished_classes": vanished, "distribution_drift": drift}


def format_drift_lines(cmp: Dict[str, object]) -> List[str]:
    """Render the drifting classes of a :func:`class_comparison` block,
    one line per class -- the ONE spelling shared by
    ``format_comparison`` and the CI's per-target report."""
    drifting = sorted(
        set(c for c, row in cmp["classes"].items() if not row["overlap"])
        | set(cmp["new_classes"]) | set(cmp["vanished_classes"]))
    out = []
    for cls_name in drifting:
        row = cmp["classes"][cls_name]
        tag = (" (new class)" if cls_name in cmp["new_classes"] else
               " (vanished class)" if cls_name in cmp["vanished_classes"]
               else "")
        out.append(
            f"{cls_name}: base [{100 * row['base']['lo']:.3f}%,"
            f" {100 * row['base']['hi']:.3f}%]  vs  "
            f"[{100 * row['new']['lo']:.3f}%,"
            f" {100 * row['new']['hi']:.3f}%]{tag}")
    return out


def compare_runs(base: Summary, new: Summary,
                 z: float = 1.96) -> Dict[str, object]:
    """Protection-cost metrics of ``new`` relative to ``base``.

    ``mwtf`` is the Mean-Work-To-Failure *ratio* of jsonParser.py:473:
    (error-rate improvement) / (runtime slowdown).  >1 means the protection
    buys more reliability than it costs in time.

    The runtime-slowdown denominator: the reference measures guest runtime
    of the protected binary.  Here both programs scan the same step count
    by construction (``steps_x`` is ~1); the replication cost (N lanes +
    voters) lands in wall-clock per injection, so ``runtime_x`` prefers the
    seconds-per-injection ratio and falls back to the step ratio when a
    summary carries no timing.

    Alongside the scalar ratios, the output carries the per-class
    distribution comparison of :func:`class_comparison` -- Wilson
    intervals (at quantile ``z``) for every outcome class on both
    sides, an ``overlap`` verdict per class, and the aggregate
    ``distribution_drift`` flag the protection-regression CI gates on.
    """
    import math

    def _ratio(a: float, b: float) -> float:
        if math.isnan(a) or math.isnan(b):
            # A campaign with no completed runs has no mean runtime: the
            # comparison is undefined, not infinite (the reference's
            # StatisticsError path, reported as NaN upstream).
            return float("nan")
        if b == 0.0:
            return float("inf") if a > 0 else 1.0
        return a / b

    steps_x = _ratio(new.mean_steps, base.mean_steps)
    if base.seconds and new.seconds:
        runtime_x = _ratio(new.seconds_per_injection(),
                           base.seconds_per_injection())
    else:
        runtime_x = steps_x
    error_rate_x = _ratio(new.error_rate, base.error_rate)
    improvement = _ratio(base.error_rate, new.error_rate)
    if math.isnan(runtime_x) or math.isnan(improvement):
        mwtf = float("nan")
    else:
        mwtf = improvement / runtime_x if runtime_x > 0 else float("inf")
    return {
        "runtime_x": runtime_x,
        "steps_x": steps_x,
        "error_rate_x": error_rate_x,
        "error_improvement_x": improvement,
        "mwtf": mwtf,
        **class_comparison(base, new, z),
    }


def format_comparison(base: Summary, new: Summary) -> str:
    cmp = compare_runs(base, new)
    lines = [f"=== {base.name} (base)  vs  {new.name} ===",
             base.format(), new.format(), "--- comparison ---"]
    lines.append(f"  runtime x          {cmp['runtime_x']:.3f} "
                 f"(steps x {cmp['steps_x']:.3f})")
    lines.append(f"  error rate x       {cmp['error_rate_x']:.4f}")
    lines.append(f"  error improvement  {cmp['error_improvement_x']:.2f}x")
    lines.append(f"  MWTF               {cmp['mwtf']:.2f}")
    # Distribution verdict (the CI's drift kernel): only the classes
    # that disagree are worth a line; agreement is the quiet default.
    verdict = "DRIFT" if cmp["distribution_drift"] else "consistent"
    lines.append(f"  distribution       {verdict}")
    lines.extend(f"    {d}" for d in format_drift_lines(cmp))
    return "\n".join(lines)


# -- per-section attribution (per-register counts :259-287 + per-symbol
#    examineSymbolInjections :340-455) ---------------------------------------

def section_stats(docs: Iterable[Dict[str, object]],
                  kinds: Optional[set] = None) -> Dict[str, Dict[str, int]]:
    """symbol -> {class -> count, 'injections' -> n}.

    On TPU the injected "section"/"symbol" is the state leaf recorded in each
    run's ``symbol`` key (fallback: parse the ``name`` field's ``sym[lane``
    shape), so register-style and symbol-style attribution coincide.
    ``kinds`` restricts the table to sections of those kinds (e.g.
    ``{"reg", "ctrl"}`` for the reference's per-register error counts,
    jsonParser.py:259-287).
    """
    table: Dict[str, Dict[str, int]] = {}
    for doc in docs:
        if "columns" in doc:                      # vectorised columnar path
            import numpy as np
            col = doc["columns"]  # type: ignore
            codes = np.asarray(col["code"])
            leaf_ids = np.asarray(col["leaf_id"]).copy()
            # Cache draws outside the program footprint (t < 0, never
            # fired) go to the '<invalid-line>' bucket, matching
            # to_injection_logs' symbol override.
            invalid_line = np.asarray(col["t"]) < 0
            leaf_ids[invalid_line] = -1
            sec_name = {s["leaf_id"]: s["name"]
                        for s in doc.get("sections", [])}  # type: ignore
            sec_name[-1] = "<invalid-line>"
            sec_kind = {s["leaf_id"]: s.get("kind")
                        for s in doc.get("sections", [])}  # type: ignore
            for lid in np.unique(leaf_ids):
                if kinds is not None and sec_kind.get(int(lid)) not in kinds:
                    continue
                sym = sec_name.get(int(lid), "?")
                row = table.setdefault(
                    sym, {**{cls: 0 for cls in _CLASSES}, "injections": 0})
                sel = codes[leaf_ids == lid]
                binc = np.bincount(sel, minlength=len(_CLASSES))
                row["injections"] += len(sel)
                for i, cls in enumerate(_CLASSES):
                    row[cls] += int(binc[i])
            continue
        for run in doc["runs"]:  # type: ignore
            if kinds is not None and run.get("section") not in kinds:
                continue
            sym = run.get("symbol")
            if not sym:
                sym = str(run.get("name", "?")).split("[", 1)[0]
            row = table.setdefault(
                sym, {**{cls: 0 for cls in _CLASSES}, "injections": 0})
            row["injections"] += 1
            row[classify_run(run)] += 1
    return table


def trap_counts(docs: Iterable[Dict[str, object]]) -> Tuple[int, int]:
    """(traps, timeouts): how many DUE timeouts were traps (``-t``,
    jsonParser.py countTrap).  TPU runs cannot trap -- there is no
    exception vector, the watchdog bound is the only hang detector -- so
    traps is 0 unless logs came from another platform; the flag exists
    for CLI parity and honest reporting of that difference."""
    traps = timeouts = 0
    for doc in docs:
        if "columns" in doc:
            import numpy as np
            codes = np.asarray(doc["columns"]["code"])  # type: ignore
            timeouts += int((codes == _CLASSES.index("due_timeout")).sum())
        else:
            for run in doc["runs"]:  # type: ignore
                res = run.get("result") or {}
                if "timeout" in res:
                    timeouts += 1
                    traps += 1 if res.get("trap") else 0
    return traps, timeouts


def format_section_stats(table: Dict[str, Dict[str, int]]) -> str:
    # ``sdc`` column = _SDC_CLASSES: train campaigns refine the raw sdc
    # bucket into train_sdc, which must still rank/print as corruption.
    def _sdc(row):
        return sum(row.get(k, 0) for k in _SDC_CLASSES)

    lines = ["--- per-section attribution ---",
             f"  {'symbol':<20} {'inj':>7} {'sdc':>6} {'corr':>6} "
             f"{'due':>6} {'inv':>5}  sdc%"]
    for sym in sorted(table, key=lambda s: -_sdc(table[s])):
        row = table[sym]
        due = sum(row.get(k, 0) for k in _DUE_CLASSES)
        sdc = _sdc(row)
        pct = 100.0 * sdc / row["injections"] if row["injections"] else 0
        lines.append(f"  {sym:<20} {row['injections']:>7} {sdc:>6} "
                     f"{row['corrected']:>6} {due:>6} {row['invalid']:>5}  "
                     f"{pct:5.1f}%")
    return "\n".join(lines)


# -- injection-time histogram (pcStats :216-230) -----------------------------

def cycle_histogram(docs: Iterable[Dict[str, object]],
                    bins: int = 20) -> List[Tuple[int, int, int]]:
    """[(lo, hi, count)] over the injection step index ('cycles' key)."""
    cycles = []
    for doc in docs:
        if "columns" in doc:
            cycles.extend(doc["columns"]["t"])  # type: ignore
        else:
            cycles.extend(int(run.get("cycles", 0))
                          for run in doc["runs"])  # type: ignore
    if not cycles:
        return []
    lo, hi = min(cycles), max(cycles)
    width = max(1, (hi - lo + bins) // bins)
    counts = [0] * bins
    for c in cycles:
        counts[min((c - lo) // width, bins - 1)] += 1
    return [(lo + i * width, lo + (i + 1) * width - 1, counts[i])
            for i in range(bins)]


def format_cycle_histogram(hist: List[Tuple[int, int, int]]) -> str:
    if not hist:
        return "--- cycle histogram: no runs ---"
    peak = max(c for _, _, c in hist) or 1
    lines = ["--- injection-step histogram ---"]
    for lo, hi, c in hist:
        bar = "#" * int(40 * c / peak)
        lines.append(f"  [{lo:>6}-{hi:>6}] {c:>7} {bar}")
    return "\n".join(lines)


# Eight-level bar glyphs for the one-line sparkline rendering.
_SPARK_GLYPHS = "▁▂▃▄▅▆▇█"


def format_cycle_sparkline(hist: List[Tuple[int, int, int]]) -> str:
    """One-line rendering of the injection-step histogram (the pcStats
    cycle plot, jsonParser.py:216-230, without the matplotlib dependency):
    one block glyph per bin, height proportional to count."""
    if not hist:
        return "steps: (no runs)"
    peak = max(c for _, _, c in hist) or 1
    bars = "".join(
        _SPARK_GLYPHS[(c * (len(_SPARK_GLYPHS) - 1)) // peak]
        for _, _, c in hist)
    lo, hi = hist[0][0], hist[-1][1]
    return f"  steps {lo}-{hi}  {bars}  (peak {peak}/bin)"


def histogram_json(hist: List[Tuple[int, int, int]]) -> Dict[str, object]:
    """JSON document for ``--hist-out``: the pcStats data as machine-
    readable bins rather than rendered text."""
    return {"metric": "injection_step_histogram",
            "bins": [{"lo": int(lo), "hi": int(hi), "count": int(c)}
                     for lo, hi, c in hist],
            "total": int(sum(c for _, _, c in hist))}


# -- CLI ---------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    paths: List[str] = []
    compare_path: Optional[str] = None
    per_section = False
    histogram = False
    hist_out: Optional[str] = None
    registers = False
    count_trap = False
    no_summary = False
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg in ("-k", "-d"):
            # -k compares files, -d directories; _iter_docs walks either,
            # so both resolve to the same comparison path (jsonParser.py
            # compare-files :88 / compare-dirs :89).
            i += 1
            if i >= len(argv):
                print(f"ERROR: {arg} needs a path", file=sys.stderr)
                return 2
            compare_path = argv[i]
        elif arg == "-p":
            per_section = True
        elif arg == "-c":
            histogram = True
        elif arg == "--hist-out" or arg.startswith("--hist-out="):
            # pcStats JSON export; implies the histogram pass (-c).
            if arg.startswith("--hist-out="):
                hist_out = arg.partition("=")[2]
            else:
                i += 1
                if i >= len(argv):
                    print("ERROR: --hist-out needs a path", file=sys.stderr)
                    return 2
                hist_out = argv[i]
            if not hist_out:
                print("ERROR: --hist-out needs a path", file=sys.stderr)
                return 2
            histogram = True
        elif arg == "-r":
            registers = True
        elif arg == "-t":
            count_trap = True
        elif arg == "-n":
            no_summary = True
        elif arg.startswith("-"):
            print(f"ERROR: unknown flag {arg}", file=sys.stderr)
            return 2
        else:
            paths.append(arg)
        i += 1
    if not paths:
        print(__doc__, file=sys.stderr)
        return 2

    def _load(path: str):
        try:
            return [doc for _, doc in _iter_docs(path)]
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"ERROR: {path}: {e}", file=sys.stderr)
            return None

    # The per-run tables need materialised docs; a plain summary (or
    # comparison) can take the native ndjson fast path in summarize_path
    # instead of per-line json.loads (~40x at 10^6 rows).
    need_docs = per_section or registers or count_trap or histogram

    def _summary(path: str) -> Optional[Summary]:
        try:
            return summarize_path(path)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"ERROR: {path}: {e}", file=sys.stderr)
            return None

    compare_summary: Optional[Summary] = None
    if compare_path is not None:
        compare_summary = _summary(compare_path)
        if compare_summary is None:
            return 1

    for path in paths:
        docs = None
        if need_docs:
            docs = _load(path)
            if docs is None:
                return 1
            base = summarize_runs(
                os.path.basename(path.rstrip("/")) or path, docs)
        else:
            base = _summary(path)
            if base is None:
                return 1
        if compare_summary is not None:
            print(format_comparison(base, compare_summary))
        elif not no_summary:
            print(base.format())
        if per_section:
            print(format_section_stats(section_stats(docs)))
        if registers:
            print(format_section_stats(
                section_stats(docs, kinds={"reg", "ctrl", "cfcss"})))
        if count_trap:
            traps, timeouts = trap_counts(docs)
            print(f"traps: {traps} of {timeouts} timeouts")
        if histogram:
            hist = cycle_histogram(docs)
            print(format_cycle_histogram(hist))
            print(format_cycle_sparkline(hist))
            if hist_out:
                with open(hist_out, "w") as fh:
                    json.dump(histogram_json(hist), fh, indent=1)
                print(f"# wrote {hist_out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
