"""Reliability SLOs: declarative targets, error budgets, burn rates.

The port's copy of the reference's SLO engine: a protected service
that measures its own SDC rate, with MWTF as a user-facing SLO.  Following
FastFlip's (arXiv:2403.13989) evidence-driven framing, a reliability
target here is a first-class object -- not a number eyeballed out of
``/status`` -- evaluated over exactly the recorded campaign evidence
the convergence tracker already trusts:

  * :class:`SLOSpec` -- one declarative objective.  Four kinds:

      - ``sdc_rate <= c``      SDC-rate ceiling over the weighted class
        histogram (the :data:`classify.SDC_CLASSES` sum, same as the
        live ``sdc_rate`` ring);
      - ``availability >= f``  availability floor, where availability
        is ``1 - rate(DUE classes)`` -- detected-unrecoverable outcomes
        are the "downtime" of a protected region;
      - ``mwtf >= m``          Mean-Work-To-Failure improvement floor
        against a recorded baseline (the ``compare_runs`` definition:
        error improvement over runtime cost);
      - ``p99_dispatch <= s``  a latency-percentile ceiling over the
        profiler's per-dispatch histograms (``p<q>_dispatch`` reads
        ``dispatch_device_seconds``, ``p<q>_gap`` the host-gap one).

  * **Wilson-backed attainment**: a rate objective is *attained* only
    when its Wilson interval (:func:`obs.convergence.wilson_interval`,
    the same z) lies entirely on the good side of the target, *violated*
    only when the interval lies entirely on the bad side, and
    *inconclusive* (``None``) in between -- small samples cannot buy a
    verdict in either direction.
  * **Error budgets**: a ceiling ``c`` over ``n`` effective injections
    allows ``c*n`` bad events; ``budget.remaining_frac`` is the
    unconsumed fraction (negative = overspent).
  * **Multi-window burn rates**: ``burn = bad_rate / allowed_rate``
    evaluated over the full campaign (long window) AND the recent ring
    tail (short window, when series are available).  The verdict is
    ``page`` when both windows burn at ``page_burn`` or the budget is
    already exhausted, ``warn`` when the long window burns >= 1x (or
    attainment is definitively violated), else ``ok`` -- the
    two-window rule that makes a page mean "burning NOW and not just a
    stale spike".

:class:`SLOSet` parses/round-trips a canonical spec string (the
StopWhen discipline, so a spec can ride in artifacts as identity), and
the evidence extractors accept every surface the repo records: live
:class:`CampaignMetrics` snapshots, ``--status-json`` files, campaign
log summaries, and ``summarize`` artifacts.  ``python -m
coast_tpu_torch slo`` (:mod:`coast_tpu_torch.obs.slo_cli`) is the offline
entry; the metrics hub evaluates the same engine live.  On the port the
dispatch histogram is the profiler's busy window (an upper bound of the
device time), so a ``p<q>_dispatch`` value is not the reference's.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
from typing import Dict, List, Mapping, Optional, Tuple

from coast_tpu_torch.inject.classify import DUE_CLASSES, SDC_CLASSES
from coast_tpu_torch.obs.convergence import wilson_interval

__all__ = ["SLOSpec", "SLOSet", "SLOError", "evaluate", "worst_verdict",
           "evidence_from_status", "evidence_from_summary",
           "load_evidence", "baseline_from", "summary_block",
           "status_line", "VERDICTS"]

#: Verdict severity order (worst last).
VERDICTS = ("ok", "warn", "page")

#: Short histogram aliases for latency objectives.
_HIST_ALIASES = {"dispatch": "dispatch_device_seconds",
                 "gap": "dispatch_host_gap_seconds"}

_LATENCY_RE = re.compile(r"^p(\d{1,2}(?:\.\d+)?)_([a-z_]+)$")


class SLOError(ValueError):
    """A malformed SLO specification."""


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One declarative reliability objective.

    ``objective`` is the canonical name (``sdc_rate``, ``availability``,
    ``mwtf``, or ``p<q>_<hist>``); ``op`` is ``<=`` (ceiling) or ``>=``
    (floor); ``target`` the bound.  ``z`` matches the convergence
    tracker's quantile; ``min_n`` floors the effective sample count
    below which no verdict is issued (mirrors StopWhen.min_done);
    ``page_burn`` is the multi-window page threshold.
    """

    objective: str
    op: str
    target: float
    z: float = 1.96
    min_n: float = 0.0
    page_burn: float = 2.0

    def __post_init__(self):
        if self.op not in ("<=", ">="):
            raise SLOError(f"SLO op must be <= or >=, got {self.op!r}")
        kind = self.kind()
        if kind == "rate_ceiling" and self.op != "<=":
            raise SLOError(f"{self.objective} is a ceiling; use <=")
        if kind in ("availability", "mwtf") and self.op != ">=":
            raise SLOError(f"{self.objective} is a floor; use >=")
        if kind == "latency" and self.op != "<=":
            raise SLOError(f"{self.objective} is a ceiling; use <=")
        if kind in ("rate_ceiling", "availability"):
            if not (0.0 < float(self.target) < 1.0):
                raise SLOError(
                    f"{self.objective} target must be in (0, 1), got "
                    f"{self.target!r}")
        elif float(self.target) <= 0.0:
            raise SLOError(
                f"{self.objective} target must be > 0, got "
                f"{self.target!r}")
        if self.z <= 0:
            raise SLOError(f"SLO z must be > 0, got {self.z!r}")
        if self.min_n < 0:
            raise SLOError(f"SLO min_n must be >= 0, got {self.min_n!r}")
        if self.page_burn < 1.0:
            raise SLOError(
                f"SLO page_burn must be >= 1, got {self.page_burn!r}")
        if kind == "latency":
            self.latency_parts()      # reject bad quantiles at parse time

    def kind(self) -> str:
        if self.objective == "sdc_rate":
            return "rate_ceiling"
        if self.objective == "availability":
            return "availability"
        if self.objective == "mwtf":
            return "mwtf"
        if _LATENCY_RE.match(self.objective):
            return "latency"
        raise SLOError(
            f"unknown SLO objective {self.objective!r} (valid: sdc_rate, "
            "availability, mwtf, p<q>_dispatch, p<q>_gap)")

    def latency_parts(self) -> Tuple[float, str]:
        """(quantile, histogram name) for a latency objective."""
        m = _LATENCY_RE.match(self.objective)
        assert m is not None, self.objective
        q = float(m.group(1)) / 100.0
        hist = _HIST_ALIASES.get(m.group(2), m.group(2))
        if not (0.0 < q < 1.0):
            raise SLOError(
                f"latency quantile must be in (0, 100), got {m.group(1)}")
        return q, hist

    def spec(self) -> str:
        return f"{self.objective}{self.op}{self.target:g}"


@dataclasses.dataclass(frozen=True)
class SLOSet:
    """An ordered set of objectives + shared knobs, round-trippable as
    ``"sdc_rate<=0.002,availability>=0.99;z=2.576;min=4096;page=14"``
    (the StopWhen grammar discipline: comma-separated objectives, then
    ``;key=value`` knobs in any order)."""

    objectives: Tuple[SLOSpec, ...]

    def __post_init__(self):
        if not self.objectives:
            raise SLOError("SLO set needs at least one objective")
        seen = set()
        for spec in self.objectives:
            if spec.objective in seen:
                raise SLOError(
                    f"duplicate SLO objective {spec.objective!r}")
            seen.add(spec.objective)

    @classmethod
    def parse(cls, text: str) -> "SLOSet":
        body = (text or "").strip()
        if not body:
            raise SLOError("empty SLO specification")
        parts = body.split(";")
        z, min_n, page_burn = 1.96, 0.0, 2.0
        for knob in parts[1:]:
            knob = knob.strip()
            if not knob:
                continue
            key, sep, value = knob.partition("=")
            try:
                if key == "z" and sep:
                    z = float(value)
                elif key == "min" and sep:
                    min_n = float(value)
                elif key == "page" and sep:
                    page_burn = float(value)
                else:
                    raise SLOError(
                        f"unknown SLO knob {knob!r} (want z=Q, min=N, or "
                        "page=B)")
            except ValueError as e:
                raise SLOError(f"bad SLO knob {knob!r}: {e}") from e
        objectives: List[SLOSpec] = []
        for item in parts[0].split(","):
            item = item.strip()
            if not item:
                continue
            for op in ("<=", ">="):
                name, sep, value = item.partition(op)
                if sep:
                    try:
                        target = float(value)
                    except ValueError as e:
                        raise SLOError(
                            f"bad SLO target in {item!r}: {e}") from e
                    objectives.append(SLOSpec(
                        objective=name.strip(), op=op, target=target,
                        z=z, min_n=min_n, page_burn=page_burn))
                    break
            else:
                raise SLOError(
                    f"bad SLO objective {item!r} (want name<=target or "
                    "name>=target, e.g. sdc_rate<=0.002)")
        return cls(objectives=tuple(objectives))

    def spec(self) -> str:
        """Canonical round-trippable string (knobs only when shared and
        non-default)."""
        body = ",".join(o.spec() for o in self.objectives)
        first = self.objectives[0]
        if all(o.z == first.z for o in self.objectives) and \
                first.z != 1.96:
            body += f";z={first.z:g}"
        if all(o.min_n == first.min_n for o in self.objectives) and \
                first.min_n:
            body += f";min={first.min_n:g}"
        if all(o.page_burn == first.page_burn
               for o in self.objectives) and first.page_burn != 2.0:
            body += f";page={first.page_burn:g}"
        return body


# ---------------------------------------------------------------------------
# Evidence extraction: one neutral shape from every recorded surface
# ---------------------------------------------------------------------------

def evidence_from_status(doc: Mapping[str, object]) -> Dict[str, object]:
    """Evidence from a ``coast-status`` document (a live
    ``CampaignMetrics.snapshot()`` or a ``--status-json`` file):
    cumulative counts, throughput, latency histograms, and the recent
    ``sdc_rate`` ring tail for the short burn window."""
    counts = {str(k): float(v)
              for k, v in (doc.get("counts") or {}).items()}
    prof = doc.get("profile") or {}
    series = doc.get("series") or {}
    sdc_tail = [float(v) for _, v in (series.get("sdc_rate") or [])]
    elapsed = float(doc.get("elapsed_s") or 0.0)
    done = float(doc.get("done_rows") or 0.0)
    return {
        "counts": counts,
        "inj_per_sec": (done / elapsed) if elapsed > 0 else None,
        "histograms": dict(prof.get("histograms") or {}),
        "sdc_rate_recent": sdc_tail,
    }


def evidence_from_summary(doc: Mapping[str, object]) -> Dict[str, object]:
    """Evidence from a ``CampaignResult.summary()`` block (a campaign
    log head or a ``summarize`` artifact row).

    ``summary()`` flattens the class histogram into top-level keys
    (``**self.counts``) and stores the trial count under
    ``injections``; fleet worker done-records instead nest a
    ``counts`` dict.  Accept both shapes."""
    counts = {str(k): float(v)
              for k, v in (doc.get("counts") or {}).items()}
    if not counts:
        from coast_tpu_torch.inject.classify import CLASS_NAMES
        vocab = CLASS_NAMES + ("cache_invalid",)
        counts = {k: float(doc[k]) for k in vocab
                  if isinstance(doc.get(k), (int, float))}
    prof = doc.get("profile") or {}
    n = float(doc.get("n") or doc.get("injections")
              or sum(counts.values()))
    seconds = float(doc.get("seconds") or 0.0)
    hists = dict(prof.get("histograms") or {})
    if "device_seconds_histogram" in prof:
        hists.setdefault("dispatch_device_seconds",
                         prof["device_seconds_histogram"])
    if "host_gap_seconds_histogram" in prof:
        hists.setdefault("dispatch_host_gap_seconds",
                         prof["host_gap_seconds_histogram"])
    return {
        "counts": counts,
        "inj_per_sec": (n / seconds) if seconds > 0 else None,
        "histograms": hists,
        "sdc_rate_recent": [],
    }


def load_evidence(path: str) -> Dict[str, object]:
    """Evidence from a recorded file: a status JSON, a run doc with a
    ``summary`` block, a bare summary JSON, or an NDJSON campaign log
    (head line carries the summary)."""
    with open(path) as fh:
        head = fh.readline()
        doc = json.loads(head)
        if not isinstance(doc, dict):
            raise SLOError(f"not a JSON object: {path}")
        rest = fh.read().strip()
    if rest and not doc.get("format"):
        # Multi-line non-NDJSON JSON document: reparse whole.
        doc = json.loads(head + rest)
    if doc.get("format") == "coast-status":
        return evidence_from_status(doc)
    if isinstance(doc.get("summary"), dict):
        return evidence_from_summary(doc["summary"])
    if "counts" in doc or "injections" in doc:
        return evidence_from_summary(doc)
    raise SLOError(
        f"no SLO evidence in {path}: want a coast-status doc, a run doc "
        "with a summary block, or a summary JSON")


def baseline_from(path: str) -> Dict[str, object]:
    """Reduce recorded evidence (any :func:`load_evidence` surface) to
    the MWTF objective's baseline dict: the unprotected run's SDC rate
    and throughput.  Shared by the offline ``slo`` CLI and the serving
    front end's ``--baseline``, so the two cannot disagree on what an
    ``mwtf>=N`` denominator is."""
    ev = load_evidence(path)
    counts = ev.get("counts") or {}
    n = float(sum(counts.values()))
    bad = sum(float(counts.get(k, 0.0)) for k in SDC_CLASSES)
    return {"sdc_rate": (bad / n) if n > 0 else None,
            "inj_per_sec": ev.get("inj_per_sec")}


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------

def _rate_objective(spec: SLOSpec, bad: float, n: float,
                    allowed: float, recent: List[float]
                    ) -> Dict[str, object]:
    """Shared ceiling math: ``bad`` events over ``n`` effective trials
    against an allowed rate."""
    rate = bad / n if n > 0 else 0.0
    lo, hi = wilson_interval(bad, n, spec.z)
    if n < spec.min_n or n <= 0:
        attained: Optional[bool] = None
    elif hi <= allowed:
        attained = True
    elif lo > allowed:
        attained = False
    else:
        attained = None
    budget_total = allowed * n
    remaining = ((budget_total - bad) / budget_total
                 if budget_total > 0 else 0.0)
    burn_long = rate / allowed if allowed > 0 else math.inf
    burn_short = None
    if recent:
        tail = recent[-min(len(recent), 32):]
        burn_short = (sum(tail) / len(tail)) / allowed
    return {
        "observed": rate,
        "wilson": {"lo": lo, "hi": hi},
        "effective_n": n,
        "bad": bad,
        "attained": attained,
        "budget": {"allowed_rate": allowed,
                   "total": budget_total,
                   "consumed": bad,
                   "remaining_frac": remaining},
        "burn": {"long": burn_long, "short": burn_short},
    }


def _verdict(spec: SLOSpec, row: Dict[str, object]) -> str:
    """page/warn/ok from a row's burn + budget + attainment (the
    two-window rule; a missing short window falls back to the long
    one so offline artifacts still page on gross burns)."""
    if row.get("attained") is None and row.get("effective_n", 0) == 0:
        return "ok"                       # no evidence constrains nothing
    n = float(row.get("effective_n") or 0.0)
    if 0 < n < spec.min_n:
        return "ok"                       # below the sample floor
    burn = row.get("burn") or {}
    long_burn = burn.get("long")
    short_burn = burn.get("short")
    budget = row.get("budget") or {}
    remaining = budget.get("remaining_frac")
    if remaining is not None and remaining <= 0.0 and \
            (long_burn or 0.0) > 1.0:
        # Budget exhausted -- but a page must mean burning NOW, so a
        # quiet short window (the recent ring) downgrades the stale
        # spike to warn; no short window (offline artifacts) pages.
        if short_burn is None or short_burn > 1.0:
            return "page"
        return "warn"
    if long_burn is not None and long_burn >= spec.page_burn:
        if short_burn is None or short_burn >= spec.page_burn:
            return "page"
    if (long_burn is not None and long_burn > 1.0) or \
            row.get("attained") is False:
        return "warn"
    return "ok"


def _quantile_from_hist(hist: Mapping[str, object],
                        q: float) -> Optional[float]:
    """Upper bound of the smallest cumulative ``le`` bucket covering
    quantile ``q`` (Prometheus-style histogram_quantile without
    interpolation below the bound: conservative for a ceiling check).
    None when empty or when ``q`` lands in the +Inf bucket."""
    count = int(hist.get("count") or 0)
    if count <= 0:
        return None
    need = q * count
    for bound, cum in zip(hist.get("le") or (),
                          hist.get("counts") or ()):
        if float(cum) >= need:
            return float(bound)
    return None                           # beyond the last finite bound


def _eval_one(spec: SLOSpec, evidence: Mapping[str, object],
              baseline: Optional[Mapping[str, object]]
              ) -> Dict[str, object]:
    counts = {str(k): float(v)
              for k, v in (evidence.get("counts") or {}).items()}
    n = float(sum(counts.values()))
    kind = spec.kind()
    recent = list(evidence.get("sdc_rate_recent") or [])

    if kind == "rate_ceiling":
        bad = sum(counts.get(k, 0.0) for k in SDC_CLASSES)
        row = _rate_objective(spec, bad, n, float(spec.target), recent)
    elif kind == "availability":
        bad = sum(counts.get(k, 0.0) for k in DUE_CLASSES)
        allowed = 1.0 - float(spec.target)
        row = _rate_objective(spec, bad, n, allowed, [])
        row["observed"] = 1.0 - (bad / n if n > 0 else 0.0)
    elif kind == "mwtf":
        row = _eval_mwtf(spec, counts, n, evidence, baseline)
    else:
        row = _eval_latency(spec, evidence)

    row["objective"] = spec.objective
    row["op"] = spec.op
    row["target"] = float(spec.target)
    row["verdict"] = _verdict(spec, row)
    return row


def _eval_mwtf(spec: SLOSpec, counts, n, evidence, baseline
               ) -> Dict[str, object]:
    """MWTF improvement vs a recorded baseline, the ``compare_runs``
    definition: (baseline sdc rate / ours) / (our seconds-per-injection
    / baseline's).  Without a baseline the objective reports no data
    (None attainment, zero burn) rather than inventing one."""
    base = baseline or {}
    base_rate = base.get("sdc_rate")
    base_ips = base.get("inj_per_sec")
    ips = evidence.get("inj_per_sec")
    empty = {
        "observed": None, "effective_n": n, "attained": None,
        "budget": {"allowed_rate": None, "total": None,
                   "consumed": None, "remaining_frac": None},
        "burn": {"long": None, "short": None},
    }
    if base_rate is None or n <= 0:
        return empty
    bad = sum(counts.get(k, 0.0) for k in SDC_CLASSES)
    # Rare-event honesty: a zero observed rate uses the Wilson upper
    # bound instead, so "no SDC seen yet" never claims infinite MWTF.
    _, hi = wilson_interval(bad, n, spec.z)
    rate = max(bad / n if bad > 0 else hi, 1e-12)
    improvement = float(base_rate) / rate
    runtime_x = 1.0
    if base_ips and ips:
        runtime_x = float(base_ips) / float(ips)  # sec/inj ratio
        runtime_x = max(runtime_x, 1e-12)
    mwtf = improvement / runtime_x
    burn = float(spec.target) / max(mwtf, 1e-12)
    attained: Optional[bool] = None
    if n >= spec.min_n:
        attained = mwtf >= float(spec.target)
    return {
        "observed": mwtf,
        "effective_n": n,
        "attained": attained,
        "budget": {"allowed_rate": None, "total": None, "consumed": None,
                   "remaining_frac": (1.0 - burn)},
        "burn": {"long": burn, "short": None},
    }


def _eval_latency(spec: SLOSpec, evidence) -> Dict[str, object]:
    q, hist_name = spec.latency_parts()
    hist = (evidence.get("histograms") or {}).get(hist_name) or {}
    count = int(hist.get("count") or 0)
    empty = {
        "observed": None, "effective_n": 0, "attained": None,
        "budget": {"allowed_rate": None, "total": None,
                   "consumed": None, "remaining_frac": None},
        "burn": {"long": None, "short": None},
    }
    if count <= 0:
        return empty
    observed = _quantile_from_hist(hist, q)
    # Bad events: observations ABOVE the target bound; allowed:
    # (1-q) of the population -- the latency budget.
    above = count
    for bound, cum in zip(hist.get("le") or (),
                          hist.get("counts") or ()):
        if float(bound) >= float(spec.target):
            above = count - int(cum)
            break
    allowed = (1.0 - q) * count
    burn = above / allowed if allowed > 0 else math.inf
    attained: Optional[bool] = None
    if count >= spec.min_n:
        if observed is not None and observed <= float(spec.target):
            attained = True
        elif burn > 1.0:
            attained = False
    remaining = ((allowed - above) / allowed if allowed > 0 else 0.0)
    return {
        "observed": observed,
        "effective_n": count,
        "bad": above,
        "attained": attained,
        "budget": {"allowed_rate": 1.0 - q, "total": allowed,
                   "consumed": above, "remaining_frac": remaining},
        "burn": {"long": burn, "short": None},
    }


def worst_verdict(verdicts) -> str:
    worst = "ok"
    for v in verdicts:
        if VERDICTS.index(v) > VERDICTS.index(worst):
            worst = v
    return worst


def evaluate(slo_set: SLOSet, evidence: Mapping[str, object],
             baseline: Optional[Mapping[str, object]] = None
             ) -> Dict[str, object]:
    """The one evaluation everybody calls (live hub, CLI, fleet): a
    JSON-able report with per-objective rows and the worst verdict.

    ``baseline`` feeds the MWTF objective: ``{"sdc_rate": r,
    "inj_per_sec": s}`` from an unprotected run's recorded evidence.
    """
    rows = [_eval_one(spec, evidence, baseline)
            for spec in slo_set.objectives]
    burning = [r["objective"] for r in rows if r["verdict"] != "ok"]
    return {
        "spec": slo_set.spec(),
        "objectives": rows,
        "verdict": worst_verdict(r["verdict"] for r in rows),
        "burning": burning,
    }


def summary_block(report: Mapping[str, object]) -> Dict[str, object]:
    """The compact ``Summary.slo`` / ``CampaignResult.slo`` form: per
    objective attainment, budget remaining, burn rate -- the numbers a
    human reads off a run record (rounded; the full report stays in
    artifacts)."""
    out: Dict[str, object] = {
        "spec": report.get("spec"),
        "verdict": report.get("verdict"),
        "burning": list(report.get("burning") or []),
        "objectives": {},
    }
    for row in report.get("objectives") or []:
        budget = row.get("budget") or {}
        burn = row.get("burn") or {}
        out["objectives"][row["objective"]] = {
            "target": row.get("target"),
            "op": row.get("op"),
            "observed": _round6(row.get("observed")),
            "attained": row.get("attained"),
            "budget_remaining_frac": _round6(
                budget.get("remaining_frac")),
            "burn_rate": _round6(burn.get("long")),
            "verdict": row.get("verdict"),
        }
    return out


def status_line(report: Optional[Mapping[str, object]]) -> Optional[str]:
    """One live status fragment for the heartbeat/console: the worst
    verdict, the worst-burning objective and its remaining budget --
    ``slo PAGE sdc_rate burn 3.2x budget 8%`` -- or ``slo ok``.  None
    when there is no report yet."""
    if not report:
        return None
    verdict = str(report.get("verdict") or "ok")
    if verdict == "ok":
        return "slo ok"
    rows = [r for r in (report.get("objectives") or [])
            if r.get("verdict") != "ok"]

    def _severity(row):
        burn = (row.get("burn") or {}).get("long")
        return (VERDICTS.index(row.get("verdict", "warn")),
                burn if burn is not None else 0.0)

    if not rows:
        return f"slo {verdict}"
    worst = max(rows, key=_severity)
    frag = f"slo {verdict.upper()} {worst['objective']}"
    burn = (worst.get("burn") or {}).get("long")
    if burn is not None:
        frag += f" burn {burn:.1f}x"
    remaining = (worst.get("budget") or {}).get("remaining_frac")
    if remaining is not None:
        frag += f" budget {100.0 * remaining:.0f}%"
    return frag


def _round6(value):
    if isinstance(value, float):
        if math.isinf(value):
            return value
        return round(value, 6)
    return value
