"""Statistical convergence tracking: Wilson intervals + early stop.

A campaign's purpose is an estimate -- the per-class rates of the
classification distribution -- and an estimate has a precision.  The
reference platform sizes campaigns by a crude proxy ("inject until N
errors seen, then round up", supervisor.py:339); FastFlip
(arXiv:2403.13989) makes the sharper observation that injection work
should stop the moment additional samples stop changing the answer.
This module supplies the machinery:

  * :func:`wilson_interval` -- the Wilson score interval for a binomial
    proportion.  Chosen over the normal approximation because campaign
    classes are routinely rare (SDC under TMR is ~0) and Wilson behaves
    at p=0/p=1 and small n where Wald collapses to a zero-width lie.
  * :class:`ConvergenceTracker` -- feeds on the cumulative class
    histogram after every collected batch (weighted counts included:
    equivalence-reduced campaigns converge over *effective*
    injections) and reports per-class rate + CI.
  * :class:`StopWhen` -- the opt-in early-stop condition: named target
    classes each with a CI half-width threshold, plus the z quantile
    and a minimum sample floor.  ``parse``/``spec`` round-trip a
    canonical string so the condition can ride in a journal header as
    campaign identity (resuming under a different stop rule must
    refuse, exactly like a different seed).

The tracker is pure arithmetic over the counts the campaign loop
already maintains -- no extra device work, no extra host passes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple

__all__ = ["wilson_interval", "interval_table", "intervals_overlap",
           "StopWhen", "ConvergenceTracker", "StopWhenError"]

#: Valid stop-condition target classes: the classifier taxonomy plus the
#: cache_invalid bucket the campaign counts alongside it.
_VALID_CLASSES = ("success", "corrected", "sdc", "due_abort",
                  "due_timeout", "invalid", "due_stack_overflow",
                  "due_assert", "train_self_heal", "train_sdc",
                  "cache_invalid")


class StopWhenError(ValueError):
    """A malformed --stop-when specification."""


def wilson_interval(k: float, n: float, z: float = 1.96
                    ) -> Tuple[float, float]:
    """Wilson score interval for ``k`` successes in ``n`` trials.

    Accepts float counts: equivalence-reduced campaigns feed *weighted*
    (effective) counts, and the interval arithmetic is identical.
    ``n <= 0`` returns the vacuous ``(0, 1)`` -- no data constrains
    nothing.
    """
    if n <= 0:
        return (0.0, 1.0)
    p = k / n
    z2 = z * z
    denom = 1.0 + z2 / n
    center = (p + z2 / (2.0 * n)) / denom
    half = (z / denom) * math.sqrt(p * (1.0 - p) / n
                                   + z2 / (4.0 * n * n))
    return (max(0.0, center - half), min(1.0, center + half))


@dataclasses.dataclass(frozen=True)
class StopWhen:
    """Early-stop condition: every target class's CI half-width must
    drop to (or below) its threshold.

    ``targets`` maps class name -> half-width threshold (absolute rate
    units: 0.001 means the class rate is known to about +-0.1%).
    ``z`` is the normal quantile (1.96 ~ 95%, 2.576 ~ 99%).
    ``min_done`` floors the sample count so a lucky first batch of an
    all-success campaign cannot stop it before the rare classes had any
    chance to appear.
    """

    targets: Mapping[str, float]
    z: float = 1.96
    min_done: int = 0

    def __post_init__(self):
        if not self.targets:
            raise StopWhenError("stop_when needs at least one "
                                "class:half_width target")
        for cls_name, hw in self.targets.items():
            if cls_name not in _VALID_CLASSES:
                raise StopWhenError(
                    f"unknown class {cls_name!r} in stop_when (valid: "
                    f"{', '.join(_VALID_CLASSES)})")
            if not (0.0 < float(hw) < 1.0):
                raise StopWhenError(
                    f"stop_when half-width for {cls_name!r} must be in "
                    f"(0, 1), got {hw!r}")
        if self.z <= 0:
            raise StopWhenError(f"stop_when z must be > 0, got {self.z!r}")
        if self.min_done < 0:
            raise StopWhenError(
                f"stop_when min_done must be >= 0, got {self.min_done!r}")

    @classmethod
    def parse(cls, spec: str) -> "StopWhen":
        """``"sdc:0.002,due_abort:0.01;z=2.576;min=4096"`` -> StopWhen.

        Comma-separated ``class:half_width`` targets, then optional
        ``;z=`` / ``;min=`` knobs in any order.
        """
        text = (spec or "").strip()
        if not text:
            raise StopWhenError("empty stop_when specification")
        parts = text.split(";")
        targets: Dict[str, float] = {}
        for pair in parts[0].split(","):
            pair = pair.strip()
            if not pair:
                continue
            name, sep, value = pair.partition(":")
            if not sep:
                raise StopWhenError(
                    f"bad stop_when target {pair!r} (want "
                    "class:half_width, e.g. sdc:0.002)")
            try:
                targets[name.strip()] = float(value)
            except ValueError as e:
                raise StopWhenError(
                    f"bad stop_when half-width in {pair!r}: {e}") from e
        z, min_done = 1.96, 0
        for knob in parts[1:]:
            knob = knob.strip()
            if not knob:
                continue
            key, sep, value = knob.partition("=")
            try:
                if key == "z" and sep:
                    z = float(value)
                elif key == "min" and sep:
                    min_done = int(value)
                else:
                    raise StopWhenError(
                        f"unknown stop_when knob {knob!r} (want z=Q or "
                        "min=N)")
            except ValueError as e:
                raise StopWhenError(
                    f"bad stop_when knob {knob!r}: {e}") from e
        return cls(targets=targets, z=z, min_done=min_done)

    def spec(self) -> str:
        """Canonical round-trippable string (sorted targets, knobs only
        when non-default) -- the journal-header identity form."""
        body = ",".join(f"{k}:{self.targets[k]:g}"
                        for k in sorted(self.targets))
        if self.z != 1.96:
            body += f";z={self.z:g}"
        if self.min_done:
            body += f";min={self.min_done}"
        return body


def interval_table(counts: Mapping[str, float], z: float = 1.96,
                   ensure: "Optional[tuple]" = None
                   ) -> Dict[str, Dict[str, float]]:
    """{class: {count, rate, lo, hi, half_width}} over a counts
    histogram -- the one shared shape every surface renders (tracker
    reports, /status rates, console rows).  ``ensure`` forces rows for
    named zero-count classes (stop targets: their shrinking upper bound
    IS the convergence story for rare events)."""
    total = float(sum(counts.values()))
    names = {k: float(v) for k, v in counts.items()}
    for k in ensure or ():
        names.setdefault(k, 0.0)
    out: Dict[str, Dict[str, float]] = {}
    for k in sorted(names):
        count = names[k]
        lo, hi = wilson_interval(count, total, z)
        out[k] = {
            "count": count,
            "rate": (count / total) if total else 0.0,
            "lo": lo,
            "hi": hi,
            "half_width": (hi - lo) / 2.0,
        }
    return out


def intervals_overlap(a: Mapping[str, float],
                      b: Mapping[str, float]) -> bool:
    """Whether two ``{lo, hi}`` interval rows (the :func:`interval_table`
    shape) intersect.  Closed-interval semantics: touching endpoints
    count as overlap -- the two estimates are still mutually consistent.
    The one overlap rule shared by the comparison surface
    (``json_parser.compare_runs``) and the protection-regression CI's
    drift verdict."""
    return (float(a["lo"]) <= float(b["hi"])
            and float(b["lo"]) <= float(a["hi"]))


class ConvergenceTracker:
    """Per-class Wilson CIs over a campaign's cumulative counts.

    Feed :meth:`update` the same ``counts_so_far`` histogram the
    campaign loop hands its progress callback after every collected
    batch (weighted counts for reduced campaigns); ``converged`` flips
    True once every target class's CI half-width is at or below its
    threshold.  A tracker without a :class:`StopWhen` still tracks --
    it just never stops anything (the metrics/status surfaces want the
    intervals regardless).
    """

    def __init__(self, stop_when: Optional[StopWhen] = None):
        self.stop_when = stop_when
        self.total = 0.0
        self.counts: Dict[str, float] = {}

    def update(self, counts: Mapping[str, float]) -> None:
        """Replace the tracked histogram with the new cumulative one."""
        self.counts = {k: float(v) for k, v in counts.items()}
        self.total = float(sum(self.counts.values()))

    def interval(self, cls_name: str) -> Tuple[float, float]:
        z = self.stop_when.z if self.stop_when is not None else 1.96
        return wilson_interval(self.counts.get(cls_name, 0.0),
                               self.total, z)

    def intervals(self) -> Dict[str, Dict[str, float]]:
        """Per-class interval table over every class seen so far, plus
        zero-count rows for the stop targets."""
        z = self.stop_when.z if self.stop_when is not None else 1.96
        ensure = (tuple(self.stop_when.targets)
                  if self.stop_when is not None else None)
        return interval_table(self.counts, z, ensure=ensure)

    @property
    def converged(self) -> bool:
        if self.stop_when is None or self.total <= 0:
            return False
        if self.total < self.stop_when.min_done:
            return False
        for cls_name, threshold in self.stop_when.targets.items():
            lo, hi = self.interval(cls_name)
            if (hi - lo) / 2.0 > threshold:
                return False
        return True

    def report(self, stopped: bool, planned_n: int,
               done_n: int) -> Dict[str, object]:
        """The ``CampaignResult.convergence`` block: what the campaign
        knew when it finished (or stopped)."""
        out: Dict[str, object] = {
            "stopped": bool(stopped),
            "planned_n": int(planned_n),
            "done_n": int(done_n),
            "z": (self.stop_when.z if self.stop_when is not None
                  else 1.96),
            "intervals": {
                k: {kk: round(vv, 8) for kk, vv in v.items()}
                for k, v in self.intervals().items()},
        }
        if self.stop_when is not None:
            out["stop_when"] = self.stop_when.spec()
        return out
