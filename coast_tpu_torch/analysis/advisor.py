"""Selective-hardening advisor: data-driven xMR scope recommendations.

The counterpart of ``coast_tpu/analysis/advisor.py``.  The reference
leaves protection scope to the user (hand-composed ``-ignoreGlbls`` /
``-cloneGlbls`` lists, iterated against campaigns by hand).  The advisor
automates that loop: inject into the *unprotected* program on its device,
attribute SDC/DUE/INVALID outcomes to the state leaf that was hit, and
greedily protect the highest-harm leaves -- closed over the SoR rules so
the verifier accepts the result -- until a target residual harm rate is
met.  The output is both region annotations and a functions.config
snippet (``cloneGlbls=`` / ``ignoreGlbls=``).

Every campaign runs on the program's device through the port's
:class:`~coast_tpu_torch.inject.campaign.CampaignRunner` (K1 on the card
for the validation builds); ``device="cpu"`` runs them on the host.  The
``static_seed`` prior reads the static vulnerability map
(``analysis/propagation``), which is host analysis of the CPU capture.

CLI: ``python -m coast_tpu_torch.analysis.advisor <benchmark> [-e N]
[-t RATE] [--seed S] [--no-validate] [--cost-aware] [--static-seed]
[-o functions.config] [-d cpu]``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, FrozenSet, List, Optional, Tuple

import numpy as np

from coast_tpu_torch import device as device_mod
from coast_tpu_torch.inject import classify as cls
from coast_tpu_torch.inject.campaign import (CampaignResult, CampaignRunner,
                                             _rows_subset)
from coast_tpu_torch.inject.schedule import generate_stratified_total
from coast_tpu_torch.ir.region import KIND_CTRL, KIND_RO, LeafSpec, Region
from coast_tpu_torch.passes.strategies import TMR, unprotected
from coast_tpu_torch.passes.verification import RegionDataflow, analyze

__all__ = ["LeafHarm", "Advice", "advise", "main"]


@dataclasses.dataclass
class LeafHarm:
    """Campaign attribution for one injectable leaf of the unprotected run."""

    name: str
    injections: int
    sdc: int
    due: int
    invalid: int
    words: int

    @property
    def harm(self) -> int:
        """Bad outcomes attributed to this leaf.  INVALID counts: a flip
        that corrupts the check machinery itself is still a corruption
        that protection would have masked."""
        return self.sdc + self.due + self.invalid

    @property
    def harm_rate(self) -> float:
        """P(SDC, DUE or INVALID | flip lands in this leaf)."""
        return self.harm / self.injections if self.injections else 0.0

    @property
    def harm_ci95(self) -> Tuple[float, float]:
        """Wilson 95% interval on harm_rate."""
        n = self.injections
        if not n:
            return (0.0, 1.0)
        z = 1.959963984540054
        phat = self.harm / n
        denom = 1 + z * z / n
        centre = phat + z * z / (2 * n)
        half = z * math.sqrt(phat * (1 - phat) / n + z * z / (4 * n * n))
        return (max(0.0, (centre - half) / denom),
                min(1.0, (centre + half) / denom))


@dataclasses.dataclass
class Advice:
    region_name: str
    target_harm: float
    ranked: List[LeafHarm]              # harm-descending attribution table
    protect: List[str]                  # leaves to replicate (SoR-closed)
    annotations: Dict[str, LeafSpec]    # selective spec (xmr islands)
    baseline: Dict[str, object]         # unprotected campaign summary
    achieved: Optional[Dict[str, object]] = None   # selective TMR summary
    full: Optional[Dict[str, object]] = None       # full TMR summary
    protected_words: int = 0
    total_words: int = 0
    baseline_rate: float = 0.0          # post-stratified population estimate
    # static_seed=True: the per-leaf static vulnerability verdicts the
    # probe campaign was seeded with (analysis/propagation).
    static_verdicts: Optional[Dict[str, str]] = None

    @property
    def config_text(self) -> str:
        """functions.config-style snippet: the protect list as cloneGlbls,
        the rest as ignoreGlbls."""
        ignore = [h.name for h in self.ranked if h.name not in self.protect]
        return ("# selective xMR scope recommended by coast_tpu advisor\n"
                f"cloneGlbls={','.join(self.protect)}\n"
                f"ignoreGlbls={','.join(ignore)}\n")

    def format(self) -> str:
        lines = [f"--- selective-hardening advice: {self.region_name} ---",
                 f"  {'leaf':<18} {'inj':>6} {'sdc':>6} {'due':>5} "
                 f"{'inv':>5} {'words':>6}  harm% (95% CI)      protect"]
        for h in self.ranked:
            mark = "xMR" if h.name in self.protect else "-"
            lo, hi = h.harm_ci95
            lines.append(
                f"  {h.name:<18} {h.injections:>6} {h.sdc:>6} {h.due:>5} "
                f"{h.invalid:>5} {h.words:>6}  {100 * h.harm_rate:5.1f} "
                f"[{100 * lo:4.1f},{100 * hi:5.1f}]  {mark}")
        lines.append(f"  replicated words: {self.protected_words}"
                     f"/{self.total_words}")
        lines.append(f"  unprotected harm rate: "
                     f"{100 * self.baseline_rate:.2f}% "
                     f"(post-stratified estimate)")
        if self.achieved is not None:
            lines.append(f"  selective TMR harm rate: "
                         f"{100 * harm_rate(self.achieved):.2f}%")
        if self.full is not None:
            lines.append(f"  full TMR harm rate: "
                         f"{100 * harm_rate(self.full):.2f}%")
        return "\n".join(lines)


def harm_rate(summary: Dict[str, object]) -> float:
    """SDC + DUE + INVALID over the injections of a campaign summary."""
    n = summary["injections"]
    bad = (sum(summary.get(k, 0) for k in cls.SDC_CLASSES)
           + summary["due_abort"] + summary["due_timeout"]
           + summary["invalid"])
    return bad / n if n else 0.0


def _leaf_harms(res: CampaignResult, runner: CampaignRunner) -> List[LeafHarm]:
    codes = res.codes
    lids = np.asarray(res.schedule.leaf_id)
    harms = []
    for sec in runner.mmap.sections:
        sel = codes[lids == sec.leaf_id]
        binc = np.bincount(sel, minlength=cls.NUM_CLASSES)
        harms.append(LeafHarm(
            name=sec.name,
            injections=int(len(sel)),
            sdc=int(binc[cls.SDC] + binc[cls.TRAIN_SDC]),
            due=int(binc[cls.DUE_ABORT] + binc[cls.DUE_TIMEOUT]),
            invalid=int(binc[cls.INVALID]),
            words=int(sec.words * sec.lanes)))
    harms.sort(key=lambda h: (-h.harm_rate, h.name))
    return harms


def _sor_closure(region: Region, flow: RegionDataflow,
                 chosen: FrozenSet[str]) -> FrozenSet[str]:
    """Close the protect set under the verifier's rules so the recommended
    config always builds:

    * NotProtected->Protected: a replicated leaf may not read a *mutable*
      unprotected leaf, so every mutable transitive source joins the set;
    * unvoted control: once anything is replicated, every KIND_CTRL leaf
      must be too, so all ctrl leaves join the set.
    """
    closed = set(chosen)
    if closed:
        closed |= {n for n, s in region.spec.items() if s.kind == KIND_CTRL}
    frontier = list(closed)
    while frontier:
        name = frontier.pop()
        for src in flow.deps.get(name, frozenset()):
            if src != name and src in flow.written and src not in closed:
                closed.add(src)
                frontier.append(src)
    return frozenset(closed)


def _selective_region(region: Region, protect_set: FrozenSet[str]) -> Region:
    spec = {}
    for name, s in region.spec.items():
        spec[name] = dataclasses.replace(s, xmr=(name in protect_set))
    return dataclasses.replace(region, spec=spec, default_xmr=False)


def advise(region: Region,
           budget: int = 8192,
           target_harm: float = 0.0,
           seed: int = 0,
           batch_size: int = 2048,
           validate: bool = True,
           stratified: bool = True,
           cost_aware: bool = False,
           static_seed: bool = False,
           device=device_mod.DEFAULT) -> Advice:
    """Recommend a selective xMR scope for ``region``.

    ``budget`` faults are injected into the unprotected program on
    ``device`` (equal-allocation stratified across leaves by default);
    leaves are protected greedily by population harm contribution
    (SoR-closed at every step) until the post-stratified residual harm
    rate is <= ``target_harm``.  ``cost_aware=True`` switches the greedy
    to marginal harm removed per replicated word added.  ``validate=True``
    reruns the campaign against the recommended selective TMR and full TMR
    for the achieved rates.

    ``static_seed=True`` seeds the loop with the static vulnerability map:
    leaves it proves ``masked`` are dropped from the probe schedule (their
    strata go to leaves that can harm), and the protect list is ordered by
    verdict tier (``sdc-possible`` first), then measured population harm
    contribution within a tier.
    """
    runner = CampaignRunner(unprotected(region, device=device),
                            strategy_name="none")
    static_verdicts: Optional[Dict[str, str]] = None
    masked_names: FrozenSet[str] = frozenset()
    if static_seed:
        from coast_tpu_torch.analysis.propagation import (VERDICT_MASKED,
                                                          analyze_propagation)
        vmap = analyze_propagation(runner.prog)
        static_verdicts = vmap.section_verdicts()
        masked_names = frozenset(n for n, v in static_verdicts.items()
                                 if v == VERDICT_MASKED)
    if stratified:
        # Equal allocation: every leaf measured at the same resolution;
        # population rates are recovered below by size reweighting.
        n_sections = len(runner.mmap.sections)
        n_live = max(1, n_sections - len(masked_names))
        # Static seeding reallocates the provably masked strata.
        probe_total = budget * n_sections // n_live if masked_names \
            else budget
        sched = generate_stratified_total(runner.mmap, probe_total, seed,
                                          region.nominal_steps)
        if masked_names:
            lid_of = {s.leaf_id: s.name for s in runner.mmap.sections}
            keep = np.flatnonzero(np.array(
                [lid_of.get(int(l), "?") not in masked_names
                 for l in np.asarray(sched.leaf_id)]))
            sched = _rows_subset(sched, keep)
        # One-shot campaign: the batch is clamped to the schedule, so a
        # small budget pays for no padding rows.
        base = runner.run_schedule(sched, min(batch_size, len(sched)))
    else:
        base = runner.run(budget, seed=seed, batch_size=batch_size)
    harms = _leaf_harms(base, runner)
    flow = analyze(region)

    # Post-stratified population estimate: each leaf's conditional harm
    # rate weighted by its share of the injectable bit space.
    weight = {s.name: s.bits / runner.mmap.total_bits
              for s in runner.mmap.sections}

    def pop_rate(excluded: FrozenSet[str]) -> float:
        return sum(weight[h.name] * h.harm_rate for h in harms
                   if h.name not in excluded)

    protect_set: FrozenSet[str] = frozenset()
    by_name = {h.name: h for h in harms}

    def protectable(h: LeafHarm) -> bool:
        # Never-cloned rule: read-only leaves are unprotectable; their
        # harm stays in the residual.
        return (h.harm > 0 and h.name in region.spec
                and region.spec[h.name].kind != KIND_RO)

    if cost_aware:
        # Each step protects the candidate whose SoR-closed addition
        # removes the most population harm per replicated word added.
        while pop_rate(protect_set) > target_harm:
            cur = pop_rate(protect_set)
            best = None
            for h in harms:
                if h.name in protect_set or not protectable(h):
                    continue
                cand = _sor_closure(region, flow, protect_set | {h.name})
                benefit = cur - pop_rate(cand)
                if benefit <= 0:
                    continue
                cost = sum(by_name[n].words for n in cand - protect_set
                           if n in by_name)
                score = benefit / max(cost, 1)
                if best is None or score > best[0]:
                    best = (score, cand)
            if best is None:
                break
            protect_set = best[1]
    else:
        # Greedy by population harm contribution (weight x rate).
        for h in sorted(harms,
                        key=lambda x: (-weight[x.name] * x.harm_rate,
                                       x.name)):
            if pop_rate(protect_set) <= target_harm:
                break
            if h.harm == 0:
                break
            if h.name in protect_set or not protectable(h):
                continue
            protect_set = _sor_closure(region, flow, protect_set | {h.name})

    annotations = _selective_region(region, protect_set).spec
    if static_verdicts is not None:
        # Verdict tier first, harm contribution within a tier.
        tier = {"sdc-possible": 0, "detected-bounded": 1, "masked": 2}
        protect_list = sorted(
            (h.name for h in harms if h.name in protect_set),
            key=lambda nm: (tier.get(static_verdicts.get(nm, ""), 0),
                            -(weight.get(nm, 0.0)
                              * by_name[nm].harm_rate),
                            nm)) + sorted(protect_set - set(by_name))
    else:
        protect_list = ([h.name for h in harms if h.name in protect_set]
                        + sorted(protect_set - set(by_name)))
    advice = Advice(
        region_name=region.name,
        target_harm=target_harm,
        ranked=harms,
        # The full closed set (harm-table order first, then closure
        # members outside it), so config_text round-trips to the
        # validated scope.
        protect=protect_list,
        annotations=annotations,
        baseline=base.summary(),
        protected_words=sum(by_name[n].words for n in protect_set
                            if n in by_name),
        total_words=sum(h.words for h in harms),
        baseline_rate=pop_rate(frozenset()),
        static_verdicts=static_verdicts,
    )

    if validate and protect_set:
        sel_prog = TMR(_selective_region(region, protect_set), device=device)
        sel = CampaignRunner(sel_prog, strategy_name="TMR-selective").run(
            budget, seed=seed, batch_size=batch_size)
        advice.achieved = sel.summary()
        full = CampaignRunner(TMR(region, device=device),
                              strategy_name="TMR").run(
            budget, seed=seed, batch_size=batch_size)
        advice.full = full.summary()
    return advice


def main(argv=None) -> int:
    """``python -m coast_tpu_torch.analysis.advisor <benchmark> [-e N]
    [-t RATE] [--seed S] [-o functions.config] [-d cpu]`` -- recommend a
    selective scope for a registered benchmark and optionally write the
    config snippet."""
    import argparse
    import sys

    from coast_tpu_torch.models import REGISTRY, resolve_region

    ap = argparse.ArgumentParser(
        prog="coast_tpu_torch.analysis.advisor",
        description="data-driven selective-xMR scope recommendation")
    ap.add_argument("benchmark",
                    help="registry name (one of: "
                         + ", ".join(sorted(REGISTRY)) + ")")
    ap.add_argument("-e", type=int, default=8192, metavar="N",
                    help="injection budget (default 8192)")
    ap.add_argument("-t", type=float, default=0.0, metavar="RATE",
                    help="target residual harm rate, SDC+DUE+INVALID "
                         "(default 0: minimal)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-validate", action="store_true",
                    help="skip the selective/full TMR validation campaigns")
    ap.add_argument("--cost-aware", action="store_true",
                    help="greedy by harm removed per replicated word "
                         "(smaller footprint for the same target)")
    ap.add_argument("--static-seed", action="store_true",
                    help="seed the loop with the static vulnerability "
                         "prior (analysis/propagation): masked leaves "
                         "are not probed, and the protect ranking is "
                         "verdict tier + harm contribution")
    ap.add_argument("-o", metavar="PATH",
                    help="write the functions.config snippet here")
    ap.add_argument("-d", "--device", default=device_mod.DEFAULT,
                    help="device the campaigns run on (default the card; "
                         "'cpu' for the host)")
    args = ap.parse_args(argv)

    # Name validation first, so an internal KeyError inside a valid
    # model's make_region() surfaces as itself.
    if not args.benchmark.endswith(".c") and args.benchmark not in REGISTRY:
        ap.error(f"unknown benchmark: {args.benchmark!r} (or pass a .c "
                 "source path)")
    from coast_tpu_torch.frontend import LiftError
    try:
        region = resolve_region(args.benchmark, device=args.device)
    except FileNotFoundError as e:
        ap.error(f"file {e.args[0]} does not exist")
    except LiftError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1

    adv = advise(region, budget=args.e,
                 target_harm=args.t, seed=args.seed,
                 validate=not args.no_validate,
                 cost_aware=args.cost_aware,
                 static_seed=args.static_seed,
                 device=args.device)
    print(adv.format())
    if args.o:
        with open(args.o, "w") as f:
            f.write(adv.config_text)
        print(f"wrote {args.o}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
