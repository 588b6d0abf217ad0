"""Lane-isolation noninterference prover.

The counterpart of ``coast_tpu/analysis/propagation/isolation.py``, over
the captured trips of the protected step (``analysis/lint/capture.py``).

**Theorem (lane noninterference).**  For a protected program whose step
contains no *live unsanctioned cross-lane dataflow site* -- no lane-axis
collapse and no single-lane extraction outside a ``coast:voter`` /
``coast:sync:*`` / ``coast:view:*`` tag (modulo the configured single-lane
call allowlist, reported as assumptions) -- a fault injected into one
replica lane can influence another lane, a shared leaf or a step flag only
through a sanctioned voted commit.

The proof is constructive both ways:

  * when it HOLDS, the prover reports the discharged obligations: the live
    sanctioned vote tags of the capture and the configured single-lane
    call assumptions;
  * when it FAILS, every leak carries a **counterexample path**: the
    dataflow chain (``aten.op(shape)`` entries) from the unsanctioned
    cross-lane site to the step output it reaches.  Leak taint does not
    die at a later voter tag: once one lane's value has fanned out to
    every replica, all lanes agree on it and no majority can witness it.

The capture has flat SSA trips where the reference has nested jaxprs: each
distinct trip is walked from its own live unsanctioned cross-lane sites
(``provenance.cross_lane_sites``), and a site of one description in one
position of its trip is one leak source across the trips.

:func:`seeded_voter_bypass` is the generic seeded regression: every vote
returns lane 0 with no sanction tag and no miscompare.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

import torch

from coast_tpu_torch.analysis.propagation.walker import (StepFacts,
                                                         _detector_tag,
                                                         analyze_step,
                                                         cross_lane_sites,
                                                         node_entry)
from coast_tpu_torch.ops.voters import TAG_SPOF

__all__ = ["Leak", "IsolationProof", "prove_isolation",
           "seeded_voter_bypass"]

#: Cap the reported leaks (a pervasive leak reaches every output).
_MAX_LEAKS = 16
_PATH_MAX = 12


@dataclasses.dataclass(frozen=True)
class Leak:
    """One noninterference counterexample."""

    rule: str                 # "spof" | "lane-collapse"
    source: str               # the cross-lane site (operator + leaves)
    output: str               # step output (leaf or flag) reached
    path: Tuple[str, ...]     # dataflow chain site -> output

    def format(self) -> str:
        return (f"[{self.rule}] {self.source} -> output '{self.output}' "
                f"via " + " -> ".join(self.path))

    def to_dict(self) -> Dict[str, object]:
        return {"rule": self.rule, "source": self.source,
                "output": self.output, "path": list(self.path)}


@dataclasses.dataclass
class IsolationProof:
    """The prover's verdict for one protected program."""

    benchmark: str
    strategy: str
    num_clones: int
    holds: bool
    vacuous: bool                       # nothing replicated: no lanes
    leaks: List[Leak]
    total_leak_paths: int               # before the report cap
    voted_commits: List[str]            # live sanctioned tags (obligations
    #                                     the engine discharges)
    assumptions: List[str]              # accepted single-lane calls

    def summary(self) -> Dict[str, object]:
        return {
            "benchmark": self.benchmark,
            "strategy": self.strategy,
            "num_clones": self.num_clones,
            "holds": self.holds,
            "vacuous": self.vacuous,
            "leaks": [l.to_dict() for l in self.leaks],
            "total_leak_paths": self.total_leak_paths,
            "voted_commits": list(self.voted_commits),
            "assumptions": list(self.assumptions),
        }

    def format(self) -> str:
        if self.vacuous:
            return (f"isolation {self.benchmark} [{self.strategy}]: "
                    "vacuously holds (nothing replicated)")
        if self.holds:
            return (f"isolation {self.benchmark} [{self.strategy}]: "
                    f"HOLDS ({len(self.voted_commits)} voted commit(s), "
                    f"{len(self.assumptions)} single-lane-call "
                    "assumption(s))")
        lines = [f"isolation {self.benchmark} [{self.strategy}]: "
                 f"LEAK ({self.total_leak_paths} path(s))"]
        for l in self.leaks:
            lines.append("  " + l.format())
        return "\n".join(lines)


def _leak_flow(trip, inject: Dict[Tuple[int, int], int],
               roots: Dict[int, Tuple[str, ...]]
               ) -> Tuple[Dict[int, FrozenSet[int]],
                          Dict[int, Dict[int, Tuple[str, ...]]]]:
    """Forward leak reachability over one trip: leak ids enter at the
    ``inject`` sites (``(node, output)`` -> id) and flow through every
    operator, tags included.  Returns each value's leak ids and, per value
    and id, the first path that carried it there."""
    env: Dict[int, FrozenSet[int]] = {}
    path: Dict[int, Dict[int, Tuple[str, ...]]] = {}
    for i, node in enumerate(trip.nodes):
        ins = [env.get(v, frozenset()) for v in node.ins]
        union = frozenset().union(*ins) if ins else frozenset()
        for j, vid in enumerate(node.outs):
            lid = inject.get((i, j))
            taint = union if lid is None else union | {lid}
            if not taint:
                continue
            env[vid] = env.get(vid, frozenset()) | taint
            d = path.setdefault(vid, {})
            entry = node_entry(node, j)
            for l in sorted(taint):
                if l in d:
                    continue
                if l == lid:
                    p = roots[l]
                else:
                    p = next((path[v][l] for v in node.ins
                              if l in path.get(v, {})), roots[l])
                d[l] = p + (entry,) if len(p) < _PATH_MAX else p
    return env, path


def prove_isolation(prog, closed=None,
                    facts: Optional[StepFacts] = None,
                    strategy: Optional[str] = None) -> IsolationProof:
    """Prove (or refute, with counterexample paths) lane noninterference
    for ``prog``'s protected step.  Static analysis of the CPU capture: no
    run on the program's device."""
    if facts is None:
        facts = analyze_step(prog, closed=closed, track_paths=False)
    n = facts.num_clones
    strategy = strategy or f"N={n}"
    benchmark = prog.region.name

    if n <= 1 or not any(prog.replicated.get(k) for k in prog.region.spec):
        return IsolationProof(
            benchmark=benchmark, strategy=strategy, num_clones=n,
            holds=True, vacuous=True, leaks=[], total_leak_paths=0,
            voted_commits=[], assumptions=[])

    # Discharged obligations and configured assumptions, from the live tags.
    voted: Set[str] = set()
    assumptions: Set[str] = set()
    for w in facts.walks:
        for i, tag in w.walker.tags.items():
            if i not in w.live:
                continue
            if _detector_tag(tag):
                voted.add(tag)
            elif tag.startswith(TAG_SPOF):
                assumptions.add(tag[len(TAG_SPOF):])

    # The interference sources of each trip, and the leaks they reach.
    site_desc: Dict[Tuple[str, str, int], int] = {}
    descs: List[Tuple[str, str]] = []
    found: Dict[Tuple[int, str], Tuple[str, ...]] = {}
    for w in facts.walks:
        inject: Dict[Tuple[int, int], int] = {}
        roots: Dict[int, Tuple[str, ...]] = {}
        ordinal: Dict[Tuple[str, str], int] = {}
        cands = sorted(cross_lane_sites(w.walker, w.live, n),
                       key=lambda c: c["node"])
        for cand in cands:
            leaves = "+".join(sorted(cand["deps"])) or "?"
            desc = f"{cand['prim']} over {leaves}"
            if cand["kind"] == "spof" and cand.get("lane") is not None:
                desc += f" (lane {cand['lane']})"
            kind = str(cand["kind"])
            k = ordinal.get((kind, desc), 0)
            ordinal[(kind, desc)] = k + 1
            lid = site_desc.setdefault((kind, desc, k), len(descs))
            if lid == len(descs):
                descs.append((kind, desc))
            lane = cand.get("lane")
            out = 0
            if cand["kind"] == "spof" and lane is not None:
                # unbind's j-th output is lane j (provenance._Walker).
                node = w.trip.nodes[cand["node"]]
                if len(node.outs) > 1:
                    out = int(lane)
            inject[(cand["node"], out)] = lid
            roots[lid] = (desc,)
        if not inject:
            continue
        env, path = _leak_flow(w.trip, inject, roots)
        outs = {**w.trip.state_out, **w.trip.flags_out}
        for out_name in sorted(outs):
            vid = outs[out_name]
            for lid in sorted(env.get(vid, frozenset())):
                found.setdefault((lid, out_name),
                                 path.get(vid, {}).get(lid, roots[lid]))

    # Reported in output order, then by source, as the reference lists them.
    leaks: List[Leak] = []
    out_rank = {name: i for i, name in enumerate(facts.out_names)}
    order = sorted(found, key=lambda key: (
        out_rank.get(key[1], len(out_rank)), key[1], key[0]))
    for lid, out_name in order[:_MAX_LEAKS]:
        kind, desc = descs[lid]
        leaks.append(Leak(rule=kind, source=desc, output=out_name,
                          path=found[(lid, out_name)]))
    total = len(found)
    return IsolationProof(
        benchmark=benchmark, strategy=strategy, num_clones=n,
        holds=total == 0, vacuous=False, leaks=leaks,
        total_leak_paths=total, voted_commits=sorted(voted),
        assumptions=sorted(assumptions))


@contextlib.contextmanager
def seeded_voter_bypass():
    """Regression seam: build and run protected programs whose votes route
    lane 0's value around the voter -- no majority, no miscompare, no
    sanction tag.  The generic "injected-lane value reaches the served
    state" bug the isolation prover must catch on every target.

    It patches the binding points the engine reaches as module attributes
    at run time: the grouped K1 wrapper (``hopper_voters.vote_sites``) and
    its plain version (``voters.vote_sites``), the fused commit
    (``fused_step.commit_sites``) and K2's wrapper
    (``hopper_commit.commit_sites``), and the ``sync_tag`` and
    ``lane_view`` sanctions.  A bypassed build launches
    neither kernel on the card.  The capture runs when the proof needs it,
    so the context must hold the analysis as well as the build::

        with seeded_voter_bypass():
            prog = TMR(region)
            proof = prove_isolation(prog)
        assert not proof.holds and proof.leaks[0].path
    """
    from coast_tpu_torch.ops import (fused_step, hopper_commit,
                                     hopper_voters, voters)

    def bypass_vote_sites(sites, num_clones):
        # Lane 0 verbatim (its window where the site has one), and the
        # miscompare that would have latched a divergence is zero.
        values = []
        for site in sites:
            lanes = site.lanes
            if site.offsets is not None:
                lanes = voters.window(lanes, site.offsets, site.width)
            values.append(lanes[:, 0].clone())
        rows = sites[0].lanes.shape[0]
        return values, torch.zeros(len(sites), rows, dtype=torch.int32,
                                   device=sites[0].lanes.device)

    def bypass_commit_sites(sites, num_clones):
        repaired, voted = [], []
        for lanes, masks in sites:
            flipped = (lanes if masks is None
                       else (lanes.view(torch.int32) ^ masks)
                       .view(lanes.dtype))
            value = flipped[:, 0].clone()
            voted.append(value)
            # TMR's repair fans lane 0 out to every lane; DWC's lanes
            # commit as flipped.
            repaired.append(value.unsqueeze(1).expand(flipped.shape)
                            .contiguous() if num_clones == 3
                            else flipped.clone())
        rows = sites[0][0].shape[0]
        return repaired, voted, torch.zeros(
            len(sites), rows, dtype=torch.int32, device=sites[0][0].device)

    def bypass_sync(lanes, klass, leaf):
        return lanes                     # the sanction tag is dropped

    def bypass_view(lanes):
        # The DWC boundary read without its coast:view sanction: the
        # served view consumes a raw lane.
        return lanes[:, 0]

    patches = [
        (hopper_voters, "vote_sites", bypass_vote_sites),
        (voters, "vote_sites", bypass_vote_sites),
        (fused_step, "commit_sites", bypass_commit_sites),
        (hopper_commit, "commit_sites", bypass_commit_sites),
        (voters, "sync_tag", bypass_sync),
        (voters, "lane_view", bypass_view),
    ]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
