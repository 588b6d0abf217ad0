"""Redundancy-survival pass: does the program the port runs still carry
its redundancy?

The counterpart of ``coast_tpu/analysis/lint/survival.py``, with its rule
names, severities and loci.  The reference checks the *compiled* step
against XLA, which may CSE replicated computations into one.  The port has
no compiler between the step and the card: its step dispatches aten
operations eagerly and its votes are K1 and K2 launches.  So each of the
three checks reads what the port really runs:

  * **hlo-voter-missing** (error): every tagged vote of a trip must reach
    a voter.  One trip runs on the program's device and counts the
    replica sets its grouped voter calls voted (``voters.SITE_RECORDS``:
    the K1 or K2 site records on the card, the plain ``vote_sites`` sites
    on the CPU); fewer than the capture's tagged votes (a ``coast:sync:``
    tag that feeds a ``coast:voter`` tag) is a vote that never reached a
    voter.  The loci stay the reference's ``hlo:select`` (TMR) and
    ``hlo:compare``.
  * **lane-dedup** (error): the reference's semantic probe, unchanged.
    For each probed replicated leaf and each lane, one input bit is
    flipped and the step re-run on the program's device (through K1 and
    K2 on the card): a lane whose perturbation provokes no response in
    the committed state or the flags is dead weight.
  * **segment-cse** (error, segmented ``-s`` mode only): the arithmetic
    aten operations of the protected capture against those of the bare
    region step, each counted once per distinct operation on distinct
    values (the common-subexpression rule a compiler would apply): the
    unrolled lane bodies must bring ``~num_clones`` times the bare
    step's arithmetic.  The reference's floor and ratio rule hold.

Probe-site selection is the reference's: a leaf fully rewritten each step
has no one-step response channel and is skipped with a note, and voted TMR
leaves need ``count_errors`` for the correction counter to witness the
repair.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch.utils._pytree import tree_map

from coast_tpu_torch.analysis.lint.capture import Ref, Trip, capture_fn
from coast_tpu_torch.analysis.lint.findings import LintReport
from coast_tpu_torch.ops import voters

# Arithmetic operators counted by the segmented fingerprint (the
# reference's list in aten words): voter machinery (where, compares,
# and/or/not) and data movement are left out.
_SIG_OPS = ("add", "sub", "rsub", "mul", "div", "remainder", "fmod",
            "floor_divide", "bitwise_xor", "__lshift__", "__rshift__",
            "bitwise_left_shift", "bitwise_right_shift", "mm", "bmm",
            "dot", "maximum", "minimum", "pow")
_SIG_FLOOR = 8          # fingerprint is meaningless on near-empty steps
_MAX_PROBE_LEAVES = 4   # per-program probe budget (lanes x sites each)
# Bits probed per site: the bottom, middle and top of the word.
_PROBE_BITS = (0, 15, 31)
# Successive program states probed (phase-gated leaves respond only in the
# micro-step that consumes them).
_PROBE_STATES = 3


def sig_count(trip: Trip) -> int:
    """Arithmetic operations of a trip, each distinct (operator, operand
    values, arguments) counted once."""
    canon = {}
    seen = {}
    count = 0

    def key_of(x):
        return Ref(canon.get(int(x), int(x))) if isinstance(x, Ref) else x

    for node in trip.nodes:
        if not node.mutates and node.packet != "alias_update":
            key = (node.op, repr(tree_map(key_of, node.args)),
                   repr(tree_map(key_of, node.kwargs)))
            if key in seen:
                for out, first in zip(node.outs, seen[key]):
                    canon[out] = first
                continue
            seen[key] = node.outs
        if node.packet in _SIG_OPS:
            count += 1
    return count


def count_votes(trip: Trip) -> int:
    """Tagged votes of a trip: ``coast:sync:`` tags whose value a
    ``coast:voter`` tag reads (guard and CFCSS reads are tagged syncs too,
    but no voter reads them)."""
    synced = {node.outs[0] for node in trip.nodes
              if node.tag is not None and node.tag.startswith(voters.TAG_SYNC)}
    return sum(1 for node in trip.nodes
               if node.tag == voters.TAG_VOTER and node.ins[0] in synced)


def site_records(prog) -> int:
    """Replica sets one trip (t=0, one row) votes on the program's device."""
    pstate, flags = prog.init_pstate(1)
    before = voters.SITE_RECORDS
    with torch.no_grad():
        prog.step(pstate, flags, 0)
    return voters.SITE_RECORDS - before


def _flip_bit(arr: torch.Tensor, lane: int, word: int,
              bit: int) -> torch.Tensor:
    """XOR one bit of 32-bit word ``word`` of ``lane`` (one row)."""
    out = arr.clone()
    words = out.view(out.shape[0], out.shape[1], -1)
    if words.dtype != torch.int32:
        words = words.view(torch.int32)
    words[0, lane, word] ^= (1 << bit) if bit < 31 else -2 ** 31
    return out


def _tree_bytes(state, flags) -> bytes:
    return b"".join(tree[k].detach().cpu().numpy().tobytes()
                    for tree in (state, flags) for k in sorted(tree))


def _probe_leaves(prog) -> Tuple[List[str], List[str]]:
    """(probed, skipped-with-reason) leaf selections for the lane probe."""
    from coast_tpu_torch.passes.verification import analyze
    flow = analyze(prog.region)
    probed: List[str] = []
    skipped: List[str] = []
    for name in prog.leaf_order:
        if name not in prog.region.spec:
            continue                     # synthetic (CFCSS) leaves
        if not prog.replicated.get(name):
            continue
        self_dep = name in flow.deps.get(name, frozenset())
        passthrough = name not in flow.written
        if not (self_dep or passthrough):
            skipped.append(
                f"{name}: fully rewritten each step, no one-step response "
                "channel")
            continue
        voted = prog.step_sync.get(name) or prog.pre_sync.get(name)
        if (voted and prog.cfg.num_clones == 3
                and not prog.cfg.count_errors):
            skipped.append(
                f"{name}: voted leaf but -countErrors is off, repair "
                "leaves no witness")
            continue
        probed.append(name)
    for name in probed[_MAX_PROBE_LEAVES:]:
        skipped.append(f"{name}: probe budget ({_MAX_PROBE_LEAVES} "
                       "leaves per program) exhausted")
    return probed[:_MAX_PROBE_LEAVES], skipped


def lint_survival(prog, report: Optional[LintReport] = None,
                  closed: Optional[Sequence[Trip]] = None) -> LintReport:
    """Run the survival checks: one voter-count trip and the lane probe on
    ``prog.device``, the fingerprint over the capture.  ``closed``
    forwards already captured trips (a full lint captures once)."""
    from coast_tpu_torch.analysis.lint.provenance import trace_step
    cfg = prog.cfg
    region = prog.region
    if report is None:
        report = LintReport(benchmark=region.name,
                            strategy=f"N={cfg.num_clones}")
    report.passes_run.append("survival")
    n = cfg.num_clones
    if n <= 1 or not prog._any_replicated:
        return report
    if closed is None:
        closed = trace_step(prog)

    # -- voter survival -------------------------------------------------
    votes = count_votes(closed[0])
    records = site_records(prog)
    if records < votes:
        where = ("K1/K2 site records" if prog.device.type == "cuda"
                 else "plain voter sites")
        if n == 3:
            report.add(
                "hlo-voter-missing", "error", "hlo:select",
                f"one trip voted {records} replica set(s) ({where}) for "
                f"{votes} tagged TMR vote(s): majority voters never ran")
        report.add(
            "hlo-voter-missing", "error", "hlo:compare",
            f"one trip voted {records} replica set(s) ({where}) for "
            f"{votes} tagged vote(s): miscompare detection never ran")

    # -- semantic lane probe --------------------------------------------
    probed, skipped = _probe_leaves(prog)
    for reason in skipped:
        report.add("lane-probe", "note", f"leaf:{reason.split(':', 1)[0]}",
                   f"lane probe skipped -- {reason.split(': ', 1)[1]}")
    if probed:
        with torch.no_grad():
            _lane_probe(prog, probed, report)

    # -- segmented CSE fingerprint --------------------------------------
    if cfg.segmented:
        image = region.init(torch.device("cpu"))
        base = capture_fn(region.bound_step(),
                          {k: v.expand(2, *v.shape).clone()
                           for k, v in image.items()})
        s1 = sig_count(base)
        sn = sig_count(closed[0])
        if s1 < _SIG_FLOOR:
            report.add(
                "segment-cse", "note", "hlo:fingerprint",
                f"fingerprint skipped: single-lane step has only {s1} "
                f"arithmetic op(s) (< {_SIG_FLOOR}), ratio would be "
                "noise")
        elif sn < (n - 0.5) * s1:
            report.add(
                "segment-cse", "error", "hlo:fingerprint",
                f"segmented step carries {sn} distinct arithmetic op(s) "
                f"vs {s1} for a single lane (ratio {sn / s1:.2f} < "
                f"{n - 0.5}): the unrolled replica bodies were "
                "deduplicated into one fingerprint")
    return report


def _lane_probe(prog, probed: List[str], report: LintReport) -> None:
    """Flip one bit of each lane of each probed leaf at successive states
    and look for any response of the step."""
    n = prog.cfg.num_clones
    pstate_t, flags_t = prog.init_pstate(1)
    states = []
    for t in range(_PROBE_STATES):
        states.append((pstate_t, flags_t, t))
        if t + 1 < _PROBE_STATES:
            pstate_t, flags_t = prog.step(pstate_t, flags_t, t)
    bases = [_tree_bytes(*prog.step(*s)) for s in states]
    for name in probed:
        lane0 = states[0][0][name][0, 0]
        if lane0.element_size() != 4:
            report.add("lane-probe", "note", f"leaf:{name}",
                       "lane probe skipped -- leaf is not "
                       "32-bit-word addressable")
            continue
        words = lane0.numel()
        sites = sorted({0, words - 1, words // 2})
        for lane in range(n):
            responded = False
            for (pstate_s, flags_s, t_s), base in zip(states, bases):
                for word in sites:
                    for bit in _PROBE_BITS:
                        perturbed = dict(pstate_s)
                        perturbed[name] = _flip_bit(pstate_s[name], lane,
                                                    word, bit)
                        got = _tree_bytes(*prog.step(perturbed,
                                                     dict(flags_s), t_s))
                        if got != base:
                            responded = True
                            break
                    if responded:
                        break
                if responded:
                    break
            if not responded:
                report.add(
                    "lane-dedup", "error", f"leaf:{name}:lane{lane}",
                    f"perturbing lane {lane} of replicated leaf "
                    f"'{name}' (bits {list(_PROBE_BITS)} of words "
                    f"{sites}, steps 0..{_PROBE_STATES - 1}) produced no "
                    "observable response in the step: this replica was "
                    "deduplicated or never distinct -- faults there are "
                    "invisible to voting and detection")
