"""The shared fault-propagation walker: one abstract interpretation of the
protected step, consumed by the equivalence partition, the static
vulnerability map and the isolation prover.

The counterpart of ``coast_tpu/analysis/propagation/walker.py``.  The
reference walks a jaxpr; the port walks the aten operations of the trips
:func:`~coast_tpu_torch.analysis.lint.provenance.trace_step` captures
(``analysis/lint/capture.py``: the distinct trip graphs of one fault-free
run's first eight trips on the CPU).  :func:`analyze_step` returns one
:class:`StepFacts` bundle:

  * the **lane-provenance lattice** walk
    (:class:`~coast_tpu_torch.analysis.lint.provenance._Walker`, one a
    trip) and its cross-lane collapse candidates;
  * the **structural-taint walk** (:class:`_TaintWalk`: verbatim-word flow
    through selects, slices, index writes and views, killed at sanctioned
    vote tags, ``value_fed`` where a live operation consumes taint
    non-structurally), with optional witness paths (:class:`TraceTaint`);
  * backward **liveness** a trip (``provenance.live_nodes``);
  * the per-step **influence** edges (:class:`_InfluenceWalk`);
  * per-leaf roles (consumed, written from the region's own dataflow
    declaration, lane-flagged) and region-level hazards (guards, CFCSS,
    single-lane function scopes, the training fallback);
  * the **check() cone**: which leaves the self-check reads.

Every fact is the union over the captured trip graphs: a trip is the
branch of the step that ran, so the union stands for the reference's
``cond`` and ``while`` joins.  That union is sound only while the capture
holds every distinct trip graph of the fault-free run.  Over the registry's
36 regions, TMR and DWC, eight trips (``capture.MAX_TRIPS``) do, up to
constant operands (simd's trips differ only in the offsets ``t`` picks);
``tests/test_torch_walker.py`` pins the graphs and the facts of eight
trips against a capture of the whole run.

The reference's structural primitives have these aten counterparts (the
``_STRUCTURAL`` table below); their steering operands (a ``where``
condition, every index tensor, a ``masked_fill`` mask) feed a value.  A
bitcast (``view.dtype``) is not structural, as ``bitcast_convert_type`` is
not in the reference's list.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Iterator, List, Optional, Set, Tuple

import torch

from coast_tpu_torch.analysis.lint.capture import (BATCH, SHAPE_ONLY, Ref,
                                                   Trip, capture_fn)
from coast_tpu_torch.analysis.lint.provenance import (StepWalk, _Val,
                                                      _Walker,
                                                      cross_lane_sites,
                                                      trace_step, walk_trips)
from coast_tpu_torch.ops.voters import TAG_SPOF, TAG_SYNC, TAG_VIEW, TAG_VOTER

__all__ = ["StepFacts", "TraceTaint", "analyze_step", "cross_lane_sites",
           "node_entry"]

# Operators that move words verbatim: a flipped word passes through them
# unchanged (or is dropped), never arithmetically transformed.  The capture
# names an in-place write's new version of a tensor written through a view
# ``alias_update``: it joins the old words and the written ones.
_STRUCTURAL = frozenset({
    "select", "slice", "narrow", "unbind", "split", "split_with_sizes",
    "view", "_unsafe_view", "reshape", "_reshape_alias", "view_as",
    "permute", "transpose", "t", "expand", "expand_as", "squeeze",
    "unsqueeze", "cat", "concat", "stack", "clone", "copy", "copy_",
    "contiguous", "index", "_unsafe_index", "index_select", "gather",
    "index_put", "index_put_", "_index_put_impl_", "index_copy",
    "index_copy_", "scatter", "scatter_", "select_scatter",
    "slice_scatter", "where", "masked_fill", "masked_fill_", "flip",
    "roll", "repeat", "constant_pad_nd", "alias", "detach", "lift_fresh",
    "lift_fresh_copy", "alias_update",
})

# Overloads of a structural operator that transform words: a bitcast.
_NOT_STRUCTURAL = frozenset({"aten.view.dtype"})

# The argument positions of each structural operator's steering operands
# (predicates, indices): a flipped value there changes WHICH words move.
_STEERING = {
    "where": (0,), "index": (1,), "_unsafe_index": (1,),
    "index_put": (1,), "index_put_": (1,), "_index_put_impl_": (1,),
    "index_select": (2,), "gather": (2,), "scatter": (2,),
    "scatter_": (2,), "index_copy": (2,), "index_copy_": (2,),
    "masked_fill": (1,), "masked_fill_": (1,),
}

# Sync classes whose tag marks a detector on the tagged value: taint
# entering one is either masked (lanes equal) or latched/repaired there.
# 'guard' is not one: kernel guards read raw per-lane values and trip
# value-dependently.
_DETECTOR_CLASSES = frozenset({
    "load_addr", "store_data", "ctrl", "stack", "sor_crossing",
    "boundary", "call_boundary", "cfcss", "param", "opt_state",
})


def _detector_tag(tag: str) -> bool:
    if tag.startswith(TAG_VOTER) and not tag.startswith(TAG_VIEW):
        return True
    if tag.startswith(TAG_SYNC):
        klass = tag[len(TAG_SYNC):].partition(":")[0]
        return klass in _DETECTOR_CLASSES
    return False


def _structural(node) -> bool:
    return node.packet in _STRUCTURAL and node.op not in _NOT_STRUCTURAL


def _operands(node) -> Iterator[Tuple[int, bool]]:
    """``(value, steering)`` for every tensor operand of ``node``."""
    if node.packet == "alias_update":
        for v in node.ins:
            yield v, False
        return
    steer = _STEERING.get(node.packet, ())

    def flat(x, pos):
        if isinstance(x, Ref):
            yield int(x), pos in steer
        elif isinstance(x, (list, tuple)):
            for a in x:
                yield from flat(a, pos)

    for pos, a in enumerate(node.args):
        yield from flat(a, pos)
    for a in node.kwargs.values():
        yield from flat(a, -1)


def node_entry(node, j: int = 0) -> str:
    """``op(shape)`` display entry of one node's ``j``-th output: the
    witness paths' and the fingerprint cones' vocabulary."""
    shape = tuple(node.out_shapes[j]) if node.out_shapes else ()
    return f"{node.op}{shape}"


class _TaintWalk:
    """Forward verbatim-word taint over the captured trips.

    ``env[(k, vid)]`` is the set of leaf names whose unmodified words may
    be present in value ``vid`` of trip ``k``.  Taint passes through
    structural operators, dies at detector tags, and marks a leaf
    ``value_fed`` wherever a live operation consumes its taint
    non-structurally (arithmetic, reductions, steering operands, guard
    inputs, single-lane calls)."""

    def __init__(self, live: Optional[List[Set[int]]],
                 shared_surviving: Optional[FrozenSet[str]] = None):
        self.env: Dict[Tuple[int, int], FrozenSet[str]] = {}
        self.value_fed: Set[str] = set()
        self.live = live
        # Leaves whose corruption survives a sanctioned vote (a shared
        # single-copy leaf corrupts every replica alike); None keeps the
        # kill-at-detector semantics the partition's fingerprints use.
        self.shared_surviving = shared_surviving
        self._k = 0

    def val(self, vid: int) -> FrozenSet[str]:
        return self.env.get((self._k, vid), frozenset())

    def _set(self, vid: int, taint: FrozenSet[str]) -> None:
        key = (self._k, vid)
        old = self.env.get(key)
        self.env[key] = taint if old is None else (old | taint)

    def seed(self, k: int, trip: Trip, taints: Dict[str, FrozenSet[str]]
             ) -> None:
        self._k = k
        for name, vid in trip.state_in.items():
            self._set(vid, taints.get(name, frozenset()))

    def _is_live(self, i: int) -> bool:
        return self.live is None or i in self.live[self._k]

    def _feed(self, i: int, node, taint: FrozenSet[str]) -> None:
        if taint and self._is_live(i):
            self.value_fed |= taint

    def walk(self, k: int, trip: Trip) -> None:
        self._k = k
        for i, node in enumerate(trip.nodes):
            outs = self._node_outs(i, node)
            for vid, t in zip(node.outs, outs):
                self._set(vid, t)

    def _node_outs(self, i: int, node) -> List[FrozenSet[str]]:
        ins = [self.val(v) for v in node.ins]
        union = frozenset().union(*ins) if ins else frozenset()
        tag = node.tag
        if tag is not None:
            if _detector_tag(tag):
                if self.shared_surviving is not None and ins:
                    return [ins[0] & self.shared_surviving]
                return [frozenset()]
            if tag.startswith(TAG_SPOF):
                # A single-lane call boundary: the callee sees raw lane-0
                # values, a value consumption by definition.
                self._feed(i, node, union)
                return [frozenset()]
            return [ins[0] if ins else frozenset()]
        if node.packet in SHAPE_ONLY:
            return [frozenset() for _ in node.outs]
        if node.packet == "copy_":
            # The target is overwritten whole by the source's words.
            return [self.val(node.ins[-1])] + [
                frozenset() for _ in node.outs[1:]]
        if _structural(node):
            data: FrozenSet[str] = frozenset()
            for vid, steering in _operands(node):
                if steering:
                    self._feed(i, node, self.val(vid))
                else:
                    data |= self.val(vid)
            return [data for _ in node.outs]
        # Any other operator transforms values: tainted inputs are
        # value-fed, outputs carry no verbatim words.
        self._feed(i, node, union)
        return [frozenset() for _ in node.outs]


class _InfluenceWalk(_TaintWalk):
    """Value-influence closure over one protected step: which leaves'
    output values a corrupted leaf can change at all.  Every operator's
    outputs inherit the union of their operands' influence; detector tags
    still kill it except for ``shared_surviving`` leaves, and single-lane
    call boundaries pass it.  The per-step leaf->leaf edges
    (``StepFacts.out_taint``) are the raw material of the vulnerability
    map's cross-shard reach (``vulnmap._shard_reach``)."""

    def _node_outs(self, i: int, node) -> List[FrozenSet[str]]:
        tag = node.tag
        if tag is not None and tag.startswith(TAG_SPOF):
            ins = [self.val(v) for v in node.ins]
            return [frozenset().union(*ins) if ins else frozenset()]
        if tag is not None or node.packet in SHAPE_ONLY \
                or node.packet == "copy_":
            return super()._node_outs(i, node)
        ins = [self.val(v) for v in node.ins]
        union = frozenset().union(*ins) if ins else frozenset()
        return [union for _ in node.outs]

    def _feed(self, i: int, node, taint: FrozenSet[str]) -> None:
        # Influence is not consumption: value_fed stays the base walk's.
        pass


#: Witness paths are display artifacts, not proofs: their length is capped.
_PATH_MAX = 12


class TraceTaint(_TaintWalk):
    """:class:`_TaintWalk` plus witness paths: ``witness[leaf]`` is the
    first chain (trip order, ``op(shape)`` entries, the last suffixed
    ``!`` for the value-feeding consumer) that carried ``leaf``'s verbatim
    words to a live non-structural consumer.  The taint is the base
    walk's."""

    def __init__(self, live: Optional[List[Set[int]]]):
        super().__init__(live)
        self.path: Dict[Tuple[int, int], Dict[str, Tuple[str, ...]]] = {}
        self.witness: Dict[str, Tuple[str, ...]] = {}

    def _in_path(self, node, leaf: str) -> Tuple[str, ...]:
        for vid in node.ins:
            d = self.path.get((self._k, vid))
            if d is not None and leaf in d:
                return d[leaf]
            if leaf in self.val(vid):
                return (leaf,)        # the seeded leaf input itself
        return (leaf,)

    def _feed(self, i: int, node, taint: FrozenSet[str]) -> None:
        if taint and self._is_live(i):
            for leaf in sorted(taint):
                if leaf not in self.witness:
                    self.witness[leaf] = (self._in_path(node, leaf)
                                          + (node_entry(node) + "!",))
        super()._feed(i, node, taint)

    def walk(self, k: int, trip: Trip) -> None:
        self._k = k
        for i, node in enumerate(trip.nodes):
            outs = self._node_outs(i, node)
            for j, (vid, t) in enumerate(zip(node.outs, outs)):
                self._set(vid, t)
                if t:
                    d = self.path.setdefault((k, vid), {})
                    for leaf in sorted(t):
                        if leaf not in d:
                            p = self._in_path(node, leaf)
                            d[leaf] = (p + (node_entry(node, j),)
                                       if len(p) < _PATH_MAX else p)


@dataclasses.dataclass
class StepFacts:
    """Everything the static passes know about one protected step, from
    one capture and one walk."""

    closed: List[Trip]                  # the captured trips
    state_names: List[str]
    flag_names: List[str]
    walks: List[StepWalk]               # lattice walk + liveness a trip
    out_vals: Dict[str, List[_Val]]     # lattice values of each output,
    #                                     one a trip that returns it
    taint: _TaintWalk                   # value_fed (+ witness when traced)
    consumed: Set[str]                  # leaves feeding OTHER outputs
    written: Set[str]                   # region dataflow write set
    lane_flagged: Set[str]              # leaves behind live unsanctioned
    #                                     cross-lane candidates
    check_reads: Set[str]               # leaves check()'s verdict reads
    check_walker: Optional[_Walker]     # check() cone (fingerprints)
    check_closed: Optional[Trip]
    guards: bool
    cfcss: bool
    fn_unsafe: bool
    train_fallback: bool
    num_clones: int
    #: Per-step influence edges: output -> the leaves whose surviving
    #: corruption can change its committed value this step.
    out_taint: Dict[str, FrozenSet[str]] = dataclasses.field(
        default_factory=dict)

    @property
    def live(self) -> List[Set[int]]:
        return [w.live for w in self.walks]

    @property
    def out_names(self) -> List[str]:
        return self.state_names + self.flag_names


def _check_trip(region) -> Trip:
    """One captured call of ``region.check`` on the two-row CPU image."""
    image = region.init(torch.device("cpu"))
    state = {k: v.expand(BATCH, *v.shape).clone() for k, v in image.items()}
    return capture_fn(lambda s, t: {"E": region.check(s)}, state)


def analyze_step(prog, closed: Optional[List[Trip]] = None,
                 track_paths: bool = True) -> StepFacts:
    """Run the shared fault-propagation walk over ``prog``'s protected
    step.  ``closed`` forwards already captured trips (callers that lint
    and partition capture once); ``track_paths=False``
    skips the witness-path bookkeeping."""
    if prog.cfg.fuse_step and closed is None:
        # A fused build's records equal its unfused twin's; the protection
        # structure the static analyses read is the twin's, so fusion
        # changes no fingerprint or merge mode.
        prog = prog.unfused_twin()
    cfg = prog.cfg
    region = prog.region
    n = cfg.num_clones
    if closed is None:
        closed = trace_step(prog)
    walks = walk_trips(prog, closed)
    live = [w.live for w in walks]
    state_names = sorted({k for t in closed for k in t.state_in})
    flag_names = sorted({k for t in closed for k in t.flags_in})

    # -- lattice values of the outputs, a trip at a time -----------------
    out_vals: Dict[str, List[_Val]] = {}
    for w in walks:
        for name, vid in {**w.trip.state_out, **w.trip.flags_out}.items():
            out_vals.setdefault(name, []).append(w.walker.val(vid))
    consumed: Set[str] = set()
    for out_name, vals in out_vals.items():
        for val in vals:
            consumed |= {dep for dep in val.deps if dep != out_name}

    # -- value-feeding taint walk ----------------------------------------
    seeds = {name: frozenset({name}) for name in state_names}
    taint = TraceTaint(live) if track_paths else _TaintWalk(live)
    for k, trip in enumerate(closed):
        taint.seed(k, trip, seeds)
        taint.walk(k, trip)

    # -- per-step influence edges ----------------------------------------
    shared_names = frozenset(
        name for name in state_names if not prog.replicated.get(name))
    infl = _InfluenceWalk(live, shared_surviving=shared_names)
    out_taint: Dict[str, FrozenSet[str]] = {}
    for k, trip in enumerate(closed):
        infl.seed(k, trip, seeds)
        infl.walk(k, trip)
        # The reference freezes every leaf through a select on the commit
        # halt; the port's step returns an unwritten leaf's tensor as it
        # is.  Such a passthrough takes the freeze condition's influence,
        # as the reference's select gives it.
        made = {vid: node for node in trip.nodes for vid in node.outs}
        freeze: FrozenSet[str] = frozenset()
        for vid in trip.state_out.values():
            node = made.get(vid)
            if node is not None and node.packet == "where" \
                    and isinstance(node.args[0], Ref):
                freeze |= infl.val(int(node.args[0]))
        for name, vid in {**trip.state_out, **trip.flags_out}.items():
            got = infl.val(vid)
            if name in trip.state_in and vid == trip.state_in[name]:
                got = got | freeze
            out_taint[name] = out_taint.get(name, frozenset()) | got

    # -- per-leaf facts ---------------------------------------------------
    # The write set is the region's dataflow declaration (the analysis the
    # engine derives its store syncs from): the captured step gives every
    # leaf a fresh output (the freeze select), so value identity cannot
    # tell a write from a passthrough.
    from coast_tpu_torch.passes.verification import analyze
    written = set(analyze(region).written)

    # Live single-lane extractions and unsanctioned collapses implicate
    # their provenance leaves (unfiltered, as the partition's reference
    # is; cross_lane_sites applies the fan-out filter).
    lane_flagged: Set[str] = set()
    for w in walks:
        for cand in w.walker.candidates.values():
            if cand["node"] in w.live:
                lane_flagged |= set(cand["deps"])

    guards = (region.stack_guard is not None
              or region.assert_guard is not None)
    train_fallback = region.train_probe is not None
    cfcss = prog._cfcss_step is not None
    fn_unsafe = n > 1 and any(
        scope not in ("replicated", "replicated_return")
        for scope in prog.fn_scope.values())

    # -- check() cone: which leaves the self-check verdict reads ---------
    check_walker: Optional[_Walker] = None
    check_closed: Optional[Trip] = None
    check_reads: Set[str] = set()
    try:
        check_closed = _check_trip(region)
        check_walker = _Walker(n, check_closed)
        for name, vid in check_closed.state_in.items():
            check_walker.env[vid] = _Val("shared", 0, False, False,
                                         frozenset({name}))
        check_walker.walk()
        for vid in check_closed.state_out.values():
            check_reads |= set(check_walker.val(vid).deps)
    except Exception:       # noqa: BLE001 - analysis must not break builds
        check_closed = None
        check_walker = None
        # An unanalysable check conservatively reads every leaf.
        check_reads = set(region.spec)

    return StepFacts(
        closed=list(closed), state_names=state_names, flag_names=flag_names,
        walks=walks, out_vals=out_vals, taint=taint, consumed=consumed,
        written=written, lane_flagged=lane_flagged, check_reads=check_reads,
        check_walker=check_walker, check_closed=check_closed, guards=guards,
        cfcss=cfcss, fn_unsafe=fn_unsafe, train_fallback=train_fallback,
        num_clones=n, out_taint=out_taint)
