"""Lane-provenance pass: static replication-integrity rules over the
captured protected step.

The counterpart of ``coast_tpu/analysis/lint/provenance.py``, with its rule
names, severities and loci.  The engine's replicas live on a lane axis of
every replicated leaf (``[B, n, *leaf]``; the interleaved step sees them as
``[B * n, ...]`` rows, lane minor); redundancy is intact exactly while every
value derived from replicated state keeps that axis until a *sanctioned*
voter collapses it (the voter wrappers tag each replica set they vote
``coast:voter`` and ``coast:sync:<class>:<leaf>``, ``ops/voters.py``).
The pass walks the aten operations of the trips :func:`trace_step`
captures (``capture.py``) with a replicated/shared lattice:

  * **lane-collapse** (error): a reduction or a product contraction
    merges the lane axis outside a sanctioned voter;
  * **spof** (error/note): a single lane is extracted from live replicated
    dataflow outside a voter (every lane of one source extracted once,
    the segmented scheduler's fan-out, is sanctioned; a ``coast:spof:<fn>``
    tag from the skipLibCalls/cloneAfterCall wrappers makes it a note);
  * **voter-coverage** (error/warning): the classified vote tags *observed
    in the capture* against an expectation re-derived from the
    ``ProtectionConfig`` and the region's dataflow roles -- never
    ``ProtectedProgram.sync_tags()``, which is a declaration;
  * **unreplicated-import** (error): a mutable shared leaf feeds
    replicated leaves while its committed value never passed a voter.

The lattice follows the aten operations: select, slice, index, gather,
scatter, where, view and reshape, permute, expand, cat and stack, and the
sum/amax/any reductions are modelled, with the row axis of the
interleaved step tracked as a merged lane axis; mm and bmm are the
products.  Any other operation keeps the lane axis when its output keeps
it and otherwise degrades to *unknown*, which never produces a finding
(the reference's bias toward false negatives).  Findings come only from
live operations (a backward liveness pass from a trip's returned state and
flags: eager torch runs dead operations that XLA would drop), and a loci's
operator is named as the reference's primitive (``select`` is ``slice``,
``sum`` is ``reduce_sum``).  The union over a run's trips stands for the
jaxpr's branches.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from coast_tpu_torch.analysis.lint.capture import (BATCH, SHAPE_ONLY, Ref,
                                                   Trip, capture_run)
from coast_tpu_torch.analysis.lint.findings import LintReport
from coast_tpu_torch.ir.region import (KIND_CTRL, KIND_MEM, KIND_OPT_STATE,
                                       KIND_PARAM, KIND_RO, KIND_STACK)
from coast_tpu_torch.ops.voters import TAG_SPOF, TAG_SYNC, TAG_VIEW, TAG_VOTER

# Sync classes with an independently derivable expectation (the
# reference's list; call_boundary, cfcss, boundary, guard and view are
# observed but carry no per-leaf expectation from the config alone).
COVERAGE_CLASSES = ("load_addr", "store_data", "ctrl", "stack",
                    "sor_crossing", "param", "opt_state")

_SHARED, _LANED, _UNKNOWN = "shared", "laned", "unknown"


@dataclasses.dataclass(frozen=True)
class _Val:
    """Lattice value of one captured value."""

    status: str = _SHARED
    axis: int = 0                  # lane axis position when laned
    sanct: bool = False            # laned value inside a sanctioned voter
    voted: bool = False            # some upstream vote in the provenance
    deps: FrozenSet[str] = frozenset()
    rows: bool = False             # the lane is merged into axis ``axis``
    #                                (the interleaved step's B * n rows)


def _join(a: _Val, b: _Val) -> _Val:
    deps = a.deps | b.deps
    voted = a.voted or b.voted
    if (a.status == b.status == _LANED and a.axis == b.axis
            and a.rows == b.rows):
        return _Val(_LANED, a.axis, a.sanct and b.sanct, voted, deps,
                    a.rows)
    if a.status == b.status == _SHARED:
        return _Val(_SHARED, 0, False, voted, deps)
    return _Val(_UNKNOWN, 0, False, voted, deps)


# The reference's primitive for each aten operator a locus names.
_PRIM = {"select": "slice", "slice": "slice", "unbind": "slice",
         "sum": "reduce_sum", "mean": "reduce_sum", "amax": "reduce_max",
         "max": "reduce_max", "amin": "reduce_min", "min": "reduce_min",
         "any": "reduce_or", "all": "reduce_and", "prod": "reduce_prod",
         "argmax": "argmax", "argmin": "argmin", "mm": "dot_general",
         "bmm": "dot_general", "index": "gather", "gather": "gather"}
_REDUCE = ("sum", "mean", "amax", "amin", "max", "min", "any", "all", "prod",
           "argmax", "argmin", "logsumexp", "nansum", "count_nonzero")
# Operators that index: a laned operand keeps its axis position in the
# output rather than broadcasting right-aligned.
_INDEXING = ("index", "index_put", "index_put_", "_index_put_impl_",
             "gather", "scatter", "scatter_", "scatter_add", "scatter_add_",
             "scatter_reduce", "scatter_reduce_", "index_select",
             "index_copy", "index_copy_", "index_add", "index_add_",
             "take", "embedding")
_VIEWS = ("view", "_unsafe_view", "reshape", "_reshape_alias",
          "view_as")


def _dims(spec, ndim: int) -> List[int]:
    if spec is None:
        return list(range(ndim))
    if isinstance(spec, int):
        spec = [spec]
    spec = list(spec)
    if not spec:
        return list(range(ndim))
    return [d % ndim if ndim else 0 for d in spec]


def _arg(node, i: int, name: str, default=None):
    if len(node.args) > i:
        return node.args[i]
    return node.kwargs.get(name, default)


class _Walker:
    """Forward lattice walk over one captured trip."""

    def __init__(self, n: int, trip: Trip, batch: int = BATCH):
        self.n = n
        self.width = n * batch             # the merged row axis' size
        self.trip = trip
        self.env: Dict[int, _Val] = {}
        # Collapse candidates, keyed by (node, output).
        self.candidates: Dict[Tuple[int, int], Dict[str, object]] = {}
        # Observed tags: node index -> tag string.
        self.tags: Dict[int, str] = {}

    def val(self, vid: int) -> _Val:
        return self.env.get(vid, _Val())

    def _candidate(self, key, node, kind: str, src: int,
                   lane: Optional[int], deps: FrozenSet[str]) -> None:
        self.candidates[key] = {
            "node": key[0], "kind": kind,
            "prim": _PRIM.get(node.packet, node.packet), "src": src,
            "lane": lane, "deps": deps}

    def _size(self, v: _Val) -> int:
        return self.width if v.rows else self.n

    def _node_outs(self, i: int, node, ins: List[_Val]) -> List[_Val]:
        op = node.packet
        shapes = self.trip.shapes
        out_shapes = node.out_shapes
        deps = frozenset().union(*(v.deps for v in ins)) if ins \
            else frozenset()
        voted = any(v.voted for v in ins)

        tag = node.tag
        if tag is not None:
            v = ins[0]
            if tag.startswith((TAG_VOTER, TAG_SYNC, TAG_SPOF, TAG_VIEW)):
                self.tags[i] = tag
                v = dataclasses.replace(v, sanct=True, voted=True)
            return [v]
        if op in SHAPE_ONLY:
            return [_Val() for _ in node.outs]
        if op == "copy_" or op == "copy":
            # The target takes the source's value, broadcast to its shape.
            src_v = ins[-1]
            return [self._place(src_v, shapes[node.ins[-1]],
                                out_shapes[0])]
        if op == "alias_update":
            old, writes = ins[0], ins[1:]
            if old.status == _LANED and all(
                    w.status != _UNKNOWN for w in writes):
                sanct = old.sanct and all(w.sanct for w in writes
                                          if w.status == _LANED)
                return [_Val(_LANED, old.axis, sanct, voted, deps,
                             old.rows)]
            if all(v.status == _SHARED for v in ins):
                return [_Val(_SHARED, 0, False, voted, deps)]
            return [_Val(_UNKNOWN, 0, False, voted, deps)]

        if any(v.status == _UNKNOWN for v in ins):
            return [_Val(_UNKNOWN, 0, False, voted, deps)
                    for _ in node.outs]
        laned = [(vid, v) for vid, v in zip(node.ins, ins)
                 if v.status == _LANED]
        if not laned:
            return [_Val(_SHARED, 0, False, voted, deps)
                    for _ in node.outs]
        src, first = laned[0]
        a, rows = first.axis, first.rows
        sanct = all(v.sanct for _, v in laned)
        main = node.args[0] if node.args else None
        on_main = isinstance(main, Ref) and int(main) == src
        in_shape = shapes[src]
        nd = len(in_shape)

        def laned_out(axis: int, merged: bool = rows) -> _Val:
            return _Val(_LANED, axis, sanct, voted, deps, merged)

        def unknown_out() -> _Val:
            return _Val(_UNKNOWN, 0, False, voted, deps)

        def shared_out() -> _Val:
            return _Val(_SHARED, 0, sanct, voted, deps)

        if on_main and op == "select":
            dim = node.args[1] % nd
            if dim != a:
                return [laned_out(a - 1 if dim < a else a)]
            if rows:
                return [unknown_out()]
            if not sanct:
                self._candidate((i, 0), node, "spof", src,
                                int(node.args[2]) % self.n, deps)
            return [shared_out()]
        if on_main and op == "unbind":
            dim = _arg(node, 1, "dim", 0) % nd
            if dim != a:
                return [laned_out(a - 1 if dim < a else a)
                        for _ in node.outs]
            if rows:
                return [unknown_out() for _ in node.outs]
            if not sanct:
                for j in range(len(node.outs)):
                    self._candidate((i, j), node, "spof", src, j, deps)
            return [shared_out() for _ in node.outs]
        if on_main and op == "slice":
            dim = _arg(node, 1, "dim", 0) % nd
            if dim != a:
                return [laned_out(a)]
            size = in_shape[a]
            start = _arg(node, 2, "start", 0) or 0
            end = _arg(node, 3, "end", size)
            step = _arg(node, 4, "step", 1)
            start = max(0, min(size, start + size if start < 0 else start))
            end = size if end is None else end
            end = max(0, min(size, end + size if end < 0 else end))
            length = max(0, end - start)
            if length >= size and step == 1:
                return [laned_out(a)]
            if rows or step != 1:
                return [unknown_out()]
            if length == 1:
                if not sanct:
                    self._candidate((i, 0), node, "spof", src, int(start),
                                    deps)
                return [shared_out()]
            return [unknown_out()]
        if on_main and op == "unsqueeze":
            dim = node.args[1] % (nd + 1)
            return [laned_out(a + 1 if dim <= a else a)]
        if on_main and op == "squeeze":
            dims = _dims(_arg(node, 1, "dim"), nd)
            removed = [d for d in dims if in_shape[d] == 1]
            if a in removed:
                return [unknown_out()]
            return [laned_out(a - sum(1 for d in removed if d < a))]
        if on_main and op == "permute":
            perm = [d % nd for d in node.args[1]]
            return [laned_out(perm.index(a))]
        if on_main and op in ("transpose", "t", "numpy_T"):
            d0, d1 = ((node.args[1] % nd, node.args[2] % nd)
                      if op == "transpose" else (0, 1))
            return [laned_out(d1 if a == d0 else d0 if a == d1 else a)]
        if on_main and op in ("expand", "expand_as", "broadcast_to"):
            return [laned_out(a + len(out_shapes[0]) - nd)]
        if on_main and op in _VIEWS:
            return [self._reshape(first, in_shape, out_shapes[0], sanct,
                                  voted, deps)]
        if on_main and op in _REDUCE and not isinstance(
                _arg(node, 1, "dim"), Ref):
            dims = _dims(_arg(node, 1, "dim"), nd)
            keep = bool(_arg(node, 2, "keepdim", False))
            if a in dims:
                if not sanct:
                    self._candidate((i, 0), node, "lane-collapse", src,
                                    None, deps)
                return [shared_out() for _ in node.outs]
            new_a = a if keep else a - sum(1 for d in dims if d < a)
            return [laned_out(new_a) for _ in node.outs]
        if op in ("mm", "bmm"):
            return [self._product(i, node, ins, voted, deps)]
        if op in ("cat", "concat", "stack"):
            dim = _arg(node, 1, "dim", 0)
            out_shape = out_shapes[0]
            outs = []
            for vid, v in laned:
                r = len(shapes[vid])
                if op == "stack":
                    d = dim % (r + 1)
                    pos = v.axis + 1 if d <= v.axis else v.axis
                else:
                    if dim % r == v.axis:
                        return [unknown_out()]
                    pos = v.axis
                if out_shape[pos] != self._size(v):
                    return [unknown_out()]
                outs.append((pos, v.rows))
            if len(set(outs)) != 1:
                return [unknown_out()]
            return [laned_out(*outs[0])]

        # Generic: the lane axis survives iff every laned operand's axis
        # lands on an output position of its size (right-aligned
        # broadcasting for elementwise operators, in place for indexing
        # ones); otherwise the value degrades.
        results = []
        for shape in out_shapes:
            pos_set = set()
            for vid, v in laned:
                r = len(shapes[vid])
                pos = v.axis if (r == len(shape) or op in _INDEXING) \
                    else v.axis + len(shape) - r
                if not 0 <= pos < len(shape) \
                        or shape[pos] != self._size(v):
                    pos_set = None
                    break
                pos_set.add((pos, v.rows))
            if pos_set is None or len(pos_set) != 1:
                results.append(unknown_out())
            else:
                results.append(laned_out(*pos_set.pop()))
        return results

    def _place(self, v: _Val, src_shape, dst_shape) -> _Val:
        """``v`` broadcast into ``dst_shape`` (copy_'s value)."""
        if v.status != _LANED:
            return v
        pos = v.axis + len(dst_shape) - len(src_shape)
        if 0 <= pos < len(dst_shape) and dst_shape[pos] == self._size(v):
            return dataclasses.replace(v, axis=pos)
        return _Val(_UNKNOWN, 0, False, v.voted, v.deps)

    def _reshape(self, v: _Val, ins, outs, sanct, voted, deps) -> _Val:
        a = v.axis
        ins, outs = tuple(ins), tuple(outs)

        def laned(axis, rows):
            return _Val(_LANED, axis, sanct, voted, deps, rows)

        if ins[:a + 1] == outs[:a + 1]:
            return laned(a, v.rows)
        if not v.rows:
            # [.., X, n, ..] -> [.., X * n, ..]: the lane merges into the
            # axis before it (the interleaved step's rows).
            if (a >= 1 and len(outs) >= a and ins[:a - 1] == outs[:a - 1]
                    and outs[a - 1] == ins[a - 1] * ins[a]):
                return laned(a - 1, True)
        elif (len(outs) > a + 1 and ins[:a] == outs[:a]
              and outs[a] * outs[a + 1] == ins[a]
              and outs[a + 1] == self.n):
            # Rows back to [.., X, n, ..].
            return laned(a + 1, False)
        return _Val(_UNKNOWN, 0, False, voted, deps)

    def _product(self, i, node, ins, voted, deps) -> _Val:
        """mm ``[M, K] @ [K, N]`` / bmm ``[b, M, K] @ [b, K, N]``."""
        batch = 1 if node.packet == "bmm" else 0
        outs = []
        for side, (vid, v) in enumerate(zip(node.ins[:2], ins[:2])):
            if v.status != _LANED:
                continue
            contract = batch + 1 if side == 0 else batch
            if v.axis == contract:
                if not v.sanct:
                    self._candidate((i, 0), node, "lane-collapse", vid,
                                    None, deps)
                outs.append(_Val(_SHARED, 0, v.sanct, voted, deps))
            else:
                outs.append(_Val(_LANED, v.axis, v.sanct, voted, deps,
                                 v.rows))
        out = outs[0]
        for o in outs[1:]:
            out = _join(out, o)
        return out

    def walk(self) -> None:
        for i, node in enumerate(self.trip.nodes):
            ins = [self.val(v) for v in node.ins]
            outs = self._node_outs(i, node, ins)
            if len(outs) != len(node.outs):
                outs = [_Val(_UNKNOWN if any(
                    v.status != _SHARED for v in ins) else _SHARED, 0,
                    False, any(v.voted for v in ins),
                    frozenset().union(*(v.deps for v in ins)) if ins
                    else frozenset()) for _ in node.outs]
            for vid, val in zip(node.outs, outs):
                self.env[vid] = val


def live_nodes(trip: Trip) -> Set[int]:
    """Backward liveness: the nodes whose outputs reach the trip's
    returned state or flags."""
    live_vars = set(trip.state_out.values()) | set(trip.flags_out.values())
    live: Set[int] = set()
    for i in range(len(trip.nodes) - 1, -1, -1):
        node = trip.nodes[i]
        if any(v in live_vars for v in node.outs):
            live.add(i)
            live_vars.update(node.ins)
    return live


def cross_lane_sites(walker: _Walker, live: Set[int],
                     n: int) -> List[Dict[str, object]]:
    """The live unsanctioned cross-lane sites of one trip, the segmented
    scheduler's all-lane fan-out (every lane of one source extracted once)
    filtered out as sanctioned -- the reference's acceptance rule."""
    by_src: Dict[int, List[Dict[str, object]]] = {}
    for c in walker.candidates.values():
        if c["node"] in live:
            by_src.setdefault(c["src"], []).append(c)
    out: List[Dict[str, object]] = []
    for cands in by_src.values():
        lanes_seen = {c["lane"] for c in cands}
        if (all(c["kind"] == "spof" for c in cands)
                and None not in lanes_seen
                and lanes_seen == set(range(n))):
            continue
        out.extend(cands)
    return out


# -- expected voter coverage --------------------------------------------------

def expected_sync_classes(region, cfg) -> Dict[str, Set[str]]:
    """Per-leaf expected vote classes, re-derived from the config and the
    region's dataflow roles -- deliberately NOT read from the engine's
    ``step_sync``/``pre_sync`` tables, so an engine bug in the sync-point
    policy shows up as a coverage mismatch."""
    from coast_tpu_torch.passes.verification import analyze
    flow = analyze(region)
    replicated = {name: cfg.resolve_xmr(region, name)
                  for name in region.spec}
    expected: Dict[str, Set[str]] = {name: set() for name in region.spec}
    if cfg.num_clones <= 1 or not any(replicated.values()):
        return expected
    for name, spec in region.spec.items():
        if replicated[name]:
            if cfg.protect_stack and spec.stack:
                expected[name].add("stack")
            if spec.kind == KIND_CTRL:
                in_load = name in flow.load_addr
                in_store = name in flow.store_addr
                if in_load and not cfg.no_load_sync:
                    expected[name].add("load_addr")
                if ((in_store and not cfg.no_store_addr_sync)
                        or not (in_load or in_store)):
                    if not (cfg.protect_stack and spec.stack):
                        expected[name].add("ctrl")
            elif spec.kind == KIND_MEM:
                if (not cfg.no_store_data_sync and name in flow.written
                        and not (cfg.protect_stack and spec.stack)):
                    expected[name].add("store_data")
            elif spec.kind == KIND_STACK:
                if not cfg.no_store_data_sync and name in flow.written:
                    expected[name].add("stack")
            elif spec.kind in (KIND_PARAM, KIND_OPT_STATE):
                # The weight-update commit vote, phase-agnostic: it must
                # exist in the live step, wherever it fires.
                if not cfg.no_store_data_sync and name in flow.written:
                    expected[name].add(spec.kind)
        else:
            if (spec.kind != KIND_RO and name in flow.written
                    and not spec.unvoted_crossing):
                # A declared unvoted crossing ships replica data raw on
                # purpose: no sor_crossing vote is expected there.
                expected[name].add("sor_crossing")
    return expected


def _parse_sync_tag(tag: str) -> Optional[Tuple[str, str]]:
    if not tag.startswith(TAG_SYNC):
        return None
    klass, _, leaf = tag[len(TAG_SYNC):].partition(":")
    return klass, leaf


# -- the pass -----------------------------------------------------------------

def trace_step(prog) -> List[Trip]:
    """The protected step's captured trips (shared by the provenance and
    survival passes, so a full lint captures once)."""
    return capture_run(prog)


@dataclasses.dataclass
class StepWalk:
    """One trip's lattice walk and liveness."""

    trip: Trip
    walker: _Walker
    live: Set[int]


def walk_trips(prog, trips: Sequence[Trip]) -> List[StepWalk]:
    """Walk every captured trip: replicated state leaves seeded laned on
    axis 1, shared ones and the flags shared."""
    n = prog.cfg.num_clones
    out = []
    for trip in trips:
        walker = _Walker(n, trip)
        for name, vid in trip.state_in.items():
            walker.env[vid] = _Val(
                _LANED if prog.replicated.get(name) else _SHARED,
                1 if prog.replicated.get(name) else 0, False, False,
                frozenset({name}))
        walker.walk()
        out.append(StepWalk(trip, walker, live_nodes(trip)))
    return out


def observed_tags(walks: Sequence[StepWalk]) -> List[str]:
    """The tags of live tag operations, over every trip."""
    return [t for w in walks for k, t in w.walker.tags.items()
            if k in w.live]


def lint_provenance(prog, report: Optional[LintReport] = None,
                    closed: Optional[List[Trip]] = None) -> LintReport:
    """Run the lane-provenance rules over the captured trips of
    ``prog.step``."""
    cfg = prog.cfg
    region = prog.region
    if report is None:
        report = LintReport(benchmark=region.name,
                            strategy=f"N={cfg.num_clones}")
    report.passes_run.append("provenance")
    n = cfg.num_clones
    if n <= 1 or not prog._any_replicated:
        # Nothing is replicated: no lanes to lose.
        return report
    if closed is None:
        closed = trace_step(prog)
    walks = walk_trips(prog, closed)

    # -- lane-collapse / spof findings ----------------------------------
    seen = set()

    def add(*finding):
        if finding not in seen:
            seen.add(finding)
            report.add(*finding)

    for w in walks:
        for c in cross_lane_sites(w.walker, w.live, n):
            leaves = "+".join(sorted(c["deps"])) or "?"
            if c["kind"] == "spof":
                lane = c["lane"]
                where = f"lane {lane}" if lane is not None \
                    else "a traced lane index"
                add("spof", "error", f"eqn:{c['prim']}:{leaves}",
                    f"single lane ({where}) extracted from live "
                    f"replicated dataflow of {leaves} outside a "
                    "sanctioned voter: one corruptible copy now stands "
                    "for all replicas")
            else:
                add("lane-collapse", "error", f"eqn:{c['prim']}:{leaves}",
                    f"{c['prim']} merges the lane axis of {leaves} "
                    "outside a sanctioned voter: replicas are combined "
                    "without majority voting")

    # -- observed tags (live only) --------------------------------------
    observed: Dict[str, Set[str]] = {}
    spof_tags: Set[str] = set()
    for tag in observed_tags(walks):
        parsed = _parse_sync_tag(tag)
        if parsed is not None:
            klass, leaf = parsed
            observed.setdefault(leaf, set()).add(klass)
        elif tag.startswith(TAG_SPOF):
            spof_tags.add(tag[len(TAG_SPOF):])

    # -- SPOF allowlist report ------------------------------------------
    allow = set(cfg.skip_lib_calls) | set(cfg.clone_after_call_fns)
    for fn in sorted(spof_tags):
        if fn in allow:
            report.add(
                "spof", "note", f"fn:{fn}",
                f"accepted single point of failure: '{fn}' runs once on "
                "lane 0's arguments (skipLibCalls/cloneAfterCall "
                "allowlist)")
        else:
            report.add(
                "spof", "error", f"fn:{fn}",
                f"single-lane call to '{fn}' is not in the skipLibCalls/"
                "cloneAfterCall allowlist")

    # -- voter coverage vs. the config ----------------------------------
    expected = expected_sync_classes(region, cfg)
    for name in sorted(region.spec):
        want = expected.get(name, set())
        have = {k for k in observed.get(name, set())
                if k in COVERAGE_CLASSES}
        for klass in sorted(want - have):
            report.add(
                "voter-coverage", "error", f"leaf:{name}",
                f"expected a {klass} vote for leaf '{name}' under this "
                "ProtectionConfig, but the protected step contains none "
                "(the sync point was dropped or compiled around)")
        for klass in sorted(have - want):
            report.add(
                "voter-coverage", "warning", f"leaf:{name}",
                f"unexpected {klass} vote for leaf '{name}': the "
                "ProtectionConfig does not call for this sync point")

    # -- unreplicated-import --------------------------------------------
    flagged: Dict[str, List[str]] = {}
    for w in walks:
        trip = w.trip
        out_by_name = {name: w.walker.val(vid)
                       for name, vid in trip.state_out.items()}
        for name in sorted(region.spec):
            if prog.replicated.get(name) or name not in trip.state_out:
                continue
            if region.spec[name].kind == KIND_RO:
                continue
            if trip.state_out[name] == trip.state_in.get(name):
                continue                         # not written
            consumers = [r for r in sorted(region.spec)
                         if prog.replicated.get(r)
                         and name in out_by_name.get(r, _Val()).deps]
            if consumers and not out_by_name[name].voted:
                flagged.setdefault(name, consumers)
    for name in sorted(flagged):
        report.add(
            "unreplicated-import", "error", f"leaf:{name}",
            f"mutable shared leaf '{name}' feeds replicated leaves "
            f"({', '.join(flagged[name])}) but its committed value never "
            "passes a voter: corrupt unprotected state would be "
            "imported identically into every replica")
    return report
