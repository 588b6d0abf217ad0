"""Sphere-of-Replication verification: the verifyOptions step, and the
region's dataflow facts the sync tables are built from.

The counterpart of ``coast_tpu/passes/verification.py``.  The reference
derives :class:`RegionDataflow` by walking the step's jaxpr; the port
derives it from a capture of the bare step (``analysis/lint/capture.py``):
the aten operations of a few calls on a two-row CPU image, one a ``t`` in
``0 .. DERIVE_TRIPS - 1`` (so a step's Python phase gates on ``t`` show
both ways), their union standing for the jaxpr's branches.  A leaf is
*written* when a call returns a value other than its input; its ``deps``
are the leaves that reach that value; ``load_addr`` / ``store_addr`` are
the leaves reaching the index operand of a read (``index``, ``gather``,
``index_select``) or a write (``index_put``, ``scatter``), or an index
``ops/indexing.py`` tags ``coast:load_addr`` / ``coast:store_addr``.  An
operator whose value is its shape alone (``zeros_like``) carries no
provenance, and ``copy_`` carries its source's.

Each ported region also declares its dataflow in ``meta["dataflow"]``
(held equal to the reference's ``analyze()`` of the JAX twin by the
tests).  The declaration is a check: :func:`analyze` raises
:class:`SoRViolation` naming the region and the leaf where the derived
facts leave it (see there for why the check is one-sided).  The
derivation runs once a region object.

``verify_options`` ports the rule checks that concern the scope lists
(``ignore_globals`` / ``xmr_globals``, the function-scope lists,
``-isrFunctions`` and ``-runtimeInitGlobals``) and the read-only / control
rules they interact with; violations raise :class:`SoRViolation` with the
reference's messages.  A region with named sub-functions is analysed with
the raw functions bound, as the reference's analysis sees it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Set

from coast_tpu_torch.ir.region import KIND_CTRL, KIND_LINK, KIND_RO, Region

_ERR = "ERROR (SoR verification): "


class SoRViolation(Exception):
    """Raised instead of the reference's std::exit(-1); carries every
    violation found."""

    def __init__(self, errors: List[str]):
        self.errors = errors
        super().__init__("\n".join(_ERR + e for e in errors))


@dataclasses.dataclass(frozen=True)
class RegionDataflow:
    """Static dataflow facts about a region's step function.

    ``written``: leaves the step does not pass through unchanged.
    ``deps``: out leaf -> the leaves its value depends on.
    ``load_addr`` / ``store_addr``: leaves that form the index of a row
    read / row write (``ops/indexing.py``) -- the GEP operands the
    reference's syncGEP votes.
    ``stored_into``: leaves that are the target (operand 0) of a store-like
    partial update -- the memory the reference's syncStoreInst guards.
    ``branch_pred``: leaves that reach the condition operand of a
    ``where`` -- the terminator-sync state the reference votes before a
    branch.  Only :func:`analyze_step` fills these two (the lifter's
    classification reads them); :func:`derive` and the sync tables leave
    them empty."""

    written: FrozenSet[str]
    deps: Dict[str, FrozenSet[str]]
    load_addr: FrozenSet[str] = frozenset()
    store_addr: FrozenSet[str] = frozenset()
    stored_into: FrozenSet[str] = frozenset()
    branch_pred: FrozenSet[str] = frozenset()


#: Calls of the bare step the derivation captures (t = 0, 1, ...).
DERIVE_TRIPS = 2
# (name, step code, declared facts) of every declaration checked so far.
_CHECKED: Set[tuple] = set()

# aten operators that read at an index / write at one, and which of their
# arguments holds the index.
_LOAD_INDEX = {"index": 1, "gather": 2, "index_select": 2, "take": 1,
               "embedding": 1}
_STORE_INDEX = {"index_put": 1, "index_put_": 1, "_index_put_impl_": 1,
                "scatter": 2, "scatter_": 2, "scatter_add": 2,
                "scatter_add_": 2, "scatter_reduce": 2, "scatter_reduce_": 2,
                "index_copy": 2, "index_copy_": 2, "index_add": 2,
                "index_add_": 2}
# Partial updates at a static slice or position (``x.at[1:8].set`` of the
# reference): stores into their operand 0, with no index value.
_STORE_STATIC = ("slice_scatter", "select_scatter")


def _refs(arg) -> List[int]:
    from coast_tpu_torch.analysis.lint.capture import Ref
    if isinstance(arg, Ref):
        return [int(arg)]
    if isinstance(arg, (list, tuple)):
        return [int(a) for a in arg if isinstance(a, Ref)]
    return []


def _trip_flow(trip, join_where: bool = False):
    """Leaf provenance through one captured call -> ``(written, deps,
    load, store, stored_into, branch_pred, src)``; ``src`` maps each value
    id to the leaves it depends on.

    ``join_where`` reads the trip as the reference's trace of the same
    step: ``jnp.where`` is one cached sub-jaxpr per operand signature, and
    its walk seeds that sub-jaxpr with the union of its call sites'
    provenance, in call order.  So a ``where`` node's operands take the
    provenance of every earlier ``where`` of the same overload, operand
    shapes and dtypes as well as their own."""
    from coast_tpu_torch.analysis.lint.capture import SHAPE_ONLY
    src: Dict[int, FrozenSet[str]] = {
        vid: frozenset({name}) for name, vid in trip.state_in.items()}
    load: Set[str] = set()
    store: Set[str] = set()
    stored: Set[str] = set()
    pred: Set[str] = set()
    # Values made from an ops/indexing index: its tag already gave their
    # role (update_drop's internal read at the store index is not a load).
    tagged: Set[int] = set()
    # where signature -> the provenance seeded into each operand so far.
    joined: Dict[tuple, List[Set[str]]] = {}

    def deps_of(vids) -> Set[str]:
        out: Set[str] = set()
        for v in vids:
            out |= src.get(v, frozenset())
        return out

    for node in trip.nodes:
        op = node.packet
        for table, role in ((_LOAD_INDEX, load), (_STORE_INDEX, store)):
            if op in table and len(node.args) > table[op]:
                role |= deps_of([v for v in _refs(node.args[table[op]])
                                 if v not in tagged])
        seeded = None
        if join_where and op == "where":
            refs = [_refs(a) for a in node.args]
            key = (node.op, tuple(
                tuple((trip.shapes[v], trip.dtypes.get(v)) for v in r)
                for r in refs))
            acc = joined.setdefault(key, [set() for _ in refs])
            for slot, r in zip(acc, refs):
                slot |= deps_of(r)
            seeded = acc
        if (op in _STORE_INDEX or op in _STORE_STATIC) and node.args:
            stored |= deps_of(_refs(node.args[0]))
        elif op == "where" and node.args:
            pred |= (seeded[0] if seeded is not None
                     else deps_of(_refs(node.args[0])))
        tag = node.tag
        if tag == "coast:load_addr":
            load |= deps_of(node.ins[:1])
        elif tag == "coast:store_addr":
            store |= deps_of(node.ins[:1])
        elif tag == "coast:branch_pred":
            # A branch no where shows: an if of the C front end, the
            # condition of a nested while (frontend/loops.py).
            pred |= deps_of(node.ins[:1])
        if tag in ("coast:load_addr", "coast:store_addr") or any(
                v in tagged for v in node.ins):
            tagged.update(node.outs)
        if op in SHAPE_ONLY:
            out = frozenset()
        elif op in ("copy_", "copy"):
            out = frozenset(deps_of(node.ins[-1:]))
        elif seeded is not None:
            out = frozenset().union(*seeded)
        else:
            out = frozenset(deps_of(node.ins))
        for vid in node.outs:
            src[vid] = out
    written = set()
    deps: Dict[str, FrozenSet[str]] = {}
    for name, vid in trip.state_out.items():
        if vid != trip.state_in.get(name):
            written.add(name)
            deps[name] = src.get(vid, frozenset())
    return written, deps, load, store, stored, pred, src


def derive(region: Region) -> RegionDataflow:
    """The region's dataflow, from captures of its bare step."""
    import torch

    from coast_tpu_torch.analysis.lint.capture import capture_fn
    image = region.init(torch.device("cpu"))
    state = {k: v.expand(2, *v.shape).clone() for k, v in image.items()}
    step = region.bound_step()
    written: Set[str] = set()
    deps: Dict[str, Set[str]] = {}
    load: Set[str] = set()
    store: Set[str] = set()
    for t in range(DERIVE_TRIPS):
        trip = capture_fn(step, state, t)
        w, d, ld, st, _, _, _ = _trip_flow(trip)
        written |= w
        for name, got in d.items():
            deps.setdefault(name, set()).update(got)
        load |= ld
        store |= st
        with torch.no_grad():
            state = {**state, **step(dict(state), t)}
    return RegionDataflow(
        written=frozenset(written),
        deps={name: (frozenset(deps.get(name, ())) if name in written
                     else frozenset({name})) for name in region.spec},
        load_addr=frozenset(load), store_addr=frozenset(store))


#: Calls of a bare step :func:`analyze_step` captures at most.  A leaf's
#: store or predicate role can first show at a later trip than
#: :data:`DERIVE_TRIPS` covers; eight trips hold every distinct trip graph
#: of the registry's fault-free runs (``analysis/lint/capture.MAX_TRIPS``).
STEP_TRIPS = 8


def _image_rows(state) -> Dict[str, "torch.Tensor"]:
    """A one-image state (unbatched tensors, or a callable of a device) as
    the two-row CPU state a capture records."""
    import torch
    from coast_tpu_torch.analysis.lint.capture import BATCH
    if callable(state):
        state = state(torch.device("cpu"))
    return {k: torch.as_tensor(v).cpu().expand(BATCH, *v.shape).clone()
            for k, v in state.items()}


def analyze_step(step, state, done=None) -> RegionDataflow:
    """Dataflow facts of a bare step ``step(state, t)`` over the image
    ``state`` (unbatched tensors, or a callable of a device): the union of
    captures of up to :data:`STEP_TRIPS` calls on a two-row CPU image (``t = 0, 1,
    ...``), stopping after the trip at which ``done`` (when given) holds
    for the image.  Unlike :func:`derive` it fills ``stored_into`` and
    ``branch_pred``: the lifter (``frontend/lifter.py``) classifies leaf
    kinds from them."""
    import torch

    from coast_tpu_torch.analysis.lint.capture import capture_fn
    rows = _image_rows(state)
    names = list(rows)
    written: Set[str] = set()
    deps: Dict[str, Set[str]] = {}
    facts = {k: set() for k in ("load", "store", "stored_into",
                                "branch_pred")}
    for t in range(STEP_TRIPS):
        w, d, ld, st, stored, pred, _ = _trip_flow(
            capture_fn(step, rows, t), join_where=True)
        written |= w
        for name, got in d.items():
            deps.setdefault(name, set()).update(got)
        facts["load"] |= ld
        facts["store"] |= st
        facts["stored_into"] |= stored
        facts["branch_pred"] |= pred
        with torch.no_grad():
            rows = {**rows, **step(dict(rows), t)}
            if done is not None and bool(done(rows).all()):
                break
    return RegionDataflow(
        written=frozenset(written),
        deps={name: (frozenset(deps.get(name, ())) if name in written
                     else frozenset({name})) for name in names},
        load_addr=frozenset(facts["load"]),
        store_addr=frozenset(facts["store"]),
        stored_into=frozenset(facts["stored_into"]),
        branch_pred=frozenset(facts["branch_pred"]))


def reads_of(fn, state, *extra_args) -> FrozenSet[str]:
    """The state leaves the output of ``fn(state, *extra)`` depends on
    (e.g. which leaves a region's ``done()`` predicate reads), from a
    capture of one call on the two-row CPU image of ``state``."""
    import torch

    from coast_tpu_torch.analysis.lint.capture import Trip, recording
    rows = _image_rows(state)
    with torch.no_grad(), recording() as rec:
        state_in = {k: rec.bind_input(v) for k, v in rows.items()}
        out = fn(dict(rows), *extra_args)
        outs = out if isinstance(out, (list, tuple)) else [out]
        out_ids = {f"out{i}": rec.value_of(o) for i, o in enumerate(outs)
                   if isinstance(o, torch.Tensor)}
    src = _trip_flow(Trip(0, rec.nodes, rec.shapes, state_in, {}, out_ids,
                          {}))[-1]
    acc: Set[str] = set()
    for vid in out_ids.values():
        acc |= src.get(vid, frozenset())
    return frozenset(acc)


def analyze(region: Region) -> RegionDataflow:
    """The region's dataflow facts: derived from its step (:func:`derive`)
    and, where the region declares ``meta["dataflow"]``, held against the
    declaration, which is then what the sync tables read.

    The declaration is the reference's ``analyze()`` of the JAX twin, and
    the reference's walk over-approximates: JAX caches one sub-jaxpr for
    each ``jnp.where``/``jnp.clip``-style helper, and its walk seeds that
    sub-jaxpr's inputs with the union of every call site's provenance (in
    crc16, ``i = where(i < n, i + 1, i)`` reads as depending on ``crc`` and
    ``msg`` because ``crc``'s update goes through the same ``_where``).  So
    the check is one-sided: the derived ``written`` set must equal the
    declared one, and every derived dependency and address role must be
    declared; a declared fact the step does not show is the reference's
    over-approximation and is kept, since the port's sync tables must
    equal the reference's.  A derived fact the declaration lacks raises
    :class:`SoRViolation` naming the region and the leaf."""
    flow = getattr(region, "_checked_dataflow", None)
    if flow is not None:
        return flow
    declared = region.meta.get("dataflow")
    # A declaration checked once holds for every region object of the same
    # name, step code and declared facts (a registry factory's instances).
    key = declared and (region.name, getattr(region.step, "__code__", None),
                        declared.written, declared.load_addr,
                        declared.store_addr,
                        tuple(sorted(declared.deps.items())))
    if declared is None or key not in _CHECKED:
        derived = derive(region)
        if declared is None:
            region._checked_dataflow = derived
            return derived
        errors = _mismatches(region, declared, derived)
        if errors:
            raise SoRViolation(errors)
        _CHECKED.add(key)
    region._checked_dataflow = declared
    return declared


def _mismatches(region: Region, declared: RegionDataflow,
                derived: RegionDataflow) -> List[str]:
    """Where the derived facts leave the declaration."""
    errors = []
    for name in sorted(region.spec):
        if (name in declared.written) != (name in derived.written):
            errors.append(
                f"region '{region.name}' declares leaf '{name}' "
                f"{'written' if name in declared.written else 'unwritten'}"
                ", but its step "
                f"{'passes it through' if name in declared.written else 'writes it'}")
        for fact in ("load_addr", "store_addr"):
            if (name in getattr(derived, fact)
                    and name not in getattr(declared, fact)):
                errors.append(
                    f"region '{region.name}' does not declare leaf "
                    f"'{name}' in {fact}, but its step indexes with it")
        extra = (derived.deps.get(name, frozenset({name}))
                 - declared.deps.get(name, frozenset({name})))
        if extra:
            errors.append(
                f"region '{region.name}' declares leaf '{name}' to depend "
                f"on {sorted(declared.deps.get(name, frozenset({name})))}"
                f", but its step also reads {sorted(extra)}")
    return errors


def _scope_excluded(region: Region, cfg, name: str) -> bool:
    """Excluded from the SoR by an explicit user choice (CL list,
    annotation, or region default), as opposed to by kind or mode."""
    if name in cfg.ignore_globals:
        return True
    if name in cfg.xmr_globals:
        return False
    spec = region.spec[name]
    if spec.xmr is False:
        return True
    return region.default_xmr is False and spec.xmr is not True


def verify_options(region: Region, cfg) -> FrozenSet[str]:
    """Raises SoRViolation on a rule break; returns the forced-boundary-sync
    leaf set (shared leaves written from replicated data) otherwise."""
    flow = analyze(region)
    errors: List[str] = []
    forced_sync: Set[str] = set()

    for opt, val in (("ignore_globals", cfg.ignore_globals),
                     ("xmr_globals", cfg.xmr_globals)):
        for name in val:
            if name not in region.spec:
                errors.append(
                    f"-{opt}: no leaf named '{name}' in region "
                    f"'{region.name}' (have: {', '.join(sorted(region.spec))})")
    for name in sorted(set(cfg.ignore_globals) & set(cfg.xmr_globals)):
        errors.append(f"leaf '{name}' listed in both -ignore_globals and "
                      "-xmr_globals")
    # Function-scope lists name existing functions; -isrFunctions has no
    # meaning here and -runtimeInitGlobals names leaves: each is refused,
    # never silently inert.
    for flag, names in cfg.fn_lists().items():
        for name in names:
            if name not in region.functions:
                have = ", ".join(sorted(region.functions)) or "<none>"
                errors.append(
                    f"-{flag}: no function named '{name}' in region "
                    f"'{region.name}' (have: {have})")
    for name in cfg.isr_functions:
        errors.append(
            f"-isrFunctions: '{name}': interrupt service routines do not "
            "exist in a stepped TPU region; remove the flag (the reference "
            "excludes ISRs from cloning, inspection.cpp:183-186 -- here "
            "there is nothing to exclude)")
    for name in cfg.runtime_init_globals:
        if name not in region.spec:
            errors.append(
                f"-runtimeInitGlobals: no leaf named '{name}' in region "
                f"'{region.name}' (every replicated leaf is already "
                "runtime-initialised from the init() image by "
                "init_pstate, the addGlobalRuntimeInit analogue)")
    if errors:
        raise SoRViolation(errors)

    replicated = {name: cfg.resolve_xmr(region, name) for name in region.spec}
    any_replicated = any(replicated.values())

    for name, spec in region.spec.items():
        if spec.kind == KIND_RO and name in flow.written and not spec.no_verify:
            errors.append(
                f"read-only leaf '{name}' is written by step(); "
                "declare it KIND_MEM or stop writing it")
        if spec.kind == KIND_RO and (spec.xmr is True
                                     or name in cfg.xmr_globals):
            errors.append(
                f"leaf '{name}' is KIND_RO (never cloned) but annotated "
                "__xMR; conflicting replication scope")
        if not any_replicated or spec.no_verify:
            continue
        if (spec.kind == KIND_CTRL and not replicated[name]
                and cfg.num_clones > 1 and _scope_excluded(region, cfg, name)):
            errors.append(
                f"control leaf '{name}' excluded from replication: "
                "branch predicates must be voted before the branch; "
                "an unprotected loop variable defeats every replica")

    if cfg.num_clones > 1:
        # NotProtected -> Protected: a replicated leaf reading a mutable
        # leaf excluded from the SoR by scope choice imports one corruptible
        # copy into every replica.  KIND_LINK leaves are sanctioned
        # crossings, not holes: the engine votes their commit (vote-then-
        # exchange), or the region declares unvoted_crossing and votes the
        # in-flight copies on the receive side (exchange-then-vote).
        mutable_unprot = {
            n for n in region.spec
            if not replicated[n] and n in flow.written
            and region.spec[n].kind not in (KIND_RO, KIND_LINK)
            and _scope_excluded(region, cfg, n)}
        for name in sorted(region.spec):
            if not replicated[name] or region.spec[name].no_verify:
                continue
            bad = (flow.deps.get(name, frozenset()) & mutable_unprot) - {name}
            for src in sorted(bad):
                errors.append(
                    f"replicated leaf '{name}' reads mutable unprotected "
                    f"leaf '{src}': NotProtected->Protected writes are not "
                    "OK; replicate the source or mark it no_verify")
        # Protected -> NotProtected: OK, with a forced vote before the store.
        for name in sorted(region.spec):
            if replicated[name] or region.spec[name].kind == KIND_RO:
                continue
            if name in flow.written and any(
                    replicated.get(s, False)
                    for s in flow.deps.get(name, frozenset())):
                forced_sync.add(name)

    if errors:
        raise SoRViolation(errors)
    return frozenset(forced_sync)
