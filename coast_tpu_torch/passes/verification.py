"""Sphere-of-Replication verification: the verifyOptions step, and the
region's dataflow facts the sync tables are built from.

The counterpart of ``coast_tpu/passes/verification.py``.  The reference
derives :class:`RegionDataflow` by walking the step's jaxpr; this slice has
no graph walker (ROADMAP Queue A item 17), so each ported region declares
its dataflow in ``meta["dataflow"]`` and the tests hold the declaration
equal to the reference's ``analyze()`` of the JAX twin.

``verify_options`` ports the rule checks that concern the scope lists
(``ignore_globals`` / ``xmr_globals``, the function-scope lists,
``-isrFunctions`` and ``-runtimeInitGlobals``) and the read-only / control
rules they interact with; violations raise :class:`SoRViolation` with the
reference's messages.  A region with named sub-functions declares the
dataflow of its step with the raw functions bound, as the reference's
analysis sees it.
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
    reference's syncGEP votes."""

    written: FrozenSet[str]
    deps: Dict[str, FrozenSet[str]]
    load_addr: FrozenSet[str] = frozenset()
    store_addr: FrozenSet[str] = frozenset()


def analyze(region: Region) -> RegionDataflow:
    """The region's declared dataflow (``meta["dataflow"]``)."""
    flow = region.meta.get("dataflow")
    if flow is None:
        raise NotImplementedError(
            f"region {region.name} declares no meta['dataflow']; deriving it "
            "from the step is ROADMAP Queue A item 17")
    return flow


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
