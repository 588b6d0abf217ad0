"""The ``opt`` flag surface of the port: the subset the supervisor uses.

The counterpart of ``coast_tpu/opt.py``'s flag tables, ``parse_argv``,
``build_overrides`` and ``_parse_inject``, with the reference's flag names
(single-dash long flags, ``-flag=v1,v2`` comma lists) and error messages,
so the supervisor's ``-O`` string means the same program in both packages:
``-CFCSS``, ``-s``, the function-scope lists, ``-isrFunctions`` and
``-runtimeInitGlobals`` reach the engine, which checks the names as the
reference does.

:func:`main` (``python -m coast_tpu_torch.opt [-TMR|-DWC] [flags]
<benchmark>``) builds the program and runs it once on the card, optionally
with one flip (``-inject=leaf:lane:word:bit:t``), and prints the guest's
``C: E: F: T:`` line with the reference's exit codes: 134 and a hook line
on stderr for a stack-overflow or assert trip, a DWC or CFCSS abort; 124
for a timeout; else the error count (at most 100).

Every TMR or DWC build runs the replication-integrity gate first (the
provenance rules of ``analysis/lint`` and the lane-isolation prover of
``analysis/propagation`` over one CPU capture of the step and one shared
walk, the reference's ``verifyCloningSuccess`` check): an error finding
refuses the build with exit 1 unless ``-noCloneOpsCheck`` is given.
``-lintOut=<path>`` writes the report for any build, ``-propOut=<path>``
the static vulnerability map and the isolation proof (``{"vulnerability_map":
..., "isolation": ...}``; the map runs one fault-free run on the device to
bound the live flip window).  ``-dumpModule`` (or
``-dumpModule=jaxpr``) prints the captured graph of the step's first trip;
``-dumpModule=hlo`` prints the operation stream one trip dispatches on the
device, the aten operations and the K1/K2 launches with their site
records -- the closest the port has to the reference's compiled module.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

_BOOL_FLAGS = {
    "TMR", "DWC", "EDDI", "CFCSS",
    "noMemReplication", "noLoadSync", "noStoreDataSync", "noStoreAddrSync",
    "storeDataSync", "countErrors", "reportErrors", "countSyncs",
    "i", "s", "verbose", "noMain", "noCloneOpsCheck",
    "protectStack", "pallasVoters", "noPallasVoters",
    "fuseStep", "noFuseStep",
    "DebugStatements", "SmallProfile", "noPrint", "ExitMarker",
}
_LIST_FLAGS = {
    "ignoreFns", "ignoreGlbls", "skipLibCalls", "replicateFnCalls",
    "isrFunctions", "cloneFns", "cloneGlbls", "cloneReturn",
    "cloneAfterCall", "protectedLibFn", "runtimeInitGlobals",
    "fnPrintList",
}
# List flags that feed the scope config; fnPrintList is instrumentation-only.
_SCOPE_LIST_FLAGS = _LIST_FLAGS - {"fnPrintList"}
_STR_FLAGS = {"configFile", "inject", "printFnName", "lintOut", "propOut"}
# Flags accepted bare or with a value (-dumpModule=jaxpr|hlo).
_OPT_VALUE_FLAGS = {"dumpModule"}


class UsageError(Exception):
    pass


def parse_argv(argv: List[str]) -> Tuple[Dict[str, object], List[str]]:
    flags: Dict[str, object] = {}
    positional: List[str] = []
    for arg in argv:
        if not arg.startswith("-"):
            positional.append(arg)
            continue
        name, sep, value = arg[1:].partition("=")
        if name in _OPT_VALUE_FLAGS:
            flags[name] = value if sep else True
        elif name in _BOOL_FLAGS:
            if sep:
                raise UsageError(f"flag -{name} takes no value")
            flags[name] = True
        elif name in _LIST_FLAGS:
            if not sep:
                raise UsageError(f"flag -{name} needs =name,name,...")
            flags.setdefault(name, [])
            flags[name].extend(v for v in value.split(",") if v)  # type: ignore
        elif name in _STR_FLAGS:
            if not sep:
                raise UsageError(f"flag -{name} needs =value")
            flags[name] = value
        else:
            raise UsageError(f"unknown flag -{name}")
    return flags, positional


def _parse_inject(spec: str, prog) -> Dict[str, object]:
    """``leaf:lane:word:bit:t`` -> one fault, int32 0-d tensors on the
    program's device, range-checked against the leaf's geometry."""
    import torch
    parts = spec.split(":")
    if len(parts) != 5:
        raise UsageError("-inject=leaf:lane:word:bit:t")
    leaf, lane, word, bit, t = parts
    if leaf not in prog.leaf_order:
        raise UsageError(f"-inject: no injectable leaf '{leaf}' "
                         f"(have: {', '.join(prog.leaf_order)})")
    lane, word, bit, t = int(lane), int(word), int(bit), int(t)
    # The flipper ignores an index outside the leaf and a bit >= 32 is a
    # no-op: refuse both rather than flip nothing the user named.
    rows = {name: (lanes, words)
            for name, _, lanes, words in prog.injectable_sections()}
    lanes, words = rows[leaf]
    if not 0 <= lane < lanes:
        raise UsageError(f"-inject: lane {lane} out of range for '{leaf}' "
                         f"(has {lanes} lane(s))")
    if not 0 <= word < words:
        raise UsageError(f"-inject: word {word} out of range for '{leaf}' "
                         f"(has {words} word(s) per lane)")
    if not 0 <= bit < 32:
        raise UsageError(f"-inject: bit {bit} out of range (32-bit words)")
    if t < 0:
        raise UsageError(f"-inject: step {t} must be >= 0")
    return {k: torch.tensor(v, dtype=torch.int32, device=prog.device)
            for k, v in (("leaf_id", prog.leaf_order.index(leaf)),
                         ("lane", lane), ("word", word), ("bit", bit),
                         ("t", t))}


def build_overrides(flags: Dict[str, object]) -> Dict[str, object]:
    """Parsed flags -> ProtectionConfig overrides (incl. the scope lists
    from config file + CL merging), as the reference builds them."""
    from coast_tpu_torch.interface.config import parse_config_file
    scope = parse_config_file(flags.get("configFile"),
                              required="configFile" in flags)
    scope.merge_cl({k: v for k, v in flags.items()
                    if k in _SCOPE_LIST_FLAGS})
    overrides = dict(scope.protection_overrides())
    overrides["no_mem_replication"] = bool(flags.get("noMemReplication"))
    overrides["no_store_data_sync"] = bool(flags.get("noStoreDataSync"))
    overrides["no_load_sync"] = bool(flags.get("noLoadSync"))
    overrides["no_store_addr_sync"] = bool(flags.get("noStoreAddrSync"))
    overrides["count_errors"] = bool(flags.get("countErrors"))
    overrides["count_syncs"] = bool(flags.get("countSyncs"))
    overrides["segmented"] = bool(flags.get("s"))
    overrides["cfcss"] = bool(flags.get("CFCSS"))
    overrides["protect_stack"] = bool(flags.get("protectStack"))
    # Only a flag forces the voter switch; absence keeps the config's
    # default.
    if flags.get("pallasVoters") and flags.get("noPallasVoters"):
        raise UsageError(
            "-pallasVoters and -noPallasVoters are mutually exclusive")
    if flags.get("pallasVoters"):
        overrides["pallas_voters"] = True
    elif flags.get("noPallasVoters"):
        overrides["pallas_voters"] = False
    if flags.get("fuseStep") and flags.get("noFuseStep"):
        raise UsageError(
            "-fuseStep and -noFuseStep are mutually exclusive")
    if flags.get("fuseStep"):
        overrides["fuse_step"] = True
    elif flags.get("noFuseStep"):
        overrides["fuse_step"] = False
    return overrides


#: The usage text's note on -dumpModule's two formats.
_DUMP_HELP = ("-dumpModule[=jaxpr] prints the captured graph of the step; "
              "-dumpModule=hlo prints the operation stream one trip "
              "dispatches on the device (aten operations and K1/K2 "
              "launches with their site records), the closest the port "
              "has to a compiled module")


def main(argv: Optional[List[str]] = None, device: str = "cuda") -> int:
    """The ``opt`` CLI: build ``<benchmark>`` under the flags and run it
    once on ``device`` (the card unless the caller passes ``"cpu"``)."""
    argv = sys.argv[1:] if argv is None else argv
    try:
        flags, positional = parse_argv(argv)
    except UsageError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 2
    from coast_tpu_torch.models import REGISTRY, UNPORTED, c_source_paths
    is_c_source = len(positional) == 1 and positional[0].endswith(".c")
    if is_c_source:
        try:
            c_source_paths(positional[0])
        except FileNotFoundError as e:
            print(f"ERROR: file {e.args[0]} does not exist",
                  file=sys.stderr)
            return 2
    if not is_c_source and (len(positional) != 1 or positional[0] not in
                            {**REGISTRY, **UNPORTED}):
        print("usage: python -m coast_tpu_torch.opt [-TMR|-DWC] [flags] "
              f"<benchmark | program.c>\n{_DUMP_HELP}\n"
              f"benchmarks: {', '.join(sorted(REGISTRY))}\n"
              "or a C source file (restricted subset)",
              file=sys.stderr)
        return 2
    dump = flags.get("dumpModule")
    if dump not in (None, True, "jaxpr", "hlo"):
        print(f"ERROR: -dumpModule={dump}: format must be jaxpr or hlo",
              file=sys.stderr)
        return 2
    strategies = [s for s in ("TMR", "DWC", "EDDI") if flags.get(s)]
    if len(strategies) > 1:
        print(f"ERROR: choose one of -TMR/-DWC/-EDDI, got {strategies}",
              file=sys.stderr)
        return 2
    if flags.get("i") and flags.get("s"):
        print("ERROR: -i and -s are mutually exclusive", file=sys.stderr)
        return 2

    from coast_tpu_torch.interface.config import ConfigError
    try:
        overrides = build_overrides(flags)
    except UsageError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 2
    except ConfigError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1

    from coast_tpu_torch.frontend import LiftError
    from coast_tpu_torch.models import resolve_region
    from coast_tpu_torch.passes.strategies import DWC, EDDI, TMR, unprotected
    from coast_tpu_torch.passes.verification import SoRViolation
    strategy = strategies[0] if strategies else None
    try:
        region = resolve_region(positional[0], device=device)
    except LiftError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    try:
        if strategy == "TMR":
            prog = TMR(region, device=device, **overrides)
        elif strategy == "DWC":
            prog = DWC(region, device=device, **overrides)
        elif strategy == "EDDI":
            EDDI(region)           # raises: deprecated, switch to DWC
            return 1
        else:
            prog = unprotected(region, device=device, **{
                k: v for k, v in overrides.items()
                if k not in ("ignore_globals", "xmr_globals")})
    except SoRViolation as e:
        print(str(e), file=sys.stderr)
        return 1
    except NotImplementedError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1

    if flags.get("verbose"):
        for name in sorted(region.spec):
            print(f"# leaf {name}: kind={region.spec[name].kind} "
                  f"replicated={prog.replicated[name]}", file=sys.stderr)

    # The replication-integrity gate (verifyCloningSuccess analogue): the
    # provenance rules and the isolation prover run on every protected
    # build and refuse to run the program on an error; -noCloneOpsCheck
    # disables it, -lintOut and -propOut write their reports either way.
    # One capture and one shared walk feed them all.  The survival pass
    # stays with the lint CLI and the campaign pre-flight.
    trips = None
    gate = strategy in ("TMR", "DWC") and not flags.get("noCloneOpsCheck")
    if "lintOut" in flags or "propOut" in flags or gate:
        from coast_tpu_torch.analysis import lint as lint_mod
        from coast_tpu_torch.analysis.propagation import analyze_step
        trips = lint_mod.trace_step(prog)
        facts = analyze_step(prog, closed=trips,
                             track_paths="propOut" in flags)
        report = lint_mod.lint_program(
            prog, survival=False, strategy=strategy or "unprotected",
            closed=trips, propagation=True, facts=facts)
        if "lintOut" in flags:
            report.write_json(flags["lintOut"])          # type: ignore
        if "propOut" in flags:
            import json
            from coast_tpu_torch.analysis.propagation import (
                analyze_propagation, prove_isolation)
            vmap = analyze_propagation(prog, facts=facts)
            proof = prove_isolation(prog, facts=facts,
                                    strategy=strategy or "unprotected")
            with open(flags["propOut"], "w") as fh:     # type: ignore
                json.dump({"vulnerability_map": vmap.summary(),
                           "isolation": proof.summary()},
                          fh, indent=1, sort_keys=True)
                fh.write("\n")
        if gate and not report.ok:
            print(report.format(include_notes=False), file=sys.stderr)
            print("ERROR: replication-integrity check failed; rerun with "
                  "-noCloneOpsCheck to bypass", file=sys.stderr)
            return 1
    if dump is not None:
        from coast_tpu_torch.analysis.lint import capture
        if dump == "hlo":
            print(capture.dispatch_stream(prog))
        else:
            if trips is None:
                trips = capture.capture_run(prog, max_trips=1)
            print(capture.format_trip(trips[0]))

    fault = None
    if "inject" in flags:
        try:
            fault = _parse_inject(flags["inject"], prog)   # type: ignore
        except (UsageError, ValueError) as e:
            print(f"ERROR: {e}", file=sys.stderr)
            return 2
    if "printFnName" in flags:
        print("WARNING: -printFnName has no effect here (profile stats "
              "print host-side)", file=sys.stderr)

    want_trace = bool(flags.get("DebugStatements")
                      or (flags.get("SmallProfile")
                          and not flags.get("noPrint")))
    want_state = bool(flags.get("ExitMarker"))
    rec = prog.run(fault, trace=want_trace, return_state=want_state)
    if want_trace or want_state:
        from coast_tpu_torch.passes import instrument
        host = {k: v.cpu().numpy() for k, v in rec.items()
                if k != "final_state"}
        if flags.get("DebugStatements"):
            for line in instrument.format_trace(
                    prog, host, tuple(flags.get("fnPrintList", ()))):
                print(line)
        if flags.get("SmallProfile") and not flags.get("noPrint"):
            for line in instrument.format_profile_stats(
                    instrument.profile_counts(prog, host)):
                print(line)
        if want_state:
            digest = instrument.state_digest(
                {k: v.cpu().numpy() for k, v in rec["final_state"].items()})
            print("EXIT_MARKER: " + " ".join(
                f"{k}={v:#010x}" for k, v in digest.items()))

    errors = int(rec["errors"])
    if bool(rec["stack_fault"]):
        # The kernel's stack-overflow hook line.
        print("HALT: stack overflow in task <kernel>", file=sys.stderr)
        return 134
    if bool(rec["assert_fault"]):
        print("ASSERT FAILED: kernel invariant", file=sys.stderr)
        return 134
    if bool(rec["dwc_fault"]):
        print("FAULT_DETECTED_DWC: abort()", file=sys.stderr)
        return 134                       # SIGABRT convention
    if bool(rec["cfc_fault"]):
        print("FAULT_DETECTED_CFC: abort()", file=sys.stderr)
        return 134
    if not bool(rec["done"]):
        print("TIMEOUT: watchdog expired", file=sys.stderr)
        return 124                       # timeout(1) convention
    if flags.get("countSyncs"):
        print(f"__SYNC_COUNT: {int(rec['sync_count'])}")
    print(f"C: 0 E: {errors} F: {int(rec['corrected'])} "
          f"T: {int(rec['steps'])}")
    # Clamp below the 124/134 sentinels: a large error count stays
    # distinguishable from timeout, abort and success.
    return min(errors, 100)


if __name__ == "__main__":
    sys.exit(main())
