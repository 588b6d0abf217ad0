"""The ``opt`` flag surface of the port: the subset the supervisor uses.

The counterpart of ``coast_tpu/opt.py``'s flag tables, ``parse_argv``,
``build_overrides`` and ``_parse_inject``, with the reference's flag names
(single-dash long flags, ``-flag=v1,v2`` comma lists) and error messages,
so the supervisor's ``-O`` string means the same program in both packages:
``-CFCSS``, ``-s``, the function-scope lists, ``-isrFunctions`` and
``-runtimeInitGlobals`` reach the engine, which checks the names as the
reference does.  The CLI's own
``main`` (``python -m coast_tpu.opt``: ``-dumpModule``, the lint gate,
``-propOut``) is ROADMAP Queue A item 17.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

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
