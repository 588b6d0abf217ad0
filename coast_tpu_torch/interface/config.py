"""Scope-configuration ingestion: config file + command-line lists.

File format is byte-compatible with the reference's functions.config
(parsed at interface.cpp:172-241): ``key = name, name, ...`` lines, ``#``
comments, blank lines skipped, all whitespace stripped, unknown keys are a
hard error.  Default location: ``$COAST_TPU_ROOT/functions.config`` falling
back to ``./functions.config`` (the reference uses ``$COAST_ROOT/...``).

Merging follows getFunctionsFromCL (interface.cpp:82-164): command-line
lists are appended after the config file's, and the clone lists remove
matching names from the ignore lists ("pretty much reverse priority").
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

# The six keys the reference config parser accepts (interface.cpp:211-228).
FILE_KEYS = ("skipLibCalls", "ignoreFns", "replicateFnCalls", "ignoreGlbls",
             "runtimeInitGlobals", "isrFunctions")


class ConfigError(Exception):
    """Unknown option / unreadable file (the reference prints and returns
    nonzero, failing the pass; interface.cpp:187-191, 224-228)."""


@dataclasses.dataclass
class ScopeConfig:
    """All scope lists, mirroring the reference's internal editable lists
    (interface.cpp:40-61)."""

    skip_lib_calls: List[str] = dataclasses.field(default_factory=list)
    ignore_fns: List[str] = dataclasses.field(default_factory=list)
    replicate_fn_calls: List[str] = dataclasses.field(default_factory=list)
    ignore_glbls: List[str] = dataclasses.field(default_factory=list)
    runtime_init_globals: List[str] = dataclasses.field(default_factory=list)
    isr_functions: List[str] = dataclasses.field(default_factory=list)
    clone_fns: List[str] = dataclasses.field(default_factory=list)
    clone_glbls: List[str] = dataclasses.field(default_factory=list)
    clone_return: List[str] = dataclasses.field(default_factory=list)
    clone_after_call: List[str] = dataclasses.field(default_factory=list)
    protected_lib_fns: List[str] = dataclasses.field(default_factory=list)

    _FIELD_OF_KEY = {
        "skipLibCalls": "skip_lib_calls",
        "ignoreFns": "ignore_fns",
        "replicateFnCalls": "replicate_fn_calls",
        "ignoreGlbls": "ignore_glbls",
        "runtimeInitGlobals": "runtime_init_globals",
        "isrFunctions": "isr_functions",
        "cloneFns": "clone_fns",
        "cloneGlbls": "clone_glbls",
        "cloneReturn": "clone_return",
        "cloneAfterCall": "clone_after_call",
        "protectedLibFn": "protected_lib_fns",
    }

    def merge_cl(self, cl_lists: Dict[str, List[str]]) -> None:
        """Append command-line lists with the reference's override rules:
        cloneFns removes from ignoreFns, cloneGlbls from ignoreGlbls,
        replicateFnCalls from skipLibCalls, and cloneAfterCall implies
        skipLibCalls+ignoreFns (interface.cpp:88-164)."""
        for key, values in cl_lists.items():
            field = self._FIELD_OF_KEY.get(key)
            if field is None:
                raise ConfigError(f"unrecognized option '{key}'")
            getattr(self, field).extend(values)
        for x in cl_lists.get("replicateFnCalls", ()):
            while x in self.skip_lib_calls:
                self.skip_lib_calls.remove(x)
        for x in cl_lists.get("cloneFns", ()):
            while x in self.ignore_fns:
                self.ignore_fns.remove(x)
        for x in cl_lists.get("cloneGlbls", ()):
            while x in self.ignore_glbls:
                self.ignore_glbls.remove(x)
        for x in cl_lists.get("cloneAfterCall", ()):
            self.skip_lib_calls.append(x)
            self.ignore_fns.append(x)

    def protection_overrides(self) -> Dict[str, Tuple[str, ...]]:
        """The engine-facing knobs: every scope list, forwarded to
        ProtectionConfig.  Function-scope lists rewrap the region's named
        sub-functions per class (dataflow_protection.fn_scope_of); names
        that don't exist and flags with no tpu semantics are hard errors
        in verify_options, never silently inert."""
        u = lambda xs: tuple(dict.fromkeys(xs))  # noqa: E731 - dedupe, keep order
        return {
            "ignore_globals": u(self.ignore_glbls),
            "xmr_globals": u(self.clone_glbls),
            "ignore_fns": u(self.ignore_fns),
            "skip_lib_calls": u(self.skip_lib_calls),
            "replicate_fn_calls": u(self.replicate_fn_calls),
            "clone_fns": u(self.clone_fns),
            "clone_return_fns": u(self.clone_return),
            "clone_after_call_fns": u(self.clone_after_call),
            "protected_lib_fns": u(self.protected_lib_fns),
            "isr_functions": u(self.isr_functions),
            "runtime_init_globals": u(self.runtime_init_globals),
        }


def default_config_path() -> str:
    root = os.environ.get("COAST_TPU_ROOT")
    if root:
        return os.path.join(root, "functions.config")
    return "functions.config"


def parse_config_file(path: Optional[str] = None,
                      required: bool = False) -> ScopeConfig:
    """Parse a functions.config-format file into a ScopeConfig.

    Missing file: error only if ``required`` (the reference always errors,
    but ships a default file; we default to empty scope so the CLI works
    without one unless -configFile was given explicitly)."""
    filename = path or default_config_path()
    cfg = ScopeConfig()
    try:
        fh = open(filename, "r")
    except OSError:
        if required:
            raise ConfigError(
                f"No configuration file found at '{filename}'. "
                "Please pass one in using -configFile")
        return cfg
    with fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            line = line.replace(" ", "").replace("\t", "")
            key, sep, rest = line.partition("=")
            if not sep:
                raise ConfigError(f"malformed line (no '=') in '{filename}': "
                                  f"{line!r}")
            if key not in FILE_KEYS:
                raise ConfigError(f"unrecognized option '{key}' in "
                                  f"configuration file '{filename}'")
            field = getattr(cfg, ScopeConfig._FIELD_OF_KEY[key])
            field.extend(v for v in rest.split(",") if v)
    return cfg
