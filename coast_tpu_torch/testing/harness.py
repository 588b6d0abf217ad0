"""Flag-matrix regression harness: the unittest/unittest.py equivalent.

The counterpart of ``coast_tpu/testing/harness.py``.  The reference's
tier-1 functional tests build every benchmark with every ``OPT_PASSES``
combo and regex-check its self-check output (unittest/unittest.py:28-88;
configs ``unittest/cfg/{fast,full,full_tmr}.yml``).  Here one combo is one
in-process call of the port's opt CLI (``coast_tpu_torch.opt.main``) on a
device: the card unless the caller asks for the CPU.

The config format is the reference's, unchanged:

    benchmarks:
      - path: matrixMultiply         # registry name, or a suite name
        re: "E: 0"                   # optional stdout regex oracle
        passes: ["-TMR", "-DWC"]     # optional: overrides OPT_PASSES
    OPT_PASSES:
      - ""
      - "-DWC"
    drivers:
      - module: resume_smoke         # coast_tpu_torch.testing.<module>
        args: []

A ``.c`` benchmark path (``+``-joined for several translation units)
runs through the restricted-C lifter, as ``opt ... file.c`` does.
Every driver of ``fast.yml`` has its port.  PyYAML is imported
only by :func:`main`: the card's machine may lack it, and ``FAST`` /
``FULL`` hold ``unittest/cfg/fast.yml`` and ``full.yml`` as dicts.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import re
import sys
from typing import List, Optional, Tuple


class _Colors:
    HEADER = "\033[95m"
    OKBLUE = "\033[94m"
    FAIL = "\033[91m"
    ENDC = "\033[0m"


class HarnessError(Exception):
    pass


#: The drivers the port has (``coast_tpu_torch/testing/<name>.py``).
PORTED_DRIVERS = ("resume_smoke", "stream_smoke", "faultmodel_smoke",
                  "equiv_smoke", "train_smoke", "sparse_smoke",
                  "stencil_smoke", "propagation_smoke", "fused_smoke",
                  "obs_live_smoke", "slo_smoke", "fleet_smoke",
                  "profile_smoke", "ci_smoke", "serve_smoke", "fuzz")

_FAST_DRIVERS = ("resume_smoke", "stream_smoke", "faultmodel_smoke",
                 "equiv_smoke", "obs_live_smoke", "train_smoke",
                 "fleet_smoke", "ci_smoke", "sparse_smoke",
                 "propagation_smoke", "profile_smoke", "slo_smoke",
                 "serve_smoke", "stencil_smoke", "fused_smoke")

#: ``unittest/cfg/fast.yml`` (comments aside).
FAST = {
    "benchmarks": [{"path": p, "re": "E: 0"} for p in
                   ("matrixMultiply", "rtos_mm", "rtos_kUser", "train_mlp")],
    "OPT_PASSES": ["", "-DWC", "-TMR"],
    "drivers": [{"module": m, "args": []} for m in _FAST_DRIVERS],
}

#: ``unittest/cfg/full.yml`` (comments aside).
FULL = {
    "benchmarks": [{"path": p, "re": "E: 0"} for p in
                   ("matrixMultiply", "chstone", "crazyCF", "cache_test",
                    "crc16", "aes", "quicksort")],
    "OPT_PASSES": [
        "", "-DWC", "-TMR", "-TMR -countErrors",
        "-DWC -noMemReplication", "-TMR -noMemReplication",
        "-DWC -noLoadSync", "-TMR -noLoadSync",
        "-DWC -noStoreDataSync", "-TMR -noStoreDataSync",
        "-DWC -noStoreAddrSync", "-TMR -noStoreAddrSync",
        "-DWC -noMemReplication -noLoadSync",
        "-TMR -noMemReplication -noLoadSync",
        "-DWC -noMemReplication -noStoreDataSync",
        "-TMR -noMemReplication -noStoreDataSync",
        "-DWC -noMemReplication -noStoreAddrSync",
        "-TMR -noMemReplication -noStoreAddrSync"],
}


def expand_benchmarks(
        cfg: dict) -> List[Tuple[str, Optional[str], Optional[List[str]]]]:
    """Resolve cfg benchmark entries to ``(registry_name, regex,
    passes_override)`` rows; ``passes_override`` is None for benchmarks
    using the global OPT_PASSES column.  ``path`` may name one region or
    a suite ('chstone' expands to the CHSTONE tuple; 'all' to the whole
    registry)."""
    from coast_tpu_torch.models import CHSTONE, REGISTRY
    rows: List[Tuple[str, Optional[str], Optional[List[str]]]] = []
    for entry in cfg["benchmarks"]:
        path = entry["path"]
        regex = entry.get("re")
        if path == "all":
            names = sorted(REGISTRY)
        elif path == "chstone":
            names = list(CHSTONE)
        elif path in REGISTRY:
            names = [path]
        elif path.endswith(".c"):
            # C source paths ('+'-joined for multi-TU programs) run
            # through the same ingestion path as `opt ... file.c`.
            from coast_tpu_torch.models import c_source_paths
            try:
                c_source_paths(path)
            except FileNotFoundError as e:
                raise HarnessError(
                    f"No benchmark source at {e.args[0]!r}") from e
            names = [path]
        else:
            raise HarnessError(f"No benchmarks found at {path!r}")
        passes = entry.get("passes")
        if passes is not None and (not isinstance(passes, list)
                                   or not passes):
            raise HarnessError(
                f"'passes' for {path!r} must be a non-empty list of "
                "combo strings (omit it to use the global OPT_PASSES)")
        rows.extend((n, regex, passes) for n in names)
    return rows


def run_combo(bench: str, opt_passes: str,
              device: str = "cuda") -> Tuple[int, str]:
    """One (benchmark, OPT_PASSES) cell on ``device``: returns
    ``(exit_status, stdout)``."""
    from coast_tpu_torch.opt import main as opt_main
    argv = opt_passes.split() + [bench]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = opt_main(argv, device=device)
    return rc, buf.getvalue()


def run_config(cfg: dict, quiet: bool = False, device: str = "cuda") -> int:
    """The unittest.py main loop: every combo x every benchmark.  Returns
    the number of cells run; raises HarnessError on the first failure.
    Benchmarks with a ``passes`` override run their own combo column
    after the global matrix."""
    benches = expand_benchmarks(cfg)
    cells = 0

    def one_cell(bench, regex, opt_pass):
        rc, out = run_combo(bench, opt_pass, device)
        if rc != 0:
            print(out)
            raise HarnessError(
                f"Could not run {bench} with OPT_PASSES='{opt_pass}' "
                f"(exit {rc})")
        if regex is not None and not re.search(regex, out):
            print(out)
            raise HarnessError(
                f"Could not match stdout of {bench} using re "
                f"expression: {regex}")

    for opt_pass in cfg["OPT_PASSES"]:
        if not quiet:
            print(f"{_Colors.HEADER}OPT_PASSES: {opt_pass}{_Colors.ENDC}")
        for bench, regex, passes in benches:
            if passes is not None:
                continue                 # own column below
            if not quiet:
                print(f"  {_Colors.OKBLUE}{bench}{_Colors.ENDC}")
            one_cell(bench, regex, opt_pass)
            cells += 1
    for bench, regex, passes in benches:
        if passes is None:
            continue
        for opt_pass in passes:
            if not quiet:
                print(f"{_Colors.HEADER}OPT_PASSES: {opt_pass}"
                      f"{_Colors.ENDC}  {_Colors.OKBLUE}{bench}"
                      f"{_Colors.ENDC}")
            one_cell(bench, regex, opt_pass)
            cells += 1
    return cells


def run_drivers(cfg: dict, quiet: bool = False, device: str = "cuda") -> int:
    """The pyDriver.py layer (unittest/pyDriver.py:1-88): run each driver
    (``coast_tpu_torch.testing.<module>.main(argv)``, with ``-d device``
    unless its args name a device); each must print 'Success!'.  A
    config naming a driver the port does not have is refused before any
    driver runs."""
    import importlib
    for drv in cfg.get("drivers", ()):
        if drv["module"] not in PORTED_DRIVERS:
            raise HarnessError(f"no driver named {drv['module']!r}; the "
                               f"drivers are {', '.join(PORTED_DRIVERS)}")
    ran = 0
    for drv in cfg.get("drivers", ()):
        name = drv["module"]
        mod = importlib.import_module(f"coast_tpu_torch.testing.{name}")
        argv = [str(a) for a in drv.get("args", ())]
        if "-d" not in argv and "--device" not in argv:
            argv += ["-d", device]
        if not quiet:
            print(f"{_Colors.HEADER}driver: {name} "
                  f"{' '.join(argv)}{_Colors.ENDC}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = mod.main(argv)
        out = buf.getvalue()
        if rc != 0 or not re.search(r"Success!", out):
            print(out)
            raise HarnessError(f"driver {name} failed (exit {rc})")
        ran += 1
    return ran


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="yml-driven flag-matrix regression harness")
    parser.add_argument("config_yml")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("-d", "--device", default="cuda",
                        help="cuda (the card, default) or cpu")
    args = parser.parse_args(argv)

    import yaml
    try:
        with open(args.config_yml) as fh:
            cfg = yaml.safe_load(fh)
    except OSError:
        print(f"!!!! ERROR: Config file {args.config_yml} does not exist.")
        return 1
    except yaml.YAMLError as exc:
        print(f"!!!! ERROR: invalid YAML in {args.config_yml}: {exc}")
        return 1
    if not isinstance(cfg, dict):
        print(f"!!!! ERROR: Config file {args.config_yml} is empty or not "
              "a mapping.")
        return 1
    if "OPT_PASSES" in cfg and "benchmarks" not in cfg:
        print(f"!!!! ERROR: Config file {args.config_yml} has OPT_PASSES "
              "but no benchmarks section.")
        return 1

    try:
        cells = (run_config(cfg, quiet=args.quiet, device=args.device)
                 if "OPT_PASSES" in cfg else 0)
        cells += run_drivers(cfg, quiet=args.quiet, device=args.device)
    except HarnessError as e:
        print(f"{_Colors.FAIL}!!!! ERROR: {e}{_Colors.ENDC}")
        return 1
    print(f"{cells} cells passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
