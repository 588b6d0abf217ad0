"""Benchmark regions of the port, by the reference's registry names."""

from __future__ import annotations

import importlib
import importlib.util
import os
from typing import Callable, Dict

from coast_tpu_torch import device as device_mod
from coast_tpu_torch.ir.region import Region


def _lazy(modname: str, fn: str = "make_region",
          package: str = "coast_tpu_torch.models") -> Callable[[], Region]:
    def make(**kw) -> Region:
        mod = importlib.import_module(f"{package}.{modname}")
        return getattr(mod, fn)(**kw)
    make.module = f"{package}.{modname}"
    return make


REGISTRY: Dict[str, Callable[[], Region]] = {
    "matrixMultiply": _lazy("mm"),
    "matrixMultiply256": _lazy("mm256"),
    "matrixMultiply1024": _lazy("mm256", "make_region_1024"),
    "matrixMultiply1024b512": _lazy("mm256", "make_region_1024_b512"),
    "crc16": _lazy("crc16"),
    "quicksort": _lazy("quicksort"),
    "aes": _lazy("aes"),
    "sha256": _lazy("sha256"),
    "chstone_mips": _lazy("chstone_mips"),
    "chstone_sha": _lazy("chstone.sha"),
    "chstone_adpcm": _lazy("chstone.adpcm"),
    "chstone_blowfish": _lazy("chstone.blowfish"),
    "chstone_dfadd": _lazy("chstone.dfkernels", "make_dfadd"),
    "chstone_dfmul": _lazy("chstone.dfkernels", "make_dfmul"),
    "chstone_dfdiv": _lazy("chstone.dfkernels", "make_dfdiv"),
    "chstone_dfsin": _lazy("chstone.dfkernels", "make_dfsin"),
    "chstone_gsm": _lazy("chstone.gsm"),
    "chstone_motion": _lazy("chstone.motion"),
    "chstone_jpeg": _lazy("chstone.jpeg"),
    "towersOfHanoi": _lazy("hanoi"),
    "crazyCF": _lazy("crazycf"),
    "whetstone": _lazy("whetstone"),
    "simd": _lazy("vector", "make_simd_region"),
    "scalarize": _lazy("vector", "make_scalarize_region"),
    "cache_test": _lazy("cache_test"),
    "schedule2": _lazy("schedule2"),
    "trivial": _lazy("smoke", "make_trivial_region"),
    "helloWorld": _lazy("smoke", "make_hello_region"),
    "simpleTMR": _lazy("smoke", "make_simple_tmr_region"),
    "nestedCalls": _lazy("nested_calls"),
    "rtos_app": _lazy("rtos_app"),
    "rtos_mm": _lazy("rtos_kernel", "make_rtos_mm"),
    "rtos_kUser": _lazy("rtos_kernel", "make_rtos_kuser"),
    # The protected training step (coast_tpu_torch.train).
    "train_mlp": _lazy("mlp", "make_region", "coast_tpu_torch.train"),
    "train_mlp_adam": _lazy("mlp", "make_region_adam",
                            "coast_tpu_torch.train"),
    # The sharded halo-exchange stencil; the registry build is the
    # vote-then-exchange placement, ``resolve_region("stencil",
    # placement="link")`` the other.
    "stencil": _lazy("stencil"),
}

# The CHStone sub-suite (BASELINE config 4: full TMR campaign), the
# reference's tuple: 12 kernels, aes the shared aes region.
CHSTONE = ("chstone_mips", "chstone_sha", "chstone_adpcm",
           "chstone_blowfish", "chstone_dfadd", "chstone_dfmul",
           "chstone_dfdiv", "chstone_dfsin", "chstone_gsm",
           "chstone_motion", "chstone_jpeg", "aes")

#: The reference registry's other names, not ported yet, with the ROADMAP
#: Queue A item that brings each: none left.
UNPORTED: Dict[str, str] = {}


def c_source_paths(arg: str):
    """Split a '+'-joined C-source argument (multi-translation-unit
    programs: the reference links aes.c with TI_aes_128.c) and validate
    existence; FileNotFoundError names the first missing file.  The ONE
    place the '+' convention is interpreted: the CLIs and the harness
    all route here."""
    paths = arg.split("+")
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(missing[0])
    return paths


def resolve_region(arg: str, device=None, **kw) -> Region:
    """The program argument of the CLIs: a registry name or a restricted-C
    ``.c`` source path (``+``-joined for several translation units), as
    the reference's tools take the program by file.  Raises
    FileNotFoundError for a missing .c path, KeyError for an unknown
    name, LiftError (``CLiftError``) for a source outside the subset.
    ``device`` is where a C program's lift measures a while phase (the
    card unless ``"cpu"``).  ``**kw`` goes to the name's factory (the
    stencil's ``placement``); a factory without the knob raises
    TypeError, and a C source takes none."""
    if arg.endswith(".c"):
        if kw:
            raise TypeError(
                f"factory arguments {sorted(kw)} do not apply to "
                "C-source programs")
        paths = c_source_paths(arg)
        from coast_tpu_torch.frontend import lift_c
        # Single-TU programs name after the file; multi-TU programs
        # after their common directory (gsm's add.c+gsm.c+lpc.c is
        # "gsm", not "add").
        if len(paths) == 1:
            name = os.path.splitext(os.path.basename(paths[0]))[0]
        else:
            name = os.path.basename(os.path.dirname(
                os.path.abspath(paths[0]))) or "program"
        return lift_c(name, paths,
                      device=device_mod.DEFAULT if device is None
                      else device)
    if arg in UNPORTED:
        raise NotImplementedError(
            f"benchmark {arg!r} is not ported yet; see ROADMAP Queue A "
            f"{UNPORTED[arg]}")
    if arg not in REGISTRY:
        raise KeyError(arg)
    return REGISTRY[arg](**kw)


def model_source(name: str) -> str:
    """Absolute path of the port's model module behind a REGISTRY name:
    line 1 of a reference-format log (the reference names its own model
    module there; the reference's jsonParser refuses a log whose line-1
    path does not exist).  Unknown names fall back to the package."""
    make = REGISTRY.get(name)
    if make is not None:
        spec = importlib.util.find_spec(make.module)
        if spec is not None and spec.origin:
            return os.path.realpath(spec.origin)
    import coast_tpu_torch
    return os.path.realpath(coast_tpu_torch.__file__)
