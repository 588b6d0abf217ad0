"""Benchmark regions of the port, by the reference's registry names."""

from __future__ import annotations

import importlib
from typing import Callable, Dict

from coast_tpu_torch.ir.region import Region


def _lazy(modname: str, fn: str = "make_region") -> Callable[[], Region]:
    def make() -> Region:
        mod = importlib.import_module(f"coast_tpu_torch.models.{modname}")
        return getattr(mod, fn)()
    return make


REGISTRY: Dict[str, Callable[[], Region]] = {
    "matrixMultiply": _lazy("mm"),
    "matrixMultiply256": _lazy("mm256"),
    "matrixMultiply1024": _lazy("mm256", "make_region_1024"),
    "matrixMultiply1024b512": _lazy("mm256", "make_region_1024_b512"),
    "crc16": _lazy("crc16"),
}
