"""Strategy front-ends: TMR / DWC / EDDI / unprotected over the engine.

The counterpart of ``coast_tpu/passes/strategies.py``.  Every
ProtectionConfig knob flows through ``**overrides``; ``device`` (default the
card) goes to the program.
"""

from __future__ import annotations

import dataclasses

from coast_tpu_torch import device as device_mod
from coast_tpu_torch.ir.region import Region
from coast_tpu_torch.passes.dataflow_protection import (ProtectedProgram,
                                                        ProtectionConfig,
                                                        protect)


def TMR(region: Region, device=device_mod.DEFAULT,
        **overrides) -> ProtectedProgram:
    """Triple modular redundancy: 3 lanes, majority voters, fault masking."""
    cfg = dataclasses.replace(ProtectionConfig(num_clones=3), **overrides)
    if cfg.num_clones != 3:
        raise ValueError("TMR is fixed at 3 replicas")
    return protect(region, cfg, device)


def DWC(region: Region, device=device_mod.DEFAULT,
        **overrides) -> ProtectedProgram:
    """Duplication with compare: 2 lanes, compare + abort (detect-only)."""
    cfg = dataclasses.replace(ProtectionConfig(num_clones=2), **overrides)
    if cfg.num_clones != 2:
        raise ValueError("DWC is fixed at 2 replicas")
    return protect(region, cfg, device)


def EDDI(region: Region, device=device_mod.DEFAULT,
         **overrides) -> ProtectedProgram:
    """Deprecated; kept for name recognition like the reference."""
    raise NotImplementedError(
        "EDDI is deprecated. Switch to DWC (duplication with compare).")


def unprotected(region: Region, device=device_mod.DEFAULT,
                **overrides) -> ProtectedProgram:
    """Passthrough: the unprotected baseline build."""
    cfg = dataclasses.replace(ProtectionConfig(num_clones=1), **overrides)
    return protect(region, cfg, device)
