"""The COAST.h annotation surface: one module, every user-facing macro.

The counterpart of ``coast_tpu/coast_h.py``.  Each macro of the
reference's ``COAST.h`` maps to a LeafSpec / Region / ProtectionConfig
idiom:

  =====================  ====================================================
  COAST.h macro          coast_tpu_torch equivalent
  =====================  ====================================================
  __xMR                  ``xMR(spec)``: LeafSpec with xmr=True
  __NO_xMR               ``NO_xMR(spec)``: LeafSpec with xmr=False
  __DEFAULT_NO_xMR       ``Region(default_xmr=False)``
  __NO_xMR_ARG(n)        ``no_xmr_arg(n)(fn)`` / ``replicated_return(fn,
                         no_xmr_args=(n,))`` (interface/wrappers.py)
  __xMR_RET_VAL          ``replicated_return(fn)``, or -cloneReturn naming
                         a Region.functions entry
  __xMR_PROT_LIB         ``protected_lib(fn)``, or -protectedLibFn naming a
                         Region.functions entry
  __xMR_ALL_AFTER_CALL   ``clone_after_call(fn)``, or -cloneAfterCall
  __ISR_FUNC             refused: a stepped region has no interrupts
  __COAST_VOLATILE       ``VOLATILE(spec)``: LeafSpec with no_verify=True
  __COAST_IGNORE_GLOBAL  ProtectionConfig(ignore_globals=...)
  =====================  ====================================================

Precedence is the reference's: ProtectionConfig scope lists override
region annotations, which override ``default_xmr``.
"""

from __future__ import annotations

import dataclasses

from coast_tpu_torch.interface.wrappers import (clone_after_call, no_xmr_arg,
                                                protected_lib,
                                                replicated_return)
from coast_tpu_torch.ir.region import LeafSpec

__all__ = ["xMR", "NO_xMR", "VOLATILE", "no_xmr_arg", "protected_lib",
           "replicated_return", "clone_after_call", "LeafSpec"]


def xMR(spec: LeafSpec = None, **kw) -> LeafSpec:
    """__xMR: force the leaf into the sphere of replication."""
    base = spec if spec is not None else LeafSpec(**kw)
    return dataclasses.replace(base, xmr=True)


def NO_xMR(spec: LeafSpec = None, **kw) -> LeafSpec:
    """__NO_xMR: keep the leaf out of the sphere of replication."""
    base = spec if spec is not None else LeafSpec(**kw)
    return dataclasses.replace(base, xmr=False)


def VOLATILE(spec: LeafSpec = None, **kw) -> LeafSpec:
    """__COAST_VOLATILE: exempt the leaf from SoR verification."""
    base = spec if spec is not None else LeafSpec(**kw)
    return dataclasses.replace(base, no_verify=True)
