"""coast_tpu_torch: software fault tolerance (TMR / DWC) in PyTorch + CUDA.

The port of ``coast_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA Hopper
card.  It imports ``torch`` and numpy only, never ``jax`` and nothing of
``coast_tpu``, whose package stays the reference the port is tested
against.  Layout mirrors the reference: ``ir/`` (the Region contract),
``ops/`` (indexing, voters, the bit flip, the Hopper vote kernel K1),
``models/`` (the matrixMultiply family), ``passes/`` (the replication
engine and the strategies), ``inject/`` (memory map, schedule, classify,
campaigns).  CUDA sources live in ``csrc/`` and are built by ``build.py``
at first use.

Entry points run on the card unless the caller passes ``device="cpu"``::

    from coast_tpu_torch import TMR
    from coast_tpu_torch.models import REGISTRY
    from coast_tpu_torch.inject.campaign import CampaignRunner
    prog = TMR(REGISTRY["matrixMultiply"]())            # on the card
    res = CampaignRunner(prog).run(4096, seed=1)
"""

from coast_tpu_torch.ir.region import (KIND_CTRL, KIND_MEM, KIND_REG, KIND_RO,
                                       LeafSpec, Region)
from coast_tpu_torch.passes.dataflow_protection import (ProtectedProgram,
                                                        ProtectionConfig,
                                                        protect)
from coast_tpu_torch.passes.strategies import DWC, EDDI, TMR, unprotected

__all__ = ["KIND_CTRL", "KIND_MEM", "KIND_REG", "KIND_RO", "LeafSpec",
           "Region", "ProtectedProgram", "ProtectionConfig", "protect",
           "DWC", "EDDI", "TMR", "unprotected"]
