"""The protected training step, on torch tensors.

The counterpart of ``coast_tpu/train/``: :mod:`.mlp` is a small MLP whose
forward, backward (the gradient taken inside the replicated lanes with
``torch.func``) and optimizer phases run as protected micro-steps, with
the parameters and optimizer state as ``KIND_PARAM`` / ``KIND_OPT_STATE``
leaves.  :func:`selective_xmr` replicates the persistent state and runs
the backward pass once; ``train_probe`` splits a weight SDC into
``train_self_heal`` and ``train_sdc``.
"""

from coast_tpu_torch.train.mlp import (HEAL_WINDOW, ITERS, PHASES,
                                       flops_overhead, make_train_region,
                                       selective_xmr)

__all__ = ["make_train_region", "selective_xmr", "flops_overhead",
           "ITERS", "PHASES", "HEAL_WINDOW"]
