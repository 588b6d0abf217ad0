"""Registry shim for the RTOS kernel targets: the model lives in
``coast_tpu_torch/rtos/``; this module gives ``rtos_mm`` and
``rtos_kUser`` a file under ``models/`` for ``model_source``."""

from coast_tpu_torch.rtos.apps import make_rtos_kuser, make_rtos_mm

__all__ = ["make_rtos_mm", "make_rtos_kuser"]
