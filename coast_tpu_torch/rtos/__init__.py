"""The preemptive RTOS kernel model, on torch tensors.

The counterpart of ``coast_tpu/rtos/``: :mod:`.kernel` is a tick-driven
preemptive round-robin scheduler as a protected region (per-task stacks as
``KIND_STACK`` leaves with a canary word, TCB saved SPs, the ready list,
the current-task pointer, a message queue), whose ``stack_guard`` and
``assert_guard`` latch the DUE_STACK_OVERFLOW and DUE_ASSERT classes;
:mod:`.apps` holds the task sets of the ``rtos_mm`` and ``rtos_kUser``
targets; :mod:`.campaign` runs the canonical-config campaign
(``rtos/Makefile`` plus ``rtos/kernel.config``).
"""

from coast_tpu_torch.rtos.kernel import (CANARY, FRAME_WORDS, N_TASKS,
                                         STACK_WORDS, make_kernel_region)

__all__ = ["make_kernel_region", "CANARY", "N_TASKS", "STACK_WORDS",
           "FRAME_WORDS"]
