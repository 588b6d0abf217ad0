"""Device kernels by layer, by name: the yardstick's frozen grouping.

A copy of the grouping ``coast_tpu_torch/breakdown.py`` made when the
benchmark was defined, kept here so that a change to the program cannot
move the yardstick.  K1 is the hand-written vote (``csrc/vote.cu``,
``vote_kernel<N>``), K2 the fused vote-and-repair commit
(``csrc/commit.cu``, ``commit_kernel<N>``).  A later change that moves the
voting into kernels of other names needs a benchmark change to re-point
these lists; until then the K1 and K2 readers find nothing and report
nothing.
"""

from __future__ import annotations

K1 = "K1 vote"
K2 = "K2 commit"
GEMM = "product (cuBLAS)"
MEMCPY = "memcpy/memset"
ELEMENTWISE = "elementwise / indexing"

LAYERS = ((K1, ("vote_kernel",)),
          (K2, ("commit_kernel",)),
          (GEMM, ("gemm", "cutlass", "xmma", "cublas")),
          (MEMCPY, ("memcpy", "memset")))


def layer_of(kernel: str) -> str:
    low = kernel.lower()
    for layer, keys in LAYERS:
        if any(k in low for k in keys):
            return layer
    return ELEMENTWISE


def is_copy(kernel: str) -> bool:
    """A memory copy or fill of the runtime, not a launched kernel."""
    return layer_of(kernel) == MEMCPY
