"""K2 on Hopper: the fused flip + vote + repair as a hand-written CUDA kernel.

Replaces the Pallas TPU kernel ``coast_tpu/ops/fused_step.py``
``_commit_kernel``; the CUDA source and its design note are
``coast_tpu_torch/csrc/commit.cu``.  Its plain version is
``coast_tpu_torch/ops/fused_step.py`` ``plain_vote_flip_commit``, which
``fused_step.vote_flip_commit`` takes only for a tensor that lies on the
CPU; on a CUDA tensor it calls :func:`launch` here, which launches the
kernel or raises.  There is no size floor and no fall back.

``LAUNCHES`` counts kernel launches (one per call on the card), so a run
can show that its fused commits went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from coast_tpu_torch import build

LAUNCHES = 0
_DTYPES = (torch.int32, torch.float32)


@functools.lru_cache(maxsize=None)
def _kernel():
    """``coast_commit`` of the built library, its C signature declared."""
    fn = build.load("commit").coast_commit
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(lanes: torch.Tensor, masks: Optional[torch.Tensor],
           num_clones: int) -> None:
    if lanes.device.type != "cuda":
        raise ValueError(f"K2 runs on a CUDA tensor, not {lanes.device}")
    if lanes.dtype not in _DTYPES:
        raise TypeError(
            f"K2 commits 32-bit int32/float32 words, not {lanes.dtype}")
    if (lanes.dim() < 2 or lanes.shape[1] != num_clones
            or num_clones not in (2, 3)):
        raise ValueError(
            f"K2 takes a [R, n, ...] replica set with n = num_clones in "
            f"(2, 3); got shape {tuple(lanes.shape)} for n={num_clones}")
    if not lanes.is_contiguous():
        raise ValueError("K2 takes a contiguous replica set")
    if lanes.shape[0] == 0 or lanes[0, 0].numel() == 0:
        raise ValueError(f"K2 got an empty replica set {tuple(lanes.shape)}")
    if masks is not None and (
            masks.device != lanes.device or masks.dtype != torch.int32
            or masks.shape != lanes.shape or not masks.is_contiguous()):
        raise ValueError(
            "masks must be a contiguous int32 tensor of the replica set's "
            f"shape {tuple(lanes.shape)} on its device")


def launch(lanes: torch.Tensor, masks: Optional[torch.Tensor],
           num_clones: int) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """K2 over ``lanes [R, n, *leaf]`` (and ``masks`` of the same shape, or
    None for no flip) -> ``(repaired [R, n, *leaf], voted [R, *leaf],
    miscompare bool [R])``, each a fresh tensor."""
    global LAUNCHES
    _check(lanes, masks, num_clones)
    rows = lanes.shape[0]
    repaired = torch.empty_like(lanes)
    voted = torch.empty(lanes.shape[:1] + lanes.shape[2:], dtype=lanes.dtype,
                        device=lanes.device)
    mis = torch.zeros(rows, dtype=torch.int32, device=lanes.device)
    stream = torch.cuda.current_stream(lanes.device).cuda_stream
    err = _kernel()(lanes.data_ptr(),
                    None if masks is None else masks.data_ptr(),
                    repaired.data_ptr(), voted.data_ptr(), mis.data_ptr(),
                    rows, num_clones, lanes[0, 0].numel(),
                    int(lanes.dtype == torch.float32),
                    lanes.device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"K2 commit launch failed: cudaError {err} for "
                           f"shape {tuple(lanes.shape)}")
    LAUNCHES += 1
    return repaired, voted, mis.bool()
