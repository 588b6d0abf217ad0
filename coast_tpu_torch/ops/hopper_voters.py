"""K1 on Hopper: the replica-set vote as a hand-written CUDA kernel.

Replaces the Pallas TPU kernel ``coast_tpu/ops/pallas_voters.py``
``_vote_kernel``; the CUDA source and its design note are
``coast_tpu_torch/csrc/vote.cu``.  Its plain version is
``coast_tpu_torch/ops/voters.py`` (``vote`` and ``window``), which the
wrappers here take only for a tensor that lies on the CPU.  On a CUDA
tensor they launch the kernel or raise; there is no size floor and no
fall back.

``LAUNCHES`` counts kernel launches (one per wrapper call on the card), so
a run can show that its votes went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from coast_tpu_torch import build
from coast_tpu_torch.ops import voters

LAUNCHES = 0
_DTYPES = (torch.int32, torch.float32)


@functools.lru_cache(maxsize=None)
def _kernel():
    """``coast_vote`` of the built library, its C signature declared."""
    fn = build.load("vote").coast_vote
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(leaf: torch.Tensor, num_clones: int) -> None:
    if leaf.device.type != "cuda":
        raise ValueError(f"K1 runs on a CUDA tensor, not {leaf.device}")
    if leaf.dtype not in _DTYPES:
        raise TypeError(f"K1 votes 32-bit int32/float32 words, not {leaf.dtype}")
    if leaf.dim() < 2 or leaf.shape[1] != num_clones or num_clones not in (2, 3):
        raise ValueError(
            f"K1 takes a [R, n, ...] replica set with n = num_clones in "
            f"(2, 3); got shape {tuple(leaf.shape)} for n={num_clones}")
    if not leaf.is_contiguous():
        raise ValueError("K1 takes a contiguous replica set")
    if leaf.shape[0] == 0 or leaf[0, 0].numel() == 0:
        raise ValueError(f"K1 got an empty replica set {tuple(leaf.shape)}")


def _launch(leaf: torch.Tensor, width: int,
            offsets: Optional[torch.Tensor]) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    global LAUNCHES
    rows, n = leaf.shape[:2]
    lane_words = leaf[0, 0].numel()
    voted = torch.empty((rows, width), dtype=leaf.dtype, device=leaf.device)
    mis = torch.zeros(rows, dtype=torch.int32, device=leaf.device)
    stream = torch.cuda.current_stream(leaf.device).cuda_stream
    err = _kernel()(leaf.data_ptr(), voted.data_ptr(), mis.data_ptr(),
                    rows, n, width, lane_words, n * lane_words,
                    None if offsets is None else offsets.data_ptr(),
                    int(leaf.dtype == torch.float32), leaf.device.index or 0,
                    stream)
    if err != 0:
        raise RuntimeError(f"K1 vote launch failed: cudaError {err} for "
                           f"shape {tuple(leaf.shape)} width {width}")
    LAUNCHES += 1
    return voted, mis.bool()


def vote(lanes: torch.Tensor,
         num_clones: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vote a replica set ``[R, n, *leaf]`` -> ``(voted [R, *leaf],
    miscompare bool [R])``."""
    if lanes.device.type == "cpu":
        return voters.vote(lanes, num_clones)
    _check(lanes, num_clones)
    voted, mis = _launch(lanes, lanes[0, 0].numel(), None)
    return voted.view(lanes.shape[:1] + lanes.shape[2:]), mis


def vote_window(leaf: torch.Tensor, offsets: torch.Tensor, width: int,
                num_clones: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vote words ``[offsets[r], offsets[r] + width)`` of every lane of row
    ``r`` of a ``[R, n, L]`` replica set, read in place -> ``(voted
    [R, width], miscompare bool [R])``.  A start clamps into
    ``[0, L - width]``, so the kernel never reads outside the lane."""
    if leaf.device.type == "cpu":
        return voters.vote(voters.window(leaf, offsets, width), num_clones)
    _check(leaf, num_clones)
    if leaf.dim() != 3 or not 0 < width <= leaf.shape[2]:
        raise ValueError(f"bad window {width} over {tuple(leaf.shape)}")
    if (offsets.device != leaf.device or offsets.dtype != torch.int32
            or offsets.shape != leaf.shape[:1] or not offsets.is_contiguous()):
        raise ValueError("offsets must be a contiguous int32 [R] tensor on "
                         "the replica set's device")
    return _launch(leaf, width, offsets)
