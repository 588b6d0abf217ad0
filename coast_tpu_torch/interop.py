"""Carrying region state and fault columns between numpy and the port.

The system has no weights: what a reference run and a port run must share
is the region's memory image and the fault schedule.  Both cross as numpy
arrays.  State words stay 32-bit; ``torch.uint32`` has no add, compare or
shift, so a uint32 leaf is carried as ``torch.int32`` (the same bits) and
its logical type lives on the leaf's spec (``LeafSpec.unsigned``).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_WORD_TYPES = (np.int32, np.float32)


def state_from_numpy(arrays: Mapping[str, np.ndarray],
                     device) -> Dict[str, torch.Tensor]:
    """Region leaves (numpy, e.g. a reference ``init()`` image) -> the
    port's state dict: uint32 is reinterpreted as int32, int32 and f32
    stay.  The tensors are copies, never views of the arrays."""
    out = {}
    for name, arr in arrays.items():
        arr = np.asarray(arr)
        if arr.dtype == np.uint32:
            arr = arr.view(np.int32)
        if arr.dtype not in _WORD_TYPES:
            raise TypeError(
                f"leaf {name!r} has dtype {arr.dtype}; region state must be "
                "32-bit words (int32, uint32 or float32)")
        out[name] = torch.tensor(arr, device=device)
    return out


def state_to_numpy(state: Mapping[str, torch.Tensor],
                   region) -> Dict[str, np.ndarray]:
    """Inverse of :func:`state_from_numpy`: leaves the region's spec marks
    ``unsigned`` come back as uint32."""
    out = {}
    for name, t in state.items():
        arr = t.detach().cpu().numpy()
        if region.spec[name].unsigned:
            arr = arr.view(np.uint32)
        out[name] = arr
    return out


def fault_from_numpy(cols: Mapping[str, np.ndarray],
                     device) -> Dict[str, torch.Tensor]:
    """Fault columns (leaf_id, lane, word, bit, t) -> int32 tensors."""
    return {k: torch.tensor(np.asarray(v, np.int32), device=device)
            for k, v in cols.items()}
