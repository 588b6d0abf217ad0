"""Row indexing with the reference's clamped semantics, per batch row.

The counterpart of ``coast_tpu/ops/indexing.py`` ``row_select`` /
``row_update``.  A region walks its arrays with a loop counter that a fault
can corrupt; the reference treats an out-of-range index exactly as
``lax.dynamic_slice`` does -- one python-style negative wrap, then a clamp
into range -- so a corrupted counter reads or writes a wrong row instead of
trapping.  Torch advanced indexing raises on an out-of-range index, so the
index is wrapped and clamped here first.

Both functions take ``mat`` with a leading row axis ``R`` and one index per
row (``i`` int32 ``[R]``); the indexed axis is ``mat``'s axis 1.
"""

from __future__ import annotations

import torch


def clamp_index(i: torch.Tensor, n: int) -> torch.Tensor:
    """One negative wrap, then clamp into ``[0, n)``; int64 for indexing."""
    i = i.to(torch.int64)
    return torch.clamp(torch.where(i < 0, i + n, i), 0, n - 1)


def row_select(mat: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``mat[r, clamp(i[r])]`` for every row ``r``."""
    ic = clamp_index(i, mat.shape[1])
    return mat[torch.arange(mat.shape[0], device=mat.device), ic]


def row_update(mat: torch.Tensor, row: torch.Tensor,
               i: torch.Tensor) -> torch.Tensor:
    """A copy of ``mat`` with ``mat[r, clamp(i[r])] = row[r]``."""
    ic = clamp_index(i, mat.shape[1])
    out = mat.clone()
    out[torch.arange(mat.shape[0], device=mat.device), ic] = row
    return out
