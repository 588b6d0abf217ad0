"""Bit-flip primitives: seeded XORs, one word per campaign row and site.

The counterpart of ``coast_tpu/ops/bitflip.py``.  Semantics follow the
reference's ``build_masks`` / ``apply_masks``: the target word of a leaf is
``lane * words_per_lane + word`` for a replicated leaf and ``word`` for a
shared one, every other leaf gets XOR 0, and the flip is gated by ``t ==
fault["t"] and not halted``.  The lowering is the one-word form of
``coast_tpu/ops/fused_step.py`` ``make_sparse_flipper``: a gather, an XOR
and a scatter of one int32 word per row, instead of a mask as large as the
state.  A target index outside the leaf flips nothing, as in the masked
form.  A flip group (``inject/schedule.FaultModel``) is one site a column,
applied in column order, so two flips of one word at one step cancel.

The XOR works on the int32 view of a leaf, so float leaves flip their raw
bits.  The bit mask is built in int64 and wrapped, so bit 31 yields
``INT32_MIN`` (``1 << 31`` overflows int32).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

Site = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


def bit_word(bit: np.ndarray) -> np.ndarray:
    """``1 << bit`` as the int32 word with that bit set; 0 for a bit
    outside [0, 32) (the reference's shift by >= 32 is 0)."""
    bit = np.asarray(bit, np.int64)
    ok = (bit >= 0) & (bit < 32)
    one = np.left_shift(np.int64(1), np.where(ok, bit, 0))
    return np.where(ok, one, 0).astype(np.uint32).view(np.int32)


def _bit_word(bit: torch.Tensor) -> torch.Tensor:
    """:func:`bit_word` on a tensor, on its device."""
    bit = bit.to(torch.int64)
    ok = (bit >= 0) & (bit < 32)
    one = torch.where(ok, torch.bitwise_left_shift(
        torch.ones_like(bit), bit.clamp(0, 31)), 0)
    return (one - ((one >> 31) << 32)).to(torch.int32)


def _column(v, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return torch.as_tensor(np.asarray(v, np.int32), device=device)


def build_site(leaf_order: List[str], lane_words: Mapping[str, int],
               lanes: Mapping[str, int], fault: Mapping[str, object],
               device, leaves: Sequence[int]) -> Site:
    """Per targeted leaf of one site column, ``(flat word index int64 [B],
    xor word int32 [B])``, built on ``device``.  ``fault`` holds [B]
    columns leaf_id/lane/word/bit, numpy arrays or tensors.  ``lane_words``
    is the flat word count of one lane of each leaf, ``lanes`` its lane
    count (1 for a shared leaf, whose ``lane`` column is ignored).
    ``leaves`` lists the leaf indices to build: a leaf no row targets
    would get XOR 0 in every row, so it is left out."""
    leaf_id, lane, word = (_column(fault[k], device).to(torch.int64)
                           for k in ("leaf_id", "lane", "word"))
    one = _bit_word(_column(fault["bit"], device))
    site: Site = {}
    for i in leaves:
        name = leaf_order[i]
        hit = leaf_id == i
        idx = lane * lane_words[name] + word if lanes[name] > 1 else word
        hit &= (idx >= 0) & (idx < lanes[name] * lane_words[name])
        site[name] = (torch.where(hit, idx, 0), torch.where(hit, one, 0))
    return site


def apply_site(pstate: Dict[str, torch.Tensor], site: Site,
               enable: torch.Tensor) -> None:
    """XOR each targeted word in place where ``enable`` (bool [B])."""
    for name, (idx, mask) in site.items():
        arr = pstate[name]
        flat = arr.view(torch.int32).view(arr.shape[0], -1)
        if flat.shape[1] == 0:
            continue        # a zero-size leaf holds no word to flip
        col = idx[:, None]
        cur = flat.gather(1, col)
        flat.scatter_(1, col, cur ^ torch.where(enable, mask, 0)[:, None])


def noop_fault() -> Dict[str, int]:
    """A well-formed fault that never fires: ``t = -1`` matches no step."""
    return {"leaf_id": 0, "lane": 0, "word": 0, "bit": 0, "t": -1}
