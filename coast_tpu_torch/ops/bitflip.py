"""Bit-flip primitives: one seeded XOR per campaign row.

The counterpart of ``coast_tpu/ops/bitflip.py``.  Semantics follow the
reference's ``build_masks`` / ``apply_masks``: the target word of a leaf is
``lane * words_per_lane + word`` for a replicated leaf and ``word`` for a
shared one, every other leaf gets XOR 0, and the flip is gated by ``t ==
fault["t"] and not halted``.  The lowering is the one-word form of
``coast_tpu/ops/fused_step.py`` ``make_sparse_flipper``: a gather, an XOR
and a scatter of one int32 word per row, instead of a mask as large as the
state.  A target index outside the leaf flips nothing, as in the masked
form.

The XOR works on the int32 view of a leaf, so float leaves flip their raw
bits.  The bit mask is built in int64 and wrapped, so bit 31 yields
``INT32_MIN`` (``1 << 31`` overflows int32).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

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


def build_site(leaf_order: List[str], lane_words: Mapping[str, int],
               lanes: Mapping[str, int], fault: Mapping[str, np.ndarray],
               device) -> Site:
    """Per targeted leaf, ``(flat word index int64 [B], xor word int32
    [B])``, built once per run on the host.  ``lane_words`` is the flat
    word count of one lane of each leaf, ``lanes`` its lane count (1 for a
    shared leaf, whose ``lane`` column is ignored).  Leaves no row targets
    are left out: their XOR would be 0 in every row."""
    leaf_id = np.asarray(fault["leaf_id"], np.int64)
    lane = np.asarray(fault["lane"], np.int64)
    word = np.asarray(fault["word"], np.int64)
    one = bit_word(fault["bit"])
    site: Site = {}
    for i, name in enumerate(leaf_order):
        hit = leaf_id == i
        if not hit.any():
            continue
        idx = lane * lane_words[name] + word if lanes[name] > 1 else word
        hit &= (idx >= 0) & (idx < lanes[name] * lane_words[name])
        site[name] = (torch.tensor(np.where(hit, idx, 0), device=device),
                      torch.tensor(np.where(hit, one, 0).astype(np.int32),
                                   device=device))
    return site


def apply_site(pstate: Dict[str, torch.Tensor], site: Site,
               enable: torch.Tensor) -> None:
    """XOR each targeted word in place where ``enable`` (bool [B])."""
    for name, (idx, mask) in site.items():
        arr = pstate[name]
        flat = arr.view(torch.int32).view(arr.shape[0], -1)
        col = idx[:, None]
        cur = flat.gather(1, col)
        flat.scatter_(1, col, cur ^ torch.where(enable, mask, 0)[:, None])


def noop_fault() -> Dict[str, int]:
    """A well-formed fault that never fires: ``t = -1`` matches no step."""
    return {"leaf_id": 0, "lane": 0, "word": 0, "bit": 0, "t": -1}
