"""Bytes the voting must move, counted from the work itself.

For every sync point of the reference's TMR plan (``reference/engine.
sync_plan``) a vote of a ``W``-word replica set reads each of its three
replicas once (``3 W`` words), writes the voted words once (``W``) and one
flag word: ``16 W + 4`` bytes.  A store window votes only the rows the
step stores, and only at the steps that store.  The plan's votes land on
the kernels as the configuration builds them: unfused, every vote is K1's;
fused (``fuse_step``), the whole-leaf votes a repair follows (load sync,
commit) are K2's and the windows and the region boundary stay K1's.

A row's share is counted over the steps it ran while live (its record's
T): a halted row needs no vote.  So a later change that regroups, fuses or
renames the kernels does not move the count; one that votes halted rows or
unstored rows spends time the count does not pay for.

``HBM_BYTES_PER_S`` is one NVIDIA H100 SXM's published memory bandwidth
(3.35 TB/s at its full 700 W limit).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

from perfbench import kernels
from perfbench.reference.engine import Region, sync_plan

HBM_BYTES_PER_S = 3.35e12
WORD = 4


def vote_bytes(words: int) -> int:
    """One vote of a ``words``-word replica set."""
    return (3 * words + words) * WORD + WORD


def _window_words(region: Region, name: str) -> int:
    leaf = region.leaf(name)
    return region.window_rows * math.prod(leaf.shape[1:])


def per_row(region: Region, fused: bool) -> Dict[str, Dict[str, int]]:
    """Bytes a row moves, by kernel: ``{"trip": ..., "store": ...,
    "boundary": ...}`` for K1 and K2 (a store trip adds ``store``)."""
    plan = sync_plan(region)
    whole = kernels.K2 if fused else kernels.K1
    out = {k: {"trip": 0, "store": 0, "boundary": 0}
           for k in (kernels.K1, kernels.K2)}
    for name in plan.pre:
        out[whole]["trip"] += vote_bytes(region.leaf(name).words)
    for name in plan.commit:
        if name in region.windows:
            out[kernels.K1]["store"] += vote_bytes(
                _window_words(region, name))
        else:
            out[whole]["trip"] += vote_bytes(region.leaf(name).words)
    for name in plan.boundary:
        out[kernels.K1]["boundary"] += vote_bytes(region.leaf(name).words)
    return out


def campaign_bytes(region: Region, fused: bool,
                   steps: np.ndarray) -> Dict[str, int]:
    """Bytes of a campaign whose rows ran ``steps`` live steps each."""
    steps = np.asarray(steps, np.int64)
    stores = region.store_trips(steps) if region.windows else 0
    rows = per_row(region, fused)
    return {k: int(v["trip"] * steps.sum() + v["store"] * np.sum(stores)
                   + v["boundary"] * steps.size)
            for k, v in rows.items()}


def share_pct(bytes_moved: float, device_s: float) -> "float | None":
    """Share of the bandwidth bound: bytes over peak, over device time."""
    if device_s <= 0 or bytes_moved <= 0:
        return None
    return 100.0 * bytes_moved / HBM_BYTES_PER_S / device_s
