"""CFCSS: control-flow checking by software signatures, stackable with TMR
or DWC.

The counterpart of ``coast_tpu/passes/cfcss.py``.  Signatures are assigned
once a program on the host (``native.cfcss_assign``, the reference's
numpy body); the four tables go to the program's device once, at install.
The runtime tracker G and the previous block are injectable replicated
leaves, one word a lane (``[B, n]``, even at ``num_clones=1``), updated
each step before the block body commits:

    v_lane   = block_of(that lane's own control state)
    G'_lane  = G_lane ^ diffs[v] ^ (fanin[v] ? dedge[prev_lane, v] : 0)
    fault   |= any_lane(G'_lane != sigs[v]);   prev'_lane = v

Each lane is classified from its own pre-step state (after the pre-step
repairs), read from the engine's ``[B * n]`` row view: a voted view would
absorb the lane-local control corruption CFCSS exists to catch.  A
mismatch latches ``cfc_fault``, which halts the row before the step
commits.  The tracker is uint32 in the reference and int32 bits here: the
XOR and the compare are the same on the bits.

A flip makes ``PREV_LEAF`` (and a corrupted lane's ``v``) any word, so the
table reads take the reference's ``a[i]`` rule (one negative wrap, then a
clamp), each axis of ``dedge[prev, v]`` on its own; ``dedge`` is read even
where ``fanin`` is false, as the reference computes it.  Nothing here
syncs with the host.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from coast_tpu_torch.ir.graph import BlockGraph
from coast_tpu_torch.native import cfcss_assign
from coast_tpu_torch.ops import voters
from coast_tpu_torch.ops.indexing import clamp_index

# The CFCSS runtime leaves (the reference's BasicBlockSignatureTracker and
# previous-block globals), part of the injectable memory map.
G_LEAF = "__cfcss_sig_tracker"
PREV_LEAF = "__cfcss_prev_block"

SIG_BITS = 16  # the reference's default signature width


def _words(a: np.ndarray, device) -> torch.Tensor:
    """A uint32 table as int32 bits on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(
        np.int32)).to(device)


def apply_cfcss(prog):
    """Stack CFCSS onto a protected program (mutates and returns it): the
    ``opt -TMR -CFCSS`` stacking of BASELINE config 5."""
    region = prog.region
    graph: BlockGraph = region.graph
    if graph is None:
        raise ValueError(
            f"region {region.name} has no block graph; CFCSS needs one "
            "(the reference requires basic blocks to instrument)")
    graph.validate()

    tables = cfcss_assign(graph.n, graph.edges, sig_bits=SIG_BITS)
    n_blocks = graph.n
    n_lanes = prog.cfg.num_clones
    # The tables on each device the program runs on (made once a device:
    # a lint capture runs a card's program on the CPU).
    on_device: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}

    def tabs():
        dev = prog.device
        if dev not in on_device:
            on_device[dev] = (
                _words(tables["sigs"], dev), _words(tables["diffs"], dev),
                _words(tables["dedge"], dev),
                torch.from_numpy(tables["fanin"]).to(dev))
        return on_device[dev]

    def cfcss_init(batch: int) -> Dict[str, torch.Tensor]:
        # G starts at the entry signature, prev at the entry block.
        sigs = tabs()[0]
        return {G_LEAF: sigs[0].expand(batch, n_lanes).clone(),
                PREV_LEAF: torch.zeros(batch, n_lanes, dtype=torch.int32,
                                       device=prog.device)}

    def cfcss_step(region_state, tracker, cfc_fault: torch.Tensor,
                   halted: torch.Tensor
                   ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """One block entry: the updated runtime leaves and ``cfc_fault``.
        A halted row keeps its tracker and its flag."""
        batch = halted.shape[0]
        v = graph.block_of(prog.row_view(region_state, batch)).reshape(
            batch, -1).expand(batch, n_lanes)
        g, prev = tracker[G_LEAF], tracker[PREV_LEAF]
        sigs, diffs, dedge, fanin = tabs()
        vi = clamp_index(v, n_blocks)
        adj = torch.where(fanin[vi], dedge[clamp_index(prev, n_blocks), vi],
                          0)
        g_new = g ^ diffs[vi] ^ adj
        mismatch = voters.sync_tag(g_new != sigs[vi], "cfcss",
                                   G_LEAF).any(dim=1)
        cfc_fault = cfc_fault | (~halted & mismatch)
        keep = halted[:, None]
        return ({G_LEAF: torch.where(keep, g, g_new),
                 PREV_LEAF: torch.where(keep, prev, v)}, cfc_fault)

    prog.install_cfcss(cfcss_init, cfcss_step)
    return prog
