"""Sharded halo-exchange stencil: the region whose fault surface includes
the interconnect.

The counterpart of ``coast_tpu/models/stencil.py``.  A 2D five-point
relaxation in mod-2^32 integer arithmetic (every flipped bit propagates),
sharded into two column blocks: each super-step packs the shard-interface
edge columns into an exchange buffer (the words on the wire of a
send/receive), then integrates the received halo and relaxes.  The region
models the distributed program on one device -- per-shard grid leaves plus
a ``link``-kind leaf for the in-flight halo -- so single-device campaigns
and the sharded runner (``parallel/mesh.py``) see the same program;
:func:`run_distributed` is the distributed executor, over a mesh in one
process or over a ``torch.distributed`` group, held bit-equal to
:func:`golden_trajectory`.

Two protection schedules, selected by ``placement``:

* ``compute`` -- vote-then-exchange.  The halo is a plain shared leaf: the
  engine's SoR-crossing vote fires on the pack commit, before the value
  travels.  A compute flip in one replica's edge cell is repaired before
  it leaves the shard; a flip on the link itself is integrated by every
  replica of the neighbour and no vote catches it.
* ``link`` -- exchange-then-vote.  The halo carries ``R_LINK = 3`` copies
  and is declared ``unvoted_crossing``: the engine commits lane 0's pack
  raw and the receiver majority-votes the copies.  A link flip hits one
  copy and is repaired; a lane-0 compute flip of an edge cell at a pack
  step ships in all three copies and crosses to the neighbour shard.

The ``link`` fault model (``inject/schedule.py``) targets the halo in its
receive window (``meta['link_window'] = (1, 2)``: odd steps, after the
pack committed and before the receive reads it).

uint32 words are int32 tensors here (``LeafSpec.unsigned``); int32 adds
wrap as uint32 adds do.  ``_fill``, ``_relax_full`` and
:func:`golden_trajectory` are numpy copies of the reference's.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from coast_tpu_torch import device as device_mod
from coast_tpu_torch.interop import state_from_numpy
from coast_tpu_torch.ir.region import (KIND_CTRL, KIND_LINK, KIND_MEM,
                                       KIND_RO, LeafSpec, Region)
from coast_tpu_torch.passes.verification import RegionDataflow

H = 8            # rows per shard (vertical axis is periodic, unsharded)
W = 6            # interior columns per shard
SHARDS = 2       # column blocks (grid0 | grid1)
R_LINK = 3       # in-flight halo copies under exchange-then-vote
N_ITERS = 6      # relaxation iterations (2 micro-steps each)
SEED = 1234

PLACEMENTS = ("compute", "link")

# The reference's analyze() of its step (pinned in
# tests/test_torch_stencil.py), the same under both placements.
DATAFLOW = RegionDataflow(
    written=frozenset({"grid0", "grid1", "halo", "it"}),
    deps={
        "golden0": frozenset({"golden0"}),
        "golden1": frozenset({"golden1"}),
        "grid0": frozenset({"grid0", "halo"}),
        "grid1": frozenset({"grid0", "grid1", "halo"}),
        "halo": frozenset({"grid0", "grid1", "halo"}),
        "it": frozenset({"it"}),
    },
    load_addr=frozenset(),
    store_addr=frozenset())


def _fill(seed: int, n: int) -> np.ndarray:
    """Deterministic full-width uint32 pseudo-random fill (splitmix-like
    finalizer): the initial field, dense in every bit position."""
    x = np.arange(1, n + 1, dtype=np.uint64) + np.uint64(seed)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x = x ^ (x >> np.uint64(31))
    return (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _relax_full(u: np.ndarray) -> np.ndarray:
    """One five-point relaxation of the full logical grid (numpy truth):
    u' = u + N + S + E + W mod 2^32, rows periodic, zero side boundary."""
    up = np.roll(u, 1, axis=0)
    down = np.roll(u, -1, axis=0)
    z = np.zeros((u.shape[0], 1), np.uint32)
    left = np.concatenate([z, u[:, :-1]], axis=1)
    right = np.concatenate([u[:, 1:], z], axis=1)
    return u + up + down + left + right


def golden_trajectory(n_iters: int = N_ITERS) -> np.ndarray:
    """The single-device truth: the full (H, SHARDS*W) uint32 grid after
    ``n_iters`` relaxations.  The region and both distributed executors
    are held against it bit for bit."""
    u = _fill(SEED, H * SHARDS * W).reshape(H, SHARDS * W)
    for _ in range(n_iters):
        u = _relax_full(u)
    return u


def _relax_block(u: torch.Tensor) -> torch.Tensor:
    """Relax ``[R, H, W+2]`` shard blocks: halo columns 0 and W+1 are
    already loaded; only interior columns 1..W update."""
    zero = torch.zeros_like(u[:, :, :1])
    up = torch.roll(u, 1, dims=1)
    down = torch.roll(u, -1, dims=1)
    left = torch.cat([zero, u[:, :, :-1]], dim=2)
    right = torch.cat([u[:, :, 1:], zero], dim=2)
    relaxed = u + up + down + left + right
    return torch.cat([u[:, :, :1], relaxed[:, :, 1:-1], u[:, :, -1:]],
                     dim=2)


def _set_col(u: torch.Tensor, col: int, value) -> torch.Tensor:
    """``u.at[:, col].set(value)`` on ``[R, H, C]`` blocks, out of place."""
    out = u.clone()
    out[:, :, col] = value
    return out


def make_region(placement: str = "compute") -> Region:
    """The stencil region under one of the two voter placements:
    ``compute`` (vote-then-exchange, the registry build) or ``link``
    (exchange-then-vote)."""
    if placement not in PLACEMENTS:
        raise ValueError(
            f"unknown stencil placement {placement!r}; one of {PLACEMENTS}")
    xv = placement == "link"

    full0 = _fill(SEED, H * SHARDS * W).reshape(H, SHARDS * W)
    golden_full = golden_trajectory(N_ITERS)
    # Shard s holds logical columns [s*W, (s+1)*W) plus two halo columns.
    image = {}
    for s in range(SHARDS):
        blk = np.zeros((H, W + 2), np.uint32)
        blk[:, 1:-1] = full0[:, s * W:(s + 1) * W]
        image[f"grid{s}"] = blk
        image[f"golden{s}"] = golden_full[:, s * W:(s + 1) * W].copy()
    image["halo"] = np.zeros((R_LINK, SHARDS, H) if xv else (SHARDS, H),
                             np.uint32)
    image["it"] = np.int32(0)

    def init(device):
        return state_from_numpy(image, device)

    def _pack(g0, g1):
        """Edge columns onto the wire: row 0 eastbound (shard 0's last
        interior column -> shard 1's left halo), row 1 westbound."""
        return torch.stack([g0[:, :, W], g1[:, :, 1]], dim=1)

    def step(state, t):
        g0, g1 = state["grid0"], state["grid1"]
        if t % 2 == 0:
            # Pack: the edge columns go on the wire (under exchange-then-
            # vote, R_LINK copies of each lane's pack; the engine commits
            # lane 0's).
            packed = _pack(g0, g1)
            if xv:
                packed = packed[:, None].expand(-1, R_LINK, SHARDS, H)
            return {"halo": packed}
        halo = state["halo"]
        if xv:
            a, b, c = halo[:, 0], halo[:, 1], halo[:, 2]
            wire = (a & b) | (b & c) | (a & c)
        else:
            wire = halo
        # Receive: load the interface halos (outer side halos stay the zero
        # boundary), then relax the interiors.  The halo is written back
        # unchanged, as the reference's step writes it every step: its
        # commit is a sync point at every step.
        r0 = _set_col(_set_col(g0, W + 1, wire[:, 1]), 0, 0)
        r1 = _set_col(_set_col(g1, 0, wire[:, 0]), W + 1, 0)
        return {"grid0": _relax_block(r0), "grid1": _relax_block(r1),
                "halo": halo, "it": state["it"] + 1}

    def done(state):
        return state["it"] >= N_ITERS

    def check(state):
        return ((state["golden0"] != state["grid0"][:, :, 1:-1]).sum((1, 2))
                + (state["golden1"] != state["grid1"][:, :, 1:-1]).sum((1, 2))
                ).to(torch.int32)

    def output(state):
        rows = state["grid0"].shape[0]
        return torch.cat([state["grid0"][:, :, 1:-1].reshape(rows, -1),
                          state["grid1"][:, :, 1:-1].reshape(rows, -1)],
                         dim=1)

    return Region(
        name=f"stencil[{placement}]",
        init=init,
        step=step,
        done=done,
        check=check,
        output=output,
        nominal_steps=2 * N_ITERS,
        max_steps=6 * N_ITERS,
        spec={
            "grid0": LeafSpec(KIND_MEM, xmr=True, unsigned=True),
            "grid1": LeafSpec(KIND_MEM, xmr=True, unsigned=True),
            "golden0": LeafSpec(KIND_RO, unsigned=True),
            "golden1": LeafSpec(KIND_RO, unsigned=True),
            "halo": LeafSpec(KIND_LINK, xmr=False, unsigned=True,
                             unvoted_crossing=xv),
            "it": LeafSpec(KIND_CTRL),
        },
        default_xmr=True,
        meta={
            "placement": placement,
            # Receive window of the link fault model: the halo words are in
            # flight at odd steps (packed at t, read at t+1).
            "link_window": (1, 2),
            # Which shard each section's words belong to (None: the shared
            # interconnect / control surface): the blast-radius key.
            "shard_of": {"grid0": 0, "grid1": 1,
                         "golden0": 0, "golden1": 1,
                         "halo": None, "it": None},
            # Output-vector spans per shard (blast-radius splits).
            "shard_slices": {"grid0": (0, H * W),
                             "grid1": (H * W, 2 * H * W)},
            "golden_full": golden_full,
            "dataflow": DATAFLOW,
        },
    )


# -- the distributed executors ------------------------------------------------

def distributed_step(u: torch.Tensor, from_left: torch.Tensor,
                     from_right: torch.Tensor) -> torch.Tensor:
    """One relaxation of an ``(H, w)`` column block, given the edge columns
    its neighbours sent (``(H,)`` each; zeros where there is no neighbour,
    the collective's zero fill, which is the zero side boundary)."""
    up = torch.roll(u, 1, dims=0)
    down = torch.roll(u, -1, dims=0)
    left = torch.cat([from_left[:, None], u[:, :-1]], dim=1)
    right = torch.cat([u[:, 1:], from_right[:, None]], dim=1)
    return u + up + down + left + right


def _initial_grid() -> np.ndarray:
    cols = SHARDS * W
    return _fill(SEED, H * cols).reshape(H, cols)


def _column_count(n: int) -> int:
    cols = SHARDS * W
    if n < 1 or cols % n:
        raise ValueError(f"{cols} columns do not shard over {n}")
    return cols // n


def run_distributed(n_iters: int = N_ITERS, n_devices: int = SHARDS,
                    mesh=None, device=device_mod.DEFAULT) -> np.ndarray:
    """The stencil as a sharded program in one process: the full grid split
    into ``n_devices`` column blocks over a 1-D mesh (``make_mesh(
    n_devices, device=device)`` unless ``mesh`` is given; a mesh may repeat
    a device), each block on its shard's device, the edge columns copied to
    the neighbour's device every iteration.  Returns the final full grid
    (uint32), equal to :func:`golden_trajectory` bit for bit."""
    from coast_tpu_torch.parallel.mesh import make_mesh
    if mesh is None:
        mesh = make_mesh(n_devices, device=device)
    devices = mesh.shard_devices()
    w = _column_count(len(devices))
    u0 = _initial_grid().view(np.int32)
    blocks = [torch.tensor(u0[:, s * w:(s + 1) * w], device=dev)
              for s, dev in enumerate(devices)]
    last = len(blocks) - 1
    for _ in range(n_iters):
        # The exchange: shard s sends its last column east and its first
        # column west; the mesh's ends receive zeros.
        east = [b[:, -1] for b in blocks]
        west = [b[:, 0] for b in blocks]
        blocks = [distributed_step(
            b,
            east[s - 1].to(b.device) if s > 0 else torch.zeros_like(b[:, 0]),
            west[s + 1].to(b.device) if s < last
            else torch.zeros_like(b[:, 0]))
            for s, b in enumerate(blocks)]
    return np.concatenate([b.cpu().numpy() for b in blocks],
                          axis=1).view(np.uint32)


def run_distributed_group(n_iters: int = N_ITERS, group=None,
                          device: Optional[torch.device] = None
                          ) -> np.ndarray:
    """The stencil over a ``torch.distributed`` group: rank r holds column
    block r, and every iteration sends its edge columns to its neighbours
    with ``batch_isend_irecv`` (a rank with no neighbour on a side receives
    zeros).  Every rank returns the gathered final grid (uint32), equal to
    :func:`golden_trajectory` bit for bit.  ``device`` defaults to the
    card for an NCCL group and the CPU otherwise."""
    import torch.distributed as dist
    rank = dist.get_rank(group)
    world = dist.get_world_size(group)
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend(group) == "nccl"
                  else torch.device("cpu"))
    w = _column_count(world)
    u0 = _initial_grid().view(np.int32)
    u = torch.tensor(u0[:, rank * w:(rank + 1) * w], device=device)

    def peer(r):
        return r if group is None else dist.get_global_rank(group, r)

    for _ in range(n_iters):
        from_left = torch.zeros_like(u[:, 0])
        from_right = torch.zeros_like(u[:, 0])
        ops = []
        if rank > 0:
            ops += [dist.P2POp(dist.isend, u[:, 0].contiguous(),
                               peer(rank - 1), group),
                    dist.P2POp(dist.irecv, from_left, peer(rank - 1), group)]
        if rank < world - 1:
            ops += [dist.P2POp(dist.isend, u[:, -1].contiguous(),
                               peer(rank + 1), group),
                    dist.P2POp(dist.irecv, from_right, peer(rank + 1),
                               group)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        u = distributed_step(u, from_left, from_right)
    parts = [torch.empty_like(u) for _ in range(world)]
    dist.all_gather(parts, u.contiguous(), group=group)
    return np.concatenate([p.cpu().numpy() for p in parts],
                          axis=1).view(np.uint32)


# -- the containment study ----------------------------------------------------

def containment_study(device=device_mod.DEFAULT, mesh=None, n: int = 128,
                      seed: int = 7, batch_size: int = 64) -> Dict:
    """The recorded study of ``artifacts/stencil_campaign.json`` (written
    by the reference's ``scripts/stencil_campaign.py``): TMR under both
    placements x {single, cluster(span=4,k=3), link}.  Per cell the dense
    single-device campaign gives the counts; every SDC row is rerun to
    find which shard's grid diverged from the golden (the blast radius:
    ``reference`` rows corrupted only the golden copy); the same schedule
    through a sparse ``ShardedCampaignRunner`` over ``mesh`` (default a
    two-shard mesh on ``device``) gives the parity bit and the mesh block.
    Each cell's ``soundness_violations`` holds the static vulnerability
    map against the cell's per-section outcome counts
    (``analysis/propagation.crossvalidate_counts``): every SDC lies in an
    ``sdc-possible`` section.  Returns every key of the artifact."""
    from coast_tpu_torch.analysis.propagation import (analyze_propagation,
                                                      crossvalidate_counts)
    from coast_tpu_torch.inject import classify as cls
    from coast_tpu_torch.inject.campaign import CampaignRunner
    from coast_tpu_torch.inject.schedule import FaultModel
    from coast_tpu_torch.parallel.mesh import (ShardedCampaignRunner,
                                               make_mesh)
    from coast_tpu_torch.passes.strategies import TMR

    models = [FaultModel.single(), FaultModel.cluster(span=4, k=3),
              FaultModel.link()]
    if mesh is None:
        mesh = make_mesh(2, device=device)
    failures = []
    doc = {"benchmark": "stencil", "strategy": "TMR", "n": n, "seed": seed,
           "models": [m.spec() for m in models],
           "mesh": {"devices": mesh.size}, "placements": {}}
    for placement in PLACEMENTS:
        region = make_region(placement)
        prog = TMR(region, device=device)
        vmap = analyze_propagation(prog)
        shard_of = region.meta["shard_of"]
        slices = region.meta["shard_slices"]
        golden = region.meta["golden_full"]
        golden_out = np.concatenate([golden[:, :W].reshape(-1),
                                     golden[:, W:].reshape(-1)])
        cells = {}
        for model in models:
            runner = CampaignRunner(prog, strategy_name="TMR",
                                    fault_model=model)
            res = runner.run(n, seed=seed, batch_size=batch_size)
            sec_of_leaf = {s.leaf_id: s.name for s in runner.mmap.sections}
            sdc_rows = np.flatnonzero(res.codes == cls.SDC)
            by_section: Dict[str, int] = {}
            radius = {"reference": 0, "own_shard": 0, "cross_shard": 0,
                      "link_origin_escapes": 0}
            if len(sdc_rows):
                fault = {k: np.asarray(v)[sdc_rows]
                         for k, v in res.schedule.device_arrays().items()}
                outs = prog.run_batch(fault)["output"].cpu().numpy()
                outs = outs.view(np.uint32)
                for i, row in enumerate(sdc_rows):
                    sec = sec_of_leaf[int(res.schedule.leaf_id[row])]
                    by_section[sec] = by_section.get(sec, 0) + 1
                    origin = shard_of.get(sec)
                    bad = [s for s, (lo, hi) in sorted(slices.items())
                           if np.any(outs[i][lo:hi] != golden_out[lo:hi])]
                    if not bad:
                        radius["reference"] += 1
                    elif origin is None:
                        radius["link_origin_escapes"] += 1
                    elif bad == [f"grid{origin}"]:
                        radius["own_shard"] += 1
                    else:
                        radius["cross_shard"] += 1
            lids = np.asarray(res.schedule.leaf_id)
            section_counts = {}
            for sec in runner.mmap.sections:
                binc = np.bincount(res.codes[lids == sec.leaf_id],
                                   minlength=cls.NUM_CLASSES)
                section_counts[sec.name] = {
                    k: int(c) for k, c in zip(cls.CLASS_NAMES, binc) if c}
            violations = crossvalidate_counts(vmap, section_counts)
            if violations:
                failures.append(f"{placement}/{model.spec()}: SDC outside "
                                f"sdc-possible sections: {violations}")
            sh = ShardedCampaignRunner(prog, mesh=mesh, strategy_name="TMR",
                                       fault_model=model, collect="sparse")
            sres = sh.run_schedule(res.schedule, batch_size=batch_size)
            parity = bool(np.array_equal(
                res.codes[res.codes > cls.CORRECTED], sres.codes)
                and res.counts == sres.counts)
            if not parity:
                failures.append(f"{placement}/{model.spec()}: sharded "
                                f"parity broke: {sres.counts} vs "
                                f"{res.counts}")
            cells[model.spec()] = {
                "counts": res.counts, "sdc": int(len(sdc_rows)),
                "sdc_by_section": by_section, "blast_radius": radius,
                "soundness_violations": violations,
                "sharded_parity": parity,
                "mesh": sres.summary().get("mesh")}
        doc["placements"][placement] = {"cells": cells}
    cells = {p: doc["placements"][p]["cells"] for p in PLACEMENTS}
    link_spec = models[-1].spec()
    doc["containment"] = {
        "compute_placement_cross_shard_sdc": sum(
            c["blast_radius"]["cross_shard"]
            for s, c in cells["compute"].items() if s != link_spec),
        "compute_placement_link_sdc": cells["compute"][link_spec]["sdc"],
        "link_placement_link_sdc": cells["link"][link_spec]["sdc"],
        "link_placement_cross_shard_sdc": sum(
            c["blast_radius"]["cross_shard"]
            for s, c in cells["link"].items() if s != link_spec),
    }
    doc["failures"] = failures
    doc["ok"] = not failures
    return doc
