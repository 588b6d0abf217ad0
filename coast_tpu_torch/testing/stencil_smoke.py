"""Sharded halo-exchange stencil smoke driver (unittest/cfg/fast.yml row).

The counterpart of ``coast_tpu/testing/stencil_smoke.py``:

  1. **2-shard campaign parity, both placements** -- a sharded sparse
     campaign over a 2-shard mesh classifies bit-identically (codes AND
     counts) to the single-device runner at the same schedule, under
     vote-then-exchange (``compute``) and exchange-then-vote (``link``)
     placements, and the sharded summary carries the mesh ledger.
  2. **Link-model row** -- the containment duality: under
     vote-then-exchange every in-flight halo flip escapes as SDC, under
     exchange-then-vote the receiver's majority repairs every one.
  3. **Walker-prediction spot check** -- the propagation walker's
     cross-shard reach matches the measured truth (compute placement
     bounds each grid to its shard, link placement lets grid corruption
     cross), and a live campaign shows no SDC outside the statically
     sdc-possible sections.

On a host with one card the two shards share it (``cuda:0`` twice).
Prints ``Success!``.
"""

from __future__ import annotations

import sys
from typing import List, Optional

import numpy as np
import torch

from coast_tpu_torch.testing import device_arg


def two_shards(device: str):
    """A 2-shard mesh: two cards, or one card (or the CPU) twice."""
    from coast_tpu_torch.parallel.mesh import Mesh, make_mesh
    if device == "cpu":
        return make_mesh(2, device="cpu")
    if torch.cuda.device_count() >= 2:
        return make_mesh(2, device=device)
    return Mesh([torch.device("cuda", 0)] * 2)


def main(argv: Optional[List[str]] = None) -> int:
    device = device_arg(argv, "sharded stencil smoke")
    from coast_tpu_torch import ProtectionConfig, protect
    from coast_tpu_torch.analysis.propagation import (analyze_propagation,
                                                      crossvalidate_counts)
    from coast_tpu_torch.inject import classify as cls
    from coast_tpu_torch.inject.campaign import CampaignRunner
    from coast_tpu_torch.inject.schedule import FaultModel, generate
    from coast_tpu_torch.models import resolve_region
    from coast_tpu_torch.parallel.mesh import ShardedCampaignRunner

    mesh = two_shards(device)
    n, seed = 96, 7
    link_sdc = {}
    for placement in ("compute", "link"):
        region = resolve_region("stencil", placement=placement)
        prog = protect(region, ProtectionConfig(num_clones=3), device)

        # 1. sharded-vs-single parity per fault model, sparse collect
        for model in (FaultModel.single(), FaultModel.link()):
            sh = ShardedCampaignRunner(prog, mesh, strategy_name="TMR",
                                       fault_model=model, collect="sparse")
            sched = generate(sh.mmap, n, seed, region.nominal_steps,
                             model=sh.fault_model)
            sres = sh.run_schedule(sched, batch_size=48)
            bres = CampaignRunner(prog, strategy_name="TMR",
                                  fault_model=model, collect="sparse"
                                  ).run_schedule(sched, batch_size=48)
            if not (np.array_equal(bres.codes, sres.codes)
                    and bres.counts == sres.counts):
                print(f"{placement}/{model.spec()}: sharded campaign "
                      f"diverges from single-device: {sres.counts} vs "
                      f"{bres.counts}")
                return 1
            mesh_block = sres.summary().get("mesh") or {}
            if (mesh_block.get("devices") != 2
                    or sum(mesh_block.get("per_shard_interesting", []))
                    != len(sres.interesting_rows)):
                print(f"{placement}/{model.spec()}: bad mesh ledger "
                      f"{mesh_block}")
                return 1
            if model.kind == "link":
                link_sdc[placement] = bres.counts["sdc"]

        # 3a. walker reach closure vs the placement's measured semantics
        vmap = analyze_propagation(prog)
        reach = vmap.shard_reach or {}
        grid_cross = {name: (reach.get(name) or {}).get("cross_shard")
                      for name in ("grid0", "grid1")}
        want_cross = placement == "link"
        if any(v != want_cross for v in grid_cross.values()):
            print(f"{placement}: walker grid reach {grid_cross} != "
                  f"cross_shard={want_cross}")
            return 1

        # 3b. live soundness: every SDC inside sdc-possible sections
        dense = CampaignRunner(prog, strategy_name="TMR")
        res = dense.run(n, seed=seed, batch_size=48)
        lids = np.asarray(res.schedule.leaf_id)
        section_counts = {}
        for sec in dense.mmap.sections:
            binc = np.bincount(res.codes[lids == sec.leaf_id],
                               minlength=cls.NUM_CLASSES)
            section_counts[sec.name] = {
                k: int(c) for k, c in zip(cls.CLASS_NAMES, binc) if c}
        violations = crossvalidate_counts(vmap, section_counts)
        if violations:
            print(f"{placement}: soundness violations: {violations}")
            return 1
        print(f"{placement}: 2-shard parity OK (single+link models), "
              f"walker cross_shard={want_cross} as measured, "
              "no SDC outside sdc-possible sections")

    # 2. the containment duality on the SAME link-model draw stream
    if not (link_sdc["compute"] > 0 and link_sdc["link"] == 0):
        print(f"link-model containment broken: vote-then-exchange "
              f"sdc={link_sdc['compute']} (want >0, the blind spot), "
              f"exchange-then-vote sdc={link_sdc['link']} (want 0)")
        return 1
    print(f"link fault model: vote-then-exchange leaks "
          f"{link_sdc['compute']}/{n} in-flight flips as SDC; "
          "exchange-then-vote repairs all of them")

    print("Success!")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
