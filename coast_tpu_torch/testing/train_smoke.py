"""Protected-training smoke driver (unittest/cfg/fast.yml row).

The counterpart of ``coast_tpu/testing/train_smoke.py``:

  1. **Differential parity** -- the fault-free training trajectory (final
     weights, bit-for-bit) is identical across unprotected / DWC /
     selective-xMR / full-TMR builds of ``train_mlp``.
  2. **Outcome buckets** -- a small seeded unprotected campaign populates
     BOTH silent-training-corruption classes (``train_self_heal`` and
     ``train_sdc``), with the raw ``sdc`` bucket fully refined away.
  3. **Selective coverage** -- the selective-xMR campaign's commit votes
     repair (corrected > 0) and its persistent-SDC count sits strictly
     below the unprotected one.

Prints ``Success!``.
"""

from __future__ import annotations

import sys
from typing import List, Optional

import torch

from coast_tpu_torch.testing import device_arg


def main(argv: Optional[List[str]] = None) -> int:
    device = device_arg(argv, "protected-training smoke")
    from coast_tpu_torch import DWC, TMR, unprotected
    from coast_tpu_torch.inject.campaign import CampaignRunner
    from coast_tpu_torch.ops.bitflip import noop_fault
    from coast_tpu_torch.train import make_train_region, selective_xmr

    region = make_train_region("sgd")
    progs = {"unprotected": unprotected(region, device=device),
             "DWC": DWC(region, device=device),
             "selective-xMR": selective_xmr(region, device=device),
             "TMR": TMR(region, device=device)}

    # 1. fault-free trajectory parity, bit-for-bit
    outs = {}
    for name, prog in progs.items():
        rec = prog.run(noop_fault())
        if int(rec["errors"]) or not bool(rec["done"]) \
                or int(rec["train_probe"]):
            print(f"fault-free {name} run is not clean")
            return 1
        outs[name] = rec["output"].cpu()
    for name, out in outs.items():
        if not torch.equal(out, outs["unprotected"]):
            print(f"fault-free trajectory parity FAILED for {name}")
            return 1
    print("fault-free trajectory bit-identical across all 4 strategies")

    # 2. both train outcome buckets populated
    unprot = CampaignRunner(progs["unprotected"],
                            strategy_name="unprotected").run(
        512, seed=11, batch_size=256)
    heals = unprot.counts["train_self_heal"]
    sdcs = unprot.counts["train_sdc"]
    if not (heals and sdcs):
        print(f"train bucket empty: self_heal={heals} train_sdc={sdcs}")
        return 1
    if unprot.counts["sdc"]:
        print(f"raw sdc not refined: {unprot.counts['sdc']}")
        return 1
    print(f"unprotected n=512: self_heal={heals} persistent_sdc={sdcs}")

    # 3. selective xMR: commit votes repair, persistent SDCs shrink
    selx = CampaignRunner(progs["selective-xMR"],
                          strategy_name="selective-xMR").run(
        512, seed=11, batch_size=256)
    if not selx.counts["corrected"]:
        print("selective-xMR campaign recorded no commit-vote repairs")
        return 1
    if selx.counts["train_sdc"] >= sdcs:
        print(f"selective-xMR did not reduce persistent SDCs "
              f"({selx.counts['train_sdc']} >= {sdcs})")
        return 1
    print(f"selective-xMR n=512: corrected={selx.counts['corrected']} "
          f"persistent_sdc={selx.counts['train_sdc']}")
    print("Success!")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
