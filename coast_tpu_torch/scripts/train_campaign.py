"""Seeded protected-training campaign: the train subsystem's acceptance
record.

The counterpart of the reference's ``scripts/train_campaign.py``.  Four
campaigns over the same seeded fault stream on ``train_mlp``
(unprotected, DWC, selective xMR, full TMR) record where selective
protection of the weight-update commit recovers most of full TMR's
coverage at a fraction of the FLOPs, plus the FuzzyFlow-style
differential block (arXiv:2306.16178): the protected step's fault-free
training trajectory is bit-identical to the unprotected one under every
strategy, so every divergence the campaigns record is the injected
fault's, never the replication transform's.

Writes the record and exits nonzero if any acceptance bar fails:

  * fault-free parity holds for all four strategies (and the Adam
    variant);
  * the unprotected campaign populates BOTH train outcome buckets
    (self-heal and persistent SDC);
  * selective xMR eliminates at least half of the unprotected
    persistent-SDC mass that full TMR eliminates, at < 2/3 of full
    TMR's per-iteration FLOPs.

It runs on the card unless given ``-d cpu``.

Usage: python -m coast_tpu_torch.scripts.train_campaign [-n 2048]
       [--seed 42] [-d cpu] [--out build/studies/train_campaign.json]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys

import numpy as np

from coast_tpu_torch import device as device_mod
from coast_tpu_torch.scripts import common


def _fault_free_sha(prog) -> str:
    """sha256 of the fault-free final weights (uint32 words): the
    differential pin's witness."""
    from coast_tpu_torch.ops.bitflip import noop_fault
    rec = prog.run(noop_fault())
    if int(rec["errors"]) or not bool(rec["done"]) \
            or int(rec["train_probe"]):
        raise AssertionError("fault-free run is not clean")
    return hashlib.sha256(
        rec["output"].cpu().numpy().view(np.uint32).tobytes()).hexdigest()


def kind_table(res, runner):
    """Per-leaf-kind outcome roll-up: which state class the persistent
    SDCs live in (params, optimizer moments, golden/input data,
    control)."""
    from coast_tpu_torch.inject import classify as cls
    spec = runner.prog.region.spec
    kind_of = [spec[name].kind for name in runner.prog.leaf_order]
    lid = np.asarray(res.schedule.leaf_id)
    codes = np.asarray(res.codes)
    out = {}
    for i, kind in enumerate(kind_of):
        mask = lid == i
        if not mask.any():
            continue
        row = out.setdefault(kind, {"injections": 0, "train_sdc": 0,
                                    "train_self_heal": 0, "corrected": 0})
        row["injections"] += int(mask.sum())
        row["train_sdc"] += int((codes[mask] == cls.TRAIN_SDC).sum())
        row["train_self_heal"] += \
            int((codes[mask] == cls.TRAIN_SELF_HEAL).sum())
        row["corrected"] += int((codes[mask] == cls.CORRECTED).sum())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("-d", "--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the campaigns run (default the card)")
    ap.add_argument("--out", default=common.default_out(
        "train_campaign.json"))
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)

    from coast_tpu_torch import DWC, TMR, unprotected
    from coast_tpu_torch.inject.campaign import CampaignRunner
    from coast_tpu_torch.train import (HEAL_WINDOW, ITERS, flops_overhead,
                                       make_train_region, selective_xmr)
    from coast_tpu_torch.train.mlp import golden

    region = make_train_region("sgd")
    progs = {
        "unprotected": (unprotected(region, device=dev),
                        flops_overhead(region, 1)),
        "DWC": (DWC(region, device=dev), flops_overhead(region, 2)),
        "selective-xMR": (selective_xmr(region, device=dev),
                          flops_overhead(region, 3, selective=True)),
        "TMR": (TMR(region, device=dev), flops_overhead(region, 3)),
    }

    # The differential pin first: a transform that perturbs the
    # fault-free trajectory would invalidate every row below.
    shas = {name: _fault_free_sha(prog) for name, (prog, _) in progs.items()}
    adam = make_train_region("adam")
    adam_shas = {"unprotected": _fault_free_sha(unprotected(adam,
                                                            device=dev)),
                 "selective-xMR": _fault_free_sha(selective_xmr(adam,
                                                                device=dev)),
                 "TMR": _fault_free_sha(TMR(adam, device=dev))}
    parity = len(set(shas.values())) == 1
    adam_parity = len(set(adam_shas.values())) == 1

    rows, kinds = {}, {}
    for name, (prog, flops) in progs.items():
        runner = CampaignRunner(prog, strategy_name=name,
                                preflight="static")
        res = runner.run(args.n, seed=args.seed, batch_size=args.batch)
        rows[name] = {
            "counts": dict(res.counts),
            "flops_overhead": round(flops, 4),
            "rates": {
                "train_sdc": round(res.counts["train_sdc"] / res.n, 6),
                "train_self_heal":
                    round(res.counts["train_self_heal"] / res.n, 6),
                "corrected": round(res.counts["corrected"] / res.n, 6),
                "due": round(res.due / res.n, 6),
            },
            "injections_per_sec": round(res.injections_per_sec, 2),
        }
        if name in ("unprotected", "selective-xMR"):
            kinds[name] = kind_table(res, runner)
        print(f"# {name:<14} flops={flops:.3f}x "
              f"train_sdc={rows[name]['rates']['train_sdc']:.4f} "
              f"self_heal={rows[name]['rates']['train_self_heal']:.4f} "
              f"corrected={rows[name]['rates']['corrected']:.4f}",
              file=sys.stderr, flush=True)

    # Coverage recovery: of the persistent-SDC mass full TMR removes
    # relative to unprotected, what share does selective xMR remove?
    u = rows["unprotected"]["counts"]["train_sdc"]
    t = rows["TMR"]["counts"]["train_sdc"]
    s = rows["selective-xMR"]["counts"]["train_sdc"]
    recovery = (u - s) / (u - t) if u > t else None
    flops_frac = (rows["selective-xMR"]["flops_overhead"]
                  / rows["TMR"]["flops_overhead"])

    record = {
        "metric": "train_campaign",
        "benchmark": "train_mlp",
        "device": common.device_block(dev),
        "seed": args.seed,
        "n_per_campaign": args.n,
        "train": {"optimizer": "sgd", "iters": ITERS,
                  "heal_window": HEAL_WINDOW,
                  "golden_final_loss":
                      float(golden("sgd", dev)["losses"][-1])},
        "differential": {
            "idiom": "FuzzyFlow (arXiv:2306.16178)",
            "fault_free_trajectory_bit_identical": parity,
            "fault_free_output_sha256": shas["unprotected"],
            "per_strategy_sha256": shas,
            "adam_variant_bit_identical": adam_parity,
            "adam_fault_free_output_sha256": adam_shas["unprotected"],
        },
        "strategies": rows,
        "kind_attribution": kinds,
        "selective_vs_tmr": {
            "persistent_sdc_coverage_recovery":
                round(recovery, 4) if recovery is not None else None,
            "flops_fraction_of_tmr": round(flops_frac, 4),
        },
    }
    common.write_record(args.out, record)
    print(json.dumps({"wrote": args.out, "parity": parity,
                      "coverage_recovery": record["selective_vs_tmr"]
                      ["persistent_sdc_coverage_recovery"],
                      "flops_fraction": round(flops_frac, 4)}))

    ok = True
    if not (parity and adam_parity):
        print("ERROR: fault-free trajectory parity FAILED", file=sys.stderr)
        ok = False
    if not (rows["unprotected"]["counts"]["train_self_heal"]
            and rows["unprotected"]["counts"]["train_sdc"]):
        print("ERROR: unprotected campaign left a train bucket empty",
              file=sys.stderr)
        ok = False
    if recovery is None or recovery < 0.5 or flops_frac >= 2 / 3:
        print(f"ERROR: selective xMR bar not met (recovery={recovery}, "
              f"flops fraction={flops_frac:.3f})", file=sys.stderr)
        ok = False
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
